"""Time the lockstep-walk probe's dependent chain (kernel row 11) alone on one card.

Run on a machine with an NVIDIA H100, from the root of the repository:

    python3 tools/inflate_probe_chain.py [--steps N] [--sass PATH]

It builds a small CUDA source held here (``nvcc``, into a temporary
directory) whose kernel runs, on one warp, a chain of ``--steps`` dependent
steps of one kind and reads ``clock64`` and ``%globaltimer`` around it:

- ``lds_u8``: ``x = tab[x]``, a byte load from shared memory whose address is
  the last load's value (the shared-memory load's latency);
- ``shf``: ``x = funnelshift_r(x, y, x)`` (the funnel shift's latency);
- ``probe_step``: ``x = funnelshift_r(x, y, tab[x & 0x7FFF])``, the wave's
  dependent chain in ``csrc/inflate_probe_core.cuh`` with the length-class
  table (mask, byte load, funnel shift), with table entries of 1-22 as the
  probe's advances are.

It prints the card's name and power limit, then one JSON line: for each
kind its cycles a step (``clock64``) and ns a step (``%globaltimer``), and
the SM clock those two give (cycles over ns).  ``chip_smoke.py`` calls
:func:`build` and :func:`measure` for row 11's latency floor.  With ``--sass`` it writes
``cuobjdump -sass`` of its kernel and of the port's built probe library
(``hadoop_bam_tpu_torch/_build/libinflate_probe.so``, built first) to
PATH.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// kind 0: x = tab[x]; 1: x = funnelshift_r(x, y, x); 2: x = funnelshift_r(x,
// y, tab[x & 0x7FFF]).  out[0] = cycles, out[1] = ns, sink keeps x live.
__global__ void chain_kernel(int kind, int steps, long long* out, uint32_t* sink) {
  __shared__ uint8_t tab[1 << 15];
  for (int i = threadIdx.x; i < (1 << 15); i += blockDim.x) {
    tab[i] = static_cast<uint8_t>(kind == 0 ? (i * 37 + 11) & 0xFF : 1 + (i * 7) % 22);
  }
  __syncthreads();
  uint32_t x = threadIdx.x, y = 0x9E3779B9u * (threadIdx.x + 1);
  const long long c0 = clock64();
  const uint64_t t0 = global_ns();
  if (kind == 0) {
#pragma unroll 16
    for (int i = 0; i < steps; ++i) x = tab[x];
  } else if (kind == 1) {
#pragma unroll 16
    for (int i = 0; i < steps; ++i) x = __funnelshift_r(x, y, x);
  } else {
#pragma unroll 16
    for (int i = 0; i < steps; ++i) x = __funnelshift_r(x, y, tab[x & 0x7FFF]);
  }
  const long long c1 = clock64();
  const uint64_t t1 = global_ns();
  sink[threadIdx.x] = x;
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = static_cast<long long>(t1 - t0);
  }
}

extern "C" int chain_run(int kind, int steps, void* out, void* sink) {
  chain_kernel<<<1, 32>>>(kind, steps, static_cast<long long*>(out),
                          static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaDeviceSynchronize());
}
"""

KINDS = ("lds_u8", "shf", "probe_step")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def build(d: str) -> ctypes.CDLL:
    """Compile ``SOURCE`` with the port's ``nvcc`` flags into directory
    ``d`` and bind its entry."""
    sys.path.insert(0, REPO)
    from hadoop_bam_tpu_torch import _build

    src, lib = os.path.join(d, "chain.cu"), os.path.join(d, "libchain.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True)
    so = ctypes.CDLL(lib)
    so.chain_run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return so


def measure(so: ctypes.CDLL, steps: int) -> dict:
    """``{kind: {"cycles_per_step", "ns_per_step", "sm_mhz"}}`` for each of
    ``KINDS``, a chain of ``steps`` after one of 1,024, on the current card."""
    import torch

    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, dtype=torch.int32, device="cuda")
    row = {}
    for kind, name in enumerate(KINDS):
        so.chain_run(kind, 1024, out.data_ptr(), sink.data_ptr())  # warm-up
        rc = so.chain_run(kind, steps, out.data_ptr(), sink.data_ptr())
        if rc:
            raise RuntimeError(f"inflate_probe_chain: CUDA error {rc}")
        cycles, ns = out.tolist()
        row[name] = {"cycles_per_step": cycles / steps, "ns_per_step": ns / steps,
                     "sm_mhz": cycles / ns * 1e3}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1 << 20, help="dependent steps a chain")
    ap.add_argument("--sass", default="", help="write the kernels' SASS to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("inflate_probe_chain: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from hadoop_bam_tpu_torch import _build

    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory() as d:
        row = measure(build(d), args.steps)
        if args.sass:
            _build.build(["inflate_probe"])
            cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
            with open(args.sass, "w") as f:
                for path in (os.path.join(d, "libchain.so"),
                             str(_build.BUILD_DIR / "libinflate_probe.so")):
                    f.write(subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                                           text=True, check=True).stdout)
    print(json.dumps({"steps": args.steps, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Compare the lockstep-walk probe (kernel row 11) of two trees on one card.

Run on a machine with one NVIDIA H100, from the root of the repository, with
the other tree unpacked into a directory of it that ``.gitignore`` lists:

    git archive <commit> | (mkdir -p _parent && tar -x -C _parent)
    python3 tools/inflate_probe_pair.py [--other _parent] [--seed S]

It runs, in turns other, this, this, other, one process per run in the
tree's own root: the tree builds its probe kernel and, on an R = 4,096
stream from ``--seed`` with every cursor at 3 (as ``chip_smoke.py`` times
row 11), reports ``ms``, ``make_walk(4096, 2048)``'s call (CUDA events,
20 launches after 3); ``kernel_ms``, the bare launch of the C entry on
preallocated outputs; ``ns_per_wave_in_stream``, the slope from T = 2,048
to 16,384 (every cursor in the stream); and ``bench_marginal()``'s slope
and intercept at the reference's defaults (T = 32,768 and 131,072, the
cursors past the stream).  Each run prints one JSON line with a digest of
its T = 2,048 cursors and checksums; the card's name and power limit come
first.  The trees' digests must agree.  Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One run, executed in the root of the tree under test.
ONE_RUN = r"""
import hashlib, json, os, sys
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
from hadoop_bam_tpu_torch import _build
from hadoop_bam_tpu_torch.ops.kernels import inflate_probe as kip

seed = int(sys.argv[1])
_build.build(["inflate_probe"], force=True)
R, T = 4096, 2048
rng = np.random.default_rng(seed)
gs = torch.from_numpy(rng.integers(0, 1 << 31, (R, kip.LANES), dtype=np.int32)).cuda()
gc = torch.full((1, kip.LANES), 3, dtype=torch.int32, device="cuda")


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


walk, long_walk = kip.make_walk(R, T, "cuda"), kip.make_walk(R, 16384, "cuda")
ms = cuda_ms(lambda: walk(gs, gc), 20)
in_ns = (cuda_ms(lambda: long_walk(gs, gc), 10) - ms) / (16384 - T) * 1e6
lib = _build.load("inflate_probe")
out = torch.empty((2, kip.LANES), dtype=torch.int32, device="cuda")
stream = torch.cuda.current_stream().cuda_stream
args = [gs.data_ptr(), R, gc.data_ptr(), T, out[0].data_ptr(), out[1].data_ptr()]
bare = cuda_ms(lambda: _build.check(lib.hbt_inflate_probe_walk(*args, stream), "probe"), 20)
cur, acc = walk(gs, gc)
digest = hashlib.blake2b(cur.cpu().numpy().tobytes() + acc.cpu().numpy().tobytes(),
                         digest_size=8).hexdigest()
bench = kip.bench_marginal()
print(json.dumps({"ms": ms, "kernel_ms": bare, "ns_per_wave_in_stream": in_ns,
                  "bench_ns_per_wave": bench["ns_per_wave"], "bench_fixed_ms": bench["fixed_ms"],
                  "digest": digest}), flush=True)
"""


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=os.path.join(REPO, "_parent"),
                    help="root of the tree to compare with (default: _parent)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("inflate_probe_pair: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "hadoop_bam_tpu_torch", "csrc", "inflate_probe.cu")):
        print(f"inflate_probe_pair: no tree at {other}", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    results = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        root = other if which == "other" else REPO
        out = subprocess.run([sys.executable, "-c", ONE_RUN, str(args.seed)], cwd=root,
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        results[which].append(row)
        print(json.dumps({"tree": which, **row}), flush=True)
    for which, rows in results.items():
        print(f"{which}: " + ", ".join(
            f"{k} {[round(r[k], 5) for r in rows]}"
            for k in ("ms", "kernel_ms", "ns_per_wave_in_stream", "bench_ns_per_wave")),
            flush=True)
    digests = {r["digest"] for rows in results.values() for r in rows}
    if len(digests) != 1:
        print(f"inflate_probe_pair: the trees' walks differ: {sorted(digests)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

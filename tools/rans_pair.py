"""Compare the rANS 4x8 decode kernel (kernel row 7) of two trees on one card.

Run on a machine with one NVIDIA H100, from the root of the repository, with
the other tree unpacked into a directory of it that ``.gitignore`` lists:

    git archive <commit> | (mkdir -p _parent && tar -x -C _parent)
    python3 tools/rans_pair.py [--other _parent] [--cram-records N] [--seed S]

It writes one synthetic no-ref rANS CRAM (``chip_smoke.synth_cram``,
10,000 records a container) and then runs, in turns other, this, this,
other, one process per run in the tree's own root: the tree builds its
``csrc/rans.cu``, times one launch over the first container's rANS blocks
(CUDA events, the mean of 5 after one warm-up), and sorts the CRAM with
``sort_bam(device="cuda")``.  Each run prints one JSON line (kernel ms,
sort wall, the sort's phases, ``rans`` launches); the card's name and power
limit come first.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One run, executed in the root of the tree under test.
ONE_RUN = r"""
import json, os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
from hadoop_bam_tpu_torch import _build
from hadoop_bam_tpu_torch.ops.kernels import rans as kr
from hadoop_bam_tpu_torch.pipeline import sort_bam
from hadoop_bam_tpu_torch.spec import cram, cram_codecs as cc

cram_path, out_path = sys.argv[1], sys.argv[2]
_build.build(["rans"], force=True)
data = open(cram_path, "rb").read()
ch = cram.iter_containers(data)[1]
blocks = []
p = ch.offset + ch.header_size
while p < ch.next_offset:
    fr, p = cram.Block.read_frame(data, p, 3)
    if fr.method == cc.METHOD_RANS and fr.payload:
        blocks.append(fr.payload)
h = kr.pack([cc.parse_rans_plan(b) for b in blocks])
host = [torch.from_numpy(np.ascontiguousarray(h[k])) for k in ("payload", "meta", "lookup")]
host += [torch.from_numpy(h["fc"].view(np.int32)), torch.from_numpy(h["cmap"])]
dev = [t.cuda() for t in host]
launch = lambda: kr.rans_decode_device(*dev, h["out_total"])
launch()
torch.cuda.synchronize()
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
a.record()
for _ in range(5):
    launch()
b.record()
torch.cuda.synchronize()
kernel_ms = a.elapsed_time(b) / 5
kr.LAUNCHES.reset()
torch.cuda.synchronize()
t0 = time.perf_counter()
st = sort_bam(cram_path, out_path, device="cuda")
torch.cuda.synchronize()
wall = time.perf_counter() - t0
print(json.dumps({"kernel_ms": kernel_ms, "streams": len(blocks), "sort_wall_s": wall,
                  "phases_s": st.seconds, "rans_launches": kr.LAUNCHES.value,
                  "records": st.n_records}), flush=True)
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
    ap.add_argument("--cram-records", type=int, default=300_000)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("rans_pair: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "hadoop_bam_tpu_torch", "csrc", "rans.cu")):
        print(f"rans_pair: no tree at {other}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    print(card_line(), flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke.", dir=REPO)
    try:
        cram_path = os.path.join(work, "pair.cram")
        n_cont = chip_smoke.synth_cram(cram_path, chip_smoke.synth_rows(args.cram_records,
                                                                         args.seed + 1))
        print(f"CRAM: {args.cram_records} records, {n_cont} containers, "
              f"{os.path.getsize(cram_path)} bytes", flush=True)
        results = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            root = other if which == "other" else REPO
            out = subprocess.run(
                [sys.executable, "-c", ONE_RUN, cram_path, os.path.join(work, "out.bam")],
                cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            results[which].append(row)
            print(json.dumps({"tree": which, **row}), flush=True)
        for which, rows in results.items():
            print(f"{which}: kernel ms {[round(r['kernel_ms'], 3) for r in rows]}, read phase s "
                  f"{[round(r['phases_s'].get('read', float('nan')), 3) for r in rows]}, sort s "
                  f"{[round(r['sort_wall_s'], 3) for r in rows]}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

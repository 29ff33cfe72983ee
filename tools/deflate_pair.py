"""Compare the deflate kernel (kernel row 3) of two trees on one card.

Run on a machine with one NVIDIA H100, from the root of the repository, with
the other tree unpacked into a directory of it that ``.gitignore`` lists:

    git archive <commit> | (mkdir -p _parent && tar -x -C _parent)
    python3 tools/deflate_pair.py [--other _parent] [--records N] [--seed S]

It builds one part-like record stream: ``N`` synthetic records
(``chip_smoke.synth_rows``, 280 bytes each; the default 187,446 is the sort
input's first split) in a random order, as a coordinate sort gathers them,
cut into ``DEV_LZ_PAYLOAD`` (57,088-byte) members: 920 members at the
default.  Then it runs, in turns other, this, this, other, one process per
run in the tree's own root: the tree builds its ``csrc/deflate.cu``, runs
``deflate_lanes_stream`` once on the card, then times the mean of 5 launches
with CUDA events.  Each run prints one JSON line (kernel ms, members, output
bytes, a digest of the rows and clens); the card's name and power limit come
first.  The digests of all four runs must agree.  Imports neither JAX nor
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One run, executed in the root of the tree under test.
ONE_RUN = r"""
import hashlib, json, os, sys
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
from hadoop_bam_tpu_torch import _build
from hadoop_bam_tpu_torch.ops import flate
from hadoop_bam_tpu_torch.ops.kernels import deflate as kd

_build.build(["deflate"], force=True)
stream = torch.from_numpy(np.load(sys.argv[1])).cuda()
lens = flate._block_lens(stream.numel(), flate.DEV_LZ_PAYLOAD)
offs = np.arange(len(lens), dtype=np.int64) * flate.DEV_LZ_PAYLOAD
launch = lambda: kd.deflate_lanes_stream(stream, lens, offs=offs)
comp, clens, ok = launch()
torch.cuda.synchronize()
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
a.record()
for _ in range(5):
    launch()
b.record()
torch.cuda.synchronize()
cl = clens.cpu().numpy()
h = hashlib.sha256(comp.cpu().numpy().tobytes())
h.update(cl.tobytes())
h.update(ok.cpu().numpy().tobytes())
print(json.dumps({"kernel_ms": a.elapsed_time(b) / 5, "members": len(lens),
                  "in_bytes": stream.numel(), "out_bytes": int(cl.astype(np.int64).sum()),
                  "all_ok": bool(ok.all()), "digest": h.hexdigest()[:16]}), flush=True)
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
    ap.add_argument("--records", type=int, default=187_446)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("deflate_pair: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "hadoop_bam_tpu_torch", "csrc", "deflate.cu")):
        print(f"deflate_pair: no tree at {other}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    print(card_line(), flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke.", dir=REPO)
    try:
        rows = chip_smoke.synth_rows(args.records, args.seed)
        rows = rows[np.random.default_rng(args.seed).permutation(len(rows))]
        path = os.path.join(work, "part.npy")
        np.save(path, rows.reshape(-1))
        print(f"part: {args.records} records, {rows.size} bytes", flush=True)
        results = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            root = other if which == "other" else REPO
            out = subprocess.run([sys.executable, "-c", ONE_RUN, path], cwd=root,
                                 capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            results[which].append(row)
            print(json.dumps({"tree": which, **row}), flush=True)
        for which, rs in results.items():
            print(f"{which}: kernel ms {[round(r['kernel_ms'], 3) for r in rs]}", flush=True)
        digests = {r["digest"] for rs in results.values() for r in rs}
        if len(digests) != 1:
            print(f"deflate_pair: the trees' outputs differ: {sorted(digests)}", file=sys.stderr)
            return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

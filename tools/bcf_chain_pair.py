"""Compare the BCF chain kernel (kernel row 5) of two trees on one card.

Run on a machine with one NVIDIA H100, from the root of the repository, with
the other tree unpacked into a directory of it that ``.gitignore`` lists:

    git archive <commit> | (mkdir -p _parent && tar -x -C _parent)
    python3 tools/bcf_chain_pair.py [--other _parent] [--variants N] [--seed S]

It writes one synthetic BGZF-BCF call set (``chip_smoke.synth_bcf``,
4,500,000 sites by default, as ``chip_smoke.py``'s variants phase) and then
runs, in turns other, this, this, other, one process per run in the tree's
own root: the tree builds its kernels, times ``walk_chain_device`` over the
first split of the call set (CUDA events, the mean of 20 after 3 warm-ups),
and queries the first region of ``chip_smoke.VARIANT_REGIONS`` with
``variants_blob`` on a one-shot card context twice (a warm-up, then the measured query
with the launch counts zeroed just before it).  Each run prints one JSON
line: the kernel's ms, the query's wall and phases, its ``bcf_chain``
launches and a digest of its blob; the card's name and power limit come
first.  Imports neither JAX nor the JAX package.
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
import hashlib, json, os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
from hadoop_bam_tpu_torch import _build
from hadoop_bam_tpu_torch.io.bcf import BcfInputFormat, _read_bcf_split_local
from hadoop_bam_tpu_torch.ops.kernels import bcf_chain as kb
from hadoop_bam_tpu_torch.serve.endpoints import ServeContext, variants_blob

path, region = sys.argv[1], sys.argv[2]
_build.build(force=True)
split = BcfInputFormat().get_splits([path])[0]
_, payload, p, end, _, _ = _read_bcf_split_local(split)
g = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).cuda()
walk = lambda: kb.walk_chain_device(g, p, end)
for _ in range(3):
    walk()
torch.cuda.synchronize()
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
a.record()
for _ in range(20):
    walk()
b.record()
torch.cuda.synchronize()
kernel_ms = a.elapsed_time(b) / 20
records = int(walk()[1][0])
variants_blob(ServeContext.from_conf(with_batcher=False), path, region)
torch.cuda.synchronize()
kb.LAUNCHES.reset()
timings = {}
t0 = time.perf_counter()
blob = variants_blob(ServeContext.from_conf(with_batcher=False), path, region, timings=timings)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
print(json.dumps({"kernel_ms": kernel_ms, "split_records": records, "split_bytes": end - p,
                  "query_wall_s": wall, "phases_s": timings,
                  "bcf_chain_launches": kb.LAUNCHES.value,
                  "blob_digest": hashlib.blake2b(blob, digest_size=8).hexdigest()}), flush=True)
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
    ap.add_argument("--variants", type=int, default=4_500_000, help="sites of the call set")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bcf_chain_pair: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "hadoop_bam_tpu_torch", "csrc", "bcf_chain.cu")):
        print(f"bcf_chain_pair: no tree at {other}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    print(card_line(), flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke.", dir=REPO)
    try:
        path = os.path.join(work, "calls.bcf")
        _, pos, rows, _ = chip_smoke.synth_bcf(path, args.variants, args.seed)
        print(f"call set: {len(pos)} sites, {rows.size} bytes of records, "
              f"{os.path.getsize(path)} bytes BGZF", flush=True)
        region = chip_smoke.VARIANT_REGIONS[0]
        results = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            root = other if which == "other" else REPO
            out = subprocess.run([sys.executable, "-c", ONE_RUN, path, region], cwd=root,
                                 capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            results[which].append(row)
            print(json.dumps({"tree": which, "region": region, **row}), flush=True)
        for which, rows_ in results.items():
            print(f"{which}: kernel ms {[round(r['kernel_ms'], 4) for r in rows_]}, query s "
                  f"{[round(r['query_wall_s'], 3) for r in rows_]}, read phase s "
                  f"{[round(r['phases_s'].get('read', float('nan')), 3) for r in rows_]}",
                  flush=True)
        digests = {r["blob_digest"] for rows_ in results.values() for r in rows_}
        if len(digests) != 1:
            print(f"bcf_chain_pair: the trees' blobs differ: {sorted(digests)}", file=sys.stderr)
            return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Compare the region views (kernel row 6, the overlap cut) of two trees on one card.

Run on a machine with one NVIDIA H100, from the root of the repository, with
the other tree unpacked into a directory of it that ``.gitignore`` lists:

    git archive <commit> | (mkdir -p _parent && tar -x -C _parent)
    python3 tools/region_pair.py [--other _parent] [--records N] [--seed S]
                                 [--region R ...]

It writes the synthetic BAM of ``chip_smoke.py``'s sort (``chip_smoke.
synth_bam``, 2,000,000 records of 280 bytes by default), sorts it on the
card with the write gates off as ``chip_smoke.main_path`` does for its
region phase, and builds its ``.bai``; the chr21 view of that file reads
about 800 ``.bai`` chunk spans.  Then it runs, in turns other, this, this,
other, one process per run in the tree's own root: the tree builds its
kernels and, for each region (default: ``chip_smoke.REGIONS[:2]``, the
chr20 window and chr21), calls ``view_blob`` on a one-shot card context twice, a
warm-up and the measured call with the launch counts zeroed just before
it.  Each run prints one JSON line with each view's wall and phases, its
row-6 launches (``overlap_mask`` and, where the tree has it,
``overlap_rows``), its ``serve.view.*`` counters and overlap transfers,
and a digest of its bytes; the card's name and power limit come first.
The trees' digests must agree.  Imports neither JAX nor the JAX package.
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
import torch
sys.path.insert(0, os.getcwd())
from hadoop_bam_tpu_torch import _build
from hadoop_bam_tpu_torch.ops.kernels import LaunchCounter
from hadoop_bam_tpu_torch.ops.kernels import overlap as kov
from hadoop_bam_tpu_torch.serve.endpoints import ServeContext, view_blob

path, regions = sys.argv[1], json.loads(sys.argv[2])
_build.build(["inflate", "region"], force=True)
counters = [v for v in vars(kov).values() if isinstance(v, LaunchCounter)]
row = {}
for region in regions:
    view_blob(ServeContext.from_conf(with_batcher=False), path, region)
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    ctx = ServeContext.from_conf(with_batcher=False)
    timings = {}
    t0 = time.perf_counter()
    blob = view_blob(ctx, path, region, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = ctx.metrics.counters()
    row[region] = {
        "wall_s": wall, "phases_s": timings, "launches": {c.name: c.value for c in counters},
        "counters": {k: v for k, v in sorted(got.items())
                     if k.startswith("serve.view.") or "overlap" in k},
        "bytes": len(blob), "digest": hashlib.blake2b(blob, digest_size=8).hexdigest()}
print(json.dumps(row), flush=True)
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
    ap.add_argument("--records", type=int, default=2_000_000, help="records of the sorted BAM")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--region", action="append", default=[],
                    help="a view's region (default: the chr20 window and chr21)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("region_pair: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "hadoop_bam_tpu_torch", "csrc", "region.cu")):
        print(f"region_pair: no tree at {other}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from hadoop_bam_tpu_torch.conf import (DEFLATE_LANES, INFLATE_LANES, WRITE_DEVICE,
                                            Configuration)
    from hadoop_bam_tpu_torch.pipeline import sort_bam
    from hadoop_bam_tpu_torch.spec import indices

    regions = args.region or list(chip_smoke.REGIONS[:2])
    print(card_line(), flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke.", dir=REPO)
    try:
        src = os.path.join(work, "in.bam")
        path = os.path.join(work, "sorted.bam")
        chip_smoke.synth_bam(src, args.records, args.seed)
        off = Configuration({INFLATE_LANES: "true", DEFLATE_LANES: "false", WRITE_DEVICE: "false"})
        sort_bam(src, path, conf=off, device="cuda", device_parse=True)
        os.remove(src)
        bai = indices.build_bai(path)
        with open(path + ".bai", "wb") as f:
            bai.save(f)
        print(f"sorted BAM: {args.records} records, {os.path.getsize(path)} bytes, "
              f"regions {regions}", flush=True)
        results = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            root = other if which == "other" else REPO
            out = subprocess.run([sys.executable, "-c", ONE_RUN, path, json.dumps(regions)],
                                 cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            results[which].append(row)
            print(json.dumps({"tree": which, **row}), flush=True)
        for which, rows in results.items():
            for region in regions:
                print(f"{which} {region}: wall s {[round(r[region]['wall_s'], 4) for r in rows]}, "
                      f"overlap s {[round(r[region]['phases_s']['overlap'], 4) for r in rows]}, "
                      f"read s {[round(r[region]['phases_s']['read'], 4) for r in rows]}",
                      flush=True)
        digests = {(region, r[region]["digest"]) for rows in results.values() for r in rows
                   for region in regions}
        if len(digests) != len(regions):
            print(f"region_pair: the trees' views differ: {sorted(digests)}", file=sys.stderr)
            return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Compare the BAM record-chain kernel (kernel row 2) of two trees on one card.

Run on a machine with one NVIDIA H100, from the root of the repository, with
the other tree unpacked into a directory of it that ``.gitignore`` lists:

    git archive <commit> | (mkdir -p _parent && tar -x -C _parent)
    python3 tools/chain_pair.py [--other _parent] [--records N] [--seed S]
                                [--geometry SEG:SLAB ...] [--no-sort]

It writes the synthetic BAM of ``chip_smoke.py``'s sort (``chip_smoke.
synth_bam``, 2,000,000 records of 280 bytes by default) and then runs, in
turns other, this, this, other, one process per run in the tree's own
root: the tree builds its kernels, times ``record_chain`` over the record
stream of the input's first 32 MiB split (a view into the inflated split
at the split's first record, as ``parse_split`` passes it; CUDA events, the
mean of 20 after 3 warm-ups) and the walk with the sort keys (the fused
``record_chain_keys`` where the tree has it, else ``record_chain`` then
``stream_keys``), and, where the tree has the segmented walk
(its private ``_launch``), adds the walk's phases and hops (mean of 5) and
times each ``--geometry`` (segments of SEG bytes in slabs of SLAB, each
checked against the default walk), then sorts the file with
``sort_bam(device="cuda")`` twice (a warm-up, then the measured sort with
the launch counts zeroed just before it; ``--no-sort`` skips it).  Each run
prints one JSON line: the kernel's ms with and without the keys, the
sort's wall and phases, its ``record_chain`` and ``stream_keys`` launches
and a digest of its output; the card's name and power limit come first.
Imports neither JAX nor the JAX package.
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
import ctypes, hashlib, json, os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
from hadoop_bam_tpu_torch import _build
from hadoop_bam_tpu_torch.io.bam import BamInputFormat
from hadoop_bam_tpu_torch.ops.kernels import chain as kch
from hadoop_bam_tpu_torch.pipeline import sort_bam
from hadoop_bam_tpu_torch.spec import bam, bgzf

src, out, geometries, do_sort = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), sys.argv[4] == "1"
_build.build(None if do_sort else ["chain"], force=True)
split = BamInputFormat().get_splits([src], split_size=32 << 20)[0]
size = os.path.getsize(src)
c0, c1 = split.vstart >> 16, min(split.vend >> 16, size)
with open(src, "rb") as f:
    f.seek(c0)
    data = bytearray(f.read(min(c1 + (1 << 20), size) - c0))
co, cs, us = [], [], []
pos = 0
while pos < len(data) and pos <= c1 - c0:  # the members read_split inflates
    csize, usize = bgzf.read_block_at(data, pos)
    co.append(pos)
    cs.append(csize)
    us.append(usize)
    pos += csize
host, _ = bgzf.inflate_blocks(data, co, cs, us)
s0 = split.vstart & 0xFFFF
offs_h, s1 = bam.record_chain_partial(host, s0, len(host))
g = torch.from_numpy(host).cuda()[s0:s1]
walk = lambda: kch.record_chain(g, s1 - s0)
offs, meta = walk()
if meta.cpu().tolist() != [len(offs_h), 1] or not np.array_equal(
        offs[: len(offs_h)].cpu().numpy() + s0, offs_h):
    sys.exit("record_chain differs from the host walk at the first split")
for _ in range(3):
    walk()
torch.cuda.synchronize()


def cuda_ms(fn):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(20):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 20


def phases(seg, slab):
    runs = []
    for _ in range(5):
        ms = (ctypes.c_float * len(kch.PHASES))()
        o, m, work, segments = kch._launch(g, s1 - s0, seg, slab, phase_ms=ms)[:4]
        if not torch.equal(o[: len(offs_h)], offs[: len(offs_h)]) or not torch.equal(m, meta):
            sys.exit(f"record_chain at seg {seg}, slab {slab} differs from the default")
        runs.append((list(ms), int(work[:32].view(torch.int64)[3]), segments))
    return {"phases_us": {k: 1e3 * sum(r[0][i] for r in runs) / 5
                          for i, k in enumerate(kch.PHASES)},
            "segments": runs[0][2], "hops": runs[0][1]}


n_rec = len(offs_h)
if hasattr(kch, "record_chain_keys"):  # the keys ride the walk's emit
    keyed = lambda: kch.record_chain_keys(g, s1 - s0, n_rec)
else:  # the walk, then the standalone key gather
    keyed = lambda: kch.stream_keys(g, s1 - s0, *kch.record_chain(g, s1 - s0), n_rec)
for _ in range(3):
    keyed()
row = {"kernel_ms": cuda_ms(walk), "walk_keys_ms": cuda_ms(keyed), "split_records": n_rec,
       "split_bytes": s1 - s0}
if hasattr(kch, "_launch"):
    row.update(phases(kch.SEG, kch.SLAB))
    row["geometries"] = {}
    for seg, slab in geometries:
        for _ in range(3):
            kch._launch(g, s1 - s0, seg, slab)
        row["geometries"][f"{seg}:{slab}"] = {
            "kernel_ms": cuda_ms(lambda: kch._launch(g, s1 - s0, seg, slab)), **phases(seg, slab)}
del g, offs, meta
if not do_sort:
    print(json.dumps(row), flush=True)
    sys.exit(0)
sort_bam(src, out, device="cuda")
torch.cuda.synchronize()
kch.WALK_LAUNCHES.reset()
kch.KEYS_LAUNCHES.reset()
t0 = time.perf_counter()
st = sort_bam(src, out, device="cuda")
torch.cuda.synchronize()
wall = time.perf_counter() - t0
with open(out, "rb") as f:
    digest = hashlib.blake2b(f.read(), digest_size=8).hexdigest()
os.remove(out)
row.update({"sort_wall_s": wall, "sort_records": st.n_records, "phases_s": st.seconds,
            "record_chain_launches": kch.WALK_LAUNCHES.value,
            "stream_keys_launches": kch.KEYS_LAUNCHES.value, "out_digest": digest})
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
    ap.add_argument("--records", type=int, default=2_000_000, help="records of the sort input")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--geometry", action="append", default=[], metavar="SEG:SLAB",
                    help="also time the walk in segments of SEG bytes and slabs of SLAB")
    ap.add_argument("--no-sort", action="store_true", help="time the kernel only")
    args = ap.parse_args()
    geometries = json.dumps([[int(x) for x in g.split(":")] for g in args.geometry])

    import torch

    if not torch.cuda.is_available():
        print("chain_pair: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "hadoop_bam_tpu_torch", "csrc", "chain.cu")):
        print(f"chain_pair: no tree at {other}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    print(card_line(), flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke.", dir=REPO)
    try:
        src = os.path.join(work, "in.bam")
        size = chip_smoke.synth_bam(src, args.records, args.seed)
        print(f"sort input: {args.records} records, {size} bytes BGZF", flush=True)
        results = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            root = other if which == "other" else REPO
            out = subprocess.run([sys.executable, "-c", ONE_RUN, src,
                                  os.path.join(work, "out.bam"), geometries,
                                  "0" if args.no_sort else "1"],
                                 cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            results[which].append(row)
            print(json.dumps({"tree": which, **row}), flush=True)
        for which, rows in results.items():
            print(f"{which}: kernel ms {[round(r['kernel_ms'], 4) for r in rows]}, walk + keys ms "
                  f"{[round(r['walk_keys_ms'], 4) for r in rows]}", flush=True)
            if not args.no_sort:
                print(f"{which}: sort s {[round(r['sort_wall_s'], 3) for r in rows]}, read phase "
                      f"s {[round(r['phases_s'].get('read', float('nan')), 3) for r in rows]}",
                      flush=True)
        if args.no_sort:
            return 0
        digests = {r["out_digest"] for rows in results.values() for r in rows}
        if len(digests) != 1:
            print(f"chain_pair: the trees' outputs differ: {sorted(digests)}", file=sys.stderr)
            return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Compare the write kernels (kernel rows 3b, the gather, and 3c, the CRC32) of two trees on one card.

Run on a machine with one NVIDIA H100, from the root of the repository, with
the other tree unpacked into a directory of it that ``.gitignore`` lists:

    git archive <commit> | (mkdir -p _parent && tar -x -C _parent)
    python3 tools/write_pair.py [--other _parent] [--records N] [--seed S]
                                [--crc-geometry THREADS:W ...]
                                [--gather-geometry TILE:THREADS ...] [--no-sort]

It makes a sort part's shape: ``--part-records`` (187,446, the main path's
first split) synthetic records of 280 bytes (``chip_smoke.synth_rows``) in
a random order, as the resident sort hands them to the gather, and the
gathered stream's 57,088-byte members (``flate.DEV_LZ_PAYLOAD``) for the
CRC32; and, unless ``--no-sort``, a synthetic BAM of ``--records``
(2,000,000) records.  Then it runs, in turns other, this, this, other, one
process per run in the tree's own root.  The tree builds ``csrc/write.cu``
and prints ptxas's report of it (registers, spills, stack, shared memory);
holds the gather to the host gather and each CRC to zlib; times each
kernel with its wrapper (``gather_stream_device``, ``crc32_device``: host
columns in, as the part writer calls them) and its bare launch (the C
entry alone over columns already on the card: ``kernel_ms``), CUDA events,
the mean of 20 after 3 warm-ups; times each ``--crc-geometry`` and
``--gather-geometry`` of a tree that takes them (each checked against the
default launch); times two yardsticks, a device ``copy_`` of the part's
bytes and a ``torch.sum`` of them; and sorts the BAM as one resident split
(``sort_bam(device="cuda", split_size=size + 1)``: the device part write)
once to warm up and twice timed.  Each run prints one JSON line with
digests of the outputs; the card's name and power limit come first.
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

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One run, executed in the root of the tree under test.
ONE_RUN = r"""
import hashlib, json, os, sys, time, zlib
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
from hadoop_bam_tpu_torch import _build
from hadoop_bam_tpu_torch.ops import flate
from hadoop_bam_tpu_torch.ops.kernels import crc32 as kcrc
from hadoop_bam_tpu_torch.ops.kernels import gather as kg
from hadoop_bam_tpu_torch.ops.kernels import stream_handle

data_path, bam_path = sys.argv[1:3]
opts = json.loads(sys.argv[3])
log = _build.build(["write"], force=True)["write"]["log"]
ptxas = [l.strip() for l in log.splitlines()
         if any(w in l for w in ("registers", "spill", "stack", "smem", "Compiling"))]
z = np.load(data_path)
host, src, ln, perm = z["stream"], z["src"], z["lens"], z["perm"]
dev = torch.device("cuda")
stream = torch.from_numpy(host).to(dev)
lib = _build.load("write")
new = hasattr(kg, "_launch")


def cuda_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def digest(t):
    return hashlib.blake2b(t.cpu().numpy().tobytes(), digest_size=8).hexdigest()


row = {"ptxas": ptxas, "records": len(src)}
g, total = kg.gather_stream_device(stream, src, ln)
want = host.reshape(len(src), -1)[perm].reshape(-1)
if not np.array_equal(g.cpu().numpy(), want):
    sys.exit("gather_stream_device differs from the host gather")
row["gather_digest"] = digest(g)
row["gather_ms"] = cuda_ms(lambda: kg.gather_stream_device(stream, src, ln))
out = torch.empty(total, dtype=torch.uint8, device=dev)
if new:
    cols = kg._columns(src, ln, None, dev)
    tf = torch.empty(-(-total // kg.TILE), dtype=torch.int32, device=dev)
    row["gather_kernel_ms"] = cuda_ms(
        lambda: kg._launch(stream, *cols[:3], None, kg.FLAG_DUPLICATE, out, tf))
    row["gather_geometries"] = {}
    for tile, threads in opts["gather_geometries"]:
        tf2 = torch.empty(-(-total // tile), dtype=torch.int32, device=dev)
        out.fill_(0xA5)
        launch = lambda: kg._launch(stream, *cols[:3], None, kg.FLAG_DUPLICATE, out, tf2,
                                    tile, threads)
        launch()
        if digest(out) != row["gather_digest"]:
            sys.exit(f"gather at tile {tile}, {threads} threads differs from the default")
        row["gather_geometries"][f"{tile}:{threads}"] = cuda_ms(launch)
else:
    s_t = torch.from_numpy(src).to(dev)
    d_t = torch.from_numpy(np.cumsum(ln) - ln).to(dev)
    l_t = torch.from_numpy(ln.astype(np.int32)).to(dev)
    h = stream_handle(stream)
    row["gather_kernel_ms"] = cuda_ms(lambda: lib.hbt_gather_stream(
        stream.data_ptr(), s_t.data_ptr(), d_t.data_ptr(), l_t.data_ptr(), None, len(src),
        kg.FLAG_DUPLICATE, out.data_ptr(), h))
lens_c = flate._block_lens(total, flate.DEV_LZ_PAYLOAD)
offs_c = np.arange(len(lens_c), dtype=np.int64) * flate.DEV_LZ_PAYLOAD
crc = kcrc.crc32_device(g, offs_c, lens_c)
want = np.array([zlib.crc32(want[o: o + n]) for o, n in zip(offs_c, lens_c)], np.uint32)
if not np.array_equal(crc.view(torch.int32).cpu().numpy().view(np.uint32), want):
    sys.exit("crc32_device differs from zlib")
row["members"] = len(lens_c)
row["crc_digest"] = digest(crc.view(torch.int32))
row["crc_ms"] = cuda_ms(lambda: kcrc.crc32_device(g, offs_c, lens_c))
cout = torch.empty(len(lens_c), dtype=torch.int32, device=dev)
if new:
    o_t, l_t = kcrc._columns(offs_c, lens_c, dev)
    row["crc_kernel_ms"] = cuda_ms(lambda: kcrc._launch(g, o_t, l_t, cout))
    row["crc_geometries"] = {}
    for threads, w in opts["crc_geometries"]:
        cout.fill_(0)
        launch = lambda: kcrc._launch(g, o_t, l_t, cout, threads, w)
        launch()
        if digest(cout) != row["crc_digest"]:
            sys.exit(f"crc32 at {threads} threads, w {w} differs from the default")
        row["crc_geometries"][f"{threads}:{w}"] = cuda_ms(launch)
else:
    o_t = torch.from_numpy(offs_c).to(dev)
    l_t = torch.from_numpy(lens_c.astype(np.int32)).to(dev)
    h = stream_handle(g)
    row["crc_kernel_ms"] = cuda_ms(lambda: lib.hbt_crc32_members(
        g.data_ptr(), o_t.data_ptr(), l_t.data_ptr(), len(lens_c), cout.data_ptr(), h))
copy = torch.empty_like(g)
row["copy_ms"] = cuda_ms(lambda: copy.copy_(g))
row["sum_ms"] = cuda_ms(lambda: torch.sum(g))
del g, copy, out, stream
if opts["sort"]:
    from hadoop_bam_tpu_torch.pipeline import sort_bam

    whole = os.path.getsize(bam_path) + 1
    out_path = os.path.join(os.path.dirname(bam_path), f"sorted.{os.getpid()}.bam")
    walls = []
    for k in range(3):
        kg.LAUNCHES.reset()
        kcrc.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sort_bam(bam_path, out_path, device="cuda", split_size=whole)
        torch.cuda.synchronize()
        if k:
            walls.append(time.perf_counter() - t0)
    with open(out_path, "rb") as f:
        row["sort_digest"] = hashlib.blake2b(f.read(), digest_size=8).hexdigest()
    os.remove(out_path)
    row.update({"sort_wall_s": walls, "sort_launches": {"gather_stream": kg.LAUNCHES.value,
                                                        "crc32": kcrc.LAUNCHES.value},
                "sort_parts": st.counters.get("bam.device_write_parts", 0)})
print(json.dumps(row), flush=True)
"""


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def _pairs(values):
    return [[int(x) for x in v.split(":")] for v in values]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=os.path.join(REPO, "_parent"),
                    help="root of the tree to compare with (default: _parent)")
    ap.add_argument("--part-records", type=int, default=187_446,
                    help="records of the part the kernels are timed at")
    ap.add_argument("--records", type=int, default=2_000_000,
                    help="records of the BAM the resident sort takes")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--crc-geometry", action="append", default=[], metavar="THREADS:W",
                    help="also time the CRC kernel at THREADS a block and W bytes a round")
    ap.add_argument("--gather-geometry", action="append", default=[], metavar="TILE:THREADS",
                    help="also time the gather at TILE bytes and THREADS a block")
    ap.add_argument("--no-sort", action="store_true", help="skip the resident sort")
    args = ap.parse_args()
    opts = json.dumps({"crc_geometries": _pairs(args.crc_geometry),
                       "gather_geometries": _pairs(args.gather_geometry),
                       "sort": not args.no_sort})

    import torch

    if not torch.cuda.is_available():
        print("write_pair: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "hadoop_bam_tpu_torch", "csrc", "write.cu")):
        print(f"write_pair: no tree at {other}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    print(card_line(), flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke.", dir=REPO)
    try:
        rows = chip_smoke.synth_rows(args.part_records, args.seed)
        perm = np.random.default_rng(args.seed).permutation(len(rows))
        data_path = os.path.join(work, "part.npz")
        np.savez(data_path, stream=rows.reshape(-1), perm=perm,
                 src=(perm * rows.shape[1]).astype(np.int64),
                 lens=np.full(len(rows), rows.shape[1], np.int64))
        print(f"part: {len(rows)} records, {rows.size} bytes", flush=True)
        del rows
        bam_path = os.path.join(work, "in.bam")
        if not args.no_sort:
            size = chip_smoke.synth_bam(bam_path, args.records, args.seed)
            print(f"synthetic BAM: {args.records} records, {size} bytes", flush=True)
        results = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            root = other if which == "other" else REPO
            out = subprocess.run([sys.executable, "-c", ONE_RUN, data_path, bam_path, opts],
                                 cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            results[which].append(row)
            print(json.dumps({"tree": which, **row}), flush=True)
        for which, rs in results.items():
            print(f"{which}: gather ms {[round(r['gather_ms'], 4) for r in rs]} (kernel "
                  f"{[round(r['gather_kernel_ms'], 4) for r in rs]}), crc32 ms "
                  f"{[round(r['crc_ms'], 4) for r in rs]} (kernel "
                  f"{[round(r['crc_kernel_ms'], 4) for r in rs]}), resident sort s "
                  f"{[[round(w, 3) for w in r.get('sort_wall_s', [])] for r in rs]}", flush=True)
        for key in ("gather_digest", "crc_digest", "sort_digest"):
            digests = {r[key] for rs in results.values() for r in rs if key in r}
            if len(digests) > 1:
                print(f"write_pair: the trees' {key} differ: {sorted(digests)}", file=sys.stderr)
                return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Compare the FASTQ record-scan kernel (kernel row 4) of two trees on one card.

Run on a machine with one NVIDIA H100, from the root of the repository, with
the other tree unpacked into a directory of it that ``.gitignore`` lists:

    git archive <commit> | (mkdir -p _parent && tar -x -C _parent)
    python3 tools/record_scan_pair.py [--other _parent] [--pairs N] [--seed S]
                                      [--geometry TILE:THREADS ...] [--no-ingest]

It writes the ingest corpus of ``chip_smoke.py`` (``chip_smoke.fastq_pairs``,
250,000 read pairs by default: R1 is 89.9 MB of text, 1,575 scan chunks of
57,088 + 2,048 bytes) and then runs, in turns other, this, this, other, one
process per run in the tree's own root.  The tree builds its record-scan
kernel and prints ptxas's report of it (registers, spills, stack), then
times row 4 at R1's chunks as ``chip_smoke.time_record_scan`` does
(``scan_windows`` with its wrapper; CUDA events, the mean of 10 after 3
warm-ups), at the first 1, 132 and 528 chunks too, and, where the tree has
the tiled kernel (its private ``_launch``), the bare launch, the phases'
shares of the blocks' clock cycles and each ``--geometry`` (tiles of TILE
bytes, THREADS a block; each checked against the default launch).  Then it
ingests the corpus with ``ingest_fastq(device="cuda")`` twice (a warm-up,
then the measured run with the launch counts zeroed just before it;
``--no-ingest`` skips both).  Each run prints one JSON line: row 4's ms,
the ingest's wall and stages, its ``record_scan`` launches, a digest of the
scan's output and of the ingest's; the card's name and power limit come
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
from hadoop_bam_tpu_torch.ops.kernels import record_scan as krs

text, r1, r2, out = sys.argv[1:5]
geometries, do_ingest = json.loads(sys.argv[5]), sys.argv[6] == "1"
log = _build.build(None if do_ingest else ["record_scan"], force=True)["record_scan"]["log"]
ptxas = [l.strip() for l in log.splitlines()
         if any(w in l for w in ("registers", "spill", "stack", "smem"))]
with open(text, "rb") as f:
    run = f.read()
CHUNK, OVERLAP = 0xDF00, 2048  # the ingest's default claim and overlap
offs = np.arange(0, len(run), CHUNK, dtype=np.int64)
lens = np.minimum(CHUNK + OVERLAP, len(run) - offs)
cols = (offs, lens, np.minimum(CHUNK, len(run) - offs), offs == 0, offs + lens >= len(run))
caps = [krs.default_rec_cap(CHUNK + OVERLAP)] * len(offs)
g = torch.from_numpy(np.frombuffer(run, np.uint8).copy()).cuda()


def cuda_ms(fn, iters=10):
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


def digest(rows, meta, base):
    meta, rows, base = meta.cpu().numpy(), rows.cpu().numpy(), base.cpu().numpy()
    h = hashlib.blake2b(meta.tobytes(), digest_size=8)
    for b, n in zip(base.tolist(), meta[:, 0].tolist()):
        h.update(rows[b : b + n].tobytes())
    return h.hexdigest()


row = {"ptxas": ptxas, "chunks": len(offs), "kernel_ms_wrapped": cuda_ms(
    lambda: krs.scan_windows(g, *cols, caps))}
scan = krs.scan_windows(g, *cols, caps)
row["scan_digest"] = digest(*scan)
row["records"] = int(scan[1][:, 0].sum())
row["first_chunks_ms"] = {k: cuda_ms(lambda: krs.scan_windows(g, *(c[:k] for c in cols), caps[:k]))
                          for k in (1, 132, 528)}
if hasattr(krs, "_launch"):
    kcols, rows_k, meta_k = krs._columns(g, *cols, caps)
    row["kernel_ms"] = cuda_ms(lambda: krs._launch(g, kcols, rows_k, meta_k))
    cyc = torch.zeros(len(krs.PHASES), dtype=torch.int64, device="cuda")
    krs._launch(g, kcols, rows_k, meta_k, cycles=cyc)
    cyc = cyc.cpu().numpy().astype(np.float64)
    row["phase_shares"] = {k: round(float(v / cyc.sum()), 4) for k, v in zip(krs.PHASES, cyc)}
    row["geometries"] = {}
    for tile, threads in geometries:
        launch = lambda: krs._launch(g, kcols, rows_k, meta_k, tile, threads)
        launch()
        if digest(rows_k, meta_k, kcols[5]) != row["scan_digest"]:
            sys.exit(f"record_scan at tile {tile}, {threads} threads differs from the default")
        row["geometries"][f"{tile}:{threads}"] = cuda_ms(launch)
del g, scan
if do_ingest:
    from hadoop_bam_tpu_torch.ingest import ingest_fastq
    ingest_fastq(r1, out, r2=r2, device="cuda")
    torch.cuda.synchronize()
    krs.LAUNCHES.reset()
    t0 = time.perf_counter()
    st = ingest_fastq(r1, out, r2=r2, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(out, "rb") as f:
        row["out_digest"] = hashlib.blake2b(f.read(), digest_size=8).hexdigest()
    os.remove(out)
    row.update({"ingest_wall_s": wall, "ingest_records": st.n_records,
                "stages_s": st.seconds, "record_scan_launches": krs.LAUNCHES.value})
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
    ap.add_argument("--pairs", type=int, default=250_000, help="read pairs of the corpus")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--geometry", action="append", default=[], metavar="TILE:THREADS",
                    help="also time the kernel at tiles of TILE bytes and THREADS a block")
    ap.add_argument("--no-ingest", action="store_true", help="time the kernel only")
    args = ap.parse_args()
    geometries = json.dumps([[int(x) for x in g.split(":")] for g in args.geometry])

    import torch

    if not torch.cuda.is_available():
        print("record_scan_pair: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "hadoop_bam_tpu_torch", "csrc", "record_scan.cu")):
        print(f"record_scan_pair: no tree at {other}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    print(card_line(), flush=True)
    print(f"ncu on PATH: {shutil.which('ncu') or 'no'}", flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke.", dir=REPO)
    try:
        r1, r2 = chip_smoke.fastq_pairs(args.pairs, args.seed)
        paths = chip_smoke.write_fastq_inputs(work, r1, r2, "pair")
        text = os.path.join(work, "r1.fastq")
        with open(text, "wb") as f:
            f.write(r1)
        print(f"corpus: {args.pairs} pairs, R1 {len(r1)} bytes of text", flush=True)
        del r1, r2
        results = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            root = other if which == "other" else REPO
            out = subprocess.run([sys.executable, "-c", ONE_RUN, text, *paths,
                                  os.path.join(work, "out.bam"), geometries,
                                  "0" if args.no_ingest else "1"],
                                 cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            results[which].append(row)
            print(json.dumps({"tree": which, **row}), flush=True)
        for which, rows in results.items():
            print(f"{which}: row 4 ms {[round(r['kernel_ms_wrapped'], 4) for r in rows]}",
                  flush=True)
            if not args.no_ingest:
                print(f"{which}: ingest s {[round(r['ingest_wall_s'], 3) for r in rows]}, "
                      f"record_scan launches {[r['record_scan_launches'] for r in rows]}",
                      flush=True)
        for key in ("scan_digest",) + (() if args.no_ingest else ("out_digest",)):
            digests = {r[key] for rows in results.values() for r in rows}
            if len(digests) != 1:
                print(f"record_scan_pair: the trees' {key} differ: {sorted(digests)}",
                      file=sys.stderr)
                return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Compare the literal-only inflate kernel (kernel row 10) of two trees on one card.

Run on a machine with one NVIDIA H100, from the root of the repository, with
the other tree unpacked into a directory of it that ``.gitignore`` lists:

    git archive <commit> | (mkdir -p _parent && tar -x -C _parent)
    python3 tools/inflate_fixed_pair.py [--other _parent] [--mib N] [--seed S]
                                        [--geometry SEG:THREADS ...]

It makes the codec phase's corpus of ``chip_smoke.py``: ``--mib`` (64) MiB
of ``chip_smoke.synth_rows(seed + 2)`` record bytes through
``bgzf_compress_device(level=1, use_lanes=False)`` on the card, 2,797
literal-only members of 24,000 bytes, and their rows as
``bgzf_decompress_device`` hands them to row 10 (``chip_smoke.codec_rows``).
Then it runs, in turns other, this, this, other, one process per run in the
tree's own root.  The tree builds its row-10 kernel and prints ptxas's
report of it (registers, spills, stack), then times row 10 as
``chip_smoke.py``'s codec phase does (``inflate_fixed_literal`` with its
wrapper; CUDA events, the mean of 20 after 3 warm-ups) over all the members
and over the first 1 and 132, and, where the tree has the block-a-member
kernel (its private ``_launch``), the bare launch (``kernel_ms``), the
phases' shares of the blocks' clock cycles and each ``--geometry`` (SEG
bits a segment, THREADS a block; each checked against the default launch).
Last it decodes the corpus with ``bgzf_decompress_device(conf=inflate gate
off)`` once to warm up and three times timed, and prints their walls and a
digest of the output.  Each run prints one JSON line, with digests of row
10's output and of the decode's; the card's name and power limit come
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

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One run, executed in the root of the tree under test.
ONE_RUN = r"""
import hashlib, json, os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
from hadoop_bam_tpu_torch import _build
from hadoop_bam_tpu_torch.conf import INFLATE_LANES, Configuration
from hadoop_bam_tpu_torch.ops import flate
from hadoop_bam_tpu_torch.ops.kernels import inflate_fixed as kfix

blob_path, rows_path = sys.argv[1:3]
geometries = json.loads(sys.argv[3])
log = _build.build(["inflate_fixed"], force=True)["inflate_fixed"]["log"]
ptxas = [l.strip() for l in log.splitlines()
         if any(w in l for w in ("registers", "spill", "stack", "smem"))]
z = np.load(rows_path)
g = [torch.from_numpy(z[k]).cuda() for k in ("comp", "clens", "isizes")]
B = g[0].shape[0]


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


def digest(out, ok):
    h = hashlib.blake2b(ok.cpu().numpy().tobytes(), digest_size=8)
    h.update(out.cpu().numpy().tobytes())
    return h.hexdigest()


row = {"ptxas": ptxas, "members": B,
       "row10_ms": cuda_ms(lambda: kfix.inflate_fixed_literal(*g))}
out, ok = kfix.inflate_fixed_literal(*g)
row["row10_digest"] = digest(out, ok)
row["ok_members"] = int(ok.sum())
row["first_members_ms"] = {k: cuda_ms(lambda: kfix.inflate_fixed_literal(*(t[:k] for t in g)))
                           for k in (1, 132, B)}
del out, ok
if hasattr(kfix, "_launch"):
    c, out, ok, max_out = kfix._prepare(g[0], g[2])
    args = (c, g[1], g[2], out, ok)
    row["kernel_ms"] = cuda_ms(lambda: kfix._launch(*args))
    cyc = torch.zeros(len(kfix.PHASES), dtype=torch.int64, device="cuda")
    kfix._launch(*args, cycles=cyc)
    cyc = cyc.cpu().numpy().astype(np.float64)
    row["phase_shares"] = {k: round(float(v / cyc.sum()), 4) for k, v in zip(kfix.PHASES, cyc)}
    row["geometries"] = {}
    for seg, threads in geometries:
        launch = lambda: kfix._launch(c, g[1], g[2], out, ok, seg, threads)
        out.fill_(0xA5)
        launch()
        if digest(out[:, :max_out], ok) != row["row10_digest"]:
            sys.exit(f"inflate_fixed at seg {seg}, {threads} threads differs from the default")
        row["geometries"][f"{seg}:{threads}"] = cuda_ms(launch)
    del c, out, ok, args
del g
with open(blob_path, "rb") as f:
    blob = f.read()
off = Configuration({INFLATE_LANES: "false"})
flate.bgzf_decompress_device(blob, conf=off, device="cuda")
walls = []
for _ in range(3):
    torch.cuda.synchronize()
    kfix.LAUNCHES.reset()
    t0 = time.perf_counter()
    data = flate.bgzf_decompress_device(blob, conf=off, device="cuda")
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
row.update({"decode_wall_s": walls, "decode_launches": kfix.LAUNCHES.value,
            "decode_digest": hashlib.blake2b(data, digest_size=8).hexdigest()})
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
    ap.add_argument("--mib", type=int, default=64, help="MiB of record bytes of the corpus")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--geometry", action="append", default=[], metavar="SEG:THREADS",
                    help="also time the kernel at SEG bits a segment and THREADS a block")
    args = ap.parse_args()
    geometries = json.dumps([[int(x) for x in g.split(":")] for g in args.geometry])

    import torch

    if not torch.cuda.is_available():
        print("inflate_fixed_pair: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "hadoop_bam_tpu_torch", "csrc", "inflate_fixed.cu")):
        print(f"inflate_fixed_pair: no tree at {other}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from hadoop_bam_tpu_torch.ops import flate

    print(card_line(), flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke.", dir=REPO)
    try:
        n = args.mib << 20
        data = chip_smoke.synth_rows(-(-n // chip_smoke.ROW), args.seed + 2).reshape(-1)[:n]
        blob = flate.bgzf_compress_device(data.tobytes(), level=1, use_lanes=False, device="cuda")
        del data
        _, comp, clens, isz = chip_smoke.codec_rows(blob)
        blob_path, rows_path = os.path.join(work, "codec.bgzf"), os.path.join(work, "rows.npz")
        with open(blob_path, "wb") as f:
            f.write(blob)
        np.savez(rows_path, comp=comp, clens=clens, isizes=isz)
        print(f"corpus: {n} bytes, {len(blob)} bytes of BGZF, {len(isz)} members, C = "
              f"{comp.shape[1]}", flush=True)
        del blob, comp
        results = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            root = other if which == "other" else REPO
            out = subprocess.run([sys.executable, "-c", ONE_RUN, blob_path, rows_path, geometries],
                                 cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            results[which].append(row)
            print(json.dumps({"tree": which, **row}), flush=True)
        for which, rows in results.items():
            print(f"{which}: row 10 ms {[round(r['row10_ms'], 4) for r in rows]}, decode s "
                  f"{[[round(w, 4) for w in r['decode_wall_s']] for r in rows]}", flush=True)
        for key in ("row10_digest", "decode_digest"):
            digests = {r[key] for rows in results.values() for r in rows}
            if len(digests) != 1:
                print(f"inflate_fixed_pair: the trees' {key} differ: {sorted(digests)}",
                      file=sys.stderr)
                return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

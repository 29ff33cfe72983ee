"""Count the walk steps of the literal-only inflate kernel (kernel row 10) on the host.

Run from the root of the repository (no card needed):

    python3 tools/inflate_fixed_steps.py [--members N] [--seg BITS ...] [--seed S]

It compresses ``--members`` (6) members of 24,000 bytes of
``chip_smoke.synth_rows(seed + 2)`` record bytes, as the codec phase of
``chip_smoke.py`` does (``deflate_fixed``, literal-only), and walks each
member's bit stream as ``csrc/inflate_fixed_core.cuh`` maps and emits it:
every segment of ``--seg`` bits from its 9 entry offsets, entry 0 in full
with marks, entries 1-8 until they stop, leave the segment or land on a
mark.  It prints, per segment size, the mean over segments of a lane's map
steps (entry 0's and the others', each entry's last, ending step counted),
the mean over warps of 32 consecutive segments of the steps a warp takes
with each entry in a loop of its own (the longest lane, entry by entry) and
with entry 0 in its own loop and entries 1-8 in one shared loop (the
kernel's), and the true path's steps a segment (the emit's).  Imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def symbol_steps(stream: bytes) -> np.ndarray:
    """For each bit position of the stream: the symbol's length in bits
    when it is a literal (8 or 9), else -1 (an EOB or a length code)."""
    sys.path.insert(0, REPO)
    from hadoop_bam_tpu_torch.ops.kernels.inflate_fixed import _SYMBOLS

    bits = np.unpackbits(np.frombuffer(stream + bytes(4), np.uint8), bitorder="little")
    nb = 8 * len(stream)
    w = np.zeros(nb, np.int64)
    for k in range(9):
        w |= bits[k: k + nb].astype(np.int64) << k
    e = _SYMBOLS[w]
    return np.where(e >> 12 == 0, (e >> 8) & 15, -1)


def segment_steps(step: np.ndarray, s: int, S: int):
    """A lane's map steps for segment [s, s + S): entry 0's, then each of
    entries 1-8's (each walk's ending step included)."""
    marks, p, n0 = set(), s, 0
    while p < s + S:
        marks.add(p)
        n0 += 1
        if step[p] < 0:
            break
        p += step[p]
    others = []
    for e in range(1, 9):
        q, k = s + e, 1
        while q not in marks and step[q] > 0 and q + step[q] < s + S:
            q += step[q]
            k += 1
        others.append(k)
    return n0, others


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=6)
    ap.add_argument("--seg", type=int, action="append", default=[])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from hadoop_bam_tpu_torch.ops import flate

    n, B = 24000, args.members
    data = chip_smoke.synth_rows(-(-n * B // chip_smoke.ROW), args.seed + 2).reshape(-1)
    mat = torch.from_numpy(data[: n * B].reshape(B, n).copy())
    comp, cl = flate._deflate_fixed_rows(mat, torch.full((B,), n, dtype=torch.int32))
    steps = [symbol_steps(comp[i, : int(cl[i])].numpy().tobytes()) for i in range(B)]
    for S in args.seg or [256, 512]:
        lane, separate, shared, emit = [], [], [], []
        for step in steps:
            truth, p = set(), 3
            while step[p] > 0:
                truth.add(p)
                p += step[p]
            segs = range(0, len(step) - S - 16, S)
            rows = [segment_steps(step, s, S) for s in segs]
            emit += [sum(1 for q in range(s, s + S) if q in truth) for s in segs]
            lane += [n0 + sum(o) for n0, o in rows]
            for w in range(0, len(rows) - 31, 32):
                warp = rows[w: w + 32]
                separate.append(max(r[0] for r in warp)
                                + sum(max(r[1][e] for r in warp) for e in range(8)))
                shared.append(max(r[0] for r in warp) + max(sum(r[1]) for r in warp))
        print(json.dumps({"seg": S, "members": B, "lane_map_steps": float(np.mean(lane)),
                          "warp_steps_loop_an_entry": float(np.mean(separate)),
                          "warp_steps_shared_loop": float(np.mean(shared)),
                          "emit_steps": float(np.mean(emit))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

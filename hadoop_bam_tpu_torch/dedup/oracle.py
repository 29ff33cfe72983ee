"""The per-record duplicate-marking oracle.

Counterpart of ``hadoop_bam_tpu/dedup/oracle.py``: an implementation of the
semantics of :mod:`hadoop_bam_tpu_torch.dedup` that shares no code with the
signature columns or the decision (Python CIGAR walks, dict grouping by the
actual read name), so the decision has a real oracle.  It agrees with the
decision unless two distinct names collide in 64 hash bits.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops.quality import MARKDUP_MIN_QUALITY
from ..spec import bam
from ..utils.murmur3 import murmurhash3_int32
from .signature import _QNAME_SEED2

_SCORE_CAP = 1 << 30

EndSig = Tuple[int, int, int]  # (refid, unclipped 5' pos, reverse bit)


def clip_walk(rec: bam.BamRecord) -> Tuple[int, int, int]:
    """(leading clip, trailing clip, reference span) by a walk of the CIGAR."""
    ops = rec.cigar
    lead = 0
    for ln, op in ops:
        if op not in "SH":
            break
        lead += ln
    trail = 0
    for ln, op in reversed(ops):
        if op not in "SH":
            break
        trail += ln
    span = sum(ln for ln, op in ops if op in "MDN=X")
    return lead, trail, span


def unclipped_start(rec: bam.BamRecord) -> int:
    return rec.pos - clip_walk(rec)[0]


def unclipped_end(rec: bam.BamRecord) -> int:
    _, trail, span = clip_walk(rec)
    return rec.pos + max(span, 1) - 1 + trail


def record_score(rec: bam.BamRecord, min_quality: int = MARKDUP_MIN_QUALITY) -> int:
    """Summed base quality: bases at or above ``min_quality`` count, 0xFF
    (quality missing) never does."""
    return min(sum(q for q in rec.qual if q >= min_quality and q != 0xFF), _SCORE_CAP)


def end_signature(rec: bam.BamRecord) -> EndSig:
    rev = 1 if rec.flag & bam.FLAG_REVERSE else 0
    pos5 = unclipped_end(rec) if rev else unclipped_start(rec)
    return (rec.refid, pos5, rev)


def _exempt(rec: bam.BamRecord) -> bool:
    return bool(rec.flag & (bam.FLAG_SECONDARY | bam.FLAG_SUPPLEMENTARY | bam.FLAG_UNMAPPED)
                ) or rec.refid < 0 or rec.pos < 0


def _candidate(rec: bam.BamRecord) -> bool:
    return (not _exempt(rec) and bool(rec.flag & bam.FLAG_PAIRED)
            and not rec.flag & bam.FLAG_MATE_UNMAPPED)


def mark_duplicates_oracle(records: Sequence[bam.BamRecord]) -> np.ndarray:
    """bool[N] duplicate mask over ``records`` (any order; the mask is
    positional)."""
    n = len(records)
    dup = np.zeros(n, dtype=bool)
    sig = [end_signature(r) for r in records]
    score = [record_score(r) for r in records]
    # The content tie-breaks: the 64-bit name hash, then the flag, then the
    # index as the last resort.
    nh = [(murmurhash3_int32(r.raw[32 : 32 + r.l_read_name - 1], 0),
           murmurhash3_int32(r.raw[32 : 32 + r.l_read_name - 1], _QNAME_SEED2))
          for r in records]

    # Pair collation by read name: exactly two candidates make a mated pair.
    templates: Dict[str, List[int]] = defaultdict(list)
    for i, r in enumerate(records):
        if _candidate(r):
            templates[r.read_name].append(i)
    pairs = [tuple(idxs) for idxs in templates.values() if len(idxs) == 2]
    in_pair = {i for ij in pairs for i in ij}
    pair_end_sigs = {sig[i] for i in in_pair}

    # Pair families by their unordered signature pair; the best total score
    # survives.
    pair_fams: Dict[tuple, List[Tuple[int, int]]] = defaultdict(list)
    for i, j in pairs:
        pair_fams[tuple(sorted((sig[i], sig[j])))].append((i, j))
    for members in pair_fams.values():
        best = min(members, key=lambda ij: (-(score[ij[0]] + score[ij[1]]), nh[ij[0]], min(ij)))
        for ij in members:
            if ij != best:
                dup[ij[0]] = dup[ij[1]] = True

    # Fragment families: every record that is neither exempt nor in a mated
    # pair.  A family sharing an end with a pair loses whole; otherwise the
    # best score survives.
    frag_fams: Dict[EndSig, List[int]] = defaultdict(list)
    for i, r in enumerate(records):
        if not _exempt(r) and i not in in_pair:
            frag_fams[sig[i]].append(i)
    for s, members in frag_fams.items():
        if s in pair_end_sigs:
            for i in members:
                dup[i] = True
            continue
        best = min(members, key=lambda i: (-score[i], nh[i], records[i].flag, i))
        for i in members:
            if i != best:
                dup[i] = True
    return dup

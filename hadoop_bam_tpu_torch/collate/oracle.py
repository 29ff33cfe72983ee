"""Per-record oracles for the collation jobs.

Counterpart of ``hadoop_bam_tpu/collate/oracle.py``: Python walks and dict
grouping by the actual read name, sharing no code with the columns or the
collation, so the queryname sort and fixmate have real oracles.  The one
shared piece is the natural-order comparator (:func:`~.host.natural_compare`),
which is part of the specification, as murmur3 is for the dedup oracle.
"""

from __future__ import annotations

import struct
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from ..spec import bam
from .host import natural_sort_key


def _primary_candidate(rec: bam.BamRecord) -> bool:
    return bool(rec.flag & bam.FLAG_PAIRED) and not rec.flag & (
        bam.FLAG_SECONDARY | bam.FLAG_SUPPLEMENTARY)


def collate_oracle(records: Sequence[bam.BamRecord]
                   ) -> Tuple[Dict[str, List[int]], Dict[int, int]]:
    """(name → record indices, record index → mate index) by exact names; a
    mate exists iff a name has exactly two primary paired candidates."""
    groups: Dict[str, List[int]] = defaultdict(list)
    for i, r in enumerate(records):
        groups[r.read_name].append(i)
    mates: Dict[int, int] = {}
    for idxs in groups.values():
        cands = [i for i in idxs if _primary_candidate(records[i])]
        if len(cands) == 2:
            mates[cands[0]], mates[cands[1]] = cands[1], cands[0]
    return dict(groups), mates


def queryname_sort_oracle(records: Sequence[bam.BamRecord]) -> List[int]:
    """The queryname sort's output order: natural name order, then flag,
    position and input index."""
    names = [r.read_name.encode() for r in records]
    return sorted(range(len(records)), key=lambda i: (
        natural_sort_key(names[i]), records[i].flag, records[i].pos, i))


def _endpos(rec: bam.BamRecord) -> int:
    span = sum(n for n, op in rec.cigar if op in "MDN=X")
    return rec.pos + max(span, 1)


def fixmate_oracle(records: Sequence[bam.BamRecord]) -> List[Dict[str, object]]:
    """The fields each record should have after fixmate (input order):
    ``flag``, ``refid``, ``pos``, ``next_refid``, ``next_pos``, ``tlen`` and
    ``mc`` (the MC:Z string, or None).  Records without a mate keep their
    values, with ``mc`` None."""
    _, mates = collate_oracle(records)
    out: List[Dict[str, object]] = []
    for i, r in enumerate(records):
        exp = {"flag": r.flag, "refid": r.refid, "pos": r.pos, "next_refid": r.next_refid,
               "next_pos": r.next_pos, "tlen": r.tlen, "mc": None}
        j = mates.get(i)
        if j is None:
            out.append(exp)
            continue
        mt = records[j]
        my_unmapped = bool(r.flag & bam.FLAG_UNMAPPED)
        mt_unmapped = bool(mt.flag & bam.FLAG_UNMAPPED)
        # Placement before the mate sync, as samtools does it.
        my_refid, my_pos = r.refid, r.pos
        mt_refid, mt_pos = mt.refid, mt.pos
        if my_unmapped and not mt_unmapped:
            my_refid, my_pos = mt.refid, mt.pos
        if mt_unmapped and not my_unmapped:
            mt_refid, mt_pos = r.refid, r.pos
        flag = r.flag & ~(bam.FLAG_MATE_UNMAPPED | bam.FLAG_MATE_REVERSE)
        if mt_unmapped:
            flag |= bam.FLAG_MATE_UNMAPPED
        if mt.flag & bam.FLAG_REVERSE:
            flag |= bam.FLAG_MATE_REVERSE
        tlen = 0
        if not my_unmapped and not mt_unmapped and r.refid == mt.refid and r.refid >= 0:
            own5 = _endpos(r) if r.flag & bam.FLAG_REVERSE else r.pos
            mate5 = _endpos(mt) if mt.flag & bam.FLAG_REVERSE else mt.pos
            tlen = mate5 - own5
        mc: Optional[str] = None
        if not mt_unmapped and mt.n_cigar_op > 0:
            mc = mt.cigar_string()
        exp.update({"flag": flag, "refid": my_refid, "pos": my_pos, "next_refid": mt_refid,
                    "next_pos": mt_pos, "tlen": tlen, "mc": mc})
        out.append(exp)
    return out


_B_SIZE = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}


def mc_tag_of(rec: bam.BamRecord) -> Optional[str]:
    """The record's MC:Z value, by a tag walk of its own (the test's reader
    of fixmate's output)."""
    raw = rec.tags_raw
    p = 0
    while p + 3 <= len(raw):
        tag = raw[p : p + 2]
        ty = raw[p + 2 : p + 3]
        q = p + 3
        if ty in b"AcC":
            q += 1
        elif ty in b"sS":
            q += 2
        elif ty in b"iIf":
            q += 4
        elif ty in b"ZH":
            e = raw.index(b"\x00", q)
            if tag == b"MC" and ty == b"Z":
                return raw[q:e].decode()
            q = e + 1
        elif ty == b"B":
            (count,) = struct.unpack_from("<I", raw, q + 1)
            q += 5 + _B_SIZE[raw[q : q + 1]] * count
        else:
            return None
        p = q
    return None

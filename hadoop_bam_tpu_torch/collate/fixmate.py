"""Fixmate: mate coordinates, mate flags, TLEN and MC tags from the
collated pairs.

Counterpart of ``hadoop_bam_tpu/collate/fixmate.py``, the samtools fixmate
semantics (bam_mate.c) over the name collation instead of name-grouped
input:

- **Pairing**: primary paired records (unmapped ones included) collate by
  the 64-bit name hash; exactly two candidates under one verified name are
  mates.  Orphans and singletons pass through untouched.
- **Mate fields**: each mate's ``next_refid``/``next_pos`` become the
  other's (placed) ``refid``/``pos``; ``FLAG_MATE_UNMAPPED`` and
  ``FLAG_MATE_REVERSE`` are set and cleared from the mate's flags.
- **Placement**: an unmapped read with a mapped mate takes the mate's
  ``refid``/``pos`` and the single-base ``bin``.
- **TLEN**: ``own5 = endpos if reverse else pos`` (``endpos = pos +
  max(ref_span, 1)``); each mate gets ``mate5 - own5`` when both are mapped
  to one reference, else 0.
- **MC**: the mate's CIGAR as an ``MC:Z`` tag when the mate is mapped with a
  CIGAR; an existing MC tag is cut out first, so fixmate run again writes
  the same bytes.

The decision is vectorized over the job's collation columns; records are
rewritten per part into a new stream (:func:`~..io.bam.rebuild_record_stream`).
Proper-pair (0x2) recomputation and the mate-score tag are not implemented,
as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..spec.bam import CIGAR_OPS, FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, FLAG_REVERSE, FLAG_UNMAPPED
from ..utils.tracing import Metrics
from .device import Collation
from .host import collation_counts

#: The SoA fields a fixmate read needs.
FIXMATE_FIELDS = ("refid", "pos", "flag", "rec_off", "rec_len", "l_read_name", "n_cigar_op",
                  "l_seq")


@dataclass
class FixmateEdits:
    """The job's edit plan in read order (row == the record's index in the
    job).  Field arrays hold where ``mask``; ``place`` marks the placed
    unmapped rows, whose ``refid``/``pos``/``bin`` change too; ``mc_*``
    address the packed MC tag blob (length 0: no tag)."""

    mask: np.ndarray  # bool[N]
    place: np.ndarray  # bool[N]
    flag: np.ndarray  # int32[N]
    refid: np.ndarray
    pos: np.ndarray
    bin: np.ndarray
    next_refid: np.ndarray
    next_pos: np.ndarray
    tlen: np.ndarray
    mc: np.ndarray  # uint8 blob
    mc_off: np.ndarray  # int64[N]
    mc_len: np.ndarray  # int32[N]
    counts: Dict[str, int]

    @property
    def n(self) -> int:
        return len(self.mask)


def _cigar_string(cigs: np.ndarray, off: int, n_ops: int) -> str:
    u32 = cigs[off : off + 4 * n_ops].view("<u4")
    return "".join(f"{int(c) >> 4}{CIGAR_OPS[int(c) & 0xF]}" for c in u32)


def compute_fixmate_edits(cols: Dict[str, np.ndarray], col: Collation,
                          metrics: Optional[Metrics] = None) -> FixmateEdits:
    """The edit plan from the job's collation columns and the verified mate
    index; counts ``fixmate.records_updated``, ``fixmate.placed_unmapped``,
    ``fixmate.mc_tags`` and the census into ``metrics``."""
    n = len(cols["flag"])
    if n == 0:
        z32 = np.empty(0, np.int32)
        return FixmateEdits(
            mask=np.empty(0, bool), place=np.empty(0, bool), flag=z32, refid=z32, pos=z32,
            bin=z32, next_refid=z32, next_pos=z32, tlen=z32, mc=np.empty(0, np.uint8),
            mc_off=np.empty(0, np.int64), mc_len=z32,
            counts={"pairs": 0, "singletons": 0, "orphans": 0})
    flag = cols["flag"].astype(np.int32)
    refid = cols["refid"].astype(np.int32)
    pos = cols["pos"].astype(np.int32)
    span_c = cols["span"].astype(np.int32)
    m = col.mate
    rows = np.flatnonzero(m >= 0)
    mate = m[rows].astype(np.int64)
    unmapped = (flag & FLAG_UNMAPPED) != 0

    # Placement first (the samtools order): the mate sync reads the placed
    # values.
    place_rows = rows[unmapped[rows] & ~unmapped[mate]]
    p_refid = refid.copy()
    p_pos = pos.copy()
    p_refid[place_rows] = refid[m[place_rows]]
    p_pos[place_rows] = pos[m[place_rows]]

    new_flag = flag[rows] & ~(FLAG_MATE_UNMAPPED | FLAG_MATE_REVERSE)
    new_flag |= np.where(unmapped[mate], FLAG_MATE_UNMAPPED, 0)
    new_flag |= np.where((flag[mate] & FLAG_REVERSE) != 0, FLAG_MATE_REVERSE, 0)

    # TLEN by the 5'-to-5' rule: own5 is the alignment end of a reverse read.
    endpos = pos.astype(np.int64) + np.maximum(span_c, 1)
    own5 = np.where((flag & FLAG_REVERSE) != 0, endpos, pos.astype(np.int64))
    both_mapped = (~unmapped[rows] & ~unmapped[mate] & (refid[rows] == refid[mate])
                   & (refid[rows] >= 0))
    new_tlen = np.where(both_mapped, own5[mate] - own5[rows], 0)

    mask = np.zeros(n, dtype=bool)
    mask[rows] = True
    place = np.zeros(n, dtype=bool)
    place[place_rows] = True
    out_flag = flag.copy()
    out_flag[rows] = new_flag
    out_nrefid = np.zeros(n, np.int32)
    out_npos = np.zeros(n, np.int32)
    out_nrefid[rows] = p_refid[mate]
    out_npos[rows] = p_pos[mate]
    out_tlen = np.zeros(n, np.int32)
    out_tlen[rows] = new_tlen.astype(np.int32)
    # reg2bin(pos, pos + 1) in closed form for the placed single base.
    out_bin = np.where(p_pos >= 0, 4681 + (p_pos >> 14), 4680).astype(np.int32)

    # MC tags: the mate's CIGAR string, for rows whose mate is mapped with
    # a CIGAR.  The text is ragged, so this is a host loop over those rows;
    # each distinct CIGAR is formatted once.
    mc_off = np.zeros(n, dtype=np.int64)
    mc_len = np.zeros(n, dtype=np.int32)
    n_cig = cols["n_cig"].astype(np.int64)
    cig_off = cols["cig_off"].astype(np.int64)
    cigs = cols["cigs"]
    mc_rows = rows[~unmapped[mate] & (n_cig[mate] > 0)]
    mts = m[mc_rows].astype(np.int64)
    tags: Dict[bytes, bytes] = {}
    pieces = []
    at = 0
    for r, o, k in zip(mc_rows.tolist(), cig_off[mts].tolist(), n_cig[mts].tolist()):
        raw = cigs[o : o + 4 * k].tobytes()
        tag = tags.get(raw)
        if tag is None:
            tag = tags[raw] = b"MCZ" + _cigar_string(cigs, o, k).encode() + b"\x00"
        mc_off[r] = at
        mc_len[r] = len(tag)
        pieces.append(tag)
        at += len(tag)

    counts = collation_counts(cols, col, metrics)
    if metrics is not None:
        metrics.count("fixmate.records_updated", len(rows))
        metrics.count("fixmate.placed_unmapped", len(place_rows))
        metrics.count("fixmate.mc_tags", len(mc_rows))
    return FixmateEdits(
        mask=mask, place=place, flag=out_flag, refid=p_refid, pos=p_pos, bin=out_bin,
        next_refid=out_nrefid, next_pos=out_npos, tlen=out_tlen,
        mc=np.frombuffer(b"".join(pieces), dtype=np.uint8), mc_off=mc_off, mc_len=mc_len,
        counts=counts)


_TAG_FIXED = {
    0x41: 1,  # A
    0x63: 1, 0x43: 1,  # c C
    0x73: 2, 0x53: 2,  # s S
    0x69: 4, 0x49: 4, 0x66: 4,  # i I f
}
_B_ELEM = {0x63: 1, 0x43: 1, 0x73: 2, 0x53: 2, 0x69: 4, 0x49: 4, 0x66: 4}


_FIXED_LEN = np.full(256, -1, np.int64)
for _ty, _n in _TAG_FIXED.items():
    _FIXED_LEN[_ty] = _n
_ELEM_LEN = np.full(256, -1, np.int64)
for _ty, _n in _B_ELEM.items():
    _ELEM_LEN[_ty] = _n


def find_tag_spans(data: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                   tag: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's per-record tag walk for many records of one stream
    at once: the tag block of record i is ``data[starts[i] : ends[i]]``.
    Returns the absolute offset and length of each record's ``tag`` entry
    (tag, type and value); -1 and 0 where there is none, or where a
    malformed entry stops the walk before it.  All records step through
    their blocks together, one entry a round."""
    data = np.asarray(data, dtype=np.uint8)
    p = starts.astype(np.int64).copy()
    ends = ends.astype(np.int64)
    hit_off = np.full(len(p), -1, np.int64)
    hit_len = np.zeros(len(p), np.int64)
    zeros = np.flatnonzero(data == 0)
    rows = np.flatnonzero(p + 3 <= ends)
    while len(rows):
        pp, end = p[rows], ends[rows]
        ty = data[pp + 2].astype(np.int64)
        q = pp + 3
        fixed = _FIXED_LEN[ty]
        is_z = (ty == 0x5A) | (ty == 0x48)
        is_b = ty == 0x42
        # Z and H: past the first NUL at or after q (end + 1, a failure,
        # when the block has none).
        at = np.searchsorted(zeros, q)
        nul = np.where(at < len(zeros), zeros[np.minimum(at, len(zeros) - 1)], end)
        q_z = np.where(nul < end, nul + 1, end + 1)
        # B: the element type and the u32 count, inside the block.
        b_ok = is_b & (q + 5 <= end)
        qb = np.where(b_ok, q, 0)
        elem = np.where(b_ok, _ELEM_LEN[data[qb]], -1)
        count = sum(data[qb + 1 + k].astype(np.int64) << (8 * k) for k in range(4))
        q_b = q + 5 + elem * count
        qn = np.where(fixed >= 0, q + fixed, np.where(is_z, q_z, q_b))
        fail = ((fixed < 0) & ~is_z & ~(b_ok & (elem >= 0))) | (qn > end)
        match = ~fail & (data[pp] == tag[0]) & (data[pp + 1] == tag[1])
        hit_off[rows[match]] = pp[match]
        hit_len[rows[match]] = (qn - pp)[match]
        go = ~fail & ~match
        p[rows[go]] = qn[go]
        rows = rows[go][qn[go] + 3 <= end[go]]
    return hit_off, hit_len


def find_tag_span(body, tag_off: int, tag: bytes) -> Optional[Tuple[int, int]]:
    """(offset, length) of a whole tag entry (tag, type and value) in one
    record body, or None.  A malformed tag block stops the walk: the record
    keeps its bytes."""
    body = np.frombuffer(bytes(body), np.uint8)
    off, ln = find_tag_spans(body, np.asarray([tag_off]), np.asarray([len(body)]), tag)
    return None if off[0] < 0 else (int(off[0]), int(ln[0]))


def apply_fixmate(batch, edits: FixmateEdits, row0: int):
    """One split's records rewritten per the plan, as a new
    :class:`~..io.bam.RecordBatch` (the source payload is not changed).  The
    MC cut is found by a tag walk of the rows gaining an MC tag
    (:func:`find_tag_spans`); the rebuild and the fixed-field patches are
    vectorized too."""
    from ..io.bam import RecordBatch, rebuild_record_stream

    k = batch.n_records
    soa = batch.soa
    rec_off = soa["rec_off"].astype(np.int64)
    rec_len = soa["rec_len"].astype(np.int64)
    sl = slice(row0, row0 + k)
    mask = edits.mask[sl]
    place = edits.place[sl]
    mc_len = edits.mc_len[sl].astype(np.int64)
    mc_off = edits.mc_off[sl]

    # By default no cut (at the end, of length 0) and no append.
    cut_off = rec_len.copy()
    cut_len = np.zeros(k, dtype=np.int64)
    l_seq = soa["l_seq"].astype(np.int64)
    tag_off = (32 + soa["l_read_name"].astype(np.int64)
               + 4 * soa["n_cigar_op"].astype(np.int64) + (l_seq + 1) // 2 + l_seq)
    rows = np.flatnonzero(mc_len > 0)
    hit, ln = find_tag_spans(batch.data, rec_off[rows] + tag_off[rows], rec_off[rows] + rec_len[rows],
                             b"MC")
    found = hit >= 0
    cut_off[rows[found]] = hit[found] - rec_off[rows[found]]
    cut_len[rows[found]] = ln[found]
    out, new_off, new_len = rebuild_record_stream(batch.data, rec_off, rec_len, cut_off, cut_len,
                                                  edits.mc, mc_off, mc_len)
    rows = np.flatnonzero(mask)
    if len(rows):
        body = new_off[rows]
        _poke_i32(out, body + 20, edits.next_refid[sl][rows])
        _poke_i32(out, body + 24, edits.next_pos[sl][rows])
        _poke_i32(out, body + 28, edits.tlen[sl][rows])
        _poke_u16(out, body + 14, edits.flag[sl][rows])
    p_rows = np.flatnonzero(place)
    if len(p_rows):
        body = new_off[p_rows]
        _poke_i32(out, body + 0, edits.refid[sl][p_rows])
        _poke_i32(out, body + 4, edits.pos[sl][p_rows])
        _poke_u16(out, body + 10, edits.bin[sl][p_rows])
    return RecordBatch(soa={"rec_off": new_off, "rec_len": new_len}, data=out,
                       keys=np.empty(0, np.int64))


def _poke_i32(stream: np.ndarray, at: np.ndarray, vals: np.ndarray) -> None:
    v = vals.astype(np.int64) & 0xFFFFFFFF
    for b in range(4):
        stream[at + b] = ((v >> (8 * b)) & 0xFF).astype(np.uint8)


def _poke_u16(stream: np.ndarray, at: np.ndarray, vals: np.ndarray) -> None:
    v = vals.astype(np.int64) & 0xFFFF
    stream[at] = (v & 0xFF).astype(np.uint8)
    stream[at + 1] = ((v >> 8) & 0xFF).astype(np.uint8)

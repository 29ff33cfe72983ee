"""CIGAR ops: reference span, unclipped ends, and the interval-overlap cut.

Counterpart of ``hadoop_bam_tpu/ops/cigar.py``.  ``reference_length`` (the
span consumed on the reference: ops M/D/N/=/X) gives alignment ends for the
``.bai`` builder and the exact overlap cut of the region reads;
``unclipped_start`` / ``unclipped_end`` are ``pos`` pushed left by the
leading S/H run and the alignment end pushed right by the trailing one
(an all-clip CIGAR counts its whole length on both sides; a mapped record
with an empty CIGAR covers one base).

Two forms of each: ``*_np`` in NumPy over the ragged record stream
(flatten every CIGAR, scatter-add, no per-record loop), and ``*_padded``
as torch ops over a padded ``[N, max_ops]`` CIGAR tensor in the reference's
int32 arithmetic.  :func:`overlap_mask` is the reference's jitted overlap
op; here it feeds kernel row 6 (:mod:`.kernels.overlap`).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import overlap as koverlap

# ops M(0) D(2) N(3) =(7) X(8) consume reference.
_REF_CONSUMING = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0])
# ops S(4) H(5) are clips.
_IS_CLIP = np.array([0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0])


def _cigar_words(data: np.ndarray, soa: dict):
    """``(rec_of_op, u32 words)`` of every CIGAR op of the batch, flattened
    in record order, or None when the batch has no op."""
    n = len(soa["rec_off"])
    cigar_off = soa["rec_off"].astype(np.int64) + 32 + soa["l_read_name"]
    n_ops = soa["n_cigar_op"].astype(np.int64)
    total_ops = int(n_ops.sum())
    if total_ops == 0:
        return None
    rec_of_op = np.repeat(np.arange(n), n_ops)
    within = np.arange(total_ops) - np.repeat(np.cumsum(n_ops) - n_ops, n_ops)
    at = np.repeat(cigar_off, n_ops) + 4 * within
    u32 = (
        data[at].astype(np.uint32)
        | (data[at + 1].astype(np.uint32) << 8)
        | (data[at + 2].astype(np.uint32) << 16)
        | (data[at + 3].astype(np.uint32) << 24)
    )
    return rec_of_op, u32


def reference_lengths_np(data: np.ndarray, soa: dict) -> np.ndarray:
    """Reference span per record (int64) from the record stream."""
    n = len(soa["rec_off"])
    spans = np.zeros(n, dtype=np.int64)
    words = _cigar_words(data, soa) if n else None
    if words is None:
        return spans
    rec_of_op, u32 = words
    np.add.at(spans, rec_of_op, (u32 >> 4).astype(np.int64) * _REF_CONSUMING[u32 & 0xF])
    return spans


def clip_spans_np(data: np.ndarray, soa: dict):
    """``(leading_clip, trailing_clip, ref_span)`` int64 per record."""
    n = len(soa["rec_off"])
    lead = np.zeros(n, dtype=np.int64)
    trail = np.zeros(n, dtype=np.int64)
    span = np.zeros(n, dtype=np.int64)
    words = _cigar_words(data, soa) if n else None
    if words is None:
        return lead, trail, span
    rec_of_op, u32 = words
    n_ops = soa["n_cigar_op"].astype(np.int64)
    total_ops = len(u32)
    oplen = (u32 >> 4).astype(np.int64)
    code = u32 & 0xF
    is_clip = _IS_CLIP[code].astype(bool)
    np.add.at(span, rec_of_op, oplen * _REF_CONSUMING[code])
    # An op is a leading clip iff no non-clip op precedes it in its record,
    # trailing iff none follows: per-record prefix counts of non-clip ops
    # from one global exclusive cumsum rebased at each record's first op.
    nonclip = (~is_clip).astype(np.int64)
    before = np.cumsum(nonclip) - nonclip
    rec_first = np.clip(np.cumsum(n_ops) - n_ops, 0, total_ops - 1)
    before -= np.repeat(before[rec_first], n_ops)
    per_rec_nonclip = np.zeros(n, dtype=np.int64)
    np.add.at(per_rec_nonclip, rec_of_op, nonclip)
    after = per_rec_nonclip[rec_of_op] - before - nonclip
    np.add.at(lead, rec_of_op, oplen * (is_clip & (before == 0)))
    np.add.at(trail, rec_of_op, oplen * (is_clip & (after == 0)))
    return lead, trail, span


def unclipped_start_np(data: np.ndarray, soa: dict) -> np.ndarray:
    """0-based unclipped alignment start per record."""
    lead, _, _ = clip_spans_np(data, soa)
    return soa["pos"].astype(np.int64) - lead


def unclipped_end_np(data: np.ndarray, soa: dict) -> np.ndarray:
    """0-based unclipped alignment end per record."""
    _, trail, span = clip_spans_np(data, soa)
    return soa["pos"].astype(np.int64) + np.maximum(span, 1) - 1 + trail


def pack_cigars_padded(data: np.ndarray, soa: dict, max_ops: int) -> np.ndarray:
    """The CIGARs as a zero-padded ``[N, max_ops]`` uint32 array (op 0 of
    length 0 is a no-op).  A record with more ops raises ``ValueError``."""
    n = len(soa["rec_off"])
    n_ops = soa["n_cigar_op"].astype(np.int64)
    if n and int(n_ops.max()) > max_ops:
        raise ValueError(
            f"record has {int(n_ops.max())} CIGAR ops > max_ops={max_ops}; "
            "truncating would understate reference spans"
        )
    out = np.zeros((n, max_ops), dtype=np.uint32)
    cigar_off = soa["rec_off"].astype(np.int64) + 32 + soa["l_read_name"]
    for k in range(max_ops):
        rows = n_ops > k
        if not rows.any():
            break
        at = cigar_off[rows] + 4 * k
        out[rows, k] = (
            data[at].astype(np.uint32)
            | (data[at + 1].astype(np.uint32) << 8)
            | (data[at + 2].astype(np.uint32) << 16)
            | (data[at + 3].astype(np.uint32) << 24)
        )
    return out


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped into int32, as the reference's int32 math."""
    return (((v + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _split_ops(cigars: torch.Tensor):
    c = cigars.to(torch.int64) & 0xFFFFFFFF
    code = c & 0xF
    return c >> 4, code


def reference_lengths_padded(cigars: torch.Tensor) -> torch.Tensor:
    """``[N, max_ops]`` CIGAR words (any integer type holding the u32
    values) → int32 reference spans."""
    oplen, code = _split_ops(cigars)
    consume = torch.as_tensor(_REF_CONSUMING, device=cigars.device)[code]
    return _wrap32((oplen * consume).sum(dim=-1))


def _clip_spans_padded(cigars: torch.Tensor, n_ops: torch.Tensor):
    oplen, code = _split_ops(cigars)
    valid = torch.arange(cigars.shape[-1], device=cigars.device)[None, :] < n_ops.to(
        torch.int64)[:, None]
    is_clip = torch.as_tensor(_IS_CLIP, device=cigars.device)[code].bool() & valid
    consume = torch.as_tensor(_REF_CONSUMING, device=cigars.device)[code]
    span = (oplen * consume * valid).sum(dim=-1)
    nonclip = (valid & ~is_clip).to(torch.int64)
    before = torch.cumsum(nonclip, dim=-1) - nonclip
    after = nonclip.sum(dim=-1, keepdim=True) - before - nonclip
    lead = (oplen * (is_clip & (before == 0))).sum(dim=-1)
    trail = (oplen * (is_clip & (after == 0))).sum(dim=-1)
    return _wrap32(lead), _wrap32(trail), _wrap32(span)


def unclipped_start_padded(cigars: torch.Tensor, n_ops: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`unclipped_start_np` (int32 ``pos``)."""
    lead, _, _ = _clip_spans_padded(cigars, n_ops)
    return _wrap32(pos.to(torch.int64) - lead.to(torch.int64))


def unclipped_end_padded(cigars: torch.Tensor, n_ops: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`unclipped_end_np` (int32 ``pos``)."""
    _, trail, span = _clip_spans_padded(cigars, n_ops)
    end = pos.to(torch.int64) + torch.clamp(span.to(torch.int64), min=1) - 1 + trail.to(torch.int64)
    return _wrap32(end)


def overlap_mask(
    refid: torch.Tensor,  # int32[N]
    pos: torch.Tensor,  # int32[N] 0-based
    ref_len: torch.Tensor,  # int32[N]
    iv_refid: torch.Tensor,  # int32[K]
    iv_beg: torch.Tensor,  # int32[K] 0-based inclusive
    iv_end: torch.Tensor,  # int32[K] 0-based exclusive
) -> torch.Tensor:
    """bool[N]: the record overlaps any interval; unplaced records
    (``pos < 0``) never match.  The record spans ``[pos, pos + max(ref_len,
    1))`` in int32 arithmetic (wrapping past 2**31 - 1, as the reference's
    jitted op), and the cut runs in kernel row 6 with ``refid = -2`` for
    unplaced rows: equal to the reference bit for bit."""
    pos64 = pos.to(torch.int64)
    end = _wrap32(pos64 + torch.clamp(ref_len.to(torch.int64), min=1))
    rid = torch.where(pos64 < 0, -2, refid.to(torch.int64)).to(torch.int32)
    intervals = torch.stack([iv_refid, iv_beg, iv_end], dim=1).to(torch.int32).contiguous()
    return koverlap.overlap_mask(intervals, rid.contiguous(), pos.to(torch.int32).contiguous(),
                                 end.contiguous())

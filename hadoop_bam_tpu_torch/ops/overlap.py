"""The ragged interval join: which records overlap any of a set of windows,
and how many records overlap each window.

Counterpart of the ragged half of ``hadoop_bam_tpu/ops/pallas/overlap.py``
(``join_mask_np``, ``join_mask_device``, ``join_counts_np``,
``join_counts_device``, ``ragged_overlap_mask``, ``intervals_to_array``).
The reference's device forms are jitted XLA programs (two sorted axes
joined by binary search, no ``pallas_call``); here they are
``torch.searchsorted`` (and a gather) on the records' device.

Mask form: with windows sorted by begin and ``P[j] = max(q_end[0..j])``
(the prefix max), record ``[s, e)`` overlaps some window iff
``j_hi > 0 and P[j_hi - 1] > s``, where ``j_hi = searchsorted(q_beg, e,
'left')``: ``j < j_hi`` iff window j begins before the record ends, and the
prefix max witnesses a window among those that ends after the record
starts.  The device form runs on int32 coordinates, as the reference's;
callers gate on that domain and send other joins to the host twin.

Counts form: with the record starts and ends each sorted ascending, window
``[b, e)`` overlaps ``#(start < e) - #(end <= b)`` records, that is
``searchsorted(starts, e, 'left') - searchsorted(ends, b, 'right')``: every
record that ends at or before ``b`` also starts before ``e``.  The device
form casts to int32, as the reference's does, and needs no sentinel pads;
the reference's pads its record columns to a power of two with ends of
``2**31 - 1``, which a window beginning at ``2**31 - 1`` subtracts (a
standing deviation: the port counts what ``join_counts_np`` counts).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..utils.backend import resolve_device

_PAD_BEG = (1 << 31) - 1  # window sentinel: begins after any coordinate
_PAD_END = -(1 << 31)  # window sentinel: ends before any coordinate

Column = Union[np.ndarray, torch.Tensor]


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _host(a: Column) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def join_mask_np(starts, ends, q_beg, q_end) -> np.ndarray:
    """The host twin of the device mask form (the tier-down).  Windows
    need not arrive sorted; records are in any order."""
    starts, ends, q_beg, q_end = (_host(a) for a in (starts, ends, q_beg, q_end))
    if len(q_beg) == 0:
        return np.zeros(len(starts), dtype=bool)
    order = np.argsort(q_beg, kind="stable")
    qb = q_beg[order]
    qe_cummax = np.maximum.accumulate(q_end[order])
    j_hi = np.searchsorted(qb, ends, side="left")
    cover = qe_cummax[np.maximum(j_hi - 1, 0)]
    return (j_hi > 0) & (cover > starts)


def join_counts_np(starts, ends, q_beg, q_end) -> np.ndarray:
    """The host twin of the device counts form: int32 per-window overlap
    counts over one record set (starts and ends sorted here)."""
    starts = np.sort(_host(starts), kind="stable")
    ends = np.sort(_host(ends), kind="stable")
    hi = np.searchsorted(starts, _host(q_end), side="left")
    lo = np.searchsorted(ends, _host(q_beg), side="right")
    return (hi - lo).astype(np.int32)


def join_counts_device(
    starts: Column, ends: Column, q_beg: Column, q_end: Column,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """The counts form on ``device`` (default: where ``starts`` lies when
    it is a tensor, else the card), int32 coordinates: an int32 tensor of
    per-window counts there.  Both record columns are sorted on the device
    and searched by the windows; nothing runs on the host."""
    if device is None:
        device = starts.device if isinstance(starts, torch.Tensor) else resolve_device(None)
    s, e, qb, qe = (torch.as_tensor(a, device=device).to(torch.int32)
                    for a in (starts, ends, q_beg, q_end))
    if qb.numel() == 0 or s.numel() == 0:
        return torch.zeros(qb.numel(), dtype=torch.int32, device=device)
    hi = torch.searchsorted(torch.sort(s).values, qe, side="left")
    lo = torch.searchsorted(torch.sort(e).values, qb, side="right")
    return (hi - lo).to(torch.int32)


def join_mask_device(
    starts: Column, ends: Column, q_beg, q_end, device: Optional[torch.device] = None
) -> torch.Tensor:
    """The mask form on ``device`` (default: where ``starts`` lies when it
    is a tensor, else the card), one coordinate axis, int32 coordinates: a
    bool tensor there.

    The few windows are sorted, prefix-maxed and padded to a power of two
    on the host, as the reference does; the records stay where they are.
    Sentinel windows begin past every coordinate, so no search lands on
    one."""
    if device is None:
        device = starts.device if isinstance(starts, torch.Tensor) else resolve_device(None)
    s = torch.as_tensor(starts, device=device).to(torch.int32)
    e = torch.as_tensor(ends, device=device).to(torch.int32)
    qb_h = np.asarray(_host(q_beg), np.int32)
    qe_h = np.asarray(_host(q_end), np.int32)
    n, m = s.numel(), len(qb_h)
    if n == 0 or m == 0:
        return torch.zeros(n, dtype=torch.bool, device=device)
    order = np.argsort(qb_h, kind="stable")
    mp = _pow2(m)
    qb = np.pad(qb_h[order], (0, mp - m), constant_values=_PAD_BEG)
    qe_cummax = np.pad(
        np.maximum.accumulate(qe_h[order]), (0, mp - m), constant_values=_PAD_END
    )
    qb_d = torch.from_numpy(qb).to(device)
    qe_d = torch.from_numpy(qe_cummax).to(device)
    j_hi = torch.searchsorted(qb_d, e, side="left")
    cover = qe_d[(j_hi - 1).clamp_min(0)]
    return (j_hi > 0) & (cover > s)


def ragged_overlap_mask(
    refid: Column,
    starts: Column,
    ends: Column,
    q_refid,
    q_beg,
    q_end,
    use_device: bool = False,
    device: Optional[torch.device] = None,
):
    """Does record i (contig ``refid[i]``, 0-based ``[starts[i], ends[i])``)
    overlap any window (``q_refid``, ``[q_beg, q_end)``)?  Loops per query
    contig, so each join stays on one coordinate axis.  ``use_device=False``
    is the host twin and returns a numpy bool array; ``use_device=True``
    joins on ``device`` (default: where ``refid`` lies when it is a tensor,
    else the card) and returns a bool tensor there."""
    q_refid, q_beg, q_end = (_host(a) for a in (q_refid, q_beg, q_end))
    if not use_device:
        refid, starts, ends = (_host(a) for a in (refid, starts, ends))
        mask = np.zeros(len(refid), dtype=bool)
        for rid in np.unique(q_refid):
            qsel = q_refid == rid
            rows = np.nonzero(refid == rid)[0]
            if len(rows):
                mask[rows] = join_mask_np(starts[rows], ends[rows], q_beg[qsel], q_end[qsel])
        return mask
    if device is None:
        device = refid.device if isinstance(refid, torch.Tensor) else resolve_device(None)
    refid, starts, ends = (torch.as_tensor(a, device=device) for a in (refid, starts, ends))
    mask = torch.zeros(refid.numel(), dtype=torch.bool, device=device)
    for rid in np.unique(q_refid):
        qsel = q_refid == rid
        rows = torch.nonzero(refid == int(rid)).flatten()
        if rows.numel():
            mask[rows] = join_mask_device(starts[rows], ends[rows], q_beg[qsel], q_end[qsel])
    return mask


def intervals_to_array(header_ref_index, intervals) -> np.ndarray:
    """[K, 3] (refid, beg, end) rows from parsed intervals; unknown contigs
    are dropped (an unknown contig changes keys, never overlap)."""
    rows = []
    for iv in intervals:
        try:
            rid = header_ref_index(iv.contig)
        except KeyError:
            continue
        rows.append((rid, iv.start - 1, iv.end))
    return np.asarray(rows or np.empty((0, 3)), dtype=np.int32).reshape(-1, 3)

"""Record/interval overlap cut: ``csrc/region.cu`` and its plain versions.

Counterpart of ``hadoop_bam_tpu/ops/pallas/overlap.py`` (``overlap_mask``,
``_overlap_call``): the record-level tail of BAM bounded traversal, after
the ``.bai`` chunk spans picked the windows.  The TPU kernel pads the
records to ``[8, 128]`` tiles with refid -2; the card needs no padding.

:func:`overlap_rows` is the view's cut: from the raw columns (refid, pos,
reference length) to the hit rows, compacted and in order, behind their
count, in three launches (count, scan, scatter; ``csrc/region_core.cuh``)
counted once by :data:`ROWS_LAUNCHES`.  :func:`overlap_mask` keeps the
reference kernel's mask form over (refid, start, end).
"""

from __future__ import annotations

import torch

from ... import _build
from . import LaunchCounter, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("overlap_mask")
ROWS_LAUNCHES = LaunchCounter("overlap_rows")
#: Threads a block of the cut's count and scatter launches.
THREADS = 256


def _check(intervals, *cols, names=("refid", "start", "end")) -> None:
    check_tensor(intervals, "intervals", torch.int32)
    if intervals.dim() != 2 or intervals.shape[1] != 3:
        raise ValueError("intervals must be [K, 3] (refid, beg, end)")
    n = cols[0].numel()
    for name, t in zip(names, cols):
        check_tensor(t, name, torch.int32)
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"{name} must be one-dimensional with {n} entries")


def overlap_mask(intervals: torch.Tensor, refid: torch.Tensor, start: torch.Tensor,
                 end: torch.Tensor) -> torch.Tensor:
    """bool[N]: record i's ``[start[i], end[i])`` on ``refid[i]`` overlaps
    one of the K intervals (int32 ``[K, 3]``: refid, beg, end; half-open,
    0-based).  int32 columns on one device; a CUDA tensor launches the
    kernel, a CPU tensor takes the plain version."""
    _check(intervals, refid, start, end)
    n = refid.numel()
    if use_plain(intervals, refid, start, end):
        return overlap_mask_plain(intervals, refid, start, end)
    out = torch.empty(n, dtype=torch.bool, device=refid.device)
    k = intervals.shape[0]
    if n == 0 or k == 0:
        return out.zero_()
    lib = _build.load("region")
    rc = lib.hbt_overlap_mask(intervals.data_ptr(), k, refid.data_ptr(), start.data_ptr(),
                              end.data_ptr(), n, out.data_ptr(), stream_handle(refid))
    _build.check(rc, "overlap_mask")
    LAUNCHES.add()
    return out


def overlap_mask_plain(intervals: torch.Tensor, refid: torch.Tensor, start: torch.Tensor,
                       end: torch.Tensor) -> torch.Tensor:
    """The plain version: the reference kernel's loop over the intervals,
    OR-ing each one's hit column."""
    acc = torch.zeros(refid.numel(), dtype=torch.bool, device=refid.device)
    for rid, beg, stop in intervals.tolist():
        acc |= (refid == rid) & (start < stop) & (end > beg)
    return acc


def overlap_rows(intervals: torch.Tensor, refid: torch.Tensor, pos: torch.Tensor,
                 ref_len: torch.Tensor) -> torch.Tensor:
    """The rows of the records whose span ``[pos, pos + max(ref_len, 1))``
    (the end wrapping in int32) on ``refid`` overlaps one of the K intervals
    (int32 ``[K, 3]``: refid, beg, end; half-open, 0-based); a record with
    ``pos < 0`` never matches.  int32 columns of N records on one device.
    Returns one int32 ``[1 + N]`` buffer, so one copy reads it back: the
    count first, then the hits' rows in order (past them, whatever the
    buffer held).  A CUDA tensor launches the kernel, a CPU tensor takes the
    plain version."""
    _check(intervals, refid, pos, ref_len, names=("refid", "pos", "ref_len"))
    n = refid.numel()
    if n >= 2**31 - 1:
        raise ValueError(f"{n} records: the cut's rows are int32")
    if use_plain(intervals, refid, pos, ref_len):
        return overlap_rows_plain(intervals, refid, pos, ref_len)
    out = torch.empty(n + 1, dtype=torch.int32, device=refid.device)
    _launch(intervals, refid, pos, ref_len, out, THREADS)
    return out


def _launch(intervals, refid, pos, ref_len, out, threads: int) -> None:
    """The cut on the card with ``threads`` threads a block (32 to 1,024, a
    multiple of 32)."""
    n = refid.numel()
    words, blocks = -(-n // 32), -(-n // threads)
    work = torch.empty(words + blocks, dtype=torch.int32, device=refid.device)
    lib = _build.load("region")
    rc = lib.hbt_overlap_rows(intervals.data_ptr(), intervals.shape[0], refid.data_ptr(),
                              pos.data_ptr(), ref_len.data_ptr(), n, out.data_ptr(),
                              work.data_ptr(), threads, stream_handle(refid))
    _build.check(rc, "overlap_rows")
    if n:
        ROWS_LAUNCHES.add()


def overlap_rows_plain(intervals: torch.Tensor, refid: torch.Tensor, pos: torch.Tensor,
                       ref_len: torch.Tensor) -> torch.Tensor:
    """The plain version: the span rule in int64 wrapped to int32, the
    reference kernel's loop over the intervals, and ``torch.nonzero``.  The
    same ``[1 + N]`` buffer, zeros past the hits."""
    pos64 = pos.to(torch.int64)
    end = (pos64 + ref_len.to(torch.int64).clamp(min=1) + 2**31) % 2**32 - 2**31
    acc = torch.zeros(refid.numel(), dtype=torch.bool, device=refid.device)
    for rid, beg, stop in intervals.tolist():
        acc |= (refid == rid) & (pos64 < stop) & (end > beg)
    hit = torch.nonzero(acc & (pos64 >= 0)).flatten().to(torch.int32)
    out = torch.zeros(refid.numel() + 1, dtype=torch.int32, device=refid.device)
    out[0] = hit.numel()
    out[1 : 1 + hit.numel()] = hit
    return out

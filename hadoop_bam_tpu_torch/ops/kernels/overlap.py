"""Record/interval overlap cut: ``csrc/region.cu`` (``overlap_kernel``) and
its plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/overlap.py`` (``overlap_mask``,
``_overlap_call``): the record-level tail of BAM bounded traversal, after
the ``.bai`` chunk spans picked the windows.  The TPU kernel pads the
records to ``[8, 128]`` tiles with refid -2; the card needs no padding.
"""

from __future__ import annotations

import torch

from ... import _build
from . import LaunchCounter, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("overlap_mask")


def _check(intervals, refid, start, end) -> None:
    check_tensor(intervals, "intervals", torch.int32)
    if intervals.dim() != 2 or intervals.shape[1] != 3:
        raise ValueError("intervals must be [K, 3] (refid, beg, end)")
    n = refid.numel()
    for name, t in (("refid", refid), ("start", start), ("end", end)):
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

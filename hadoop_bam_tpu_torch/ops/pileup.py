"""Pileup depth: a segmented count over the records' reference spans.

Counterpart of ``hadoop_bam_tpu/ops/pileup.py``.  With the spans' starts
and ends each sorted,

    depth[x] = #(start <= x) - #(end <= x)
             = searchsorted(starts, x, 'right') - searchsorted(ends, x, 'right')

over the base axis, a chunk of :data:`CHUNK_BASES` bases at a time.  The
device form is the reference's plain-XLA program as torch ops on the
caller's device (int32 coordinates, the spans padded to a power of two
with the :data:`_PAD` sentinel), counted ``pileup.device_chunks``; the
host form is NumPy.  The two agree bit for bit.  The reference's
``pileup.tierdowns`` catch-all is not ported: a device failure raises.
Binned summaries reduce the profile chunk by chunk.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.tracing import Metrics
from .keys import split_keys_np

#: Bases of profile computed per device call / host vector op.
CHUNK_BASES = 1 << 20
_PAD = (1 << 31) - 1  # span sentinel: past every base coordinate


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _profile_host(starts_sorted, ends_sorted, c0: int, c1: int) -> np.ndarray:
    xs = np.arange(c0, c1, dtype=np.int64)
    return (
        np.searchsorted(starts_sorted, xs, side="right")
        - np.searchsorted(ends_sorted, xs, side="right")
    ).astype(np.int32)


def _profile_device(starts_sorted, ends_sorted, c0: int, c1: int,
                    device: torch.device) -> np.ndarray:
    """The device chunk: at most :data:`CHUNK_BASES` bases from ``c0``, as
    the reference's fixed-shape program returns."""
    n = len(starts_sorted)
    npad = _pow2(max(n, 1))
    s = np.pad(starts_sorted.astype(np.int32), (0, npad - n), constant_values=_PAD)
    e = np.pad(ends_sorted.astype(np.int32), (0, npad - n), constant_values=_PAD)
    st, et = torch.from_numpy(s).to(device), torch.from_numpy(e).to(device)
    xs = torch.arange(min(c1 - c0, CHUNK_BASES), dtype=torch.int32, device=device) + c0
    out = (torch.searchsorted(st, xs, right=True)
           - torch.searchsorted(et, xs, right=True)).to(torch.int32)
    return out.cpu().numpy()


def _profile(starts_sorted, ends_sorted, c0: int, c1: int, use_device: bool,
             device: Optional[torch.device], metrics: Optional[Metrics]) -> np.ndarray:
    if not use_device:
        return _profile_host(starts_sorted, ends_sorted, c0, c1)
    out = _profile_device(starts_sorted, ends_sorted, c0, c1, device)
    if metrics is not None:
        metrics.count("pileup.device_chunks")
    return out


def depth_profile(starts, ends, beg: int, end: int, use_device: bool = False,
                  device: Optional[torch.device] = None,
                  metrics: Optional[Metrics] = None) -> np.ndarray:
    """int32[end - beg] per-base depth over [beg, end), 0-based half-open;
    ``starts``/``ends`` are the records' reference spans in any order.
    ``use_device`` computes each chunk on ``device``."""
    starts = np.sort(np.asarray(starts, np.int64), kind="stable")
    ends = np.sort(np.asarray(ends, np.int64), kind="stable")
    parts = []
    for c0 in range(int(beg), int(end), CHUNK_BASES):
        c1 = min(int(end), c0 + CHUNK_BASES)
        parts.append(_profile(starts, ends, c0, c1, use_device, device, metrics))
    if not parts:
        return np.zeros(0, np.int32)
    return np.concatenate(parts)


def depth_summary(starts, ends, beg: int, end: int, bin_size: int = 1 << 12,
                  use_device: bool = False, device: Optional[torch.device] = None,
                  metrics: Optional[Metrics] = None) -> Dict:
    """Windowed depth over [beg, end): per-bin mean depth, the region's max
    and mean depth and covered bases, reduced chunk by chunk (chunks
    aligned to bins).  JSON-ready."""
    beg, end = int(beg), int(end)
    bin_size = max(1, int(bin_size))
    span = max(0, end - beg)
    n_bins = -(-span // bin_size) if span else 0
    sums = np.zeros(n_bins, np.int64)
    maxs = np.zeros(n_bins, np.int64)
    covered = 0
    starts = np.sort(np.asarray(starts, np.int64), kind="stable")
    ends_s = np.sort(np.asarray(ends, np.int64), kind="stable")
    chunk = bin_size * max(1, CHUNK_BASES // bin_size)
    for c0 in range(beg, end, chunk):
        c1 = min(end, c0 + chunk)
        prof = _profile(starts, ends_s, c0, c1, use_device, device, metrics)
        covered += int((prof > 0).sum())
        k = -(-len(prof) // bin_size)
        padded = np.zeros(k * bin_size, np.int64)
        padded[: len(prof)] = prof
        b0 = (c0 - beg) // bin_size
        sums[b0 : b0 + k] += padded.reshape(k, bin_size).sum(axis=1)
        maxs[b0 : b0 + k] = np.maximum(maxs[b0 : b0 + k], padded.reshape(k, bin_size).max(axis=1))
    widths = np.minimum(bin_size, span - np.arange(n_bins, dtype=np.int64) * bin_size)
    bin_mean = (sums / np.maximum(widths, 1)).round(4)
    total = int(sums.sum())
    return {
        "bin_size": bin_size,
        "bins": [float(x) for x in bin_mean],
        "max_depth": int(maxs.max()) if n_bins else 0,
        "mean_depth": round(total / span, 4) if span else 0.0,
        "covered_bases": covered,
        "total_bases": span,
    }


def spans_from_keys(keys, lengths, rid: int, beg: Optional[int] = None,
                    end: Optional[int] = None):
    """``(starts, ends)`` reference spans on contig ``rid`` from packed
    coordinate keys and the records' reference lengths, clipped to
    [beg, end) when given."""
    hi, lo = split_keys_np(np.asarray(keys, np.int64))
    sel = hi == rid
    starts = lo[sel].astype(np.int64)
    ends = starts + np.asarray(lengths, np.int64)[sel]
    if beg is not None or end is not None:
        b = 0 if beg is None else int(beg)
        e = (1 << 62) if end is None else int(end)
        keep = (starts < e) & (ends > b)
        starts, ends = starts[keep], ends[keep]
    return starts, ends

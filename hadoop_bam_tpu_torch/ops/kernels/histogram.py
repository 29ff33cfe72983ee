"""Masked value histogram: ``csrc/region.cu`` (``histogram_kernel``) and its
plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/histogram.py``
(``quality_histogram``), the quality-score histogram of the reference's
baseline config #3.  As in the reference, no production path calls it; it
is exported for callers and checked by ``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from ... import _build
from . import LaunchCounter, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("quality_histogram")
_LANES = 128  # the reference's bins come in lane-width chunks
#: Bins the kernel's shared-memory histogram holds (48 KiB of int32).
MAX_BINS = 12288


def quality_histogram(values: torch.Tensor, valid: torch.Tensor, nbins: int = 128) -> torch.Tensor:
    """int32[nbins]: counts of ``values`` (int32 ``[B, L]``) in ``[0, nbins)``
    where ``valid`` (int32 ``[B, L]``) is not 0.  ``nbins`` is a multiple of
    128, as in the reference; the kernel takes at most :data:`MAX_BINS`."""
    check_tensor(values, "values", torch.int32)
    check_tensor(valid, "valid", torch.int32)
    if values.dim() != 2 or values.shape != valid.shape:
        raise ValueError("values and valid must be [B, L] of one shape")
    if nbins % _LANES != 0 or nbins <= 0:
        raise ValueError(f"nbins must be a positive multiple of {_LANES}")
    if use_plain(values, valid):
        return quality_histogram_plain(values, valid, nbins)
    if nbins > MAX_BINS:
        raise ValueError(f"nbins {nbins} is past the kernel's {MAX_BINS} shared-memory bins")
    out = torch.zeros(nbins, dtype=torch.int32, device=values.device)
    total = values.numel()
    if total == 0:
        return out
    lib = _build.load("region")
    rc = lib.hbt_quality_histogram(values.data_ptr(), valid.data_ptr(), total, nbins,
                                   out.data_ptr(), stream_handle(values))
    _build.check(rc, "quality_histogram")
    LAUNCHES.add()
    return out


def quality_histogram_plain(values: torch.Tensor, valid: torch.Tensor, nbins: int) -> torch.Tensor:
    """The plain version: the reference kernel's compare of every value
    with every bin, summed over rows a 64-row tile at a time."""
    out = torch.zeros(nbins, dtype=torch.int64)
    bins = torch.arange(nbins, dtype=torch.int32)
    for r0 in range(0, values.shape[0], 64):
        v = values[r0 : r0 + 64].reshape(-1, 1)
        m = valid[r0 : r0 + 64].reshape(-1, 1) != 0
        out += ((v == bins[None, :]) & m).sum(dim=0)
    return out.to(torch.int32)

"""Quality-encoding ops, histograms and the duplicate-marking score.

Counterpart of ``hadoop_bam_tpu/ops/quality.py``: Sanger is Phred+33
(range [0, 93]), Illumina Phred+64 (range [0, 62]); conversion shifts by
31 after range validation (SequencedFragment.java:229-309).  The checks
report the index of the first bad byte per row (-1 if none) rather than
raise, so the caller applies its stringency.  The reference's jitted ops
become torch ops on the tensors' device; kernel rows 8 and 9 are
:mod:`.kernels.histogram` and :mod:`.kernels.unpack`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

SANGER_OFFSET = 33
SANGER_MAX = 93
ILLUMINA_OFFSET = 64
ILLUMINA_MAX = 62

#: Quality threshold of the markdup score (samtools markdup and Picard
#: MarkDuplicates sum only bases with quality >= 15).
MARKDUP_MIN_QUALITY = 15
_QUAL_MISSING = 0xFF  # the spec's "qual absent" fill byte never scores


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    n = mask.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    first = torch.where(mask, idx, n).amin(dim=-1) if n else torch.full(
        mask.shape[:-1], n, dtype=torch.int32, device=mask.device)
    return torch.where(first == n, -1, first).to(torch.int32)


def verify_quality_sanger(qual: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """First out-of-range index per row, -1 if none (``qual`` uint8
    ``[B, L]``, ``valid`` bool ``[B, L]``)."""
    q = qual.to(torch.int32)
    return _first_true(valid & ((q < SANGER_OFFSET) | (q > SANGER_OFFSET + SANGER_MAX)))


def verify_quality_illumina(qual: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    q = qual.to(torch.int32)
    return _first_true(valid & ((q < ILLUMINA_OFFSET) | (q > ILLUMINA_OFFSET + ILLUMINA_MAX)))


def illumina_to_sanger(qual: torch.Tensor) -> torch.Tensor:
    """Phred+64 → Phred+33, wrapping in uint8 (validate first)."""
    return ((qual.to(torch.int32) - (ILLUMINA_OFFSET - SANGER_OFFSET)) & 0xFF).to(torch.uint8)


def sanger_to_illumina(qual: torch.Tensor) -> torch.Tensor:
    return ((qual.to(torch.int32) + (ILLUMINA_OFFSET - SANGER_OFFSET)) & 0xFF).to(torch.uint8)


def _onehot_counts(values: torch.Tensor, valid: torch.Tensor, nbins: int) -> torch.Tensor:
    v = values.reshape(-1).to(torch.int32)
    m = valid.reshape(-1).bool()
    bins = torch.arange(nbins, dtype=torch.int32, device=values.device)
    return ((v[:, None] == bins[None, :]) & m[:, None]).sum(dim=0).to(torch.int32)


def histogram_u8(values: torch.Tensor, valid: torch.Tensor, nbins: int = 64) -> torch.Tensor:
    """int32 counts of each value in ``[0, nbins)`` over the valid positions
    (a one-hot sum, as the reference's; out-of-range values count
    nowhere)."""
    return _onehot_counts(values, valid, nbins)


def base_counts(seq_codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Counts of the 16 4-bit BAM base codes (``=ACMGRSVTWYHKDBN``)."""
    return _onehot_counts(seq_codes, valid, 16)


def unpack_seq_nibbles(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 ``[B, L/2]`` packed bases → ``(hi, lo)`` uint8 nibble planes."""
    return packed >> 4, packed & 0xF


def sum_base_qualities_np(
    data: np.ndarray, soa: dict, min_quality: int = MARKDUP_MIN_QUALITY
) -> np.ndarray:
    """int64 markdup score per record: the sum of its quality bytes at or
    above ``min_quality`` (0xFF, a missing quality, never counts)."""
    n = len(soa["rec_off"])
    scores = np.zeros(n, dtype=np.int64)
    if n == 0:
        return scores
    l_seq = soa["l_seq"].astype(np.int64)
    qual_off = (
        soa["rec_off"].astype(np.int64) + 32 + soa["l_read_name"]
        + 4 * soa["n_cigar_op"].astype(np.int64) + (l_seq + 1) // 2
    )
    # The records of one read length take their qualities as rows of one
    # strided view of the bytes.
    for length in np.unique(l_seq[l_seq > 0]).tolist():
        rows = np.flatnonzero(l_seq == length)
        q = np.lib.stride_tricks.sliding_window_view(data, length)[qual_off[rows]]
        scores[rows] = np.where((q >= min_quality) & (q != _QUAL_MISSING), q, 0).sum(
            axis=1, dtype=np.int64)
    return scores


def sum_base_qualities(qual: torch.Tensor, valid: torch.Tensor,
                       min_quality: int = MARKDUP_MIN_QUALITY) -> torch.Tensor:
    """Torch twin of :func:`sum_base_qualities_np` over padded rows
    (int32 per row)."""
    q = qual.to(torch.int32)
    counted = valid & (q >= min_quality) & (q != _QUAL_MISSING)
    return torch.where(counted, q, 0).sum(dim=-1).to(torch.int32)

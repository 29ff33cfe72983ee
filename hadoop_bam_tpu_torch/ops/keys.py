"""Sort keys as one packed int64 column.

Counterpart of ``hadoop_bam_tpu/ops/keys.py``.  The reference carries the
key as an (int32 hi, uint32 lo) pair for the TPU's 32-bit lanes; the port
carries the packed value ``pack_keys_np(hi, lo)`` itself, whose signed
order is the same.  The key is Java's ``(long)refIdx << 32 | pos0``
(BAMRecordReader.java:119-121), sign extension of a negative low word
included; unmapped rows use ``INT_MAX`` and the murmur3 hash.
"""

from __future__ import annotations

import numpy as np
import torch

from ..spec.bam import FLAG_UNMAPPED, INT_MAX


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    return ((v.to(torch.int64) + 2**31) & 0xFFFFFFFF) - 2**31


def unmapped_mask(refid: torch.Tensor, pos: torch.Tensor, flag: torch.Tensor):
    """Unmapped flag, refid < 0, or pos + 1 < 0 in int32 arithmetic (so
    pos = INT_MAX counts, as in the reference's device rule)."""
    return ((flag & FLAG_UNMAPPED) != 0) | (refid < 0) | (_wrap_int32(pos.to(torch.int64) + 1) < 0)


def make_keys(
    refid: torch.Tensor, pos: torch.Tensor, flag: torch.Tensor, hash32: torch.Tensor
) -> torch.Tensor:
    """Packed int64 keys of int32-valued columns."""
    unmapped = unmapped_mask(refid, pos, flag)
    sel_hi = torch.where(unmapped, INT_MAX, refid.to(torch.int64))
    sel_lo = torch.where(unmapped, hash32.to(torch.int64), pos.to(torch.int64))
    hi = torch.where(sel_lo < 0, -1, sel_hi)
    return hi * (1 << 32) + (sel_lo & 0xFFFFFFFF)


def split_keys_np(keys):
    """Host-side: signed int64 keys → ``(hi int32, lo uint32)`` NumPy
    columns, the reference's key pair."""
    keys = np.asarray(keys, dtype=np.int64)
    return (
        (keys >> np.int64(32)).astype(np.int32),
        (keys & np.int64(0xFFFFFFFF)).astype(np.uint32),
    )

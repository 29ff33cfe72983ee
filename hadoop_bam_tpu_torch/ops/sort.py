"""Single-device sort of the packed int64 key column.

Counterpart of ``hadoop_bam_tpu/ops/sort.py`` (``sort_keys``, a stable
``lax.sort`` over the (hi, lo) key pair, and ``apply_permutation``).  The
key is one int64 here, so a stable ``torch.sort`` gives the same
permutation.
"""

from __future__ import annotations

import torch


def sort_keys(keys: torch.Tensor):
    """``(sorted_keys, permutation)``; ties keep their input order."""
    return torch.sort(keys, stable=True)


def apply_permutation(columns: dict, perm: torch.Tensor) -> dict:
    """Every column gathered through ``perm``, on ``perm``'s device."""
    return {k: torch.as_tensor(v, device=perm.device)[perm] for k, v in columns.items()}

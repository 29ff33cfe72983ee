"""Single-device sort of the packed int64 key column.

Counterpart of ``hadoop_bam_tpu/ops/sort.py`` (``sort_keys``, a stable
``lax.sort`` over the (hi, lo) key pair).  The key is one int64 here, so a
stable ``torch.sort`` gives the same permutation.
"""

from __future__ import annotations

import torch


def sort_keys(keys: torch.Tensor):
    """``(sorted_keys, permutation)``; ties keep their input order."""
    return torch.sort(keys, stable=True)

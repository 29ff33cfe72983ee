"""Device resolution and out-of-memory classification.

Counterpart of ``hadoop_bam_tpu/utils/backend.py``.  The port's entry points
run on the card: ``None`` resolves to ``cuda``, and asking for ``cuda``
without a card raises.  The CPU runs only when the caller names it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..faults import InjectedResourceExhausted


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless device='cpu' "
            "is passed"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def is_resource_exhausted(e: BaseException) -> bool:
    """Is ``e`` the card running out of memory: a real
    ``torch.cuda.OutOfMemoryError``, or the ``arena.oom`` fault
    directive's :class:`~..faults.InjectedResourceExhausted`?  A plain
    ``MemoryError`` (the host) or any other error (a kernel that fails to
    build or launch) is not."""
    from ..faults import InjectedResourceExhausted

    return isinstance(e, (torch.cuda.OutOfMemoryError, InjectedResourceExhausted))

"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

A wrapper takes the plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises.  Each wrapper counts its
launches (:class:`LaunchCounter`), so a run can show which kernels it went
through.
"""

from __future__ import annotations

import threading

import torch


class LaunchCounter:
    """Thread-safe count of one kernel's launches."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


class OutsideInt32Domain(ValueError):
    """A geometry the reference's int32 device programs cannot address.
    Raised by a wrapper's host check before any launch; the part writer
    turns it into the counted tier-down ``bam.device_write_tierdown.size``."""


def use_plain(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (the plain version runs), False
    when every tensor is on one CUDA device (the kernel runs).  Anything
    else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream

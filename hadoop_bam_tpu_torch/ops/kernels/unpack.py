"""BAM 4-bit sequence unpack: ``csrc/region.cu`` (``unpack_kernel``) and its
plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/unpack.py`` (``unpack_nibbles``):
two bases a byte, high nibble first (SAM spec §4.2.3).  As in the
reference, no production path calls it; it is exported for callers and
checked by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build
from . import LaunchCounter, on_device, stream_handle, use_plain

LAUNCHES = LaunchCounter("unpack_nibbles")

SEQ_CODE_TO_BASE = "=ACMGRSVTWYHKDBN"  # SAM spec nibble alphabet


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """uint8 or int32 ``[B, W]`` packed bytes → int32 ``[B, 2W]`` codes
    0-15, high nibble first.  A CUDA tensor launches the kernel, a CPU
    tensor takes the plain version."""
    if packed.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"packed: expected uint8 or int32, got {packed.dtype}")
    if packed.dim() != 2:
        raise ValueError("packed must be [B, W]")
    if not packed.is_contiguous():
        raise ValueError("packed: must be contiguous")
    if use_plain(packed):
        return unpack_nibbles_plain(packed)
    b, w = packed.shape
    out = torch.empty((b, 2 * w), dtype=torch.int32, device=packed.device)
    if packed.numel() == 0:
        return out
    lib = _build.load("region")
    fn = lib.hbt_unpack_nibbles_u8 if packed.dtype == torch.uint8 else lib.hbt_unpack_nibbles_i32
    rc = fn(packed.data_ptr(), packed.numel(), out.data_ptr(), stream_handle(packed))
    _build.check(rc, "unpack_nibbles")
    LAUNCHES.add()
    return out


def unpack_nibbles_auto(packed, device=None) -> torch.Tensor:
    """:func:`unpack_nibbles` of host or device input: host input goes to
    the card unless ``device="cpu"``; a dtype other than uint8 is taken as
    int32."""
    u8 = (packed.dtype == torch.uint8 if isinstance(packed, torch.Tensor)
          else np.asarray(packed).dtype == np.uint8)
    return unpack_nibbles(on_device(packed, torch.uint8 if u8 else torch.int32, device))


def unpack_nibbles_plain(packed: torch.Tensor) -> torch.Tensor:
    """The plain version: the high and low nibble planes, interleaved."""
    p = packed.to(torch.int32)
    b, w = p.shape
    return torch.stack([(p >> 4) & 0xF, p & 0xF], dim=-1).reshape(b, 2 * w)

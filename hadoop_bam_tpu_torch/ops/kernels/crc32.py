"""Per-member CRC32: ``csrc/write.cu`` (``crc32_members_kernel``) and its
plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/crc32.py`` (``crc32_device``).
BGZF framing needs each member's CRC32; computed on the card from the
gathered part stream, only a 4-byte column comes back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build
from . import LaunchCounter, OutsideInt32Domain, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("crc32")


def _build_tables() -> np.ndarray:
    t = np.zeros((4, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0xEDB88320 if c & 1 else 0)
        t[0, i] = c
    for k in range(1, 4):
        t[k] = (t[k - 1] >> np.uint32(8)) ^ t[0][t[k - 1] & 0xFF]
    return t


#: Slicing-by-4 tables of the reflected 0xEDB88320 polynomial; row 0 is the
#: bytewise table.  ``csrc/write.cu`` builds the same tables on the card.
CRC_TABLES = _build_tables()


def crc32_device(stream: torch.Tensor, offs, lens) -> torch.Tensor:
    """CRC32 of ``stream[offs[i] : offs[i] + lens[i]]`` for every member i.

    ``stream``: uint8 tensor; ``offs``/``lens``: host integer columns.
    Returns a uint32 tensor on ``stream``'s device, one entry per member,
    equal to ``zlib.crc32`` of each window (0 for an empty one).  As in the
    reference, a window past ``2**31 - 8`` raises
    :class:`~hadoop_bam_tpu_torch.ops.kernels.OutsideInt32Domain`; a window
    past the end of ``stream`` raises ``IndexError``."""
    check_tensor(stream, "stream", torch.uint8)
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    n = len(offs)
    if len(lens) != n:
        raise ValueError("offs and lens differ in length")
    if n == 0 or stream.numel() == 0 or int(lens.max()) == 0:
        return torch.zeros(n, dtype=torch.int32, device=stream.device).view(torch.uint32)
    if int(offs.max()) + int(lens.max()) > 2**31 - 8:
        raise OutsideInt32Domain("crc32_device: stream outside the int32 domain")
    if int(offs.min()) < 0 or int((offs + lens).max()) > stream.numel():
        raise IndexError("crc32_device: a member window lies outside the stream")
    offs_t = torch.from_numpy(offs).to(stream.device)
    lens_t = torch.from_numpy(lens.astype(np.int32)).to(stream.device)
    if use_plain(stream, offs_t, lens_t):
        return crc32_plain(stream, offs_t, lens_t)
    out = torch.empty(n, dtype=torch.int32, device=stream.device)
    lib = _build.load("write")
    rc = lib.hbt_crc32_members(
        stream.data_ptr(), offs_t.data_ptr(), lens_t.data_ptr(), n, out.data_ptr(),
        stream_handle(stream),
    )
    _build.check(rc, "crc32_members")
    LAUNCHES.add()
    return out.view(torch.uint32)


def crc32_plain(stream: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The plain version on CPU tensors: the reference's lockstep
    slicing-by-4 walk, one 32-bit word of every live member per step, then
    up to three tail bytes."""
    a = stream.numpy()
    o = offs.numpy().astype(np.int64)
    ln = lens.numpy().astype(np.int64)
    t0, t1, t2, t3 = CRC_TABLES
    crc = np.full(len(o), 0xFFFFFFFF, dtype=np.uint32)
    nwords = ln >> 2
    for k in range(int(nwords.max(initial=0))):
        live = np.nonzero(nwords > k)[0]
        at = o[live] + 4 * k
        w = (a[at].astype(np.uint32) | (a[at + 1].astype(np.uint32) << 8)
             | (a[at + 2].astype(np.uint32) << 16) | (a[at + 3].astype(np.uint32) << 24))
        c = crc[live] ^ w
        crc[live] = t3[c & 0xFF] ^ t2[(c >> 8) & 0xFF] ^ t1[(c >> 16) & 0xFF] ^ t0[c >> 24]
    for k in range(3):
        live = np.nonzero(nwords * 4 + k < ln)[0]
        b = a[o[live] + nwords[live] * 4 + k].astype(np.uint32)
        c = crc[live]
        crc[live] = (c >> 8) ^ t0[(c ^ b) & 0xFF]
    crc ^= np.uint32(0xFFFFFFFF)
    return torch.from_numpy(crc.view(np.int32)).view(torch.uint32)

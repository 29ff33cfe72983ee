"""Per-member CRC32: ``csrc/write.cu`` (``crc32_members_kernel``, the core
in ``csrc/write_core.cuh``) and its plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/crc32.py`` (``crc32_device``).
BGZF framing needs each member's CRC32; computed on the card from the
gathered part stream, only a 4-byte column comes back to the host.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ... import _build
from . import LaunchCounter, OutsideInt32Domain, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("crc32")

#: The card's geometry: threads a block (a block a member) and the bytes each
#: thread folds a round (``csrc/write.cu``).
THREADS = 128
W = 32

_POLY = 0xEDB88320


def _build_tables() -> np.ndarray:
    t = np.zeros((4, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        t[0, i] = c
    for k in range(1, 4):
        t[k] = (t[k - 1] >> np.uint32(8)) ^ t[0][t[k - 1] & 0xFF]
    return t


#: Slicing-by-4 tables of the reflected 0xEDB88320 polynomial; row 0 is the
#: bytewise table.
CRC_TABLES = _build_tables()


def _apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A linear map on 32-bit registers, given by its 32 columns (the images
    of bits 0-31), applied to every value of ``v``."""
    v = np.asarray(v, dtype=np.uint32)
    r = np.zeros(v.shape, dtype=np.uint32)
    for i in range(32):
        r ^= np.where((v >> np.uint32(i)) & np.uint32(1), cols[i], np.uint32(0)).astype(np.uint32)
    return r


def zeros_shift(n: int) -> np.ndarray:
    """The columns of A^n: ``n`` zero bytes fed to the CRC register (register
    0, no inversion), by squaring the one-byte shift."""
    unit = np.uint32(1) << np.arange(32, dtype=np.uint32)
    one = (unit >> np.uint32(8)) ^ CRC_TABLES[0][unit & 0xFF]
    result, base = unit.copy(), one
    while n:
        if n & 1:
            result = _apply(base, result)
        base = _apply(base, base)
        n >>= 1
    return result


@functools.lru_cache(maxsize=None)
def crc_consts(threads: int, w: int) -> np.ndarray:
    """The CRC kernel's constants at ``threads`` threads a block and ``w``
    bytes a thread a round (``csrc/write_core.cuh``): the slicing tables, the
    round's shift A^(threads * w - w) as four 256-entry tables (byte m of the
    register), and for each tree level k < log2(threads) the shift
    A^(2^k * w) as eight 16-entry tables (nibble j)."""
    b = np.arange(256, dtype=np.uint32)
    q = np.arange(16, dtype=np.uint32)
    rnd = zeros_shift(threads * w - w)
    parts = [CRC_TABLES.ravel(), np.concatenate([_apply(rnd, b << np.uint32(8 * m))
                                                 for m in range(4)])]
    k = 0
    while (1 << k) < threads:
        lev = zeros_shift((1 << k) * w)
        parts.append(np.concatenate([_apply(lev, q << np.uint32(4 * j)) for j in range(8)]))
        k += 1
    out = np.concatenate(parts).astype(np.uint32)
    out.flags.writeable = False
    return out


_consts_lock = threading.Lock()
_consts_on: Dict[Tuple[str, int, int], torch.Tensor] = {}


def _consts_tensor(device: torch.device, threads: int, w: int) -> torch.Tensor:
    """``crc_consts`` on the card, uploaded once a device and geometry."""
    key = (str(device), threads, w)
    with _consts_lock:
        t = _consts_on.get(key)
        if t is None:
            t = torch.from_numpy(crc_consts(threads, w).view(np.int32).copy()).to(device)
            _consts_on[key] = t
    return t


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
    if use_plain(stream):
        return crc32_plain(stream, torch.from_numpy(offs), torch.from_numpy(lens.astype(np.int32)))
    offs_t, lens_t = _columns(offs, lens, stream.device)
    out = torch.empty(n, dtype=torch.int32, device=stream.device)
    _launch(stream, offs_t, lens_t, out)
    LAUNCHES.add()
    return out.view(torch.uint32)


def _columns(offs: np.ndarray, lens: np.ndarray, device: torch.device):
    """``offs`` (int64) and ``lens`` (int32) on the card, as one upload."""
    n = len(offs)
    host = np.empty(12 * n, dtype=np.uint8)
    host[: 8 * n].view(np.int64)[:] = offs
    host[8 * n :].view(np.int32)[:] = lens
    cols = torch.from_numpy(host).to(device)
    return cols[: 8 * n].view(torch.int64), cols[8 * n :].view(torch.int32)


def _launch(stream: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor, out: torch.Tensor,
            threads: int = THREADS, w: int = W) -> None:
    """The kernel over columns already on the card (``out`` int32 [n]):
    ``threads`` (32, 64, 128 or 256) a block, ``w`` bytes (16-256, a power
    of two) a thread a round.  Raises on a launch error."""
    lib = _build.load("write")
    rc = lib.hbt_crc32_members(
        stream.data_ptr(), stream.numel(), offs.data_ptr(), lens.data_ptr(), offs.numel(),
        out.data_ptr(), _consts_tensor(stream.device, threads, w).data_ptr(), threads, w,
        stream_handle(stream),
    )
    _build.check(rc, "crc32_members")


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

"""BGZF inflate on the device with per-member tier-down to host zlib.

Counterpart of ``hadoop_bam_tpu/ops/flate.py``: ``inflate_blocks_device``,
its helper ``_lanes_decode_members``, ``CodecTierStats`` and the codec
constant tables.  The reference decodes 128 members per lockstep launch
into a lane-major buffer and flattens it on the device
(``_device_flatten``); here one launch per call writes every member
straight to its offset in one flat device buffer, which becomes the
split's resident window.

Tier-down is per member and is the data contract for corrupt input, never a
fallback for a kernel that fails: a member the kernel returns with ok = 0,
or whose CRC32 differs, is re-decoded by host zlib (which raises
:class:`~hadoop_bam_tpu_torch.spec.bgzf.BgzfError` if it really is
corrupt) and counted as ``flate.lanes_tierdown``.  A build or launch
failure raises.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..spec import bgzf
from ..utils.tracing import Metrics
from .kernels import inflate as kin

# DEFLATE code tables (RFC 1951 3.2.5); ``csrc/inflate.cu`` holds the same
# values as constants.
LEN_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
     67, 83, 99, 115, 131, 163, 195, 227, 258], dtype=np.int32)
LEN_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
     5, 5, 5, 5, 0], dtype=np.int32)
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513,
     769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577],
    dtype=np.int32)
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
     11, 11, 12, 12, 13, 13], dtype=np.int32)
CLC_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32)


class CodecTierStats:
    """Members per tier of one call: ``lanes`` (the device kernel) and
    ``host`` (tier-downs), with ``tierdown_ok0`` for members the kernel
    declined and ``tierdown_crc`` for members whose CRC32 differed."""

    __slots__ = ("lanes", "host", "tierdown_ok0", "tierdown_crc")

    def __init__(self) -> None:
        for k in self.__slots__:
            setattr(self, k, 0)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


def _lanes_decode_members(
    raw: np.ndarray,
    co: np.ndarray,
    cs: np.ndarray,
    xlen: np.ndarray,
    us: np.ndarray,
    out_offsets: np.ndarray,
    device: torch.device,
    metrics: Metrics,
) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """One kernel launch over members ``co``: upload the compressed span
    ``raw[co[0] : co[-1] + cs[-1]]``, inflate into one flat buffer, bring it
    back.  Returns ``(host_out, meta, device_out)``."""
    base = int(co[0])
    # Writable for torch.from_numpy; a copy only when the caller's buffer
    # is read-only.
    span = np.require(raw[base : int(co[-1] + cs[-1])], requirements=["C", "W"])
    comp = torch.empty(len(span) + kin.COMP_PAD, dtype=torch.uint8, device=device)
    comp[: len(span)].copy_(torch.from_numpy(span))
    on_card = device.type == "cuda"
    if on_card:
        metrics.count_h2d(len(span), "inflate_comp")
    clens = (cs - 20 - xlen).astype(np.int32)
    cols = [
        torch.from_numpy(a).to(device)
        for a in (
            (co - base + 12 + xlen).astype(np.int64),
            clens,
            out_offsets[:-1].astype(np.int64),
            us.astype(np.int32),
        )
    ]
    out_dev = torch.empty(int(out_offsets[-1]), dtype=torch.uint8, device=device)
    meta = kin.inflate_members(comp, *cols, out_dev, max_clen=int(clens.max()))
    if not on_card:
        return out_dev.numpy(), meta.numpy(), out_dev
    out = out_dev.cpu().numpy()
    metrics.count_d2h(len(out), "inflate_out")
    return out, meta.cpu().numpy(), out_dev


def inflate_blocks_device(
    data,
    coffsets,
    csizes,
    usizes,
    device: torch.device,
    metrics: Metrics,
    check_crc: bool = True,
    threads: Optional[int] = None,
    stats: Optional[CodecTierStats] = None,
):
    """Inflate BGZF members on ``device``: ``(out, out_offsets, dev)``.

    ``out``/``out_offsets`` follow the host codec's contract (member i's
    payload at ``out[out_offsets[i] : out_offsets[i+1]]``).  ``dev`` is the
    same bytes as a flat uint8 tensor on ``device`` — the split's resident
    window — or None when any member tiered down (the host bytes then
    differ from what the device holds).  Members with ISIZE 0 carry no
    bytes and are not decoded, as in the reference."""
    raw = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    co = np.asarray(coffsets, dtype=np.int64)
    cs = np.asarray(csizes, dtype=np.int64)
    us = np.asarray(usizes, dtype=np.int64)
    n = len(co)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(us, out=out_offsets[1:])
    stats = stats if stats is not None else CodecTierStats()
    live = np.nonzero(us > 0)[0]
    if len(live) == 0:
        return np.empty(0, np.uint8), out_offsets, None
    xlen = raw[co + 10].astype(np.int64) | (raw[co + 11].astype(np.int64) << 8)
    out, meta, dev = _lanes_decode_members(
        raw, co[live], cs[live], xlen[live], us[live],
        np.append(out_offsets[live], out_offsets[-1]), device, metrics,
    )

    def verdict(k: int) -> Optional[str]:
        i = int(live[k])
        if not (meta[k, 1] == 1 and meta[k, 0] == us[i]):
            return "tierdown_ok0"
        if check_crc:
            o0, o1 = int(out_offsets[i]), int(out_offsets[i + 1])
            want = struct.unpack_from("<I", raw, int(co[i] + cs[i]) - 8)[0]
            if zlib.crc32(out[o0:o1]) & 0xFFFFFFFF != want:
                return "tierdown_crc"
        return None

    with ThreadPoolExecutor(threads or bgzf.default_threads()) as pool:
        reasons = list(pool.map(verdict, range(len(live))))
    down: List[int] = []
    for k, why in enumerate(reasons):
        if why is not None:
            setattr(stats, why, getattr(stats, why) + 1)
            down.append(int(live[k]))
    stats.lanes += len(live) - len(down)
    if down:
        stats.host += len(down)
        metrics.count("flate.lanes_tierdown", len(down))
        d_out, d_offs = bgzf.inflate_blocks(
            raw, co[down], cs[down], us[down], check_crc=check_crc, threads=threads
        )
        for k, i in enumerate(down):
            out[out_offsets[i] : out_offsets[i + 1]] = d_out[d_offs[k] : d_offs[k + 1]]
        dev = None
    return out, out_offsets, dev


def _crc32_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0xEDB88320 if c & 1 else 0)
        t[i] = c
    return t


#: Bytewise CRC32 table of the reflected 0xEDB88320 polynomial (the
#: reference's ``ops/pallas/crc32.py CRC_TABLES[0]``), kept for the device
#: CRC32 of the part-write slice.
CRC32_TABLE = _crc32_table()

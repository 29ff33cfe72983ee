"""BGZF inflate and deflate on the device with per-member tier-down to host
zlib.

Counterpart of ``hadoop_bam_tpu/ops/flate.py``: ``inflate_blocks_device``,
its helper ``_lanes_decode_members``, ``bgzf_compress_device``,
``deflate_blocks_device``, ``deflate_lanes_accepts``, ``CodecTierStats``
and the codec constant tables.  The reference decodes 128 members per lockstep launch
into a lane-major buffer and flattens it on the device
(``_device_flatten``); here one launch per call writes every member
straight to its offset in one flat device buffer, which becomes the
split's resident window.

Tier-down is per member and is a data or geometry contract, never a
fallback for a kernel that fails: a member the inflate kernel returns with
ok = 0, or whose CRC32 differs, is re-decoded by host zlib (which raises
:class:`~hadoop_bam_tpu_torch.spec.bgzf.BgzfError` if it really is
corrupt) and counted as ``flate.lanes_tierdown``; a member the deflate
lanes decline (size, the ``vmem`` rule, ok = 0) is compressed by host zlib
at the call's level and counted as ``flate.deflate_lanes_tierdown``.  A
build or launch failure raises.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..spec import bgzf
from ..utils.backend import resolve_device
from ..utils.tracing import Metrics
from .kernels import check_tensor
from .kernels import crc32 as kcrc
from .kernels import deflate as kdef
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


#: Largest member payload the device deflate writes: its worst-case
#: (all-literal) fixed-Huffman member still fits the u16 BSIZE field.
DEV_MAX_PAYLOAD = 0xDF00  # 57088
#: Part-write blocking of the lanes tier (full-size members).
DEV_LZ_PAYLOAD = DEV_MAX_PAYLOAD
#: The reference's default blocking off the lanes tier (level-0 members).
DEV_DEFAULT_PAYLOAD = 24000


class CodecTierStats:
    """Members per tier of one call: ``lanes`` (the device kernel), ``xla``
    (the reference's literal-only tier; always 0 here) and ``host``
    (tier-downs and stored members), with the reasons a member left the
    lanes tier: ``tierdown_size`` (past the member cap), ``tierdown_vmem``
    (past the reference's VMEM rule), ``tierdown_ok0`` (the kernel declined
    it) and, for inflate, ``tierdown_crc`` (its CRC32 differed)."""

    __slots__ = ("lanes", "xla", "host", "tierdown_size", "tierdown_vmem",
                 "tierdown_ok0", "tierdown_crc")

    def __init__(self) -> None:
        for k in self.__slots__:
            setattr(self, k, 0)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}

    def publish(self, metrics: Metrics, prefix: str) -> None:
        """Count every nonzero field as ``<prefix>.<field>``."""
        for k in self.__slots__:
            v = getattr(self, k)
            if v:
                metrics.count(f"{prefix}.{k}", v)


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


#: Bytewise CRC32 table of the reflected 0xEDB88320 polynomial (the
#: reference's ``ops/pallas/crc32.py CRC_TABLES[0]``).
CRC32_TABLE = kcrc.CRC_TABLES[0]


def deflate_lanes_accepts(max_plen: int) -> Tuple[bool, str]:
    """Would the deflate lanes take members of this payload size?  Pure
    host logic: ``(True, "")`` or ``(False, "size" | "vmem")``."""
    return kdef.accepts(max_plen)


def _host_raw_deflate(payload, level: int) -> bytes:
    """One member through host zlib as raw DEFLATE: the per-member
    tier-down of the lanes."""
    co = zlib.compressobj(max(1, min(level, 9)), zlib.DEFLATED, -15)
    return co.compress(bytes(payload)) + co.flush()


def _block_lens(n: int, block_payload: int) -> np.ndarray:
    """Member payload sizes of the fixed blocking: a cut every
    ``block_payload`` bytes; an empty stream is one empty member."""
    nblk = max(1, -(-n // block_payload))
    lens = np.full(nblk, block_payload, dtype=np.int64)
    lens[-1] = n - (nblk - 1) * block_payload
    return lens


def _compress_members(
    data,
    block_payload: Optional[int],
    level: int,
    use_lanes: bool,
    device_input: Optional[torch.Tensor],
    device,
    metrics: Optional[Metrics],
    stats: Optional[CodecTierStats],
) -> Tuple[bytes, np.ndarray]:
    """BGZF members of a byte stream, no terminator: ``(blob, sizes)``.
    See :func:`bgzf_compress_device`."""
    metrics = metrics if metrics is not None else Metrics()
    stats = stats if stats is not None else CodecTierStats()
    a: Optional[np.ndarray] = None
    if device_input is not None:
        if data is not None:
            raise ValueError("pass data or device_input, not both")
        check_tensor(device_input, "device_input", torch.uint8)
        dev = device_input.device
        n = device_input.numel()
    else:
        a = data if isinstance(data, np.ndarray) else np.frombuffer(data, dtype=np.uint8)
        dev = None
        n = len(a)
    if level != 0 and not use_lanes:
        raise NotImplementedError(
            "the literal-only device deflate (deflate_fixed) is not ported yet "
            "(ROADMAP A.13); pass use_lanes=True or level=0"
        )
    if device_input is not None and level == 0:
        # Stored members need the bytes on the host: one visible spill.
        a = device_input.cpu().numpy()
        if dev.type == "cuda":
            metrics.count_d2h(a.nbytes, "write_spill")
        metrics.count("flate.deflate.device_input_spill")
        device_input = None
    if block_payload is None:
        block_payload = DEV_LZ_PAYLOAD if level != 0 else DEV_DEFAULT_PAYLOAD
    if block_payload > DEV_MAX_PAYLOAD:
        raise bgzf.BgzfError(
            f"device codec payload cap is {DEV_MAX_PAYLOAD}, got {block_payload}")
    lens = _block_lens(n, block_payload)
    nblk = len(lens)
    starts = np.arange(nblk, dtype=np.int64) * block_payload
    clens = np.zeros(nblk, dtype=np.int64)
    rows: Optional[np.ndarray] = None  # compressed rows of the lanes tier
    overrides: Dict[int, bytes] = {}  # member -> bytes (stored or host zlib)

    def member_payload(i: int):
        s, ln = int(starts[i]), int(lens[i])
        if a is not None:
            return a[s : s + ln]
        sl = device_input[s : s + ln].cpu().numpy()
        if dev.type == "cuda":
            metrics.count_d2h(sl.nbytes, "write_tierdown")
        return sl

    if level == 0:
        for i in range(nblk):
            ln = int(lens[i])
            overrides[i] = b"\x01" + struct.pack("<HH", ln, ln ^ 0xFFFF) + bytes(member_payload(i))
            clens[i] = 5 + ln
        stats.host += nblk
    else:
        accepted, reason = deflate_lanes_accepts(int(lens.max()))
        if accepted:
            if device_input is None:
                dev = resolve_device(device)
                stream = torch.from_numpy(np.require(a, requirements=["C", "W"]))
                if dev.type == "cuda":
                    stream = stream.to(dev)
                    metrics.count_h2d(n, "deflate_payload")
            else:
                stream = device_input
            comp, cl, okt = kdef.deflate_lanes_stream(stream, lens, offs=starts)
            ok = okt.cpu().numpy()
            clens[:] = cl.cpu().numpy()
            width = int(clens[ok].max(initial=0))
            rows = comp[:, :width].cpu().numpy()
            if dev.type == "cuda":
                metrics.count_d2h(rows.nbytes, "deflate_comp")
                metrics.count_d2h(ok.nbytes + 4 * nblk, "deflate_meta")
            stats.tierdown_ok0 += int((~ok).sum())
        else:
            ok = np.zeros(nblk, dtype=bool)
            setattr(stats, f"tierdown_{reason}", getattr(stats, f"tierdown_{reason}") + nblk)
        stats.lanes += int(ok.sum())
        down = np.nonzero(~ok)[0]
        if len(down):
            metrics.count("flate.deflate_lanes_tierdown", len(down))
            stats.host += len(down)
            for i in down.tolist():
                overrides[i] = _host_raw_deflate(member_payload(i), level)
                clens[i] = len(overrides[i])
    stats.publish(metrics, "flate.deflate")

    # Framing: header, member bytes, CRC32 and ISIZE per member.  Host
    # input: zlib.crc32 over slices of the stream; device input: the CRC
    # kernel over the resident stream, so only a 4-byte column comes back.
    if a is None:
        crcs = kcrc.crc32_device(device_input, starts, lens).cpu().numpy()
        if dev.type == "cuda":
            metrics.count_d2h(crcs.nbytes, "write_crc")
    else:
        crcs = None
    sizes = clens + 26
    buf = bytearray(int(sizes.sum()))
    pos = 0
    for i in range(nblk):
        c = int(clens[i])
        ln = int(lens[i])
        buf[pos : pos + 4] = bgzf.MAGIC
        struct.pack_into("<IBBHBBHH", buf, pos + 4, 0, 0, 0xFF, 6, 0x42, 0x43, 2, c + 25)
        pos += 18
        od = overrides.get(i)
        buf[pos : pos + c] = od if od is not None else memoryview(rows[i, :c])
        pos += c
        if crcs is not None:
            crc = int(crcs[i])
        else:
            s = int(starts[i])
            crc = zlib.crc32(a[s : s + ln]) & 0xFFFFFFFF
        struct.pack_into("<II", buf, pos, crc, ln)
        pos += 8
    return bytes(buf), sizes


def bgzf_compress_device(
    data=None,
    block_payload: Optional[int] = None,
    append_terminator: bool = True,
    level: int = 1,
    use_lanes: bool = True,
    device_input: Optional[torch.Tensor] = None,
    device: Optional[Union[str, torch.device]] = None,
    metrics: Optional[Metrics] = None,
    stats: Optional[CodecTierStats] = None,
) -> bytes:
    """Compress a byte stream into BGZF with the device deflate tiers:
    byte for byte what the reference's ``bgzf_compress_device`` writes.

    1. ``level == 0``: one stored block per member, no device work.
    2. The deflate lanes (``csrc/deflate.cu``); members they decline go to
       host zlib at ``level`` one by one, counted.
    3. The reference's literal-only tier (``use_lanes=False`` with ``level
       != 0``) is not ported: it raises ``NotImplementedError``.

    ``data`` is host bytes (uploaded to ``device`` for the lanes, default
    cuda); ``device_input`` (exclusive with ``data``) is a uint8 tensor
    already on the device — the device-resident part write: the lanes read
    it in place and the CRC kernel computes the framing's CRC32 column, so
    only compressed rows, that column and any tier-down members' payloads
    come back.  Blocking is a member every ``block_payload`` bytes
    (default :data:`DEV_LZ_PAYLOAD`; :data:`DEV_DEFAULT_PAYLOAD` at level
    0, as in the reference).  Tier accounting goes to ``stats`` and,
    as ``flate.deflate.*``, to ``metrics``."""
    blob, _ = _compress_members(data, block_payload, level, use_lanes, device_input, device,
                                metrics, stats)
    return blob + bgzf.TERMINATOR if append_terminator else blob


def deflate_blocks_device(
    payload,
    level: int = 1,
    block_payload: Optional[int] = None,
    use_lanes: bool = True,
    device_input: Optional[torch.Tensor] = None,
    device: Optional[Union[str, torch.device]] = None,
    metrics: Optional[Metrics] = None,
    stats: Optional[CodecTierStats] = None,
) -> Tuple[bytes, np.ndarray]:
    """The part writer's surface of :func:`bgzf_compress_device`: no
    terminator, and the member sizes come back with the blob,
    ``(blob, sizes)`` (``sizes = clens + 26``), so the ``.splitting-bai``
    offsets follow without re-scanning the blob."""
    return _compress_members(payload, block_payload, level, use_lanes, device_input, device,
                             metrics, stats)

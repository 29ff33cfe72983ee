"""BGZF inflate and deflate on the device with per-member tier-down to host
zlib.

Counterpart of ``hadoop_bam_tpu/ops/flate.py``: ``inflate_blocks_device``,
its helper ``_lanes_decode_members``, ``bgzf_compress_device``,
``deflate_blocks_device``, ``deflate_lanes_accepts``, ``CodecTierStats``,
the codec constant tables and the host encoder oracle
(``encode_tokens_fixed``), the literal-only deflate (``deflate_fixed``),
the three general inflate programs (``inflate_stored``, ``inflate_fixed``,
``inflate_dynamic``) and the whole-stream ``bgzf_decompress_device``.  The
reference decodes 128 members per lockstep launch into a lane-major buffer
and flattens it on the device (``_device_flatten``); here one launch per
call writes every member straight to its offset in one flat device buffer,
which becomes the split's resident window.

The reference's XLA array programs (``deflate_fixed`` and the three
inflate programs) are torch ops on the caller's device: a prefix sum of
code lengths and a scatter-add of bit-reversed codes for the deflate; a
speculative token decode at every bit position, a pointer-doubling chain
walk and a pointer-jumping LZ77 resolve for the inflates.  They keep the
reference's static shapes and verdicts, and its ``_MAX_LAUNCH_ELEMS``
chunking where that bounds the memory of their ``[members, positions]``
temporaries.

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
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import faults
from ..conf import DEFLATE_LANES, INFLATE_LANES, gate
from ..spec import bgzf
from ..utils.backend import resolve_device
from ..utils.tracing import Metrics
from .kernels import check_tensor
from .kernels import crc32 as kcrc
from .kernels import deflate as kdef
from .kernels import inflate as kin
from .kernels import inflate_fixed as kfix

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


def _bit_reverse(v: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


def _fixed_code(sym: int) -> Tuple[int, int]:
    """(code, nbits) of a fixed-Huffman litlen symbol (MSB-first code)."""
    if sym <= 143:
        return 0x30 + sym, 8
    if sym <= 255:
        return 0x190 + (sym - 144), 9
    if sym <= 279:
        return sym - 256, 7
    return 0xC0 + (sym - 280), 8


def _build_litlen_table() -> np.ndarray:
    """512-entry stream-order lookup: next 9 bits → ``sym << 4 | codelen``."""
    table = np.full(512, (287 << 4) | 8, dtype=np.int32)  # default: invalid
    for sym in range(288):
        code, n = _fixed_code(sym)
        rev = _bit_reverse(code, n)
        for free in range(1 << (9 - n)):
            table[rev | (free << n)] = (sym << 4) | n
    return table


def _build_dist_table() -> np.ndarray:
    """32-entry stream-order lookup: next 5 bits → distance symbol."""
    table = np.zeros(32, dtype=np.int32)
    for dsym in range(32):
        table[_bit_reverse(dsym, 5)] = dsym
    return table


LITLEN_TABLE = _build_litlen_table()
DIST_TABLE = _build_dist_table()
#: Fixed-Huffman code lengths (RFC 1951 3.2.6): the btype=01 table is one
#: code-length vector, so the dynamic decoder subsumes it.
FIXED_LITLEN_LENS = np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, dtype=np.int32)
FIXED_DIST_LENS = np.array([5] * 32, dtype=np.int32)
REV8 = np.array([_bit_reverse(i, 8) for i in range(256)], dtype=np.int32)
#: Each literal's fixed code, bit-reversed into stream (LSB-first) order.
_LIT_STREAM_CODE = np.array(
    [_bit_reverse(*_fixed_code(b)) for b in range(256)], dtype=np.int64)


#: Largest member payload the device deflate writes: its worst-case
#: (all-literal) fixed-Huffman member still fits the u16 BSIZE field.
DEV_MAX_PAYLOAD = 0xDF00  # 57088
#: Part-write blocking of the lanes tier (full-size members).
DEV_LZ_PAYLOAD = DEV_MAX_PAYLOAD
#: The reference's default blocking off the lanes tier (literal-only and
#: stored members).
DEV_DEFAULT_PAYLOAD = 24000
#: Elements of one launch's ``[members, positions]`` temporaries: the
#: reference's XLA gather cap, kept here to bound the memory of the
#: literal-only deflate and the general inflate programs.
_MAX_LAUNCH_ELEMS = 1 << 23


# --------------------------------------------------------------------------
# Host token encoder: the tests' writing oracle.
# --------------------------------------------------------------------------


class _BitWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def bits_lsb(self, value: int, n: int) -> None:
        """n bits of value, LSB first (extra-bits fields, headers)."""
        self.acc |= (value & ((1 << n) - 1)) << self.n
        self.n += n
        while self.n >= 8:
            self.buf.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code_msb(self, code: int, n: int) -> None:
        """A Huffman codeword: its MSB enters the stream first."""
        for i in range(n - 1, -1, -1):
            self.bits_lsb((code >> i) & 1, 1)

    def done(self) -> bytes:
        if self.n:
            self.buf.append(self.acc & 0xFF)
            self.acc = 0
            self.n = 0
        return bytes(self.buf)


def encode_tokens_fixed(tokens: Sequence, final: bool = True) -> bytes:
    """Encode an explicit token list as fixed-Huffman DEFLATE.

    Tokens: ``("lit", byte)``, ``("copy", length, dist)``, or ``("block",)``
    to close the current block (non-final) and open a new fixed block."""
    w = _BitWriter()
    blocks: List[List] = [[]]
    for t in tokens:
        if t[0] == "block":
            blocks.append([])
        else:
            blocks[-1].append(t)
    for bi, blk in enumerate(blocks):
        w.bits_lsb(1 if final and bi == len(blocks) - 1 else 0, 1)
        w.bits_lsb(1, 2)  # btype=01 fixed
        for t in blk:
            if t[0] == "lit":
                w.code_msb(*_fixed_code(t[1]))
                continue
            _, length, dist = t
            li = int(np.searchsorted(LEN_BASE, length, side="right")) - 1
            if LEN_BASE[li] + (1 << LEN_EXTRA[li]) <= length:
                li += 1
            w.code_msb(*_fixed_code(257 + li))
            w.bits_lsb(length - int(LEN_BASE[li]), int(LEN_EXTRA[li]))
            di = int(np.searchsorted(DIST_BASE, dist, side="right")) - 1
            w.code_msb(di, 5)
            w.bits_lsb(dist - int(DIST_BASE[di]), int(DIST_EXTRA[di]))
        w.code_msb(*_fixed_code(256))
    return w.done()


class CodecTierStats:
    """Members per tier of one call: ``lanes`` (a device kernel: the
    deflate or inflate lanes, or the literal-only inflate kernel), ``xla``
    (the reference's array programs: members written by
    :func:`deflate_fixed`, or decoded by :func:`inflate_stored`,
    :func:`inflate_fixed` or :func:`inflate_dynamic`) and ``host``
    (tier-downs and stored members), with the reasons a member left the
    lanes tier: ``tierdown_size`` (past the member cap), ``tierdown_vmem``
    (past the reference's VMEM rule), ``tierdown_ok0`` (the kernel declined
    it) and, for :func:`inflate_blocks_device`, ``tierdown_crc`` (its CRC32
    differed)."""

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


def deflate_fixed(
    payload: torch.Tensor, lens: torch.Tensor, out_bytes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched literal-only fixed-Huffman DEFLATE, as torch ops on
    ``payload``'s device.

    ``payload``: uint8 ``[B, P]`` (rows padded), ``lens``: int ``[B]`` valid
    lengths, ``out_bytes``: output width (at least ``(3 + 9P + 7 + 7) // 8``).
    Returns ``(comp uint8 [B, out_bytes], clens int32 [B])``, the
    reference's bytes: the 3 header bits ``011``, each byte's 8- or 9-bit
    code at the running sum of the code lengths, the 7-bit EOB, zero bits
    after it.  Codes never overlap, so adding each bit-reversed code into
    32-bit words at its bit offset is the bitwise OR of the stream."""
    B, P = payload.shape
    dev = payload.device
    if P == 0:
        payload = torch.zeros((B, 1), dtype=torch.uint8, device=dev)
        P = 1
    b = payload.long()
    valid = torch.arange(P, device=dev)[None, :] < lens.long()[:, None]
    clen = torch.where(valid, torch.where(b >= 144, 9, 8), 0)
    cum = torch.cumsum(clen, dim=1)
    off = 3 + cum - clen
    code = torch.where(valid, torch.as_tensor(_LIT_STREAM_CODE, device=dev)[b], 0) << (off & 31)
    nwords = max(-(-out_bytes // 4), (3 + 9 * P + 14) // 32 + 1) + 1
    words = torch.zeros((B, nwords), dtype=torch.int64, device=dev)
    words[:, 0] = 3  # bfinal = 1, btype = 01
    widx = off >> 5
    words.scatter_add_(1, widx, code & 0xFFFFFFFF)
    words.scatter_add_(1, widx + 1, code >> 32)
    shifts = torch.arange(0, 32, 8, device=dev)
    comp = ((words[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(B, -1)
    clens = (3 + cum[:, -1] + 7 + 7) // 8
    return comp[:, :out_bytes].contiguous(), clens.to(torch.int32)


def _deflate_fixed_rows(
    mat: torch.Tensor, lens: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`deflate_fixed` over padded member rows, chunked so that one
    chunk's ``[rows, P]`` int64 temporaries hold at most
    ``_MAX_LAUNCH_ELEMS`` elements.  Returns ``(comp rows, clens)`` at the
    reference's width ``(3 + 9P + 7 + 7) // 8 + 1``."""
    nblk, P = mat.shape
    out_bytes = (3 + 9 * P + 7 + 7) // 8 + 1
    step = max(1, _MAX_LAUNCH_ELEMS // P)
    parts = [deflate_fixed(mat[g0 : g0 + step], lens[g0 : g0 + step], out_bytes)
             for g0 in range(0, nblk, step)]
    return torch.cat([c for c, _ in parts]), torch.cat([c for _, c in parts])


def _compress_members(
    data,
    block_payload: Optional[int],
    level: int,
    use_lanes: Optional[bool],
    device_input: Optional[torch.Tensor],
    device,
    metrics: Optional[Metrics],
    stats: Optional[CodecTierStats],
    conf=None,
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
    if use_lanes is None:
        if level == 0:
            use_lanes = False
        else:
            dev = dev if dev is not None else resolve_device(device)
            use_lanes = gate("HBAM_DEFLATE_LANES", conf, DEFLATE_LANES, dev.type == "cuda")
    if device_input is not None and (level == 0 or not use_lanes):
        # Stored and literal-only members are cut from host bytes: one
        # visible spill.
        a = device_input.cpu().numpy()
        if dev.type == "cuda":
            metrics.count_d2h(a.nbytes, "write_spill")
        metrics.count("flate.deflate.device_input_spill")
        device_input = None
    if block_payload is None:
        block_payload = DEV_LZ_PAYLOAD if use_lanes else DEV_DEFAULT_PAYLOAD
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
    elif not use_lanes:
        # The literal-only tier: every member on the device, none declined.
        dev = dev if dev is not None else resolve_device(device)
        P = int(lens.max()) if n else 1
        stream = torch.from_numpy(np.require(a, requirements=["C", "W"]))
        if dev.type == "cuda":
            stream = stream.to(dev)
            metrics.count_h2d(n, "deflate_payload")
        mat = torch.nn.functional.pad(stream, (0, nblk * P - n)).view(nblk, P)
        comp, cl = _deflate_fixed_rows(mat, torch.from_numpy(lens).to(dev))
        clens[:] = cl.cpu().numpy()
        rows = comp[:, : int(clens.max())].cpu().numpy()
        if dev.type == "cuda":
            metrics.count_d2h(rows.nbytes + 4 * nblk, "deflate_comp")
        stats.xla += nblk
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
    if faults.ACTIVE is not None and level != 0:
        # The forced tier-down seam: the chosen members go to host zlib
        # whichever tier made them; the framing below stays exact.
        for i in range(nblk):
            if faults.ACTIVE.flate_tierdown("deflate", i, metrics):
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
    use_lanes: Optional[bool] = True,
    device_input: Optional[torch.Tensor] = None,
    device: Optional[Union[str, torch.device]] = None,
    metrics: Optional[Metrics] = None,
    stats: Optional[CodecTierStats] = None,
    conf=None,
) -> bytes:
    """Compress a byte stream into BGZF with the device deflate tiers:
    byte for byte what the reference's ``bgzf_compress_device`` writes.

    1. ``level == 0``: one stored block per member, no device work.
    2. ``use_lanes``: the deflate lanes (``csrc/deflate.cu``); members they
       decline go to host zlib at ``level`` one by one, counted.
    3. Otherwise the literal-only tier, :func:`deflate_fixed` on the
       device: valid fixed-Huffman DEFLATE, every member, counted ``xla``.

    ``use_lanes=None`` resolves through the deflate gate
    (``HBAM_DEFLATE_LANES`` → ``conf``'s ``hadoopbam.deflate.lanes`` → on
    for a CUDA device).  ``data`` is host bytes (uploaded to ``device``,
    default cuda); ``device_input`` (exclusive with ``data``) is a uint8
    tensor already on the device — the device-resident part write: the
    lanes read it in place and the CRC kernel computes the framing's CRC32
    column, so only compressed rows, that column and any tier-down
    members' payloads come back; the stored and literal-only tiers spill
    it to the host once (``flate.deflate.device_input_spill``).  Blocking
    is a member every ``block_payload`` bytes (default
    :data:`DEV_LZ_PAYLOAD` for the lanes, :data:`DEV_DEFAULT_PAYLOAD`
    otherwise, as in the reference).  Tier accounting goes to ``stats``
    and, as ``flate.deflate.*``, to ``metrics``.  An armed fault plan's
    ``flate.deflate.tierdown`` re-deflates the members it picks with host
    zlib (level > 0)."""
    blob, _ = _compress_members(data, block_payload, level, use_lanes, device_input, device,
                                metrics, stats, conf)
    return blob + bgzf.TERMINATOR if append_terminator else blob


def deflate_blocks_device(
    payload,
    level: int = 1,
    block_payload: Optional[int] = None,
    use_lanes: Optional[bool] = True,
    device_input: Optional[torch.Tensor] = None,
    device: Optional[Union[str, torch.device]] = None,
    metrics: Optional[Metrics] = None,
    stats: Optional[CodecTierStats] = None,
    conf=None,
) -> Tuple[bytes, np.ndarray]:
    """The part writer's surface of :func:`bgzf_compress_device`: no
    terminator, and the member sizes come back with the blob,
    ``(blob, sizes)`` (``sizes = clens + 26``), so the ``.splitting-bai``
    offsets follow without re-scanning the blob."""
    return _compress_members(payload, block_payload, level, use_lanes, device_input, device,
                             metrics, stats, conf)


# --------------------------------------------------------------------------
# The general inflate programs: a speculative token decode at every bit
# position, a pointer-doubling chain walk from the block's first token, and
# a pointer-jumping LZ77 resolve, as torch ops on the members' device.
# Values are int64; the reference's uint32 windows keep their 32 bits.
# --------------------------------------------------------------------------


def _token_tables(dev: torch.device):
    return tuple(torch.as_tensor(t, dtype=torch.int64, device=dev) for t in (
        LITLEN_TABLE, DIST_TABLE, LEN_BASE, LEN_EXTRA, DIST_BASE, DIST_EXTRA))


def _bit_window_fn(comp: torch.Tensor, pad: int = 8):
    """``window(bitpos)``: the 32 stream bits at each per-member bit offset
    (``bitpos`` int64, broadcastable to ``[B, ...]``), shifted down.  A byte
    past the padded row reads as the reference's out-of-bounds gather fill
    (all ones), so every verdict matches; bit offsets are never negative."""
    B = comp.shape[0]
    data = torch.cat([comp, comp.new_zeros((B, pad))], dim=1).long()
    n = data.shape[1]

    def window(bitpos: torch.Tensor) -> torch.Tensor:
        bp = bitpos.expand(B, *bitpos.shape[1:])
        flat = bp.reshape(B, -1)
        bi = flat >> 3
        w = torch.zeros_like(flat)
        for k in range(4):
            idx = bi + k
            v = torch.gather(data, 1, idx.clamp(max=n - 1))
            w |= torch.where(idx < n, v, 0xFFFFFFFF) << (8 * k)
        return ((w & 0xFFFFFFFF) >> (flat & 7)).reshape(bp.shape)

    return window


def _chain_walk(nxt: torch.Tensor, start: torch.Tensor, T: int) -> torch.Tensor:
    """``T`` chain positions from ``start`` (int64 ``[B]``) through the jump
    map ``nxt`` by pointer doubling; a terminal token jumps to itself, so
    slots past the chain's end stay there."""
    B, NB = nxt.shape
    t = torch.arange(T, device=nxt.device)
    cur = start.clamp(0, NB - 1)[:, None].expand(B, T)
    jump = nxt
    rounds = max(1, (T - 1).bit_length())
    for k in range(rounds):
        cur = torch.where(((t >> k) & 1)[None, :] == 1, torch.gather(jump, 1, cur), cur)
        if k + 1 < rounds:
            jump = torch.gather(jump, 1, jump)
    return cur


def _coverage(cum_out: torch.Tensor, jj: torch.Tensor, T: int) -> torch.Tensor:
    """The chain slot covering each output position: output byte ``jj``
    belongs to the first token whose cumulative emit exceeds it."""
    B = cum_out.shape[0]
    cov = torch.searchsorted(cum_out.contiguous(), jj.expand(B, *jj.shape[1:]).contiguous(),
                             right=True)
    return cov.clamp(0, T - 1)


def _lz77_resolve(lit_j, val_j, d_j, o_j, covered, j):
    """Materialize every LZ77 copy by pointer jumping: each output byte
    points at a literal or at an earlier byte (``o - d + (j - o) mod d``
    for overlapping copies).  Returns ``(out uint8, neg)``; ``neg`` flags a
    member with a copy reaching before the stream's start."""
    OUT = j.shape[1]
    src = torch.where(lit_j | ~covered, j, o_j - d_j + torch.remainder(j - o_j, d_j))
    neg = (covered & (src < 0)).any(dim=1)
    ptr = src.clamp(0, OUT - 1)
    val0 = torch.where(lit_j, val_j, 0).to(torch.uint8)
    for _ in range(max(1, (OUT - 1).bit_length())):
        ptr = torch.gather(ptr, 1, ptr)
    out = torch.gather(val0, 1, ptr)
    return torch.where(covered, out, 0), neg


def inflate_fixed(
    comp: torch.Tensor,
    clens: torch.Tensor,
    isizes: torch.Tensor,
    out_bytes: int,
    max_cbits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched inflate of all-fixed-Huffman DEFLATE members (literals and
    LZ77 copies, any number of fixed blocks).

    ``comp``: uint8 ``[B, C]``; ``clens``/``isizes``: int ``[B]``;
    ``out_bytes``: output width (at least the largest isize);
    ``max_cbits``: bound on a member's real compressed bits (default the
    padded ``C * 8``), which sizes the chain walk's slot budget
    ``out_bytes + max_cbits // 10 + 8``.  Returns ``(out uint8 [B,
    out_bytes], ok bool [B])``."""
    B, C = comp.shape
    dev = comp.device
    litlen_t, dist_t, len_base, len_extra, dist_base, dist_extra = _token_tables(dev)
    NB = C * 8
    window = _bit_window_fn(comp)
    p = torch.arange(NB, device=dev)[None, :]
    w = window(p)
    t = litlen_t[w & 511]
    sym = t >> 4
    L = t & 15
    islit = sym < 256
    iseob = sym == 256
    islen = (sym > 256) & (sym < 286)
    bad = sym >= 286
    li = (sym - 257).clamp(0, 28)
    lext = len_extra[li]
    lenval = len_base[li] + ((w >> L) & ((1 << lext) - 1))
    wd = window(p + L + lext)  # the distance field follows the length's extra bits
    dsym = dist_t[wd & 31]
    bad = bad | (islen & (dsym >= 30))
    dsym = dsym.clamp(0, 29)
    dext = dist_extra[dsym]
    dist = dist_base[dsym] + ((wd >> 5) & ((1 << dext) - 1))
    # An EOB is terminal iff its code ends in the final byte's padding; a
    # non-final EOB must chain into another fixed block's 3-bit header.
    nbits_real = clens.long()[:, None] * 8
    term = iseob & (p + 15 > nbits_real)
    next_fixed = ((((w >> L) & 7) >> 1) & 3) == 1
    bad = bad | (iseob & ~term & ~next_fixed)
    adv = torch.where(islit, L, torch.where(iseob, L + 3, L + lext + 5 + dext))
    nxt = torch.where(term, p, torch.clamp(p + adv, max=NB - 1))
    emit = torch.where(islit, 1, torch.where(islen, lenval, 0))
    bad = bad | (~term & ((p + adv) > nbits_real))  # a token must end inside the member
    emit = torch.where(bad, 0, emit)

    # Slot budget: every emitting token emits >= 1 byte and every extra
    # block costs >= 10 bits of stream.
    real_bits = NB if max_cbits is None else min(NB, max_cbits)
    T = out_bytes + real_bits // 10 + 8
    cur = _chain_walk(nxt, torch.full((B,), 3, dtype=torch.int64, device=dev), T)
    ok = ~torch.gather(bad, 1, cur).any(dim=1) & torch.gather(term, 1, cur)[:, -1]
    emit_t = torch.gather(emit, 1, cur)
    cum_out = torch.cumsum(emit_t, dim=1)
    out_off_t = cum_out - emit_t
    total = cum_out[:, -1]
    ok = ok & (total == isizes.long()) & (total <= out_bytes)

    j = torch.arange(out_bytes, device=dev)[None, :]
    cov = _coverage(cum_out, j, T)
    tp = torch.gather(cur, 1, cov)  # bit position of the covering token
    covered = j < total[:, None]
    lit_j = torch.gather(islit, 1, tp) & covered
    sym_j = torch.gather(sym, 1, tp)
    d_j = torch.gather(dist, 1, tp).clamp(min=1)
    o_j = torch.gather(out_off_t, 1, cov)
    out, neg = _lz77_resolve(lit_j, sym_j, d_j, o_j, covered, j)
    return out, ok & ~neg


_MAX_STORED_BLOCKS = 8  # zlib level 0 emits at most 3 for a member of <= 64 KiB


def inflate_stored(
    comp: torch.Tensor, clens: torch.Tensor, isizes: torch.Tensor, out_bytes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stored-block members (zlib level 0): a short chain of ``[3-bit
    header | LEN NLEN | raw]`` blocks per member, each byte-aligned, walked
    in lockstep across the batch.  Returns ``(out uint8 [B, out_bytes], ok
    bool [B])``."""
    B, C = comp.shape
    dev = comp.device
    pad = torch.cat([comp, comp.new_zeros((B, 5))], dim=1).long()
    clens = clens.long()
    isizes = isizes.long()
    j = torch.arange(out_bytes, device=dev)[None, :]
    out = torch.zeros((B, out_bytes), dtype=torch.uint8, device=dev)
    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    outp = torch.zeros_like(pos)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    done = torch.zeros_like(ok)

    def at(k: int) -> torch.Tensor:
        # A live member's header lies inside its stream, so clamping the
        # index changes only lanes whose values are unused.
        return torch.gather(pad, 1, (pos[:, None] + k).clamp(max=C + 4))[:, 0]

    for _ in range(_MAX_STORED_BLOCKS):
        hdr = at(0) & 7
        ln = at(1) | (at(2) << 8)
        nln = at(3) | (at(4) << 8)
        live = ~done & ok
        good = ((hdr & 6) == 0) & (ln == (nln ^ 0xFFFF)) & (pos + 5 + ln <= clens)
        ok = torch.where(live, good, ok)
        src = pos[:, None] + 5 + (j - outp[:, None])
        mask = live[:, None] & (j >= outp[:, None]) & (j < (outp + ln)[:, None])
        vals = torch.gather(pad, 1, src.clamp(0, C + 4)).to(torch.uint8)
        out = torch.where(mask, vals, out)
        done = done | (live & ((hdr & 1) == 1))
        pos = torch.where(live, pos + 5 + ln, pos)
        outp = torch.where(live, outp + ln, outp)
    ok = ok & done & (outp == isizes) & (isizes <= out_bytes)
    return torch.where(j < isizes[:, None], out, 0), ok


def _canonical_decoder(lens: torch.Tensor, max_len: int):
    """Canonical-Huffman decode tables from per-symbol code lengths
    (``lens`` int64 ``[B, S]``, 0 = unused): ``(first, count, symoff,
    sym_sorted)``, ``[B, max_len + 1]`` three times and ``[B, S]``.  A code
    of length L with MSB-first value c is symbol ``sym_sorted[symoff[L] + c
    - first[L]]`` iff ``first[L] <= c < first[L] + count[L]``."""
    B, S = lens.shape
    dev = lens.device
    Lr = torch.arange(max_len + 1, device=dev)
    count = ((lens[:, None, :] == Lr[None, :, None]) & (Lr[None, :, None] > 0)).sum(dim=2)
    firsts = [torch.zeros(B, dtype=torch.int64, device=dev)]
    code = firsts[0]
    for L in range(1, max_len + 1):
        code = (code + count[:, L - 1]) << 1
        firsts.append(code)
    first = torch.stack(firsts, dim=1)
    symoff = torch.cumsum(count, dim=1) - count
    key = torch.where(lens > 0, lens * (2 * S) + torch.arange(S, device=dev)[None, :], 1 << 24)
    sym_sorted = torch.argsort(key, dim=1, stable=True)
    return first, count, symoff, sym_sorted


def _kraft_valid(count: torch.Tensor, max_len: int, allow_single: bool = True) -> torch.Tensor:
    """Per-member validity of a canonical table's length histogram: no
    over-subscribed set, and no incomplete one except (as zlib's
    inftrees.c) a single code of length 1 when ``allow_single``."""
    Lr = torch.arange(max_len + 1, device=count.device)
    kraft = (count << (max_len - Lr)[None, :]).sum(dim=1)
    ncodes = count.sum(dim=1)
    ok = (ncodes == 0) | (kraft == (1 << max_len))
    if allow_single:
        ok = ok | ((ncodes == 1) & (count[:, 1] == 1))
    return ok


def _canon_decode(rev: torch.Tensor, tables, max_len: int):
    """Decode MSB-first bit windows (``rev``: the next ``max_len`` stream
    bits, the first in the MSB) against canonical tables: ``(sym, L,
    matched)``; speculative positions may be unmatched."""
    first, count, symoff, sym_sorted = tables
    B = first.shape[0]
    expand = (1,) * (rev.dim() - 1)
    Lsel = torch.full_like(rev, 99)
    for L in range(max_len, 0, -1):  # downward: the smallest L wins last
        cand = rev >> (max_len - L)
        f = first[:, L].reshape(B, *expand)
        c = count[:, L].reshape(B, *expand)
        Lsel = torch.where((cand >= f) & (cand < f + c), L, Lsel)
    matched = Lsel < 99
    Ls = torch.where(matched, Lsel, 1)
    cand = rev >> (max_len - Ls)
    flat = Ls.reshape(B, -1)
    f_s = torch.gather(first, 1, flat).reshape(Ls.shape)
    o_s = torch.gather(symoff, 1, flat).reshape(Ls.shape)
    idx = (o_s + cand - f_s).clamp(0, sym_sorted.shape[1] - 1)
    sym = torch.gather(sym_sorted, 1, idx.reshape(B, -1)).reshape(Ls.shape)
    return sym, Ls, matched


_MAX_HDR_TOKENS = 318  # at most 286 + 30 + 2 RLE tokens fill the code-length section


def inflate_dynamic(
    comp: torch.Tensor,
    clens: torch.Tensor,
    isizes: torch.Tensor,
    out_bytes: int,
    max_blocks: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched inflate of general DEFLATE members: stored, fixed and
    dynamic blocks in any per-member mix, the canonical tables built on the
    device per member and block.

    One block per member per round, at most ``max_blocks`` rounds (a member
    with more fails, for the host tier).  Each round parses the headers
    (a dynamic header's code-length section is a short serial scan),
    decodes a token at every bit position, walks each member's chain from
    its block's first data bit and merges the block's literals and copies
    into member-wide planes; one LZ77 resolve over the planes follows, as
    back references span blocks.  Returns ``(out uint8 [B, out_bytes], ok
    bool [B])``; a row with ok False holds no defined bytes."""
    B, C = comp.shape
    dev = comp.device
    NB = C * 8
    OUT = out_bytes
    _, _, len_base, len_extra, dist_base, dist_extra = _token_tables(dev)
    rev8, clc_order, fixed_ll, fixed_dl = (
        torch.as_tensor(t, dtype=torch.int64, device=dev)
        for t in (REV8, CLC_ORDER, FIXED_LITLEN_LENS, FIXED_DIST_LENS))
    nbits_real = clens.long() * 8
    window = _bit_window_fn(comp)
    bytes_pad = torch.cat([comp, comp.new_zeros((B, 8))], dim=1)

    def rev15(w):
        v = w & 0x7FFF
        return ((rev8[v & 0xFF] << 8) | rev8[v >> 8]) >> 1

    def at(pos: torch.Tensor) -> torch.Tensor:
        return window(pos[:, None])[:, 0]

    p = torch.arange(NB, device=dev)[None, :]
    j = torch.arange(OUT, device=dev)[None, :]
    lit_plane = torch.zeros((B, OUT), dtype=torch.bool, device=dev)
    val_plane = torch.zeros((B, OUT), dtype=torch.uint8, device=dev)
    dst_plane = torch.ones((B, OUT), dtype=torch.int64, device=dev)
    off_plane = torch.zeros((B, OUT), dtype=torch.int64, device=dev)
    bitpos = torch.zeros(B, dtype=torch.int64, device=dev)
    out_base = torch.zeros_like(bitpos)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    done = torch.zeros_like(ok)
    T = OUT + 2  # chain slots per block: every emitting token emits >= 1 byte
    ci = torch.arange(19, device=dev)[None, :]
    m = torch.arange(_MAX_HDR_TOKENS, device=dev).repeat(B, 1)
    li288 = torch.arange(288, device=dev)[None, :]
    di32 = torch.arange(32, device=dev)[None, :]

    for _ in range(max_blocks):
        live = ok & ~done
        if not bool(live.any()):
            break
        hdr = at(bitpos)
        bfinal = (hdr & 1) == 1
        btype = (hdr >> 1) & 3
        ok = ok & (~live | (btype != 3))

        # ---- stored block (btype 00): a byte-aligned raw copy ----------
        sb = ((bitpos + 3 + 7) & ~7) >> 3
        ln_w = at(sb << 3)
        s_len = ln_w & 0xFFFF
        s_nlen = (ln_w >> 16) & 0xFFFF
        stored = live & (btype == 0)
        ok = ok & (~stored | ((s_len == (s_nlen ^ 0xFFFF))
                              & ((sb + 4) * 8 + s_len * 8 <= nbits_real)))
        src_byte = (sb + 4)[:, None] + (j - out_base[:, None])
        s_mask = stored[:, None] & (j >= out_base[:, None]) & (j < (out_base + s_len)[:, None])
        s_vals = torch.gather(bytes_pad, 1, src_byte.clamp(0, C + 7))
        lit_plane = lit_plane | s_mask
        val_plane = torch.where(s_mask, s_vals, val_plane)

        # ---- dynamic header (btype 10) ---------------------------------
        hat = bitpos + 3
        hlit = (at(hat) & 31) + 257
        hdist = (at(hat + 5) & 31) + 1
        hclen = (at(hat + 10) & 15) + 4
        is_dyn = live & (btype == 2)
        ok = ok & (~is_dyn | ((hlit <= 286) & (hdist <= 30)))
        cl_raw = torch.where(ci < hclen[:, None], window(hat[:, None] + 14 + 3 * ci) & 7, 0)
        cl_lens = torch.zeros((B, 19), dtype=torch.int64, device=dev)
        cl_lens[:, clc_order] = cl_raw
        cl_tables = _canonical_decoder(cl_lens, 7)
        ok = ok & (~is_dyn | _kraft_valid(cl_tables[1], 7, allow_single=False))
        total_codes = hlit + hdist

        # The code-length section: one RLE token per step for every member
        # still short of its hlit + hdist lengths.  Only a dynamic block's
        # scan is read, so the scan stops once every dynamic one is done.
        pos = hat + 14 + 3 * hclen
        cnt = torch.zeros_like(bitpos)
        prev = torch.zeros_like(bitpos)
        okh = torch.ones_like(ok)
        reps, vals = [], []
        for _ in range(_MAX_HDR_TOKENS):
            w = at(pos)
            csym, cL, cmatch = _canon_decode(rev8[w & 0x7F] >> 1, cl_tables, 7)
            ext = w >> cL
            rep = torch.where(csym < 16, 1, torch.where(
                csym == 16, 3 + (ext & 3), torch.where(csym == 17, 3 + (ext & 7), 11 + (ext & 127))))
            val = torch.where(csym < 16, csym, torch.where(csym == 16, prev, 0))
            nb = cL + torch.where(csym < 16, 0, torch.where(csym == 16, 2, torch.where(csym == 17, 3, 7)))
            act = cnt < total_codes
            okh = okh & (~act | cmatch)
            pos = pos + torch.where(act, nb, 0)
            cnt = cnt + torch.where(act, rep, 0)
            prev = torch.where(act, val, prev)
            reps.append(torch.where(act, rep, 0))
            vals.append(val)
            if not bool((is_dyn & (cnt < total_codes)).any()):
                break
        ok = ok & (~is_dyn | (okh & (cnt == total_codes)))
        vals_t = torch.stack(vals, dim=1)
        tok_of_m = torch.searchsorted(torch.cumsum(torch.stack(reps, dim=1), dim=1), m, right=True)
        lens_all = torch.gather(vals_t, 1, tok_of_m.clamp(0, vals_t.shape[1] - 1))
        dyn_ll = torch.where(li288 < hlit[:, None],
                             lens_all[:, :288], 0)
        dyn_dl = torch.where(di32 < hdist[:, None], torch.gather(
            lens_all, 1, (hlit[:, None] + di32).clamp(0, _MAX_HDR_TOKENS - 1)), 0)
        use_dyn = (btype == 2)[:, None]
        ll_tables = _canonical_decoder(torch.where(use_dyn, dyn_ll, fixed_ll[None, :]), 15)
        dl_tables = _canonical_decoder(torch.where(use_dyn, dyn_dl, fixed_dl[None, :]), 15)
        ok = ok & (~is_dyn | (_kraft_valid(ll_tables[1], 15) & _kraft_valid(dl_tables[1], 15)))
        data_start = torch.where(btype == 2, pos, bitpos + 3)

        # ---- a token at every bit position -----------------------------
        w = window(p)
        sym, L, matched = _canon_decode(rev15(w), ll_tables, 15)
        islit = matched & (sym < 256)
        iseob = matched & (sym == 256)
        islen = matched & (sym > 256) & (sym < 286)
        bad = ~matched | (sym >= 286)
        li = (sym - 257).clamp(0, 28)
        lext = len_extra[li]
        lenval = len_base[li] + ((w >> L) & ((1 << lext) - 1))
        wd = window(p + L + lext)
        dsym, Ld, dmatch = _canon_decode(rev15(wd), dl_tables, 15)
        bad = bad | (islen & (~dmatch | (dsym >= 30)))
        dsym = dsym.clamp(0, 29)
        dext = dist_extra[dsym]
        dist = dist_base[dsym] + ((wd >> Ld) & ((1 << dext) - 1))
        adv = torch.where(islit | iseob, L, L + lext + Ld + dext)
        nxt = torch.where(iseob, p, torch.clamp(p + adv, max=NB - 1))
        emit = torch.where(islit, 1, torch.where(islen, lenval, 0))
        bad = bad | (~iseob & ((p + adv) > nbits_real[:, None]))
        emit = torch.where(bad, 0, emit)

        # ---- the chain from the block's first data bit ------------------
        cur = _chain_walk(nxt, data_start, T)
        huff = live & ((btype == 1) | (btype == 2))
        reached = torch.gather(iseob, 1, cur)[:, -1]
        ok = ok & (~huff | (~torch.gather(bad, 1, cur).any(dim=1) & reached))
        emit_t = torch.where(huff[:, None], torch.gather(emit, 1, cur), 0)
        cum_out = torch.cumsum(emit_t, dim=1)
        tok_off = out_base[:, None] + cum_out - emit_t
        total = torch.where(huff, cum_out[:, -1], 0)

        # ---- merge the block's coverage into the member planes ----------
        jj = j - out_base[:, None]
        cov = _coverage(cum_out, jj.clamp(0, OUT), T)
        tp = torch.gather(cur, 1, cov)
        in_blk = huff[:, None] & (jj >= 0) & (jj < total[:, None])
        lit_j = torch.gather(islit, 1, tp)
        sym_j = torch.gather(sym, 1, tp).to(torch.uint8)
        lit_plane = torch.where(in_blk, lit_j, lit_plane)
        val_plane = torch.where(in_blk & lit_j, sym_j, val_plane)
        dst_plane = torch.where(in_blk, torch.gather(dist, 1, tp).clamp(min=1), dst_plane)
        off_plane = torch.where(in_blk, torch.gather(tok_off, 1, cov), off_plane)

        # ---- advance past the block ------------------------------------
        eob_pos = cur[:, -1]
        eob_L = torch.gather(L, 1, eob_pos[:, None])[:, 0]
        nxt_bit = torch.where(btype == 0, (sb + 4) * 8 + s_len * 8, eob_pos + eob_L)
        out_base = out_base + torch.where(live, torch.where(stored, s_len, total), 0)
        done = done | (live & bfinal)
        bitpos = torch.where(live, nxt_bit, bitpos)

    ok = ok & done & (out_base == isizes.long()) & (isizes.long() <= OUT)
    covered = j < out_base[:, None]
    out, neg = _lz77_resolve(lit_plane, val_plane, dst_plane, off_plane, covered, j)
    return out, ok & ~neg


# --------------------------------------------------------------------------
# Whole BGZF streams through the inflate tiers.
# --------------------------------------------------------------------------


def _pow2_at_least(n: int, lo: int) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def bgzf_decompress_device(
    data,
    check_crc: bool = True,
    _force_no_host: bool = False,
    conf=None,
    device: Optional[Union[str, torch.device]] = None,
    metrics: Optional[Metrics] = None,
    stats: Optional[CodecTierStats] = None,
) -> bytes:
    """Decompress a whole BGZF stream on ``device`` (default cuda): the
    reference's tiers, in its order, with its verdicts.

    1. Empty members (the EOF terminator) short-circuit.
    2. With the inflate gate on (``HBAM_INFLATE_LANES`` → ``conf``'s
       ``hadoopbam.inflate.lanes`` → on for a CUDA device), every member
       goes through the inflate kernel (``csrc/inflate.cu``) in one launch;
       members it declines continue below (``flate.lanes_tierdown``).
    3. The rest, grouped by the first block's header: on a CUDA device the
       fixed group goes first through the literal-only kernel
       (``csrc/inflate_fixed.cu``, one launch; its rejects count
       ``flate.lockstep_tierdown``); then each group's program,
       :func:`inflate_stored`, :func:`inflate_fixed` or
       :func:`inflate_dynamic`, in ``_MAX_LAUNCH_ELEMS`` chunks.  A stored
       or fixed member its program rejects retries in the dynamic one; a
       dynamic reject is re-decoded by host zlib (raising
       :class:`~..spec.bgzf.BgzfError` if corrupt), or raises under
       ``_force_no_host``.
    4. With ``check_crc``, a member whose CRC32 differs is re-decoded on
       the host (``_force_no_host``: raises).

    Members per tier go to ``stats`` and, as ``flate.inflate.*``, to
    ``metrics``.  An armed fault plan's ``flate.inflate.tierdown`` sends
    the members it picks straight to the host, before step 2.  A kernel
    that fails to build or launch raises."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    metrics = metrics if metrics is not None else Metrics()
    stats = stats if stats is not None else CodecTierStats()
    raw = data if isinstance(data, np.ndarray) else np.frombuffer(data, dtype=np.uint8)
    co, cs, us = bgzf.scan_blocks(raw)
    cs = cs.astype(np.int64)
    us = us.astype(np.int64)
    nblk = len(co)
    outs: List[Optional[bytes]] = [None] * nblk
    # The DEFLATE payload starts at co + 12 + XLEN (BGZF allows extra
    # subfields beside BC).
    xlen = raw[co + 10].astype(np.int64) | (raw[co + 11].astype(np.int64) << 8)
    groups: Dict[str, List[int]] = {"stored": [], "fixed": [], "dyn": []}
    for i in range(nblk):
        if us[i] == 0 and cs[i] <= 22 + xlen[i]:  # an empty DEFLATE payload is <= 2 bytes
            outs[i] = b""
            continue
        hdr3 = int(raw[int(co[i] + 12 + xlen[i])]) & 7
        groups["stored" if hdr3 < 2 else "fixed" if hdr3 < 4 else "dyn"].append(i)
    if faults.ACTIVE is not None:
        # The forced tier-down seam: the chosen members skip every device
        # tier and decode on the host (corrupt data still raises).
        forced = [i for kind in groups for i in groups[kind]
                  if faults.ACTIVE.flate_tierdown("inflate", i, metrics)]
        for i in forced:
            outs[i], _ = bgzf.inflate_block(raw[int(co[i]) : int(co[i] + cs[i])].tobytes(), 0,
                                            check_crc, metrics)
            stats.host += 1
        if forced:
            fset = set(forced)
            for kind in groups:
                groups[kind] = [i for i in groups[kind] if i not in fset]

    if gate("HBAM_INFLATE_LANES", conf, INFLATE_LANES, on_card):
        idx = np.asarray(sorted(groups["stored"] + groups["fixed"] + groups["dyn"]), np.int64)
        if len(idx):
            offs = np.zeros(len(idx) + 1, dtype=np.int64)
            np.cumsum(us[idx], out=offs[1:])
            out, meta, _ = _lanes_decode_members(raw, co[idx], cs[idx], xlen[idx], us[idx],
                                                 offs, dev, metrics)
            good = (meta[:, 1] == 1) & (meta[:, 0] == us[idx])
            for k in np.nonzero(good)[0]:
                outs[int(idx[k])] = out[offs[k] : offs[k + 1]].tobytes()
            n_down = int((~good).sum())
            stats.lanes += len(idx) - n_down
            stats.tierdown_ok0 += n_down
            if n_down:
                metrics.count("flate.lanes_tierdown", n_down)
            for kind in groups:
                groups[kind] = [i for i in groups[kind] if outs[i] is None]

    programs = {"stored": inflate_stored, "fixed": inflate_fixed, "dyn": inflate_dynamic}
    for kind in ("stored", "fixed", "dyn"):
        idx = groups[kind]
        if not idx:
            continue
        clens = (cs[idx] - 20 - xlen[idx]).astype(np.int32)
        isz = us[idx].astype(np.int32)
        C = _pow2_at_least(int(clens.max()), 512)
        OUT = _pow2_at_least(int(isz.max()), 1024)
        comp_np = np.zeros((len(idx), C), dtype=np.uint8)
        for k, i in enumerate(idx):
            s = int(co[i] + 12 + xlen[i])
            comp_np[k, : clens[k]] = raw[s : s + clens[k]]
        comp = torch.from_numpy(comp_np).to(dev)
        gc_all = torch.from_numpy(clens).to(dev)
        gz_all = torch.from_numpy(isz).to(dev)
        if on_card:
            metrics.count_h2d(comp_np.nbytes + 8 * len(idx), "inflate_comp")
        taken = np.zeros(len(idx), dtype=bool)
        if kind == "fixed" and on_card:
            # The literal-only kernel takes what deflate_fixed writes; the
            # rest comes back ok = False for the general program.
            out_l, ok_t = kfix.inflate_fixed_literal(comp, gc_all, gz_all)
            taken = ok_t.cpu().numpy()
            rows = out_l.cpu().numpy()
            metrics.count_d2h(rows.nbytes + len(idx), "inflate_out")
            for k in np.nonzero(taken)[0]:
                outs[idx[k]] = rows[k, : isz[k]].tobytes()
            stats.lanes += int(taken.sum())
            if not taken.all():
                metrics.count("flate.lockstep_tierdown", int((~taken).sum()))
        # One chunk's [members, positions] temporaries stay within
        # _MAX_LAUNCH_ELEMS elements (bit positions, or bytes for stored).
        step = max(1, _MAX_LAUNCH_ELEMS // max(C * 8 if kind != "stored" else C, OUT))
        for g0 in range(0, len(idx), step):
            sl = slice(g0, g0 + step)
            if taken[sl].all():
                continue
            if kind == "fixed":
                cbits = _pow2_at_least(int(clens[sl].max()) * 8, 4096)
                out_t, ok_t = inflate_fixed(comp[sl], gc_all[sl], gz_all[sl], OUT, cbits)
            else:
                out_t, ok_t = programs[kind](comp[sl], gc_all[sl], gz_all[sl], OUT)
            out_d = out_t.cpu().numpy()
            ok = ok_t.cpu().numpy()
            if on_card:
                metrics.count_d2h(out_d.nbytes, "inflate_out")
            for k, i in enumerate(idx[sl]):
                if outs[i] is not None:
                    continue  # the literal-only kernel's
                if ok[k]:
                    outs[i] = out_d[k, : isz[g0 + k]].tobytes()
                    stats.xla += 1
                elif kind != "dyn":
                    # Routing is by the first block; zlib may mix flavors
                    # in one member: the dynamic program takes any mix.
                    groups["dyn"].append(i)
                elif _force_no_host:
                    raise bgzf.BgzfError(f"device inflate failed for member at offset {co[i]}")
                else:
                    outs[i], _ = bgzf.inflate_block(raw, int(co[i]), check_crc)
                    stats.host += 1
    stats.publish(metrics, "flate.inflate")
    if check_crc:
        for i in range(nblk):
            if us[i] == 0:
                continue
            want = struct.unpack_from("<I", raw, int(co[i] + cs[i]) - 8)[0]
            if zlib.crc32(outs[i]) & 0xFFFFFFFF != want:
                if _force_no_host:
                    raise bgzf.BgzfError(f"CRC mismatch in BGZF member at offset {co[i]}")
                outs[i], _ = bgzf.inflate_block(raw, int(co[i]), check_crc=True)
    return b"".join(outs)

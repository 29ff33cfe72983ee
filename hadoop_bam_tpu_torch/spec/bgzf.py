"""BGZF framing: block header parse, block inflate/deflate, batched host codec.

Counterpart of ``hadoop_bam_tpu/spec/bgzf.py`` (header walk, single-block
codec with the ``flate.corrupt`` fault seam, virtual offsets, the EOF
probe, ``BgzfReader`` with its salvage mode, ``BgzfWriter``,
``TERMINATOR``) plus the batched host codec that the reference keeps
in C++ (``hadoop_bam_tpu/native``): here it is Python ``zlib`` over a thread
pool (zlib releases the GIL).  Raw DEFLATE with ``compressobj(level,
DEFLATED, -15, 8, Z_DEFAULT_STRATEGY)`` — the native library's parameters —
so compressed bytes match the reference on one machine.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, List, Optional, Sequence, Tuple

import numpy as np

from .. import faults

MAGIC = b"\x1f\x8b\x08\x04"
_BC_ID = b"BC"
MAX_PAYLOAD = 0xFF00  # 65280, the conventional BGZF input cap
MAX_BLOCK_SIZE = 0x10000  # 65536: BSIZE is a u16 + 1
HEADER_FIXED = 12  # gzip header through XLEN
FOOTER = 8  # CRC32 + ISIZE

#: The 28-byte BGZF EOF terminator (an empty fixed-Huffman member).
TERMINATOR = (
    b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00"
    b"\x1b\x00\x03\x00\x00\x00\x00\x00\x00\x00\x00\x00"
)


class BgzfError(IOError):
    pass


def has_eof_terminator(data) -> bool:
    """Does the stream end with the 28-byte BGZF EOF marker?  A missing
    marker is the signature of a truncated file (htsjdk's
    ``checkTermination``)."""
    return len(data) >= len(TERMINATOR) and bytes(data[-len(TERMINATOR):]) == TERMINATOR


def default_threads() -> int:
    return max(1, os.cpu_count() or 1)


def make_voffset(coffset: int, uoffset: int) -> int:
    return (coffset << 16) | uoffset


def split_voffset(voffset: int) -> Tuple[int, int]:
    return voffset >> 16, voffset & 0xFFFF


def parse_block_header(buf, pos: int = 0) -> Optional[Tuple[int, int]]:
    """``(bsize, xlen)`` of the BGZF block header at ``pos``, or None.

    The BC subfield may sit anywhere in the extra field; the remaining
    subfields must walk to exactly the end of it."""
    if pos + HEADER_FIXED > len(buf) or bytes(buf[pos : pos + 4]) != MAGIC:
        return None
    xlen = struct.unpack_from("<H", buf, pos + 10)[0]
    if pos + HEADER_FIXED + xlen > len(buf):
        return None
    sub = pos + HEADER_FIXED
    end = sub + xlen
    while sub + 4 <= end:
        slen = struct.unpack_from("<H", buf, sub + 2)[0]
        if bytes(buf[sub : sub + 2]) == _BC_ID and slen == 2:
            if sub + 6 > end:
                return None
            bsize = struct.unpack_from("<H", buf, sub + 4)[0] + 1
            if bsize < HEADER_FIXED + xlen + FOOTER or bsize > MAX_BLOCK_SIZE:
                return None
            walk = sub + 6
            while walk < end:
                if walk + 4 > end:
                    return None
                walk += 4 + struct.unpack_from("<H", buf, walk + 2)[0]
            if walk != end:
                return None
            return bsize, xlen
        sub += 4 + slen
    return None


def read_block_at(buf, pos: int) -> Tuple[int, int]:
    """``(csize, usize)`` of the BGZF block at ``pos``, ISIZE-validated."""
    hdr = parse_block_header(buf, pos)
    if hdr is None:
        raise BgzfError(f"bad BGZF block at {pos}")
    if pos + hdr[0] > len(buf):
        raise BgzfError(f"truncated BGZF block at offset {pos}")
    usize = struct.unpack_from("<I", buf, pos + hdr[0] - 4)[0]
    if usize > MAX_BLOCK_SIZE:
        raise BgzfError(f"ISIZE {usize} beyond BGZF bound at {pos}")
    return hdr[0], usize


def find_next_block(buf, start: int, end: Optional[int] = None) -> int:
    """First offset in ``[start, end)`` holding a parseable block header
    whose block fits in ``buf``, or -1."""
    data = bytes(buf) if not isinstance(buf, bytes) else buf
    end = len(data) if end is None else min(end, len(data))
    pos = start
    while pos < end:
        pos = data.find(b"\x1f", pos, end)
        if pos < 0:
            return -1
        hdr = parse_block_header(data, pos)
        if hdr is not None and pos + hdr[0] <= len(data):
            return pos
        pos += 1
    return -1


def is_bgzf(data) -> bool:
    """Does ``data`` begin with a valid BGZF block header?"""
    return parse_block_header(data, 0) is not None


def inflate_block(buf, pos: int = 0, check_crc: bool = True,
                  metrics=None) -> Tuple[bytes, int]:
    """Inflate one BGZF block at ``pos``; returns ``(payload, csize)``.

    The armed fault plan's ``flate.corrupt`` flips a payload byte here,
    before the CRC gate, so the gate, not luck, catches it (counted into
    ``metrics``)."""
    return _inflate_one(buf, pos, check_crc, True, metrics)


def _inflate_one(buf, pos: int, check_crc: bool, seam: bool, metrics=None) -> Tuple[bytes, int]:
    hdr = parse_block_header(buf, pos)
    if hdr is None:
        raise BgzfError(f"not a BGZF block at offset {pos}")
    bsize, xlen = hdr
    if pos + bsize > len(buf):
        raise BgzfError("truncated BGZF block")
    c0 = pos + HEADER_FIXED + xlen
    try:
        payload = zlib.decompress(
            memoryview(buf)[c0 : pos + bsize - FOOTER], wbits=-15
        )
    except zlib.error as e:
        raise BgzfError(f"corrupt deflate stream at offset {pos}: {e}") from e
    if seam and faults.ACTIVE is not None:
        payload = faults.ACTIVE.corrupt_payload(payload, metrics)
    crc, isize = struct.unpack_from("<II", buf, pos + bsize - FOOTER)
    if len(payload) != isize:
        raise BgzfError(f"ISIZE mismatch at {pos}: {len(payload)} != {isize}")
    if check_crc and (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise BgzfError(f"CRC mismatch in BGZF block at {pos}")
    return payload, bsize


def _raw_deflate(payload, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, zlib.Z_DEFAULT_STRATEGY)
    return co.compress(payload) + co.flush(zlib.Z_FINISH)


def compress_block(payload, level: int = 6) -> bytes:
    """Deflate one payload (<= MAX_PAYLOAD bytes) into a full BGZF block;
    a payload that does not fit at ``level`` is stored (level 0)."""
    if len(payload) > MAX_PAYLOAD:
        raise BgzfError(f"payload too large for one BGZF block: {len(payload)}")
    cdata = _raw_deflate(payload, level)
    bsize = len(cdata) + HEADER_FIXED + 6 + FOOTER
    if bsize > MAX_BLOCK_SIZE:
        cdata = _raw_deflate(payload, 0)
        bsize = len(cdata) + HEADER_FIXED + 6 + FOOTER
        if bsize > MAX_BLOCK_SIZE:
            raise BgzfError("cannot fit payload into one BGZF block")
    header = MAGIC + struct.pack("<IBBHBBHH", 0, 0, 0xFF, 6, 0x42, 0x43, 2, bsize - 1)
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return header + cdata + footer


def scan_blocks(data) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(coffsets, csizes, usizes)`` of the back-to-back block chain."""
    co: List[int] = []
    cs: List[int] = []
    us: List[int] = []
    pos = 0
    while pos < len(data):
        csize, usize = read_block_at(data, pos)
        co.append(pos)
        cs.append(csize)
        us.append(usize)
        pos += csize
    return (
        np.asarray(co, dtype=np.int64),
        np.asarray(cs, dtype=np.int32),
        np.asarray(us, dtype=np.int32),
    )


def decompress_all(data) -> bytes:
    """The payload of a whole back-to-back BGZF stream."""
    return inflate_blocks(data, *scan_blocks(data))[0].tobytes()


def inflate_blocks(
    data,
    coffsets: Sequence[int],
    csizes: Sequence[int],
    usizes: Sequence[int],
    check_crc: bool = True,
    threads: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched host inflate: ``(out, out_offsets)`` with block i's payload
    at ``out[out_offsets[i] : out_offsets[i+1]]``.  Raises
    :class:`BgzfError` on any bad member (CRC and ISIZE included)."""
    n = len(coffsets)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.asarray(usizes, dtype=np.int64), out=out_offsets[1:])
    out = np.empty(int(out_offsets[-1]), dtype=np.uint8)

    def one(i: int) -> None:
        # The batched codec stands for the reference's native one: no
        # fault seam here.
        payload, _ = _inflate_one(data, int(coffsets[i]), check_crc, False)
        if len(payload) != out_offsets[i + 1] - out_offsets[i]:
            raise BgzfError(f"inflate failed in block {i}")
        out[out_offsets[i] : out_offsets[i + 1]] = np.frombuffer(payload, np.uint8)

    workers = min(n, threads or default_threads())
    if workers <= 1:
        for i in range(n):
            one(i)
    else:
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(one, range(n)))
    return out, out_offsets


def deflate_blocks(
    payload,
    level: int = 6,
    threads: Optional[int] = None,
    block_payload: int = MAX_PAYLOAD,
) -> Tuple[bytes, np.ndarray]:
    """Batched BGZF compression of a byte stream (no terminator): a member
    every ``block_payload`` bytes.  Returns ``(blob, member_sizes)``."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        a = memoryview(payload).cast("B")
    else:
        a = memoryview(np.ascontiguousarray(payload, dtype=np.uint8))
    n = -(-len(a) // block_payload)
    if n == 0:
        return b"", np.zeros(0, dtype=np.int64)
    cuts = [(i * block_payload, min((i + 1) * block_payload, len(a))) for i in range(n)]
    with ThreadPoolExecutor(min(n, threads or default_threads())) as pool:
        blocks = list(pool.map(lambda c: compress_block(a[c[0] : c[1]], level), cuts))
    return b"".join(blocks), np.asarray([len(b) for b in blocks], dtype=np.int64)


class BgzfReader:
    """Sequential reader addressed by virtual offsets.

    ``source`` is a path, bytes or a binary stream.  ``check_eof``
    (default: on for a path, off for bytes, which may be a window ending
    mid-stream) probes for the EOF terminator at open, setting
    :attr:`truncated` and counting ``bgzf.missing_eof`` into ``metrics``
    when it is absent.  ``errors="salvage"`` makes a final member that
    fails to parse or inflate a clean EOF at the last whole member
    (``salvage.torn_tail``) instead of the strict raise."""

    def __init__(self, source, errors: str = "strict", check_eof: Optional[bool] = None,
                 metrics=None) -> None:
        if isinstance(source, str):
            with open(source, "rb") as f:
                self._data = f.read()
            if check_eof is None:
                check_eof = True
        elif isinstance(source, (bytes, bytearray, memoryview, np.ndarray)):
            self._data = source
        else:
            self._data = source.read()
        if errors not in ("strict", "salvage"):
            raise ValueError(f"errors must be strict|salvage, got {errors!r}")
        self._errors = errors
        self._metrics = metrics
        #: None: not probed (a windowed source); else the missing-EOF flag.
        self.truncated: Optional[bool] = None
        if check_eof:
            self.truncated = not has_eof_terminator(self._data)
            if self.truncated and metrics is not None:
                metrics.count("bgzf.missing_eof", 1)
        self._coffset = 0
        self._uoffset = 0
        self._block: Optional[bytes] = None
        self._block_csize = 0

    def _load(self) -> bool:
        if self._block is not None:
            return True
        if self._coffset >= len(self._data):
            return False
        try:
            self._block, self._block_csize = inflate_block(self._data, self._coffset,
                                                           metrics=self._metrics)
        except BgzfError:
            if self._errors != "salvage":
                raise
            # A torn tail: stop cleanly at the last whole member.
            if self._metrics is not None:
                self._metrics.count("salvage.torn_tail", 1)
            self._coffset = len(self._data)
            return False
        return True

    def seek_voffset(self, voffset: int) -> None:
        co, uo = split_voffset(voffset)
        if co != self._coffset:
            self._coffset = co
            self._block = None
        self._uoffset = uo

    def tell_voffset(self) -> int:
        if self._block is not None and self._uoffset >= len(self._block):
            return (self._coffset + self._block_csize) << 16
        return (self._coffset << 16) | self._uoffset

    def read(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            if not self._load():
                break
            avail = len(self._block) - self._uoffset
            if avail <= 0:
                self._coffset += self._block_csize
                self._uoffset = 0
                self._block = None
                continue
            take = min(avail, n - len(out))
            out += self._block[self._uoffset : self._uoffset + take]
            self._uoffset += take
        return bytes(out)

    def read_fully(self, n: int) -> bytes:
        b = self.read(n)
        if len(b) != n:
            raise BgzfError(f"EOF: wanted {n} bytes, got {len(b)}")
        return b

    @property
    def at_eof(self) -> bool:
        if self._coffset >= len(self._data):
            return True
        if self._block is not None and self._uoffset >= len(self._block):
            return self._coffset + self._block_csize >= len(self._data)
        return False


class BgzfWriter:
    """Block-at-a-time BGZF writer: a member every ``MAX_PAYLOAD`` bytes.
    ``append_terminator=False`` leaves the EOF member off, so part files
    concatenate (BGZFCompressionOutputStream.java:43-46)."""

    def __init__(self, stream: BinaryIO, level: int = 6, append_terminator: bool = True):
        self._stream = stream
        self._level = level
        self._append_terminator = append_terminator
        self._buf = bytearray()
        self._closed = False

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= MAX_PAYLOAD:
            self._flush_block(MAX_PAYLOAD)

    def _flush_block(self, n: int) -> None:
        block = compress_block(bytes(self._buf[:n]), self._level)
        del self._buf[:n]
        self._stream.write(block)

    def flush(self) -> None:
        while self._buf:
            self._flush_block(min(len(self._buf), MAX_PAYLOAD))

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        if self._append_terminator:
            self._stream.write(TERMINATOR)
        self._closed = True

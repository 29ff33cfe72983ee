"""BAM layout: header codec, record build, record chain, SoA decode and keys.

Counterpart of ``hadoop_bam_tpu/spec/bam.py`` for what the coordinate sort
and the CRAM codec need.  :func:`build_record` returns the encoded record
(size word + body); :class:`BamRecord` is the decoded view the CRAM codec
reads and returns (:func:`decode_record` over those bytes).  Sort keys follow BAMRecordReader.java:81-121: ``refIdx << 32 | pos0``
for mapped records, ``INT_MAX << 32 | murmur3(variable bytes)`` for
unmapped ones, with Java's sign extension of a negative low word.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.murmur3 import murmurhash3_int32, murmurhash3_int32_batch

MAGIC = b"BAM\x01"
SEQ_DECODE = "=ACMGRSVTWYHKDBN"
_SEQ_ENCODE = {c: i for i, c in enumerate(SEQ_DECODE)}
_SEQ_NIB_TABLE = bytes(_SEQ_ENCODE.get(chr(b).upper(), 15) for b in range(256))
CIGAR_OPS = "MIDNSHP=X"
_CIGAR_ENCODE = {c: i for i, c in enumerate(CIGAR_OPS)}

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST_OF_PAIR = 0x40
FLAG_SECOND_OF_PAIR = 0x80
FLAG_SECONDARY = 0x100
FLAG_FAIL_QC = 0x200
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800
INT_MAX = 0x7FFFFFFF  # Java Integer.MAX_VALUE, the unmapped refIdx sentinel

_FIXED = struct.Struct("<iiBBHHHIiii")

SOA_FIELDS = (
    "refid", "pos", "flag", "mapq", "bin", "n_cigar_op", "l_read_name",
    "l_seq", "next_refid", "next_pos", "tlen", "rec_off", "rec_len",
)
SOA_NCOLS = len(SOA_FIELDS)


class BamError(IOError):
    pass


@dataclass
class BamHeader:
    """Parsed BAM header: SAM text + binary reference dictionary."""

    text: str
    refs: List[Tuple[str, int]] = field(default_factory=list)

    @property
    def n_refs(self) -> int:
        return len(self.refs)

    def ref_name(self, refid: int) -> str:
        return "*" if refid < 0 else self.refs[refid][0]

    def ref_index(self, name: str) -> int:
        """The reference's index by name; ``*`` is -1; unknown raises
        ``KeyError``."""
        if name == "*":
            return -1
        for i, (n, _) in enumerate(self.refs):
            if n == name:
                return i
        raise KeyError(name)

    def with_sort_order(self, so: str) -> "BamHeader":
        """The header with its @HD SO: field set to ``so`` (a stale GO: is
        dropped; an @HD line is added when missing)."""
        lines = self.text.split("\n")
        hd_seen = False
        for i, line in enumerate(lines):
            if line.startswith("@HD"):
                hd_seen = True
                fields = [
                    f for f in line.split("\t") if not f.startswith(("SO:", "GO:"))
                ]
                fields.append(f"SO:{so}")
                lines[i] = "\t".join(fields)
        if not hd_seen:
            lines.insert(0, f"@HD\tVN:1.6\tSO:{so}")
        return BamHeader("\n".join(lines), list(self.refs))

    def encode(self) -> bytes:
        """Binary header block: magic, l_text, text, n_ref, ref dict."""
        text = self.text.encode()
        out = bytearray(MAGIC)
        out += struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(self.refs))
        for name, length in self.refs:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        return bytes(out)

    @staticmethod
    def decode(buf, pos: int = 0) -> Tuple["BamHeader", int]:
        """Parse the header block at ``pos``: ``(header, offset after it)``."""
        if bytes(buf[pos : pos + 4]) != MAGIC:
            raise BamError("missing BAM magic")
        (l_text,) = struct.unpack_from("<i", buf, pos + 4)
        p = pos + 8
        text = bytes(buf[p : p + l_text]).split(b"\x00", 1)[0].decode()
        p += l_text
        (n_ref,) = struct.unpack_from("<i", buf, p)
        p += 4
        refs: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", buf, p)
            name = bytes(buf[p + 4 : p + 4 + l_name - 1]).decode()
            p += 4 + l_name
            (l_ref,) = struct.unpack_from("<i", buf, p)
            p += 4
            refs.append((name, l_ref))
        return BamHeader(text, refs), p


def header_from_text(text: str) -> BamHeader:
    """Header from SAM text alone: the reference dictionary is rebuilt from
    the ``@SQ`` lines (the CRAM header reader uses this)."""
    refs: List[Tuple[str, int]] = []
    for line in text.split("\n"):
        if line.startswith("@SQ"):
            name: Optional[str] = None
            ln = 0
            for f in line.split("\t")[1:]:
                if f.startswith("SN:"):
                    name = f[3:]
                elif f.startswith("LN:"):
                    ln = int(f[3:])
            refs.append((name or "?", ln))
    return BamHeader(text, refs)


@dataclass
class BamRecord:
    """One alignment; fixed fields decoded, variable tails read from
    ``raw``, the record body (everything after the size word)."""

    refid: int
    pos: int  # 0-based leftmost, -1 if unplaced
    mapq: int
    bin: int
    flag: int
    next_refid: int
    next_pos: int
    tlen: int
    raw: bytes

    @property
    def l_read_name(self) -> int:
        return self.raw[8]

    @property
    def n_cigar_op(self) -> int:
        return struct.unpack_from("<H", self.raw, 12)[0]

    @property
    def l_seq(self) -> int:
        return struct.unpack_from("<I", self.raw, 16)[0]

    @property
    def read_name(self) -> str:
        return self.raw[32 : 32 + self.l_read_name - 1].decode()

    @property
    def cigar(self) -> List[Tuple[int, str]]:
        cig = np.frombuffer(self.raw, dtype="<u4", count=self.n_cigar_op,
                            offset=32 + self.l_read_name)
        return [(int(c) >> 4, CIGAR_OPS[int(c) & 0xF]) for c in cig]

    def cigar_string(self) -> str:
        ops = self.cigar
        return "*" if not ops else "".join(f"{n}{op}" for n, op in ops)

    @property
    def seq(self) -> str:
        l_seq = self.l_seq
        if l_seq == 0:
            return "*"
        off = 32 + self.l_read_name + 4 * self.n_cigar_op
        packed = self.raw[off : off + (l_seq + 1) // 2]
        return "".join(
            SEQ_DECODE[(packed[i // 2] >> 4) if i % 2 == 0 else (packed[i // 2] & 0xF)]
            for i in range(l_seq)
        )

    @property
    def qual(self) -> bytes:
        off = 32 + self.l_read_name + 4 * self.n_cigar_op + (self.l_seq + 1) // 2
        return self.raw[off : off + self.l_seq]

    @property
    def tags_raw(self) -> bytes:
        l_seq = self.l_seq
        return self.raw[32 + self.l_read_name + 4 * self.n_cigar_op + (l_seq + 1) // 2 + l_seq :]

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def alignment_start(self) -> int:
        """1-based leftmost coordinate, 0 if unplaced."""
        return self.pos + 1

    def reference_length(self) -> int:
        """Span on the reference from the CIGAR."""
        return _ref_span(self.cigar)

    def encode(self) -> bytes:
        return struct.pack("<I", len(self.raw)) + self.raw


def decode_record(buf, pos: int = 0) -> Tuple[BamRecord, int]:
    """The record whose size word is at ``pos``: ``(record, offset after)``."""
    if pos + 4 > len(buf):
        raise BamError("truncated record: no block_size")
    (block_size,) = struct.unpack_from("<I", buf, pos)
    body = bytes(buf[pos + 4 : pos + 4 + block_size])
    if len(body) != block_size:
        raise BamError("truncated record body")
    refid, p, _, mapq, bin_, _, flag, _, nrefid, npos, tlen = _FIXED.unpack_from(body, 0)
    return BamRecord(refid, p, mapq, bin_, flag, nrefid, npos, tlen, body), pos + 4 + block_size


def iter_records(buf, pos: int = 0, end: Optional[int] = None) -> Iterator[BamRecord]:
    end = len(buf) if end is None else end
    while pos < end:
        rec, pos = decode_record(buf, pos)
        yield rec


def record_offsets(buf, pos: int = 0, end: Optional[int] = None) -> np.ndarray:
    """Offsets of each record's size word from ``pos`` to ``end``; the
    chain must end exactly at ``end``."""
    end = len(buf) if end is None else end
    offs, resume = record_chain_partial(buf, pos, end)
    if resume != end:
        raise BamError(f"record chain misaligned: ended at {resume} != {end}")
    return offs


def read_header_stream(reader) -> BamHeader:
    """Parse the header from a :class:`~.bgzf.BgzfReader`, leaving it at the
    first record."""
    if reader.read_fully(4) != MAGIC:
        raise BamError("missing BAM magic")
    (l_text,) = struct.unpack("<i", reader.read_fully(4))
    if l_text < 0:
        raise BamError("negative l_text in BAM header")
    text = reader.read_fully(l_text).split(b"\x00", 1)[0].decode()
    (n_ref,) = struct.unpack("<i", reader.read_fully(4))
    if n_ref < 0:
        raise BamError("negative n_ref in BAM header")
    refs: List[Tuple[str, int]] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", reader.read_fully(4))
        if l_name < 1:
            raise BamError("invalid reference name length")
        name = reader.read_fully(l_name)[:-1].decode()
        (l_ref,) = struct.unpack("<i", reader.read_fully(4))
        refs.append((name, l_ref))
    return BamHeader(text, refs)


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning scheme (SAM spec 5.3)."""
    end -= 1
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return base + (beg >> shift)
    return 0


def build_record(
    name: str,
    refid: int,
    pos: int,
    mapq: int,
    flag: int,
    cigar: Sequence[Tuple[int, str]],
    seq: str,
    qual: Union[bytes, str],
    next_refid: int = -1,
    next_pos: int = -1,
    tlen: int = 0,
    tags: bytes = b"",
) -> bytes:
    """One encoded record: u32 block_size + body."""
    name_b = name.encode() + b"\x00"
    if len(name_b) > 255:
        raise BamError("read name too long")
    cigar_b = b"".join(
        struct.pack("<I", (n << 4) | _CIGAR_ENCODE[op]) for n, op in cigar
    )
    l_seq = 0 if seq == "*" else len(seq)
    try:
        nib = seq.encode("latin-1").translate(_SEQ_NIB_TABLE) if l_seq else b""
    except UnicodeEncodeError:  # past latin-1: one character at a time
        nib = bytes(_SEQ_ENCODE.get(c.upper(), 15) for c in seq)
    if l_seq % 2:
        nib += b"\x00"
    arr = np.frombuffer(nib, dtype=np.uint8)
    seq_b = ((arr[0::2] << 4) | arr[1::2]).astype(np.uint8).tobytes()
    if isinstance(qual, str):
        qual_b = b"\xff" * l_seq if qual == "*" else bytes(ord(c) - 33 for c in qual)
    else:
        qual_b = qual if qual else b"\xff" * l_seq
    # An unmapped read's alignment covers a single base for binning.
    span = 1 if flag & FLAG_UNMAPPED else max(1, _ref_span(cigar))
    bin_ = reg2bin(pos, pos + span) if pos >= 0 else 4680
    body = (
        _FIXED.pack(
            refid, pos, len(name_b), mapq, bin_, len(cigar), flag, l_seq,
            next_refid, next_pos, tlen,
        )
        + name_b + cigar_b + seq_b + qual_b + tags
    )
    return struct.pack("<I", len(body)) + body


def _ref_span(cigar: Sequence[Tuple[int, str]]) -> int:
    return sum(n for n, op in cigar if op in "MDN=X")


def record_chain_partial(data, start: int, end: int) -> Tuple[np.ndarray, int]:
    """Offsets of the records that lie whole in ``[start, end)`` plus the
    resume point: where the first record not taken (truncated, or past
    ``end``) starts."""
    unpack = struct.Struct("<I").unpack_from
    offs: List[int] = []
    pos = start
    while pos + 4 <= end:
        (bs,) = unpack(data, pos)
        if pos + 4 + bs > end:
            break
        offs.append(pos)
        pos += 4 + bs
    return np.asarray(offs, dtype=np.int64), pos


def soa_decode(
    data, offsets: np.ndarray, fields: Optional[Sequence[str]] = None
) -> dict:
    """Vectorized fixed-field gather at the records' size-word offsets."""
    a = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    offs = offsets.astype(np.int64)

    def u32(at: np.ndarray) -> np.ndarray:
        return (
            a[at].astype(np.uint32)
            | (a[at + 1].astype(np.uint32) << 8)
            | (a[at + 2].astype(np.uint32) << 16)
            | (a[at + 3].astype(np.uint32) << 24)
        )

    def i32(at: np.ndarray) -> np.ndarray:
        return u32(at).astype(np.int32)

    def u16(at: np.ndarray) -> np.ndarray:
        return (a[at].astype(np.uint16) | (a[at + 1].astype(np.uint16) << 8)).astype(
            np.int32
        )

    body = offs + 4
    cols = {
        "refid": lambda: i32(body),
        "pos": lambda: i32(body + 4),
        "l_read_name": lambda: a[body + 8].astype(np.int32),
        "mapq": lambda: a[body + 9].astype(np.int32),
        "bin": lambda: u16(body + 10),
        "n_cigar_op": lambda: u16(body + 12),
        "flag": lambda: u16(body + 14),
        "l_seq": lambda: i32(body + 16),
        "next_refid": lambda: i32(body + 20),
        "next_pos": lambda: i32(body + 24),
        "tlen": lambda: i32(body + 28),
        "rec_off": lambda: body,
        "rec_len": lambda: u32(offs).astype(np.int64),
    }
    want = SOA_FIELDS if fields is None else tuple(fields)
    return {k: cols[k]() for k in want}


def key0(refidx: np.ndarray, low: np.ndarray) -> np.ndarray:
    """``(long)refIdx << 32 | low`` with Java's sign extension of ``low``."""
    return (refidx.astype(np.int64) << np.int64(32)) | low.astype(np.int64)


def soa_keys(soa: dict, data) -> np.ndarray:
    """int64 sort keys of a decoded SoA batch (the host key path)."""
    refid = soa["refid"].astype(np.int64)
    pos = soa["pos"].astype(np.int64)
    keys = key0(refid, pos)
    unmapped = ((soa["flag"] & FLAG_UNMAPPED) != 0) | (refid < 0) | (pos + 1 < 0)
    rows = np.nonzero(unmapped)[0]
    if len(rows):
        off = np.asarray(soa["rec_off"], dtype=np.int64)[rows] + 32
        ln = np.maximum(np.asarray(soa["rec_len"], dtype=np.int64)[rows] - 32, 0)
        h = murmurhash3_int32_batch(np.asarray(data), off, ln, 0)
        keys[rows] = key0(np.full(len(rows), INT_MAX, dtype=np.int64), h)
    return keys


def alignment_key(rec: BamRecord) -> int:
    """One record's sort key: ``refIdx << 32 | pos0`` when mapped, else
    ``INT_MAX << 32 | murmur3(the bytes after the 32-byte fixed prefix)``."""
    if rec.is_unmapped or rec.refid < 0 or rec.alignment_start < 0:
        low = murmurhash3_int32(rec.raw[32:], 0)
        return int(key0(np.asarray([INT_MAX]), np.asarray([low]))[0])
    return int(key0(np.asarray([rec.refid]), np.asarray([rec.pos]))[0])


def read_bam(path_or_bytes: Union[str, bytes]) -> Tuple[BamHeader, List[BamRecord]]:
    """Every record of a whole BAM (path or bytes), with its header."""
    from . import bgzf

    if isinstance(path_or_bytes, str):
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    else:
        raw = path_or_bytes
    data = bgzf.decompress_all(raw)
    header, p = BamHeader.decode(data)
    return header, list(iter_records(data, p))


def write_bam(
    stream: BinaryIO,
    header: BamHeader,
    records: Iterator[BamRecord],
    level: int = 6,
    append_terminator: bool = True,
    write_header: bool = True,
) -> None:
    from . import bgzf

    w = bgzf.BgzfWriter(stream, level=level, append_terminator=append_terminator)
    if write_header:
        w.write(header.encode())
    for rec in records:
        w.write(rec.encode())
    w.close()

"""CRAM format: framing, containers, blocks, slices, record codec.

Counterpart of ``hadoop_bam_tpu/spec/cram.py``, whole: container iteration
for split planning, record decode (CRAM 2.1 and 3.0, reference-based and
no-ref) and container emission (3.0, external encodings, detached mates,
no-ref bases).  Records are :class:`~.bam.BamRecord` views over the bytes
:func:`~.bam.build_record` encodes.  A container's blocks decompress in one
``cram_codecs.decompress_batch`` call, through a
:class:`~hadoop_bam_tpu_torch.device_stream.DeviceStream` when one is given.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"CRAM"
FILE_DEFINITION_LEN = 26  # magic + 2 version bytes + 20-byte file id


class CramError(IOError):
    pass


def read_itf8(buf: bytes, pos: int) -> Tuple[int, int]:
    """CRAM ITF8 varint → (value, new_pos)."""
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | buf[pos + 1], pos + 2
    if b0 < 0xE0:
        return ((b0 & 0x3F) << 16) | (buf[pos + 1] << 8) | buf[pos + 2], pos + 3
    if b0 < 0xF0:
        return (
            ((b0 & 0x1F) << 24)
            | (buf[pos + 1] << 16)
            | (buf[pos + 2] << 8)
            | buf[pos + 3]
        ), pos + 4
    v = (
        ((b0 & 0x0F) << 28)
        | (buf[pos + 1] << 20)
        | (buf[pos + 2] << 12)
        | (buf[pos + 3] << 4)
        | (buf[pos + 4] & 0x0F)
    )
    # sign: ITF8 carries int32 values
    if v >= 1 << 31:
        v -= 1 << 32
    return v, pos + 5


def read_ltf8(buf: bytes, pos: int) -> Tuple[int, int]:
    """CRAM LTF8 varint (int64) → (value, new_pos)."""
    b0 = buf[pos]
    n_extra = 0
    probe = 0x80
    while n_extra < 8 and b0 & probe:
        n_extra += 1
        probe >>= 1
    if n_extra == 0:
        return b0, pos + 1
    if n_extra < 8:
        v = b0 & (0xFF >> (n_extra + 1))
    else:
        v = 0
    for i in range(n_extra):
        v = (v << 8) | buf[pos + 1 + i]
    if v >= 1 << 63:
        v -= 1 << 64
    return v, pos + 1 + n_extra


@dataclass
class ContainerHeader:
    offset: int  # file offset of this container
    length: int  # byte length of the container's block data
    ref_seq_id: int
    start_pos: int
    align_span: int
    n_records: int
    record_counter: int
    bases: int
    n_blocks: int
    landmarks: List[int]
    header_size: int  # bytes consumed by this header itself

    @property
    def next_offset(self) -> int:
        return self.offset + self.header_size + self.length

    @property
    def is_eof(self) -> bool:
        """EOF container: ref -1, 0 records/blocks... htsjdk detects via
        content; the spec's v3 EOF has ref_seq_id=-1 and n_records=0."""
        return self.ref_seq_id == -1 and self.n_records == 0 and self.n_blocks <= 1


def parse_file_definition(data: bytes) -> Tuple[int, int]:
    """Returns (major, minor) version; validates the magic."""
    if data[:4] != MAGIC:
        raise CramError("missing CRAM magic")
    return data[4], data[5]


def parse_container_header(
    data: bytes, pos: int, major: int
) -> ContainerHeader:
    start = pos
    if pos + 4 > len(data):
        raise CramError(f"truncated container header at {pos}")
    (length,) = struct.unpack_from("<i", data, pos)
    pos += 4
    ref_seq_id, pos = read_itf8(data, pos)
    start_pos, pos = read_itf8(data, pos)
    align_span, pos = read_itf8(data, pos)
    n_records, pos = read_itf8(data, pos)
    record_counter, pos = read_ltf8(data, pos)
    bases, pos = read_ltf8(data, pos)
    n_blocks, pos = read_itf8(data, pos)
    n_landmarks, pos = read_itf8(data, pos)
    landmarks = []
    for _ in range(n_landmarks):
        lm, pos = read_itf8(data, pos)
        landmarks.append(lm)
    if major >= 3:
        pos += 4  # crc32
    return ContainerHeader(
        offset=start,
        length=length,
        ref_seq_id=ref_seq_id,
        start_pos=start_pos,
        align_span=align_span,
        n_records=n_records,
        record_counter=record_counter,
        bases=bases,
        n_blocks=n_blocks,
        landmarks=landmarks,
        header_size=pos - start,
    )


def iter_containers(data: bytes) -> List[ContainerHeader]:
    """All container headers incl. the EOF container (CramContainerIterator
    equivalent)."""
    major, _ = parse_file_definition(data)
    out: List[ContainerHeader] = []
    pos = FILE_DEFINITION_LEN
    while pos < len(data):
        hdr = parse_container_header(data, pos, major)
        out.append(hdr)
        pos = hdr.next_offset
    if pos != len(data):
        raise CramError("container chain misaligned")
    return out


def container_offsets(data: bytes) -> List[int]:
    """Start offsets of data containers (first = the CRAM header container)."""
    return [c.offset for c in iter_containers(data)]


# ---------------------------------------------------------------------------
# Varint writers
# ---------------------------------------------------------------------------


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes(
            [0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF]
        )
    return bytes(
        [
            0xF0 | (v >> 28),
            (v >> 20) & 0xFF,
            (v >> 12) & 0xFF,
            (v >> 4) & 0xFF,
            v & 0x0F,
        ]
    )


def write_ltf8(v: int) -> bytes:
    """n leading 1-bits in the first byte announce n extra bytes; the first
    byte's low ``7-n`` bits carry the value's top bits (read_ltf8 inverse)."""
    v &= 0xFFFFFFFFFFFFFFFF
    for n_extra in range(8):
        if v < 1 << (7 + 7 * n_extra):
            ones = (0xFF << (8 - n_extra)) & 0xFF
            b0 = ones | (v >> (8 * n_extra))
            rest = [(v >> (8 * i)) & 0xFF for i in range(n_extra - 1, -1, -1)]
            return bytes([b0] + rest)
    return bytes([0xFF]) + v.to_bytes(8, "big")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5


@dataclass
class BlockFrame:
    """One block's parsed frame with the payload still compressed — the
    split that lets ``decode_container`` batch every block of a
    container through one ``cram_codecs.decompress_batch`` call (the
    rANS-lanes seam) instead of inflating inline one at a time."""

    method: int
    content_type: int
    content_id: int
    payload: bytes
    raw_size: int


@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    raw: bytes  # uncompressed payload

    @staticmethod
    def read_frame(
        data: bytes, pos: int, major: int
    ) -> Tuple[BlockFrame, int]:
        method = data[pos]
        ctype = data[pos + 1]
        pos += 2
        cid, pos = read_itf8(data, pos)
        csize, pos = read_itf8(data, pos)
        rsize, pos = read_itf8(data, pos)
        payload = data[pos : pos + csize]
        if len(payload) != csize:
            raise CramError("truncated block")
        pos += csize
        if major >= 3:
            pos += 4  # crc32
        return BlockFrame(method, ctype, cid, payload, rsize), pos

    @staticmethod
    def finish(frame: BlockFrame, raw: bytes) -> "Block":
        if len(raw) != frame.raw_size:
            raise CramError(
                f"block inflates to {len(raw)}, declared {frame.raw_size}"
            )
        return Block(frame.method, frame.content_type, frame.content_id, raw)

    @staticmethod
    def read(data: bytes, pos: int, major: int) -> Tuple["Block", int]:
        from . import cram_codecs

        frame, pos = Block.read_frame(data, pos, major)
        raw = cram_codecs.decompress(
            frame.method, frame.payload, frame.raw_size
        )
        return Block.finish(frame, raw), pos

    def write(self, major: int, method: Optional[int] = None) -> bytes:
        from . import cram_codecs

        m = self.method if method is None else method
        comp = cram_codecs.compress(m, self.raw)
        if len(comp) >= len(self.raw) and m != 0:
            m, comp = 0, self.raw  # store raw when compression doesn't pay
        out = bytearray()
        out.append(m)
        out.append(self.content_type)
        out += write_itf8(self.content_id)
        out += write_itf8(len(comp))
        out += write_itf8(len(self.raw))
        out += comp
        if major >= 3:
            out += struct.pack("<I", zlib.crc32(bytes(out)))
        return bytes(out)


# ---------------------------------------------------------------------------
# Compression header
# ---------------------------------------------------------------------------

_BASES = b"ACGTN"
_DEFAULT_SUB = bytes([0x1B, 0x1B, 0x1B, 0x1B, 0x1B])  # identity ranking


def _sub_code_to_base(matrix: bytes, ref_base: int) -> Dict[int, int]:
    """code (0..3) → substituted base, for one reference base."""
    try:
        r = _BASES.index(ref_base)
    except ValueError:
        r = 4
    alts = [b for b in _BASES if b != _BASES[r]] if r < 5 else list(_BASES[:4])
    byte = matrix[r]
    out = {}
    for alt_idx, alt in enumerate(alts):
        code = (byte >> (6 - 2 * alt_idx)) & 3
        out[code] = alt
    return out


class CompressionHeader:
    """Preservation map + data-series/tag encoding maps."""

    def __init__(self):
        self.rn_preserved = True
        self.ap_delta = True
        self.rr_required = True
        self.sub_matrix = _DEFAULT_SUB
        self.td: List[List[Tuple[bytes, int]]] = [[]]  # [(2-byte tag, type)]
        self.encodings: Dict[str, "object"] = {}
        self.tag_encodings: Dict[int, "object"] = {}

    @staticmethod
    def parse(raw: bytes) -> "CompressionHeader":
        from .cram_codecs import parse_encoding

        ch = CompressionHeader()
        pos = 0
        # preservation map
        _size, pos = read_itf8(raw, pos)
        nmap, pos = read_itf8(raw, pos)
        for _ in range(nmap):
            key = raw[pos : pos + 2].decode("latin-1")
            pos += 2
            if key == "RN":
                ch.rn_preserved = raw[pos] != 0
                pos += 1
            elif key == "AP":
                ch.ap_delta = raw[pos] != 0
                pos += 1
            elif key == "RR":
                ch.rr_required = raw[pos] != 0
                pos += 1
            elif key == "SM":
                ch.sub_matrix = bytes(raw[pos : pos + 5])
                pos += 5
            elif key == "TD":
                ln, pos = read_itf8(raw, pos)
                blob = bytes(raw[pos : pos + ln])
                pos += ln
                ch.td = []
                for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                    entries = [
                        (line[i : i + 2], line[i + 2])
                        for i in range(0, len(line), 3)
                    ]
                    ch.td.append(entries)
                if not ch.td:
                    ch.td = [[]]
            else:
                raise CramError(f"unknown preservation key {key!r}")
        # data series encodings
        _size, pos = read_itf8(raw, pos)
        nenc, pos = read_itf8(raw, pos)
        for _ in range(nenc):
            key = raw[pos : pos + 2].decode("latin-1")
            pos += 2
            enc, pos = parse_encoding(raw, pos)
            ch.encodings[key] = enc
        # tag encodings
        _size, pos = read_itf8(raw, pos)
        ntag, pos = read_itf8(raw, pos)
        for _ in range(ntag):
            key, pos = read_itf8(raw, pos)
            enc, pos = parse_encoding(raw, pos)
            ch.tag_encodings[key] = enc
        return ch

    def series(self, key: str):
        enc = self.encodings.get(key)
        if enc is None:
            raise CramError(f"no encoding for data series {key}")
        return enc


# ---------------------------------------------------------------------------
# Slice header
# ---------------------------------------------------------------------------


@dataclass
class SliceHeader:
    ref_seq_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_blocks: int
    content_ids: List[int]
    embedded_ref_id: int
    md5: bytes

    @staticmethod
    def parse(raw: bytes, major: int) -> "SliceHeader":
        pos = 0
        ref_seq_id, pos = read_itf8(raw, pos)
        start, pos = read_itf8(raw, pos)
        span, pos = read_itf8(raw, pos)
        n_records, pos = read_itf8(raw, pos)
        if major >= 3:
            counter, pos = read_ltf8(raw, pos)
        else:
            counter, pos = read_itf8(raw, pos)
        n_blocks, pos = read_itf8(raw, pos)
        nids, pos = read_itf8(raw, pos)
        ids = []
        for _ in range(nids):
            v, pos = read_itf8(raw, pos)
            ids.append(v)
        emb, pos = read_itf8(raw, pos)
        md5 = bytes(raw[pos : pos + 16])
        return SliceHeader(
            ref_seq_id, start, span, n_records, counter, n_blocks, ids, emb, md5
        )

    def encode(self, major: int) -> bytes:
        out = bytearray()
        out += write_itf8(self.ref_seq_id)
        out += write_itf8(self.start)
        out += write_itf8(self.span)
        out += write_itf8(self.n_records)
        out += (write_ltf8 if major >= 3 else write_itf8)(self.record_counter)
        out += write_itf8(self.n_blocks)
        out += write_itf8(len(self.content_ids))
        for cid in self.content_ids:
            out += write_itf8(cid)
        out += write_itf8(self.embedded_ref_id)
        out += self.md5
        return bytes(out)


# ---------------------------------------------------------------------------
# EOF containers (spec constants)
# ---------------------------------------------------------------------------

EOF_V3 = bytes.fromhex(
    "0f000000ffffffff0fe0454f460000000000010005bdd94f"
    "0001000606010001000100ee63014b"
)
EOF_V2 = bytes.fromhex(
    "0b000000ffffffffffe0454f4600000000010000010006"
    "06010001000100"
)


def is_eof_marker(data: bytes, pos: int) -> bool:
    rest = data[pos:]
    return rest == EOF_V3 or rest == EOF_V2


# ---------------------------------------------------------------------------
# Record decode
# ---------------------------------------------------------------------------

# CRAM record flags (CF)
CF_QS_STORED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8  # v3: unknown bases

# CRAM mate flags (MF)
MF_MATE_NEG_STRAND = 0x1
MF_MATE_UNMAPPED = 0x2

from .bam import (  # noqa: E402  (cycle-free: bam does not import cram)
    BamRecord,
    FLAG_MATE_REVERSE,
    FLAG_MATE_UNMAPPED,
    FLAG_REVERSE,
    FLAG_UNMAPPED,
    decode_record,
)
from .bam import build_record as _encode_record  # noqa: E402


def build_record(**fields) -> BamRecord:
    """The record of the given fields, as a :class:`BamRecord` over the
    bytes :func:`~.bam.build_record` encodes."""
    return decode_record(_encode_record(**fields))[0]


@dataclass
class _CramRec:
    bf: int = 0
    cf: int = 0
    refid: int = -1
    rl: int = 0
    ap: int = 0  # 1-based
    rg: int = -1
    name: bytes = b""
    mf: int = 0
    ns: int = -1
    np: int = 0
    ts: int = 0
    nf: int = -1
    tags: bytes = b""
    features: List[Tuple[int, str, object]] = field(default_factory=list)
    mq: int = 0
    quals: bytes = b""
    bases: object = b""  # reconstructed (bytes or str)
    _cigar: Optional[List[Tuple[int, str]]] = None


def _decode_slice_records(
    major: int,
    comp: CompressionHeader,
    sh: SliceHeader,
    ctx,
    ref_getter: Optional[Callable[[int], bytes]],
) -> List[BamRecord]:
    E = comp.series
    recs: List[_CramRec] = []
    prev_ap = sh.start
    for rec_i in range(sh.n_records):
        r = _CramRec()
        if not comp.rn_preserved:
            # deterministic generated name from the global record counter
            # (htslib lossy-names behavior); mates are renamed to match
            # during NF linking below
            r.name = str(sh.record_counter + rec_i).encode()
        r.bf = E("BF").read_int(ctx)
        r.cf = E("CF").read_int(ctx)
        r.refid = (
            E("RI").read_int(ctx) if sh.ref_seq_id == -2 else sh.ref_seq_id
        )
        r.rl = E("RL").read_int(ctx)
        if comp.ap_delta:
            r.ap = prev_ap + E("AP").read_int(ctx)
            prev_ap = r.ap
        else:
            r.ap = E("AP").read_int(ctx)
        r.rg = E("RG").read_int(ctx)
        if comp.rn_preserved:
            r.name = E("RN").read_bytes(ctx)
        if r.cf & CF_DETACHED:
            r.mf = E("MF").read_int(ctx)
            if not comp.rn_preserved:
                r.name = E("RN").read_bytes(ctx)
            r.ns = E("NS").read_int(ctx)
            r.np = E("NP").read_int(ctx)
            r.ts = E("TS").read_int(ctx)
        elif r.cf & CF_MATE_DOWNSTREAM:
            r.nf = E("NF").read_int(ctx)
        # tags
        tl = E("TL").read_int(ctx)
        if "TL" not in comp.encodings and ("TC" in comp.encodings):
            raise CramError("CRAM 2.0 TC/TN tag layout not supported")
        tag_bytes = bytearray()
        for tag, ttype in comp.td[tl]:
            key = (tag[0] << 16) | (tag[1] << 8) | ttype
            enc = comp.tag_encodings.get(key)
            if enc is None:
                raise CramError(f"no tag encoding for {tag}:{chr(ttype)}")
            val = enc.read_bytes(ctx)
            tag_bytes += tag + bytes([ttype]) + val
        r.tags = bytes(tag_bytes)
        if not (r.bf & FLAG_UNMAPPED):
            fn = E("FN").read_int(ctx)
            fpos = 0
            for _f in range(fn):
                fc = chr(E("FC").read_byte(ctx))
                fpos += E("FP").read_int(ctx)
                if fc == "X":
                    payload: object = E("BS").read_byte(ctx)
                elif fc == "I":
                    payload = E("IN").read_bytes(ctx)
                elif fc == "S":
                    payload = E("SC").read_bytes(ctx)
                elif fc == "b":
                    payload = E("BB").read_bytes(ctx)
                elif fc == "q":
                    payload = E("QQ").read_bytes(ctx)
                elif fc == "B":
                    payload = (
                        E("BA").read_byte(ctx),
                        E("QS").read_byte(ctx),
                    )
                elif fc == "i":
                    payload = E("BA").read_byte(ctx)
                elif fc == "Q":
                    payload = E("QS").read_byte(ctx)
                elif fc == "D":
                    payload = E("DL").read_int(ctx)
                elif fc == "N":
                    payload = E("RS").read_int(ctx)
                elif fc == "H":
                    payload = E("HC").read_int(ctx)
                elif fc == "P":
                    payload = E("PD").read_int(ctx)
                else:
                    raise CramError(f"unknown feature code {fc!r}")
                r.features.append((fpos, fc, payload))
            r.mq = E("MQ").read_int(ctx)
            if r.cf & CF_QS_STORED:
                r.quals = E("QS").read_byte_run(ctx, r.rl)
            if not comp.rr_required:
                # no-ref mode drains the BA series *inside* the record's
                # decode turn (htslib cram_decode_seq ordering)
                r.bases, r._cigar = _reconstruct_mapped(
                    r, comp, ctx, ref_getter
                )
        else:
            if not (r.cf & CF_NO_SEQ):
                r.bases = E("BA").read_byte_run(ctx, r.rl)
            if r.cf & CF_QS_STORED:
                r.quals = E("QS").read_byte_run(ctx, r.rl)
        recs.append(r)

    # mate linking within the slice (non-detached pairs)
    for i, r in enumerate(recs):
        if r.nf >= 0:
            j = i + r.nf + 1
            if j >= len(recs):
                raise CramError("NF mate index out of slice")
            m = recs[j]
            if not comp.rn_preserved:
                m.name = r.name  # mates share the generated name
            r.ns, r.np, m.ns, m.np = m.refid, m.ap, r.refid, r.ap
            if m.bf & FLAG_REVERSE:
                r.mf |= MF_MATE_NEG_STRAND
            if m.bf & FLAG_UNMAPPED:
                r.mf |= MF_MATE_UNMAPPED
            if r.bf & FLAG_REVERSE:
                m.mf |= MF_MATE_NEG_STRAND
            if r.bf & FLAG_UNMAPPED:
                m.mf |= MF_MATE_UNMAPPED
            # template span: leftmost positive, rightmost negative
            left, right = (r, m) if r.ap <= m.ap else (m, r)
            span = (
                right.ap
                + _read_span_from_features(right)
                - 1
                - left.ap
                + 1
            )
            left.ts, right.ts = span, -span

    out: List[BamRecord] = []
    for r in recs:
        out.append(_to_bam(r, comp, ctx, ref_getter))
    return out


def _read_span_from_features(r: _CramRec) -> int:
    span = r.rl
    for _pos, fc, payload in r.features:
        if fc == "I":
            span -= len(payload)  # type: ignore[arg-type]
        elif fc == "i":
            span -= 1
        elif fc == "S":
            span -= len(payload)  # type: ignore[arg-type]
        elif fc == "D" or fc == "N":
            span += int(payload)  # type: ignore[arg-type]
    return max(span, 1)


def _to_bam(
    r: _CramRec,
    comp: CompressionHeader,
    ctx,
    ref_getter: Optional[Callable[[int], bytes]],
) -> BamRecord:
    flag = r.bf
    if r.mf & MF_MATE_NEG_STRAND:
        flag |= FLAG_MATE_REVERSE
    if r.mf & MF_MATE_UNMAPPED:
        flag |= FLAG_MATE_UNMAPPED
    name = r.name.decode("latin-1")
    if r.bf & FLAG_UNMAPPED:
        seq = r.bases.decode("latin-1") if r.bases else "*"
        qual = r.quals if r.quals else b""
        rec = build_record(
            name=name,
            refid=r.refid,
            pos=r.ap - 1,
            mapq=r.mq,
            flag=flag,
            cigar=[],
            seq=seq,
            qual=qual,
            next_refid=r.ns,
            next_pos=r.np - 1,
            tlen=r.ts,
            tags=r.tags,
        )
        return rec
    if r._cigar is not None:  # no-ref: already reconstructed inline
        seq, cigar = r.bases, r._cigar
    else:
        seq, cigar = _reconstruct_mapped(r, comp, ctx, ref_getter)
    return build_record(
        name=name,
        refid=r.refid,
        pos=r.ap - 1,
        mapq=r.mq,
        flag=flag,
        cigar=cigar,
        seq=seq,
        qual=r.quals,
        next_refid=r.ns,
        next_pos=r.np - 1,
        tlen=r.ts,
        tags=r.tags,
    )


def _reconstruct_mapped(
    r: _CramRec,
    comp: CompressionHeader,
    ctx,
    ref_getter: Optional[Callable[[int], bytes]],
):
    """Features + (reference | BA series) → (seq, cigar).

    Mirrors the reference-based reconstruction of htslib's cram_decode_seq:
    positions not covered by features come from the reference when RR=true,
    from the BA data series when RR=false (no-ref mode).
    """
    E = comp.series
    bases = bytearray(b"N" * r.rl)
    covered = bytearray(r.rl)  # 1 = provided by a feature
    cigar_ops: List[Tuple[int, str]] = []
    ref = None
    if comp.rr_required:
        if ref_getter is None:
            raise CramError(
                "CRAM slice requires the reference; configure "
                "hadoopbam.cram.reference-source-path"
            )
        ref = ref_getter(r.refid)

    def push(op: str, n: int) -> None:
        if n <= 0:
            return
        if cigar_ops and cigar_ops[-1][1] == op:
            cigar_ops[-1] = (cigar_ops[-1][0] + n, op)
        else:
            cigar_ops.append((n, op))

    rpos = 0  # read cursor (0-based)
    ref_cursor = r.ap - 1  # 0-based reference position
    sub_cache: Dict[int, Dict[int, int]] = {}
    for fpos, fc, payload in sorted(r.features, key=lambda t: t[0]):
        gap = (fpos - 1) - rpos
        if gap > 0:
            _fill_match(bases, covered, rpos, gap, ref, ref_cursor)
            push("M", gap)
            rpos += gap
            ref_cursor += gap
        if fc == "S":
            sc = payload  # type: ignore[assignment]
            bases[rpos : rpos + len(sc)] = sc
            for k in range(len(sc)):
                covered[rpos + k] = 1
            push("S", len(sc))
            rpos += len(sc)
        elif fc == "X":
            ref_base = ref[ref_cursor] if ref is not None else ord("N")
            ref_base = _upper(ref_base)
            codes = sub_cache.get(ref_base)
            if codes is None:
                codes = _sub_code_to_base(comp.sub_matrix, ref_base)
                sub_cache[ref_base] = codes
            bases[rpos] = codes.get(int(payload), ord("N"))  # type: ignore[arg-type]
            covered[rpos] = 1
            push("M", 1)
            rpos += 1
            ref_cursor += 1
        elif fc == "I":
            ins = payload  # type: ignore[assignment]
            bases[rpos : rpos + len(ins)] = ins
            for k in range(len(ins)):
                covered[rpos + k] = 1
            push("I", len(ins))
            rpos += len(ins)
        elif fc == "i":
            bases[rpos] = int(payload)  # type: ignore[arg-type]
            covered[rpos] = 1
            push("I", 1)
            rpos += 1
        elif fc == "b":
            bb = payload  # type: ignore[assignment]
            bases[rpos : rpos + len(bb)] = bb
            for k in range(len(bb)):
                covered[rpos + k] = 1
            push("M", len(bb))
            rpos += len(bb)
            ref_cursor += len(bb)
        elif fc == "B":
            b, _q = payload  # type: ignore[misc]
            bases[rpos] = b
            covered[rpos] = 1
            push("M", 1)
            rpos += 1
            ref_cursor += 1
        elif fc == "D":
            push("D", int(payload))  # type: ignore[arg-type]
            ref_cursor += int(payload)  # type: ignore[arg-type]
        elif fc == "N":
            push("N", int(payload))  # type: ignore[arg-type]
            ref_cursor += int(payload)  # type: ignore[arg-type]
        elif fc == "H":
            push("H", int(payload))  # type: ignore[arg-type]
        elif fc == "P":
            push("P", int(payload))  # type: ignore[arg-type]
        elif fc in ("q", "Q"):
            pass  # quality-only features; positions unaffected
        else:
            raise CramError(f"unhandled feature {fc!r}")
    tail = r.rl - rpos
    if tail > 0:
        _fill_match(bases, covered, rpos, tail, ref, ref_cursor)
        push("M", tail)
    if not comp.rr_required:
        # no-ref: uncovered positions drain the BA series in read order —
        # one batched series read, scattered by the coverage mask.
        n_unc = r.rl - sum(covered)
        if n_unc > 0:
            run = E("BA").read_byte_run(ctx, n_unc)
            if n_unc == r.rl:
                bases[:] = run
            else:
                dst = np.frombuffer(bases, dtype=np.uint8)
                idx = np.nonzero(
                    np.frombuffer(covered, dtype=np.uint8) == 0
                )[0]
                dst[idx] = np.frombuffer(run, dtype=np.uint8)
    return bases.decode("latin-1"), cigar_ops


def _upper(b: int) -> int:
    return b - 32 if 97 <= b <= 122 else b


_UPPER_TABLE = bytes(
    b - 32 if 97 <= b <= 122 else b for b in range(256)
)


def _fill_match(
    bases: bytearray,
    covered: bytearray,
    rpos: int,
    n: int,
    ref: Optional[bytes],
    ref_cursor: int,
) -> None:
    # Slice assignment on a bytearray silently resizes on length mismatch;
    # out-of-range cursors from corrupt features must ERROR, not shift
    # every downstream base (the old per-index loop raised IndexError).
    if rpos < 0 or rpos + n > len(covered):
        raise CramError(
            f"feature positions run past the read length "
            f"({rpos}+{n} > {len(covered)})"
        )
    if ref is None:
        return  # no-ref mode: BA fills later, covered stays 0
    if ref_cursor < 0:
        raise CramError(f"reference cursor negative ({ref_cursor})")
    avail = min(n, max(0, len(ref) - ref_cursor))
    if avail > 0:
        bases[rpos : rpos + avail] = ref[
            ref_cursor : ref_cursor + avail
        ].translate(_UPPER_TABLE)
    covered[rpos : rpos + n] = b"\x01" * n


# ---------------------------------------------------------------------------
# Container decode / whole-file read
# ---------------------------------------------------------------------------


def decode_container(
    data: bytes,
    ch: ContainerHeader,
    major: int,
    ref_getter: Optional[Callable[[int], bytes]] = None,
    *,
    stream=None,
    errors: str = "strict",
) -> List[BamRecord]:
    """All records of one data container.

    Two passes: the frame walk collects every block of the container
    still-compressed, then one ``decompress_batch`` call inflates them
    all — via ``stream`` (a
    :class:`~hadoop_bam_tpu_torch.device_stream.DeviceStream`, whose
    policy may arm the card's rANS kernel) when given, the host batch
    otherwise.  ``errors="salvage"`` quarantines a slice whose blocks
    fail to inflate (``cram.slice.quarantined``, counted in the stream's
    metrics) instead of killing the container; a salvaged-away
    compression header quarantines the whole container."""
    from . import cram_codecs
    from .cram_codecs import DecodeContext
    from ..utils.tracing import Metrics

    metrics = stream.metrics if stream is not None else Metrics()

    if ch.is_eof or ch.n_records == 0:
        return []
    pos = ch.offset + ch.header_size
    end = ch.offset + ch.header_size + ch.length
    frames: List[BlockFrame] = []
    while pos < end:
        fr, pos = Block.read_frame(data, pos, major)
        frames.append(fr)
    if not frames:
        return []
    triples = [(f.method, f.payload, f.raw_size) for f in frames]
    if stream is not None:
        raws = stream.decompress_cram_blocks(triples, errors=errors)
    else:
        raws = cram_codecs.decompress_batch(triples, errors=errors)

    def _block(i: int) -> Optional[Block]:
        if raws[i] is None:
            return None
        return Block.finish(frames[i], raws[i])

    comp_block = _block(0)
    if comp_block is None:
        metrics.count("cram.container.quarantined", 1)
        return []
    if comp_block.content_type != CT_COMPRESSION_HEADER:
        raise CramError("expected compression-header block")
    comp = CompressionHeader.parse(comp_block.raw)
    out: List[BamRecord] = []
    i = 1
    while i < len(frames):
        if frames[i].content_type != CT_SLICE_HEADER:
            raise CramError("expected slice-header block")
        sh_block = _block(i)
        n_blocks = (
            SliceHeader.parse(sh_block.raw, major).n_blocks
            if sh_block is not None
            else None
        )
        if n_blocks is None:
            # Slice header lost in salvage: its member count is
            # unknown, so the rest of the container is unwalkable.
            metrics.count("cram.slice.quarantined", 1)
            break
        sh = SliceHeader.parse(sh_block.raw, major)
        first, i = i + 1, i + 1 + n_blocks
        members = [_block(j) for j in range(first, i)]
        if any(b is None for b in members):
            metrics.count("cram.slice.quarantined", 1)
            continue
        core = b""
        external: Dict[int, bytes] = {}
        for blk in members:
            if blk.content_type == CT_CORE:
                core = blk.raw
            elif blk.content_type == CT_EXTERNAL:
                external[blk.content_id] = blk.raw
            else:
                raise CramError(
                    f"unexpected block type {blk.content_type} in slice"
                )
        rg = ref_getter
        if sh.embedded_ref_id >= 0 and sh.embedded_ref_id in external:
            # position the embedded block at the slice start, once
            padded = b"N" * (sh.start - 1) + external[sh.embedded_ref_id]

            def rg(_refid, _p=padded):  # noqa: ANN001
                return _p

        ctx = DecodeContext(core, external)
        out.extend(_decode_slice_records(major, comp, sh, ctx, rg))
    return out


def read_cram_header_text(data: bytes) -> str:
    """SAM header text from the first (file-header) container."""
    major, _ = parse_file_definition(data)
    ch = parse_container_header(data, FILE_DEFINITION_LEN, major)
    blk, _ = Block.read(data, ch.offset + ch.header_size, major)
    if blk.content_type != CT_FILE_HEADER:
        raise CramError("first container is not the file header")
    (n,) = struct.unpack_from("<i", blk.raw, 0)
    return blk.raw[4 : 4 + n].decode()


def read_cram(
    path_or_bytes,
    ref_getter: Optional[Callable[[int], bytes]] = None,
    *,
    stream=None,
    errors: str = "strict",
):
    """(BamHeader, records) for a whole CRAM file."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    from .bam import header_from_text

    major, _ = parse_file_definition(data)
    header = header_from_text(read_cram_header_text(data))
    out: List[BamRecord] = []
    for ch in iter_containers(data)[1:]:
        out.extend(
            decode_container(
                data, ch, major, ref_getter, stream=stream, errors=errors
            )
        )
    return header, out


# ---------------------------------------------------------------------------
# Writer (CRAM 3.0: external encodings, no-ref, detached mates)
# ---------------------------------------------------------------------------

# fixed external content ids per data series
_W_IDS = {
    "BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6, "MF": 8,
    "NS": 9, "NP": 10, "TS": 11, "TL": 12, "FN": 13, "FC": 14, "FP": 15,
    "DL": 16, "BS": 17, "HC": 18, "PD": 19, "RS": 20, "BA": 21, "QS": 22,
    "MQ": 23,
}
_W_RN = 7  # byte-array-stop stream for names
_W_IN = 24  # insertion bases (stop)
_W_SC = 25  # soft-clip bases (stop)
_W_TAG_LEN = 26  # tag value lengths
_W_TAG_VAL = 27  # tag value bytes
_STOP = 0x00


class _StreamSet:
    def __init__(self):
        self.streams: Dict[int, bytearray] = {}

    def put_itf8(self, cid: int, v: int) -> None:
        self.streams.setdefault(cid, bytearray()).extend(write_itf8(v))

    def put_byte(self, cid: int, b: int) -> None:
        self.streams.setdefault(cid, bytearray()).append(b)

    def put_bytes(self, cid: int, b: bytes) -> None:
        self.streams.setdefault(cid, bytearray()).extend(b)


def _split_tags(tags_raw: bytes) -> List[Tuple[bytes, int, bytes]]:
    """BAM aux blob → [(2-byte tag, type byte, value bytes incl. any NUL)]."""
    out = []
    p = 0
    n = len(tags_raw)
    while p + 3 <= n:
        tag = tags_raw[p : p + 2]
        t = tags_raw[p + 2]
        p += 3
        c = chr(t)
        if c in "AcC":
            size = 1
        elif c in "sS":
            size = 2
        elif c in "iIf":
            size = 4
        elif c in "ZH":
            size = tags_raw.index(b"\x00", p) - p + 1
        elif c == "B":
            sub = chr(tags_raw[p])
            (cnt,) = struct.unpack_from("<I", tags_raw, p + 1)
            per = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            size = 5 + cnt * per
        else:
            raise CramError(f"unknown aux type {c!r}")
        out.append((tag, t, tags_raw[p : p + size]))
        p += size
    return out


def _build_compression_header(
    td: List[List[Tuple[bytes, int]]], tag_keys: List[int]
) -> bytes:
    from .cram_codecs import (
        encoding_byte_array_len_external,
        encoding_byte_array_stop,
        encoding_external,
    )

    # preservation map: RN=1 AP=0 RR=0 SM TD
    pres = bytearray()
    entries = 0
    for key, val in (
        (b"RN", bytes([1])),
        (b"AP", bytes([0])),
        (b"RR", bytes([0])),
        (b"SM", _DEFAULT_SUB),
    ):
        pres += key + val
        entries += 1
    td_blob = (
        b"\x00".join(
            b"".join(tag + bytes([t]) for tag, t in line) for line in td
        )
        + b"\x00"
    )
    pres += b"TD" + write_itf8(len(td_blob)) + td_blob
    entries += 1
    pres_map = write_itf8(entries) + pres

    enc = bytearray()
    n_enc = 0
    for key, cid in _W_IDS.items():
        enc += key.encode() + encoding_external(cid)
        n_enc += 1
    enc += b"RN" + encoding_byte_array_stop(_STOP, _W_RN)
    enc += b"IN" + encoding_byte_array_stop(_STOP, _W_IN)
    enc += b"SC" + encoding_byte_array_stop(_STOP, _W_SC)
    n_enc += 3
    enc_map = write_itf8(n_enc) + enc

    tags = bytearray()
    for key in tag_keys:
        tags += write_itf8(key) + encoding_byte_array_len_external(
            _W_TAG_LEN, _W_TAG_VAL
        )
    tag_map = write_itf8(len(tag_keys)) + tags

    out = bytearray()
    out += write_itf8(len(pres_map)) + pres_map
    out += write_itf8(len(enc_map)) + enc_map
    out += write_itf8(len(tag_map)) + tag_map
    return bytes(out)


def encode_container(
    records: Sequence[BamRecord],
    record_counter: int,
    major: int = 3,
    codec: str = "gzip",
) -> bytes:
    """One container holding one multi-ref slice with the given records.

    CIGAR normalisations inherent to CRAM (identical to htslib/htsjdk):
    '='/'X' runs collapse to 'M' (the distinction is reference-derived, not
    stored), and flag-unmapped records store no features, so any CIGAR they
    carry reads back as '*'.

    ``codec`` picks the external-block compression: ``"gzip"`` (the
    default, htsjdk's stance) or ``"rans"`` (rANS 4x8 — the streams the
    lockstep-lane decoder eats, used by tests and the bench CRAM twin).
    """
    # tag dictionary
    td: List[List[Tuple[bytes, int]]] = []
    td_index: Dict[tuple, int] = {}
    rec_tl: List[int] = []
    rec_tags: List[List[Tuple[bytes, int, bytes]]] = []
    for rec in records:
        tags = _split_tags(rec.tags_raw)
        sig = tuple((bytes(t), ty) for t, ty, _ in tags)
        if sig not in td_index:
            td_index[sig] = len(td)
            td.append([(t, ty) for t, ty, _ in tags])
        rec_tl.append(td_index[sig])
        rec_tags.append(tags)
    tag_keys = sorted(
        {
            (t[0] << 16) | (t[1] << 8) | ty
            for line in td
            for t, ty in line
        }
    )

    s = _StreamSet()
    for rec, tl, tags in zip(records, rec_tl, rec_tags):
        flag = rec.flag
        cf = CF_QS_STORED | CF_DETACHED
        s.put_itf8(_W_IDS["BF"], flag)
        s.put_itf8(_W_IDS["CF"], cf)
        s.put_itf8(_W_IDS["RI"], rec.refid)
        l_seq = rec.l_seq
        s.put_itf8(_W_IDS["RL"], l_seq)
        s.put_itf8(_W_IDS["AP"], rec.pos + 1)
        s.put_itf8(_W_IDS["RG"], -1)
        s.put_bytes(_W_RN, rec.read_name.encode() + bytes([_STOP]))
        # detached mate data
        mf = 0
        if flag & FLAG_MATE_REVERSE:
            mf |= MF_MATE_NEG_STRAND
        if flag & FLAG_MATE_UNMAPPED:
            mf |= MF_MATE_UNMAPPED
        s.put_itf8(_W_IDS["MF"], mf)
        s.put_itf8(_W_IDS["NS"], rec.next_refid)
        s.put_itf8(_W_IDS["NP"], rec.next_pos + 1)
        s.put_itf8(_W_IDS["TS"], rec.tlen)
        s.put_itf8(_W_IDS["TL"], tl)
        for tag, ty, val in tags:
            s.put_itf8(_W_TAG_LEN, len(val))
            s.put_bytes(_W_TAG_VAL, val)
        seq = rec.seq
        seq_b = b"" if seq == "*" else seq.encode()
        if not (flag & FLAG_UNMAPPED):
            # features: non-M cigar ops; M bases go through BA (no-ref)
            features: List[Tuple[int, str, bytes, int]] = []
            rpos = 1
            for n, op in rec.cigar:
                if op in ("M", "=", "X"):
                    rpos += n
                elif op == "S":
                    features.append((rpos, "S", seq_b[rpos - 1 : rpos - 1 + n], 0))
                    rpos += n
                elif op == "I":
                    features.append((rpos, "I", seq_b[rpos - 1 : rpos - 1 + n], 0))
                    rpos += n
                elif op == "D":
                    features.append((rpos, "D", b"", n))
                elif op == "N":
                    features.append((rpos, "N", b"", n))
                elif op == "H":
                    features.append((rpos, "H", b"", n))
                elif op == "P":
                    features.append((rpos, "P", b"", n))
                else:
                    raise CramError(f"unsupported cigar op {op}")
            s.put_itf8(_W_IDS["FN"], len(features))
            prev = 0
            covered = bytearray(l_seq)
            for fpos, fc, payload, num in features:
                s.put_byte(_W_IDS["FC"], ord(fc))
                s.put_itf8(_W_IDS["FP"], fpos - prev)
                prev = fpos
                if fc == "S":
                    s.put_bytes(_W_SC, payload + bytes([_STOP]))
                    for k in range(len(payload)):
                        covered[fpos - 1 + k] = 1
                elif fc == "I":
                    s.put_bytes(_W_IN, payload + bytes([_STOP]))
                    for k in range(len(payload)):
                        covered[fpos - 1 + k] = 1
                elif fc == "D":
                    s.put_itf8(_W_IDS["DL"], num)
                elif fc == "N":
                    s.put_itf8(_W_IDS["RS"], num)
                elif fc == "H":
                    s.put_itf8(_W_IDS["HC"], num)
                elif fc == "P":
                    s.put_itf8(_W_IDS["PD"], num)
            s.put_itf8(_W_IDS["MQ"], rec.mapq)
            s.put_bytes(_W_IDS["QS"], rec.qual or b"\xff" * l_seq)
            # no-ref BA fill for uncovered positions
            for k in range(l_seq):
                if not covered[k]:
                    s.put_byte(_W_IDS["BA"], seq_b[k] if k < len(seq_b) else ord("N"))
        else:
            s.put_bytes(_W_IDS["BA"], seq_b.ljust(l_seq, b"N"))
            s.put_bytes(_W_IDS["QS"], rec.qual or b"\xff" * l_seq)

    mapped = [r for r in records if r.refid >= 0]
    if mapped:
        start = min(r.pos for r in mapped) + 1
        end = max(r.pos + max(r.reference_length(), 1) for r in mapped)
        span = max(end - start + 1, 0)
    else:
        start, span = 0, 0
    n_ext = len(s.streams)
    sh = SliceHeader(
        ref_seq_id=-2,
        start=start if len({r.refid for r in records}) == 1 else 0,
        span=span if len({r.refid for r in records}) == 1 else 0,
        n_records=len(records),
        record_counter=record_counter,
        n_blocks=1 + n_ext,
        content_ids=sorted(s.streams),
        embedded_ref_id=-1,
        md5=b"\x00" * 16,
    )
    from .cram_codecs import METHOD_GZIP, METHOD_RANS, METHOD_RAW

    ext_method = METHOD_RANS if codec == "rans" else METHOD_GZIP
    blocks = bytearray()
    comp_raw = _build_compression_header(td, tag_keys)
    blocks += Block(METHOD_RAW, CT_COMPRESSION_HEADER, 0, comp_raw).write(
        major, METHOD_GZIP
    )
    landmark = len(blocks)
    slice_blocks = bytearray()
    slice_blocks += Block(
        METHOD_RAW, CT_SLICE_HEADER, 0, sh.encode(major)
    ).write(major, METHOD_RAW)
    slice_blocks += Block(METHOD_RAW, CT_CORE, 0, b"").write(
        major, METHOD_RAW
    )
    for cid in sorted(s.streams):
        slice_blocks += Block(
            METHOD_RAW, CT_EXTERNAL, cid, bytes(s.streams[cid])
        ).write(major, ext_method)
    blocks += slice_blocks

    hdr = bytearray()
    hdr += struct.pack("<i", len(blocks))
    hdr += write_itf8(-2)
    hdr += write_itf8(sh.start)
    hdr += write_itf8(sh.span)
    hdr += write_itf8(len(records))
    hdr += (write_ltf8 if major >= 3 else write_itf8)(record_counter)
    hdr += (write_ltf8 if major >= 3 else write_itf8)(
        sum(r.l_seq for r in records)
    )
    hdr += write_itf8(3 + n_ext)  # comp hdr + slice hdr + core + externals
    hdr += write_itf8(1)
    hdr += write_itf8(landmark)
    if major >= 3:
        hdr += struct.pack("<I", zlib.crc32(bytes(hdr)))
    return bytes(hdr) + bytes(blocks)


def encode_file_header_container(text: str, major: int = 3) -> bytes:
    raw = struct.pack("<i", len(text.encode())) + text.encode()
    from .cram_codecs import METHOD_RAW

    blk = Block(METHOD_RAW, CT_FILE_HEADER, 0, raw).write(major, METHOD_RAW)
    hdr = bytearray()
    hdr += struct.pack("<i", len(blk))
    hdr += write_itf8(0)
    hdr += write_itf8(0)
    hdr += write_itf8(0)
    hdr += write_itf8(0)
    hdr += (write_ltf8 if major >= 3 else write_itf8)(0)
    hdr += (write_ltf8 if major >= 3 else write_itf8)(0)
    hdr += write_itf8(1)
    hdr += write_itf8(0)
    if major >= 3:
        hdr += struct.pack("<I", zlib.crc32(bytes(hdr)))
    return bytes(hdr) + blk


def write_cram(
    stream,
    header,
    records: Sequence[BamRecord],
    records_per_container: int = 10000,
    append_eof: bool = True,
    codec: str = "gzip",
) -> None:
    """Complete CRAM 3.0 file: file definition, header container, data
    containers, EOF marker (suppressible for headerless parts, the
    CRAMRecordWriter.java:98-101 semantics).  ``codec="rans"`` writes
    the external series rANS-coded (see :func:`encode_container`)."""
    stream.write(MAGIC + bytes([3, 0]) + b"\x00" * 20)
    stream.write(encode_file_header_container(header.text, 3))
    counter = 0
    for i in range(0, len(records), records_per_container):
        chunk = records[i : i + records_per_container]
        stream.write(encode_container(chunk, counter, 3, codec=codec))
        counter += len(chunk)
    if append_eof:
        stream.write(EOF_V3)

"""SAM text: line <-> binary record, the tag codec, whole-file read/write.

Counterpart of ``hadoop_bam_tpu/spec/sam.py`` (htsjdk's text codec under
SAMRecordReader.java / SAMRecordWriter.java).  A SAM line becomes the
*binary* record (:class:`~.bam.BamRecord`), so text input feeds the same
SoA decode, keys and sort as BAM; the writer turns records back into lines
with their optional tags.

Tag wire format (SAM spec 4.2.4, BAM 4.2): two-char tag, type byte
(A c C s S i I f Z H B), value; ``B`` arrays carry an element type and a
count.  A text integer ``i`` narrows on encode by value, trying ``c`` before
``C`` (so ``NM:i:3`` encodes as ``NMc``); decoding renders every binary
integer as ``i``.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from . import bam


class SamError(IOError):
    pass


def _encode_tag(tag: str, typ: str, value: str) -> bytes:
    out = tag.encode()
    if typ == "A":
        return out + b"A" + value.encode()[:1]
    if typ == "i":
        v = int(value)
        for code, fmt, lo, hi in (
            (b"c", "<b", -128, 127),
            (b"C", "<B", 0, 255),
            (b"s", "<h", -32768, 32767),
            (b"S", "<H", 0, 65535),
            (b"i", "<i", -(1 << 31), (1 << 31) - 1),
            (b"I", "<I", 0, (1 << 32) - 1),
        ):
            if lo <= v <= hi:
                return out + code + struct.pack(fmt, v)
        raise SamError(f"integer tag out of range: {tag}={value}")
    if typ == "f":
        return out + b"f" + struct.pack("<f", float(value))
    if typ in ("Z", "H"):
        return out + typ.encode() + value.encode() + b"\x00"
    if typ == "B":
        parts = value.split(",")
        elem = parts[0]
        nums = parts[1:]
        fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
               "I": "<I", "f": "<f"}[elem]
        conv = float if elem == "f" else int
        body = b"".join(struct.pack(fmt, conv(x)) for x in nums)
        return out + b"B" + elem.encode() + struct.pack("<I", len(nums)) + body
    raise SamError(f"unknown tag type {typ}")


def decode_tags(raw: bytes) -> List[Tuple[str, str, str]]:
    """BAM tag block → [(tag, sam_type, sam_value)] (binary ints → 'i')."""
    out: List[Tuple[str, str, str]] = []
    p = 0
    n = len(raw)
    while p + 3 <= n:
        tag = raw[p : p + 2].decode()
        typ = chr(raw[p + 2])
        p += 3
        if typ == "A":
            out.append((tag, "A", chr(raw[p])))
            p += 1
        elif typ in "cCsSiI":
            fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H",
                   "i": "<i", "I": "<I"}[typ]
            size = struct.calcsize(fmt)
            (v,) = struct.unpack_from(fmt, raw, p)
            out.append((tag, "i", str(v)))
            p += size
        elif typ == "f":
            (v,) = struct.unpack_from("<f", raw, p)
            out.append((tag, "f", f"{v:g}"))
            p += 4
        elif typ in "ZH":
            end = raw.index(b"\x00", p)
            out.append((tag, typ, raw[p:end].decode()))
            p = end + 1
        elif typ == "B":
            elem = chr(raw[p])
            (count,) = struct.unpack_from("<I", raw, p + 1)
            p += 5
            fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
                   "I": "<I", "f": "<f"}[elem]
            size = struct.calcsize(fmt)
            vals = [
                struct.unpack_from(fmt, raw, p + i * size)[0]
                for i in range(count)
            ]
            rendered = ",".join(
                f"{v:g}" if elem == "f" else str(v) for v in vals
            )
            out.append((tag, "B", f"{elem},{rendered}" if vals else elem))
            p += count * size
        else:
            raise SamError(f"unknown binary tag type {typ!r}")
    return out


def parse_cigar(text: str) -> List[Tuple[int, str]]:
    if text == "*":
        return []
    out = []
    num = ""
    for ch in text:
        if ch.isdigit():
            num += ch
        elif ch in bam.CIGAR_OPS:
            if not num:
                raise SamError(f"malformed CIGAR {text!r}")
            out.append((int(num), ch))
            num = ""
        else:
            raise SamError(f"bad CIGAR operator {ch!r} in {text!r}")
    if num:
        raise SamError(f"malformed CIGAR {text!r}")
    return out


def sam_line_to_record(line: str, header: bam.BamHeader) -> bam.BamRecord:
    f = line.rstrip("\n").split("\t")
    if len(f) < 11:
        raise SamError(f"SAM line has {len(f)} fields (need >= 11)")
    qname, flag_s, rname, pos_s, mapq_s, cigar_s, rnext, pnext_s, tlen_s, seq, qual = f[:11]
    try:
        flag = int(flag_s)
        pos1 = int(pos_s)
        mapq = int(mapq_s)
        pnext1 = int(pnext_s)
        tlen = int(tlen_s)
    except ValueError as e:
        raise SamError(f"non-integer core field in SAM line: {e}")
    refid = header.ref_index(rname)
    if rnext == "=":
        nrefid = refid
    else:
        nrefid = header.ref_index(rnext)
    tags = b"".join(
        _encode_tag(t[:2], t[3], t[5:]) for t in f[11:] if len(t) >= 5
    )
    rec, _ = bam.decode_record(bam.build_record(
        name="" if qname == "*" else qname,
        refid=refid,
        pos=pos1 - 1,
        mapq=mapq,
        flag=flag,
        cigar=parse_cigar(cigar_s),
        seq=seq,
        qual=qual if qual == "*" else bytes(ord(c) - 33 for c in qual),
        next_refid=nrefid,
        next_pos=pnext1 - 1,
        tlen=tlen,
        tags=tags,
    ))
    return rec


def record_to_sam_line(rec: bam.BamRecord, header: bam.BamHeader) -> str:
    qual = rec.qual
    qual_s = (
        "*"
        if not qual or all(q == 0xFF for q in qual)
        else "".join(chr(q + 33) for q in qual)
    )
    rname = header.ref_name(rec.refid)
    if rec.next_refid < 0:
        rnext = "*"
    elif rec.next_refid == rec.refid:
        rnext = "="
    else:
        rnext = header.ref_name(rec.next_refid)
    fields = [
        rec.read_name or "*",
        str(rec.flag),
        rname,
        str(rec.pos + 1),
        str(rec.mapq),
        rec.cigar_string(),
        rnext,
        str(rec.next_pos + 1),
        str(rec.tlen),
        rec.seq,
        qual_s,
    ]
    for tag, typ, val in decode_tags(rec.tags_raw):
        fields.append(f"{tag}:{typ}:{val}")
    return "\t".join(fields)


def read_sam(text_or_bytes) -> Tuple[bam.BamHeader, List[bam.BamRecord]]:
    text = (
        text_or_bytes.decode()
        if isinstance(text_or_bytes, bytes)
        else text_or_bytes
    )
    header_lines: List[str] = []
    body: List[str] = []
    refs: List[Tuple[str, int]] = []
    for line in text.split("\n"):
        if not line:
            continue
        if line.startswith("@"):
            header_lines.append(line)
            if line.startswith("@SQ"):
                name, length = None, None
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SN:"):
                        name = fld[3:]
                    elif fld.startswith("LN:"):
                        length = int(fld[3:])
                if name is not None and length is not None:
                    refs.append((name, length))
        else:
            body.append(line)
    header = bam.BamHeader("\n".join(header_lines), refs)
    return header, [sam_line_to_record(l, header) for l in body]


def write_sam(
    stream, header: bam.BamHeader, records, write_header: bool = True
) -> None:
    if write_header and header.text:
        stream.write((header.text.rstrip("\n") + "\n").encode())
    for rec in records:
        stream.write((record_to_sam_line(rec, header) + "\n").encode())

"""BCF2 binary format: dictionaries, typed values, record codec.

Counterpart of ``hadoop_bam_tpu/spec/bcf.py``; encode and decode are byte
for byte the reference's, since a ranged query's output is a re-encode of
decoded records.

Oracle implementation of the role htsjdk's ``BCF2Codec``/``BCF2Encoder`` play
under the reference's BCF path (BCFRecordReader.java, BCFSplitGuesser.java).
Layout per the BCF2.2 section of the VCF spec:

- file = BGZF stream; uncompressed payload starts ``BCF\\x02\\x02``, then
  ``l_text`` (u32) + NUL-terminated VCF header text,
- each site: ``l_shared`` (u32), ``l_indiv`` (u32), shared block
  (CHROM i32, POS i32 0-based, rlen i32, QUAL f32 with signaling-NaN
  0x7F800001 for missing, n_allele<<16|n_info u32, n_fmt<<24|n_sample u32,
  ID typed string, alleles, FILTER typed int vector, INFO key/value pairs),
  then the genotype (indiv) block: n_fmt × (typed key, typed vector).

Genotype blocks are kept **unparsed** on decode (``LazyBcfGenotypes``) — the
reference's LazyBCFGenotypesContext stance (LazyBCFGenotypesContext.java:42-149):
sorting/filtering variants never pays genotype-parse cost; text materialises
only when a writer or user asks for it.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .vcf import VariantContext, VcfHeader

MAGIC = b"BCF\x02\x02"

# type codes (low nibble of the descriptor byte)
T_MISSING = 0
T_INT8 = 1
T_INT16 = 2
T_INT32 = 3
T_FLOAT = 5
T_CHAR = 7

# reserved sentinel values per int width: MISSING, END_OF_VECTOR
INT8_MISSING, INT8_EOV = -128, -127
INT16_MISSING, INT16_EOV = -32768, -32767
INT32_MISSING, INT32_EOV = -2147483648, -2147483647
FLOAT_MISSING_BITS = 0x7F800001
FLOAT_EOV_BITS = 0x7F800002

# usable (non-reserved) int ranges per width
_INT8_MIN, _INT8_MAX = -120, 127
_INT16_MIN, _INT16_MAX = -32760, 32767
_INT32_MIN, _INT32_MAX = -2147483640, 2147483647


class BcfError(IOError):
    pass


# ---------------------------------------------------------------------------
# Dictionaries
# ---------------------------------------------------------------------------


@dataclass
class _Declared:
    """One ##INFO/##FORMAT declaration (Type/Number drive encoding)."""

    id: str
    type: str  # Integer | Float | Flag | Character | String
    number: str  # '1', 'A', 'R', 'G', '.', etc.


class BcfHeader:
    """A VcfHeader plus the BCF string/contig dictionaries.

    Dictionary construction follows the spec: if any header line carries an
    ``IDX=`` attribute those indices are authoritative; otherwise the string
    dictionary is the order of first appearance of FILTER/INFO/FORMAT IDs
    with ``PASS`` implicitly at offset 0, and the contig dictionary is
    ##contig line order.
    """

    def __init__(self, vcf: VcfHeader):
        self.vcf = vcf
        strings: List[str] = []
        str_idx: Dict[str, int] = {}
        explicit: Dict[int, str] = {}
        any_idx = False
        self.info: Dict[str, _Declared] = {}
        self.format: Dict[str, _Declared] = {}

        def add(name: str, idx: Optional[int]) -> None:
            nonlocal any_idx
            if idx is not None:
                any_idx = True
                explicit[idx] = name
            elif name not in str_idx:
                str_idx[name] = len(strings)
                strings.append(name)

        if "PASS" not in str_idx:
            str_idx["PASS"] = 0
            strings.append("PASS")
        for ln in vcf.lines:
            m = re.match(r"##(FILTER|INFO|FORMAT)=<(.*)>", ln)
            if not m:
                continue
            kind, body = m.group(1), m.group(2)
            fid = _attr(body, "ID")
            if fid is None:
                continue
            idx_s = _attr(body, "IDX")
            add(fid, int(idx_s) if idx_s is not None else None)
            decl = _Declared(
                fid, _attr(body, "Type") or "String", _attr(body, "Number") or "."
            )
            if kind == "INFO":
                self.info[fid] = decl
            elif kind == "FORMAT":
                self.format[fid] = decl
        if any_idx:
            size = max(explicit) + 1
            strings = [""] * size
            for i, name in explicit.items():
                strings[i] = name
            if "PASS" not in explicit.values():
                strings[0] = "PASS"
            str_idx = {n: i for i, n in enumerate(strings) if n}
        self.strings = strings
        self._str_idx = str_idx
        self.contigs = list(vcf.contigs)
        self._contig_idx = {c: i for i, c in enumerate(self.contigs)}
        self.n_samples = len(vcf.samples)

    def string_index(self, name: str) -> int:
        try:
            return self._str_idx[name]
        except KeyError:
            raise BcfError(f"ID {name!r} not in BCF dictionary")

    def contig_index(self, name: str) -> int:
        try:
            return self._contig_idx[name]
        except KeyError:
            raise BcfError(f"contig {name!r} not in BCF dictionary")


def _attr(body: str, key: str) -> Optional[str]:
    m = re.search(rf'(?:^|,){key}=("[^"]*"|[^,]*)', body)
    if not m:
        return None
    v = m.group(1)
    return v[1:-1] if v.startswith('"') else v


# ---------------------------------------------------------------------------
# Typed values
# ---------------------------------------------------------------------------


def read_typed_descriptor(buf, p: int) -> Tuple[int, int, int]:
    """(type, length, new_p); resolves the length==15 overflow form."""
    b = buf[p]
    p += 1
    t, ln = b & 0xF, b >> 4
    if ln == 15:
        vals, p = read_typed_value(buf, p)
        ln = int(vals[0])
    return t, ln, p


def _read_ints(buf, p: int, t: int, n: int) -> Tuple[List[int], int]:
    if t == T_INT8:
        vals = list(struct.unpack_from(f"<{n}b", buf, p))
        return vals, p + n
    if t == T_INT16:
        vals = list(struct.unpack_from(f"<{n}h", buf, p))
        return vals, p + 2 * n
    if t == T_INT32:
        vals = list(struct.unpack_from(f"<{n}i", buf, p))
        return vals, p + 4 * n
    raise BcfError(f"bad int type {t}")


def read_typed_value(buf, p: int):
    """Decode one typed value → (list-or-str, new_p).

    Ints/floats come back as Python lists (missing → None, EOV trimmed);
    char vectors come back as ``str``.
    """
    t, ln, p = read_typed_descriptor(buf, p)
    if t == T_MISSING:
        return [], p
    if t == T_CHAR:
        s = bytes(buf[p : p + ln]).decode("latin-1")
        return s, p + ln
    if t == T_FLOAT:
        out: List[Optional[float]] = []
        for k in range(ln):
            (bits,) = struct.unpack_from("<I", buf, p + 4 * k)
            if bits == FLOAT_MISSING_BITS:
                out.append(None)
            elif bits == FLOAT_EOV_BITS:
                return out, p + 4 * ln
            else:
                out.append(struct.unpack_from("<f", buf, p + 4 * k)[0])
        return out, p + 4 * ln
    raw, p = _read_ints(buf, p, t, ln)
    missing, eov = {
        T_INT8: (INT8_MISSING, INT8_EOV),
        T_INT16: (INT16_MISSING, INT16_EOV),
        T_INT32: (INT32_MISSING, INT32_EOV),
    }[t]
    out = []
    for v in raw:
        if v == eov:
            break
        out.append(None if v == missing else v)
    return out, p


def _int_type_for(vals: List[int]) -> int:
    lo = min(vals) if vals else 0
    hi = max(vals) if vals else 0
    if _INT8_MIN <= lo and hi <= _INT8_MAX:
        return T_INT8
    if _INT16_MIN <= lo and hi <= _INT16_MAX:
        return T_INT16
    return T_INT32


def write_descriptor(out: bytearray, t: int, ln: int) -> None:
    if ln < 15:
        out.append((ln << 4) | t)
    else:
        out.append((15 << 4) | t)
        write_typed_ints(out, [ln])


def write_typed_ints(
    out: bytearray, vals: List[Optional[int]], pad_to: int = 0
) -> None:
    """Typed int vector; ``None`` → MISSING; padding (for fixed-width sample
    matrices) uses END_OF_VECTOR."""
    concrete = [v for v in vals if v is not None]
    t = _int_type_for(concrete)
    n = max(len(vals), pad_to)
    write_descriptor(out, t, n)
    fmt, missing, eov = {
        T_INT8: ("<b", INT8_MISSING, INT8_EOV),
        T_INT16: ("<h", INT16_MISSING, INT16_EOV),
        T_INT32: ("<i", INT32_MISSING, INT32_EOV),
    }[t]
    for v in vals:
        out.extend(struct.pack(fmt, missing if v is None else v))
    for _ in range(n - len(vals)):
        out.extend(struct.pack(fmt, eov))


def write_typed_floats(
    out: bytearray, vals: List[Optional[float]], pad_to: int = 0
) -> None:
    n = max(len(vals), pad_to)
    write_descriptor(out, T_FLOAT, n)
    for v in vals:
        if v is None:
            out.extend(struct.pack("<I", FLOAT_MISSING_BITS))
        else:
            out.extend(struct.pack("<f", v))
    for _ in range(n - len(vals)):
        out.extend(struct.pack("<I", FLOAT_EOV_BITS))


def write_typed_string(out: bytearray, s: str) -> None:
    raw = s.encode("latin-1")
    write_descriptor(out, T_CHAR, len(raw))
    out.extend(raw)


# ---------------------------------------------------------------------------
# Lazy genotypes
# ---------------------------------------------------------------------------


@dataclass
class LazyBcfGenotypes:
    """Undecoded indiv block + the bits needed to materialise VCF text
    (the LazyBCFGenotypesContext equivalent)."""

    header: BcfHeader
    n_fmt: int
    n_sample: int
    raw: bytes

    def to_text(self) -> str:
        """FORMAT + TAB-joined sample columns as VCF text."""
        if self.n_fmt == 0 or self.n_sample == 0:
            return ""
        buf = self.raw
        p = 0
        keys: List[str] = []
        cols: List[List[str]] = []  # per fmt key: one string per sample
        for _ in range(self.n_fmt):
            kidx, p = read_typed_value(buf, p)
            key = self.header.strings[int(kidx[0])]
            keys.append(key)
            t, ln, p = read_typed_descriptor(buf, p)
            per_sample: List[str] = []
            for _s in range(self.n_sample):
                if t == T_CHAR:
                    s = bytes(buf[p : p + ln]).decode("latin-1")
                    p += ln
                    per_sample.append(s.rstrip("\x00") or ".")
                elif t == T_FLOAT:
                    vals = []
                    stop = False
                    for k in range(ln):
                        (bits,) = struct.unpack_from("<I", buf, p + 4 * k)
                        if bits == FLOAT_EOV_BITS:
                            stop = True
                        elif not stop:
                            vals.append(
                                "."
                                if bits == FLOAT_MISSING_BITS
                                else _fmt_float(
                                    struct.unpack_from("<f", buf, p + 4 * k)[0]
                                )
                            )
                    p += 4 * ln
                    per_sample.append(",".join(vals) if vals else ".")
                else:
                    raw_vals, p = _read_ints(buf, p, t, ln)
                    missing, eov = {
                        T_INT8: (INT8_MISSING, INT8_EOV),
                        T_INT16: (INT16_MISSING, INT16_EOV),
                        T_INT32: (INT32_MISSING, INT32_EOV),
                    }[t]
                    if key == "GT":
                        per_sample.append(_gt_text(raw_vals, missing, eov))
                    else:
                        vals = []
                        for v in raw_vals:
                            if v == eov:
                                break
                            vals.append("." if v == missing else str(v))
                        per_sample.append(",".join(vals) if vals else ".")
            cols.append(per_sample)
        sample_cols = [
            ":".join(cols[k][s] for k in range(len(keys)))
            for s in range(self.n_sample)
        ]
        return "\t".join([":".join(keys)] + sample_cols)


def _gt_text(raw_vals: List[int], missing: int, eov: int) -> str:
    parts: List[str] = []
    for i, v in enumerate(raw_vals):
        if v == eov:
            break
        allele = "." if v == missing or (v >> 1) == 0 else str((v >> 1) - 1)
        if i == 0:
            parts.append(allele)
        else:
            parts.append(("|" if v & 1 else "/") + allele)
    return "".join(parts) if parts else "."


def _fmt_float(x: float) -> str:
    return f"{x:g}"


class BcfVariant(VariantContext):
    """VariantContext whose genotype text materialises lazily from the BCF
    indiv block (LazyBCFGenotypesContext.java:42-149 stance)."""

    def __init__(self, *args, lazy: Optional[LazyBcfGenotypes] = None, **kw):
        self._lazy = None
        super().__init__(*args, **kw)
        self._lazy = lazy

    @property  # type: ignore[override]
    def genotypes_raw(self) -> str:  # noqa: D102
        if not self._gt and self._lazy is not None:
            self._gt = self._lazy.to_text()
            self._lazy = None
        return self._gt

    @genotypes_raw.setter
    def genotypes_raw(self, v: str) -> None:
        self._gt = v


# ---------------------------------------------------------------------------
# Record codec
# ---------------------------------------------------------------------------


def decode_record(
    buf, p: int, hdr: BcfHeader
) -> Tuple[BcfVariant, int]:
    """Decode one site starting at ``p`` → (variant, new_p)."""
    l_shared, l_indiv = struct.unpack_from("<II", buf, p)
    body_start = p + 8
    chrom_i, pos0, rlen = struct.unpack_from("<iii", buf, body_start)
    (qual_bits,) = struct.unpack_from("<I", buf, body_start + 12)
    (nai,) = struct.unpack_from("<I", buf, body_start + 16)
    n_allele, n_info = nai >> 16, nai & 0xFFFF
    (nfs,) = struct.unpack_from("<I", buf, body_start + 20)
    n_fmt, n_sample = nfs >> 24, nfs & 0xFFFFFF
    if not (0 <= chrom_i < len(hdr.contigs)):
        raise BcfError(f"CHROM index {chrom_i} out of range")
    q = body_start + 24
    vid, q = read_typed_value(buf, q)
    alleles: List[str] = []
    for _ in range(n_allele):
        a, q = read_typed_value(buf, q)
        alleles.append(a if isinstance(a, str) else "")
    filt_idx, q = read_typed_value(buf, q)
    info_parts: List[str] = []
    for _ in range(n_info):
        kidx, q = read_typed_value(buf, q)
        key = hdr.strings[int(kidx[0])]
        t = buf[q] & 0xF
        val, q = read_typed_value(buf, q)
        decl = hdr.info.get(key)
        if decl is not None and decl.type == "Flag":
            info_parts.append(key)
        else:
            info_parts.append(_info_text(key, t, val))
    if q - body_start != l_shared:
        raise BcfError(
            f"shared block length mismatch: read {q - body_start}, "
            f"declared {l_shared}"
        )
    indiv = bytes(buf[q : q + l_indiv])
    if len(indiv) != l_indiv:
        raise BcfError("truncated indiv block")
    qual = (
        None
        if qual_bits == FLOAT_MISSING_BITS
        else struct.unpack("<f", struct.pack("<I", qual_bits))[0]
    )
    filters = [hdr.strings[int(i)] for i in filt_idx if i is not None]
    ref = alleles[0] if alleles else "N"
    v = BcfVariant(
        chrom=hdr.contigs[chrom_i],
        pos=pos0 + 1,
        id="" if isinstance(vid, list) or vid in (".", "") else vid,
        ref=ref,
        alts=alleles[1:],
        qual=qual,
        filters=filters,
        info=";".join(info_parts) if info_parts else ".",
        genotypes_raw="",
        lazy=LazyBcfGenotypes(hdr, n_fmt, n_sample, indiv),
    )
    return v, q + l_indiv


def _info_text(key: str, t: int, val) -> str:
    if t == T_MISSING or (isinstance(val, list) and not val):
        return key  # Flag
    if isinstance(val, str):
        return f"{key}={val}"
    parts = []
    for x in val:
        if x is None:
            parts.append(".")
        elif isinstance(x, float):
            parts.append(_fmt_float(x))
        else:
            parts.append(str(x))
    return f"{key}={','.join(parts)}"


def encode_record(hdr: BcfHeader, v: VariantContext) -> bytes:
    """Encode one site (the BCF2Encoder role)."""
    shared = bytearray()
    chrom_i = hdr.contig_index(v.chrom)
    alleles = [v.ref] + list(v.alts)
    info_items = _parse_info(v.info)
    gt_text = v.genotypes_raw
    fmt_block, n_fmt = _encode_genotypes(hdr, gt_text)
    n_sample = hdr.n_samples if gt_text else 0
    rlen = v.end - v.pos + 1
    shared.extend(struct.pack("<iii", chrom_i, v.pos - 1, rlen))
    if v.qual is None:
        shared.extend(struct.pack("<I", FLOAT_MISSING_BITS))
    else:
        shared.extend(struct.pack("<f", v.qual))
    shared.extend(struct.pack("<I", (len(alleles) << 16) | len(info_items)))
    shared.extend(struct.pack("<I", (n_fmt << 24) | n_sample))
    write_typed_string(shared, v.id or "")
    for a in alleles:
        write_typed_string(shared, a)
    write_typed_ints(shared, [hdr.string_index(f) for f in v.filters])
    for key, raw in info_items:
        write_typed_ints(shared, [hdr.string_index(key)])
        _encode_info_value(shared, hdr.info.get(key), raw)
    return (
        struct.pack("<II", len(shared), len(fmt_block))
        + bytes(shared)
        + bytes(fmt_block)
    )


def _parse_info(info: str) -> List[Tuple[str, Optional[str]]]:
    if not info or info == ".":
        return []
    out = []
    for item in info.split(";"):
        if "=" in item:
            k, _, val = item.partition("=")
            out.append((k, val))
        else:
            out.append((item, None))
    return out


def _encode_info_value(
    out: bytearray, decl: Optional[_Declared], raw: Optional[str]
) -> None:
    if raw is None:  # Flag
        write_typed_ints(out, [1])
        return
    typ = decl.type if decl else None
    vals = raw.split(",")
    if typ is None:
        typ = _infer_type(vals)
    if typ == "Integer":
        write_typed_ints(
            out, [None if x == "." else int(x) for x in vals]
        )
    elif typ == "Float":
        write_typed_floats(
            out, [None if x == "." else float(x) for x in vals]
        )
    elif typ == "Flag":
        write_typed_ints(out, [1])
    else:  # String / Character: one char vector, commas preserved
        write_typed_string(out, raw)


def _infer_type(vals: List[str]) -> str:
    try:
        for x in vals:
            if x != ".":
                int(x)
        return "Integer"
    except ValueError:
        pass
    try:
        for x in vals:
            if x != ".":
                float(x)
        return "Float"
    except ValueError:
        return "String"


def _encode_genotypes(hdr: BcfHeader, gt_text: str) -> Tuple[bytearray, int]:
    out = bytearray()
    if not gt_text:
        return out, 0
    cols = gt_text.split("\t")
    keys = cols[0].split(":")
    samples = [c.split(":") for c in cols[1:]]
    if len(samples) != hdr.n_samples:
        raise BcfError(
            f"genotype column count {len(samples)} != header samples "
            f"{hdr.n_samples}"
        )
    for ki, key in enumerate(keys):
        write_typed_ints(out, [hdr.string_index(key)])
        fields = [s[ki] if ki < len(s) else "." for s in samples]
        if key == "GT":
            encoded = [_gt_ints(f) for f in fields]
            width = max(len(e) for e in encoded)
            t = _int_type_for([v for e in encoded for v in e])
            fmt, _missing, eov = {
                T_INT8: ("<b", INT8_MISSING, INT8_EOV),
                T_INT16: ("<h", INT16_MISSING, INT16_EOV),
                T_INT32: ("<i", INT32_MISSING, INT32_EOV),
            }[t]
            write_descriptor(out, t, width)
            for e in encoded:
                for v in e:
                    out.extend(struct.pack(fmt, v))
                for _ in range(width - len(e)):
                    out.extend(struct.pack(fmt, eov))
            continue
        decl = hdr.format.get(key)
        typ = decl.type if decl else _infer_type(
            [x for f in fields for x in f.split(",")]
        )
        split = [f.split(",") if f != "." else ["."] for f in fields]
        width = max(len(s) for s in split)
        if typ == "Integer":
            mat = [
                [None if x == "." else int(x) for x in s] for s in split
            ]
            flat = [v for row in mat for v in row if v is not None]
            t = _int_type_for(flat)
            fmt, missing, eov = {
                T_INT8: ("<b", INT8_MISSING, INT8_EOV),
                T_INT16: ("<h", INT16_MISSING, INT16_EOV),
                T_INT32: ("<i", INT32_MISSING, INT32_EOV),
            }[t]
            write_descriptor(out, t, width)
            for row in mat:
                for v in row:
                    out.extend(struct.pack(fmt, missing if v is None else v))
                for _ in range(width - len(row)):
                    out.extend(struct.pack(fmt, eov))
        elif typ == "Float":
            write_descriptor(out, T_FLOAT, width)
            for s in split:
                for x in s:
                    if x == ".":
                        out.extend(struct.pack("<I", FLOAT_MISSING_BITS))
                    else:
                        out.extend(struct.pack("<f", float(x)))
                for _ in range(width - len(s)):
                    out.extend(struct.pack("<I", FLOAT_EOV_BITS))
        else:  # String per sample, NUL-padded to a fixed width
            raws = [f.encode("latin-1") for f in fields]
            width = max(len(r) for r in raws)
            write_descriptor(out, T_CHAR, width)
            for r in raws:
                out.extend(r.ljust(width, b"\x00"))
    return out, len(keys)


def _gt_ints(field: str) -> List[int]:
    """Per the spec a missing GT allele encodes as 0 ((.-allele+1)<<1), so a
    bare '.' field is the single value [0]."""
    if field in (".", ""):
        return [0]
    out: List[int] = []
    phased = False
    for tok in re.split(r"([/|])", field):
        if tok == "|":
            phased = True
        elif tok == "/":
            phased = False
        elif tok:
            allele = 0 if tok == "." else int(tok) + 1
            out.append((allele << 1) | (1 if phased and out else 0))
    return out


# ---------------------------------------------------------------------------
# Whole-payload helpers (uncompressed BCF payload)
# ---------------------------------------------------------------------------


def encode_header(vcf: VcfHeader) -> bytes:
    text = vcf.encode() + b"\x00"
    return MAGIC + struct.pack("<I", len(text)) + text


def decode_header(buf) -> Tuple[BcfHeader, int]:
    """(header, offset of first record) from an uncompressed BCF payload."""
    if bytes(buf[:3]) != b"BCF":
        raise BcfError("not a BCF stream (bad magic)")
    if bytes(buf[3:5]) != b"\x02\x02" and buf[3] != 2:
        raise BcfError(f"unsupported BCF version {buf[3]}.{buf[4]}")
    (l_text,) = struct.unpack_from("<I", buf, 5)
    if len(buf) < 9 + l_text:
        # A truncated buffer must not silently parse as a shorter header
        # (prefix readers grow on this error until the dictionary is whole).
        raise BcfError(
            f"BCF header truncated: need {9 + l_text} bytes, have {len(buf)}"
        )
    text = bytes(buf[9 : 9 + l_text]).rstrip(b"\x00").decode()
    return BcfHeader(VcfHeader.parse(text)), 9 + l_text


def write_bcf(
    stream, vcf: VcfHeader, variants: List[VariantContext]
) -> None:
    """Complete BGZF-compressed BCF file."""
    from . import bgzf

    hdr = BcfHeader(vcf)
    w = bgzf.BgzfWriter(stream, append_terminator=True)
    w.write(encode_header(vcf))
    for v in variants:
        w.write(encode_record(hdr, v))
    w.close()


def read_bcf(path_or_bytes) -> Tuple[BcfHeader, List[BcfVariant]]:
    from . import bgzf

    data = (
        path_or_bytes
        if isinstance(path_or_bytes, (bytes, bytearray))
        else open(path_or_bytes, "rb").read()
    )
    payload = (
        bgzf.inflate_blocks(data, *bgzf.scan_blocks(data))[0].tobytes()
        if bgzf.is_bgzf(data)
        else data
    )
    hdr, p = decode_header(payload)
    out: List[BcfVariant] = []
    while p + 8 <= len(payload):
        v, p = decode_record(payload, p, hdr)
        out.append(v)
    return hdr, out

"""Header-free wire format for moving variants between processes.

Counterpart of ``hadoop_bam_tpu/spec/wire.py`` (the VariantContextCodec
role, VariantContextCodec.java:47-249): BCF cannot encode a record without
its header and htsjdk's VCF writer needs one (VariantContextWritable.java:
44-53), so variants travel as chrom, start, end, id, alleles, qual (missing
= the signaling-NaN bits 0x7F800001), filters and INFO text, with the
genotypes unparsed: none, VCF text, or the raw BCF indiv block (the
Lazy*GenotypesContext stance).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from .bcf import BcfHeader, BcfVariant, LazyBcfGenotypes, FLOAT_MISSING_BITS
from .vcf import VariantContext

_GT_NONE = 0  # no genotype data
_GT_VCF_TEXT = 1  # FORMAT+samples as VCF text (LazyVCFGenotypesContext)
_GT_BCF_RAW = 2  # undecoded BCF indiv block (LazyBCFGenotypesContext)


def _put_str(out: bytearray, s: str) -> None:
    raw = s.encode()
    out.extend(struct.pack("<I", len(raw)))
    out.extend(raw)


def _get_str(buf, p: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, p)
    p += 4
    return bytes(buf[p : p + n]).decode(), p + n


def encode_variant(v: VariantContext) -> bytes:
    out = bytearray()
    _put_str(out, v.chrom)
    out.extend(struct.pack("<ii", v.pos, v.end))
    _put_str(out, v.id)
    alleles = [v.ref] + list(v.alts)
    out.extend(struct.pack("<I", len(alleles)))
    for a in alleles:
        _put_str(out, a)
    if v.qual is None:
        out.extend(struct.pack("<I", FLOAT_MISSING_BITS))
    else:
        out.extend(struct.pack("<f", v.qual))
    out.extend(struct.pack("<I", len(v.filters)))
    for f in v.filters:
        _put_str(out, f)
    _put_str(out, v.info)
    lazy = getattr(v, "_lazy", None)
    wire = getattr(v, "_wire_bcf_genotypes", None)
    if isinstance(v, BcfVariant) and lazy is not None:
        out.append(_GT_BCF_RAW)
        out.extend(struct.pack("<II", lazy.n_fmt, lazy.n_sample))
        out.extend(struct.pack("<I", len(lazy.raw)))
        out.extend(lazy.raw)
    elif wire is not None:
        # Decoded without a header and never reattached: the raw indiv block
        # must keep travelling on a re-encode (multi-hop relay).
        n_fmt, n_sample, raw = wire
        out.append(_GT_BCF_RAW)
        out.extend(struct.pack("<II", n_fmt, n_sample))
        out.extend(struct.pack("<I", len(raw)))
        out.extend(raw)
    elif v.genotypes_raw:
        out.append(_GT_VCF_TEXT)
        _put_str(out, v.genotypes_raw)
    else:
        out.append(_GT_NONE)
    return bytes(out)


def decode_variant(
    buf, p: int = 0, bcf_header: Optional[BcfHeader] = None
) -> Tuple[VariantContext, int]:
    """Decode one variant.  ``bcf_header`` plays the HeaderDataCache role
    (VCFRecordWriter.java:141-149): it must be supplied before BCF-raw
    genotypes can materialise; the raw bytes travel regardless."""
    chrom, p = _get_str(buf, p)
    pos, end = struct.unpack_from("<ii", buf, p)
    p += 8
    vid, p = _get_str(buf, p)
    (n_alleles,) = struct.unpack_from("<I", buf, p)
    p += 4
    alleles = []
    for _ in range(n_alleles):
        a, p = _get_str(buf, p)
        alleles.append(a)
    (qual_bits,) = struct.unpack_from("<I", buf, p)
    qual = (
        None
        if qual_bits == FLOAT_MISSING_BITS
        else struct.unpack_from("<f", buf, p)[0]
    )
    p += 4
    (n_filt,) = struct.unpack_from("<I", buf, p)
    p += 4
    filters = []
    for _ in range(n_filt):
        f, p = _get_str(buf, p)
        filters.append(f)
    info, p = _get_str(buf, p)
    kind = buf[p]
    p += 1
    common = dict(
        chrom=chrom,
        pos=pos,
        id=vid,
        ref=alleles[0] if alleles else "N",
        alts=alleles[1:],
        qual=qual,
        filters=filters,
        info=info,
    )
    if kind == _GT_BCF_RAW:
        n_fmt, n_sample = struct.unpack_from("<II", buf, p)
        p += 8
        (n_raw,) = struct.unpack_from("<I", buf, p)
        p += 4
        raw = bytes(buf[p : p + n_raw])
        p += n_raw
        lazy = (
            LazyBcfGenotypes(bcf_header, n_fmt, n_sample, raw)
            if bcf_header is not None
            else None
        )
        v: VariantContext = BcfVariant(genotypes_raw="", lazy=lazy, **common)
        if lazy is None:
            v._wire_bcf_genotypes = (n_fmt, n_sample, raw)  # reattach later
        return v, p
    gt = ""
    if kind == _GT_VCF_TEXT:
        gt, p = _get_str(buf, p)
    return VariantContext(genotypes_raw=gt, **common), p


def reattach_genotypes(v: VariantContext, bcf_header: BcfHeader) -> None:
    """Late header attachment for variants decoded without one
    (LazyParsingGenotypesContext.HeaderDataCache semantics)."""
    wire = getattr(v, "_wire_bcf_genotypes", None)
    if wire is not None:
        n_fmt, n_sample, raw = wire
        v._lazy = LazyBcfGenotypes(bcf_header, n_fmt, n_sample, raw)
        del v._wire_bcf_genotypes

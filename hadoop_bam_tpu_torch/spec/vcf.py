"""VCF text format: header model, variant parse/format, key function.

Counterpart of ``hadoop_bam_tpu/spec/vcf.py``.

Oracle implementation of the role htsjdk's ``VCFCodec`` plays under the
reference's VCF path.  Genotype columns stay *unparsed* (raw text), the
Lazy{VCF,BCF}GenotypesContext stance (LazyVCFGenotypesContext.java:37-128):
sorting/filtering variants never pays genotype-parse cost.

Key semantics preserved exactly (VCFRecordReader.java:200-204):
``contigIdx << 32 | (start-1)`` with the contig index taken from the
header's ##contig order, falling back to ``(int)murmur3_chars(name)`` for
unknown contigs — including Java's int truncation + sign extension.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..utils.intervals import FormatError as FormatException
from ..utils.murmur3 import murmurhash3_chars


@dataclass
class VcfHeader:
    lines: List[str]  # all '##' meta lines + the '#CHROM' line

    def __post_init__(self):
        self._contigs: List[str] = []
        for ln in self.lines:
            m = re.match(r"##contig=<.*?ID=([^,>]+)", ln)
            if m:
                self._contigs.append(m.group(1))
        self._contig_idx = {c: i for i, c in enumerate(self._contigs)}

    @property
    def contigs(self) -> List[str]:
        return self._contigs

    def contig_index(self, name: str) -> int:
        """Header contig index, or Java (int)murmur3 for unknown contigs
        (VCFRecordReader.java:200-202)."""
        idx = self._contig_idx.get(name)
        if idx is not None:
            return idx
        h = murmurhash3_chars(name, 0) & 0xFFFFFFFF
        return h - (1 << 32) if h >= 1 << 31 else h

    @property
    def samples(self) -> List[str]:
        for ln in self.lines:
            if ln.startswith("#CHROM"):
                cols = ln.split("\t")
                return cols[9:] if len(cols) > 9 else []
        return []

    def encode(self) -> bytes:
        return ("\n".join(self.lines) + "\n").encode()

    @staticmethod
    def parse(text_or_lines) -> "VcfHeader":
        if isinstance(text_or_lines, (bytes, str)):
            if isinstance(text_or_lines, bytes):
                text_or_lines = text_or_lines.decode()
            lines = [l for l in text_or_lines.split("\n") if l.startswith("#")]
        else:
            lines = list(text_or_lines)
        if not any(l.startswith("##fileformat") for l in lines):
            raise FormatException("missing ##fileformat header line")
        return VcfHeader(lines)


_MISSING_QUAL = None


@dataclass
class VariantContext:
    """One VCF site; genotype columns kept as raw text (lazy)."""

    chrom: str
    pos: int  # 1-based
    id: str
    ref: str
    alts: List[str]
    qual: Optional[float]
    filters: List[str]  # empty == missing ('.'); ['PASS'] == passed
    info: str  # raw INFO column
    genotypes_raw: str = ""  # FORMAT + sample columns, untouched

    @property
    def start(self) -> int:
        return self.pos

    @property
    def end(self) -> int:
        """END info key if present, else pos + len(ref) - 1 (htsjdk rule)."""
        m = re.search(r"(?:^|;)END=(-?\d+)(?:;|$)", self.info)
        if m:
            return int(m.group(1))
        return self.pos + len(self.ref) - 1

    def format_line(self) -> str:
        qual = (
            "."
            if self.qual is None
            else (f"{self.qual:g}" if self.qual % 1 else str(int(self.qual)))
        )
        filt = ";".join(self.filters) if self.filters else "."
        alt = ",".join(self.alts) if self.alts else "."
        base = "\t".join(
            [
                self.chrom,
                str(self.pos),
                self.id or ".",
                self.ref,
                alt,
                qual,
                filt,
                self.info or ".",
            ]
        )
        if self.genotypes_raw:
            base += "\t" + self.genotypes_raw
        return base


def parse_variant_line(line: str) -> VariantContext:
    fields = line.rstrip("\n").split("\t")
    if len(fields) < 8:
        raise FormatException(
            f"VCF data line has {len(fields)} fields (need >= 8): {line[:80]!r}"
        )
    chrom, pos_s, vid, ref, alt, qual_s, filt, info = fields[:8]
    if not chrom or not ref:
        raise FormatException(f"empty CHROM/REF in line {line[:80]!r}")
    try:
        pos = int(pos_s)
    except ValueError:
        raise FormatException(f"non-integer POS {pos_s!r}")
    if qual_s == "." or qual_s == "":
        qual = None
    else:
        try:
            qual = float(qual_s)
        except ValueError:
            raise FormatException(f"non-numeric QUAL {qual_s!r}")
    alts = [] if alt in (".", "") else alt.split(",")
    for a in alts:
        # Symbolic alleles (<DEL>, <INS:ME>…) and breakend notation allow
        # arbitrary letters in their IDs / mate coordinates (VCF 4.2
        # §1.4.5); plain tokens stay restricted to base strings.
        if re.search(r"[<>\[\]:]", a):
            ok = re.fullmatch(r"[A-Za-z0-9_.:<>\[\]=*-]+", a)
        else:
            ok = re.fullmatch(r"[ACGTNacgtn*.0-9_=-]+", a)
        if not ok:
            raise FormatException(f"malformed ALT allele {a!r}")
    filters = [] if filt in (".", "") else filt.split(";")
    genotypes_raw = "\t".join(fields[8:]) if len(fields) > 8 else ""
    return VariantContext(
        chrom=chrom,
        pos=pos,
        id="" if vid == "." else vid,
        ref=ref,
        alts=alts,
        qual=qual,
        filters=filters,
        info=info,
        genotypes_raw=genotypes_raw,
    )


def variant_key(header: VcfHeader, v: VariantContext) -> int:
    """``contigIdx << 32 | (start-1)`` with Java sign extension
    (VCFRecordReader.java:200-204)."""
    idx = header.contig_index(v.chrom)
    lo = v.start - 1
    lo64 = lo & 0xFFFFFFFFFFFFFFFF if lo < 0 else lo
    k = ((idx << 32) | lo64) & 0xFFFFFFFFFFFFFFFF
    return k - (1 << 64) if k >= 1 << 63 else k


def read_vcf(text_or_bytes) -> Tuple[VcfHeader, List[VariantContext]]:
    text = (
        text_or_bytes.decode()
        if isinstance(text_or_bytes, bytes)
        else text_or_bytes
    )
    header_lines = []
    variants = []
    for line in text.split("\n"):
        if not line:
            continue
        if line.startswith("#"):
            header_lines.append(line)
        else:
            variants.append(parse_variant_line(line))
    return VcfHeader(header_lines), variants

"""VCF input and output: format sniffing, split planning, batched reading,
the writer and the part merge.

Counterpart of ``hadoop_bam_tpu/io/vcf.py``:
- the format by extension, else by content: gunzip if needed, then a
  first byte ``B`` (BCF magic) or ``#`` (VCFFormat.java:57-72;
  ``hadoopbam.vcf.trust-exts``);
- splits: plain text by bytes; ``.gz``/``.bgz`` by bytes only when really
  BGZF (VCFInputFormat.java:198-224), plain gzip as one split; BCF files
  go to :class:`~.bcf.BcfInputFormat` (VCFInputFormat.java:271-297);
- the tabix filter of splits (VCFInputFormat.java:387-471) and the
  per-record overlap filter (VCFRecordReader.java:196-217);
- validation stringency STRICT/LENIENT/SILENT
  (``hadoopbam.vcfrecordreader.validation-stringency``,
  VCFRecordReader.java:80-92,180-194);
- the writer with its headerless part mode (VCFRecordWriter.java:152-177)
  and the part merge with its BCF guard (util/VCFFileMerger.java:44-134);
- the header reader that tries VCF, then BCF (util/VCFHeaderReader.java:51-78).

A split's lines are tokenized by array passes (:func:`_read_vectorized`),
else by the exact per-line parser.  Files are read through the filesystem
seam (:mod:`.fs`).
:class:`VariantBatch` also carries the BCF reader's device columns.
"""

from __future__ import annotations

import bisect
import gzip
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..conf import (
    VCF_INTERVALS,
    VCF_TRUST_EXTS,
    VCFRECORDREADER_VALIDATION_STRINGENCY,
    Configuration,
)
from ..spec import bgzf, indices
from ..spec.vcf import FormatException, VariantContext, VcfHeader, parse_variant_line, variant_key
from ..utils import nio
from ..utils.intervals import Interval, parse_intervals
from . import fs
from .guesser import guess_bgzf_block_start
from .splits import ByteSplit, FileVirtualSplit
from .text import (
    MAX_LINE_LENGTH,
    SplitLineReader,
    file_size,
    gather_padded,
    line_table,
    read_all,
    read_header_prefix,
    read_range,
    read_split_window,
)


def sniff_vcf_format(path: str, trust_exts: bool = True) -> Optional[str]:
    """'vcf' | 'bcf' | None (VCFFormat.java:38-72 semantics)."""
    if trust_exts:
        if path.endswith((".vcf", ".vcf.gz", ".vcf.bgz", ".vcf.bgzf.gz")):
            return "vcf"
        if path.endswith(".bcf"):
            return "bcf"
    head = read_range(path, 0, 1 << 16)
    if head[:2] == b"\x1f\x8b":
        try:
            head = (
                bgzf.inflate_block(head, 0)[0]
                if bgzf.is_bgzf(head)
                else gzip.decompress(head)
            )
        except Exception:
            return None
    if head[:1] == b"B" and head[:3] == b"BCF":
        return "bcf"
    if head[:1] == b"#":
        return "vcf"
    return None


class VariantBatch:
    """Decoded split: int64 key/pos/end SoA columns, with the per-row
    ``VariantContext`` objects materialized lazily — the sort and interval
    paths touch only the columns, so the per-record Python decode runs only
    for the rows a consumer asks for.

    ``materializer(rows=None)`` decodes every row, or the rows at the
    indices ``rows``; ``device_columns``, when set, holds the key/pos/end
    columns as int64 tensors on the device that computed them, so a join
    there needs no upload."""

    def __init__(
        self,
        header: VcfHeader,
        variants: Optional[List[VariantContext]] = None,
        keys: Optional[np.ndarray] = None,
        pos: Optional[np.ndarray] = None,
        end: Optional[np.ndarray] = None,
        materializer: Optional[Callable] = None,
        device_columns=None,
    ):
        self.header = header
        self.keys = keys if keys is not None else np.empty(0, np.int64)
        self.pos = pos if pos is not None else np.empty(0, np.int64)
        self.end = end if end is not None else np.empty(0, np.int64)
        self._variants = variants
        self._materializer = materializer
        self.device_columns = device_columns

    @property
    def variants(self) -> List[VariantContext]:
        if self._variants is None:
            self._variants = self._materializer() if self._materializer else []
        return self._variants

    def select(self, rows: Sequence[int]) -> List[VariantContext]:
        """The variants at ``rows``, in that order: from the materialized
        list when there is one, else decoded for those rows only."""
        if self._variants is None and self._materializer is not None:
            return self._materializer(np.asarray(rows, np.int64))
        vs = self.variants
        return [vs[int(i)] for i in rows]

    @property
    def n_records(self) -> int:
        return len(self.keys)


class VcfInputFormat:
    def __init__(self, conf: Optional[Configuration] = None):
        self.conf = conf or Configuration()

    # -- stringency (VCFRecordReader.java:80-92) ----------------------------

    def _stringency(self) -> str:
        s = (
            self.conf.get(VCFRECORDREADER_VALIDATION_STRINGENCY, "STRICT")
            or "STRICT"
        ).upper()
        if s not in ("STRICT", "LENIENT", "SILENT"):
            raise ValueError(f"invalid validation stringency {s}")
        return s

    def _intervals(self) -> Optional[List[Interval]]:
        return parse_intervals(self.conf.get(VCF_INTERVALS))

    # -- planning -----------------------------------------------------------

    def get_splits(self, paths, split_size: int = 4 << 20):
        """Partition by sniffed format and delegate BCF files to the BCF
        planner (VCFInputFormat.java:271-297); returns a mixed list of
        ByteSplit (VCF) and FileVirtualSplit (BCF)."""
        trust = self.conf.get_boolean(VCF_TRUST_EXTS, True)
        bcf_paths = [p for p in paths if sniff_vcf_format(p, trust) == "bcf"]
        if bcf_paths:
            from .bcf import BcfInputFormat

            sub = BcfInputFormat(self.conf)
            rest = [p for p in paths if p not in bcf_paths]
            mixed = list(sub.get_splits(bcf_paths, split_size))
            if rest:
                mixed += self.get_splits(rest, split_size)
            return mixed
        out: List[ByteSplit] = []
        for path in sorted(paths):
            size = file_size(path)
            head = read_range(path, 0, 18)
            if head[:2] == b"\x1f\x8b":
                if bgzf.parse_block_header(head + b"\x00" * 64, 0) or bgzf.is_bgzf(
                    read_range(path, 0, 1 << 16)
                ):
                    # BGZF: splittable on compressed offsets, snapped to
                    # block boundaries at read time.
                    out.extend(
                        ByteSplit(path, s, min(split_size, size - s))
                        for s in range(0, size, split_size)
                    )
                else:
                    # plain gzip: unsplittable (VCFInputFormat.java:216-221)
                    out.append(ByteSplit(path, 0, size))
            else:
                out.extend(
                    ByteSplit(
                        path, s, min(split_size, size - s), compressed=False
                    )
                    for s in range(0, size, split_size)
                )
        ivs = self._intervals()
        if ivs is not None:
            out = self.filter_by_interval(out, ivs)
        return out

    def filter_by_interval(
        self, splits: List[ByteSplit], intervals: List[Interval]
    ) -> List[ByteSplit]:
        """Drop splits whose tabix chunk spans miss every interval
        (VCFInputFormat.java:387-471).  Files without a .tbi are kept whole
        (warn-and-keep in the reference)."""
        out: List[ByteSplit] = []
        for s in splits:
            tbi_path = s.path + ".tbi"
            if not fs.get_fs(tbi_path).exists(tbi_path):
                out.append(s)
                continue
            tbi = indices.Tabix.load(tbi_path)
            keep = False
            for iv in intervals:
                for c in tbi.query(iv.contig, iv.start - 1, iv.end):
                    c_beg, c_end = c.beg >> 16, c.end >> 16
                    if c_beg < s.end and c_end >= s.start:
                        keep = True
                        break
                if keep:
                    break
            if keep:
                out.append(s)
        return out

    # -- reading ------------------------------------------------------------

    def read_split(
        self, split, data: Optional[bytes] = None
    ) -> VariantBatch:
        """Decode every variant whose line starts inside the split.  BCF
        splits (FileVirtualSplit) go to the BCF reader, which reads its
        split's window from the file itself."""
        if isinstance(split, FileVirtualSplit):
            from .bcf import BcfInputFormat

            return BcfInputFormat(self.conf).read_split(split)
        header_text, payload, lo, hi = self._split_payload(split, data)
        header = VcfHeader.parse(header_text)
        stringency = self._stringency()
        intervals = self._intervals()
        fast = _read_vectorized(header, payload, lo, hi, intervals)
        if fast is not None:
            return fast
        reader = SplitLineReader(payload, lo, hi)
        variants: List[VariantContext] = []
        for _, line in reader.lines():
            if not line or line.startswith(b"#"):
                continue
            try:
                v = parse_variant_line(line.decode())
            except FormatException:
                if stringency == "STRICT":
                    raise
                continue  # LENIENT/SILENT skip (:180-194)
            if intervals is not None and not any(
                iv.overlaps(v.chrom, v.start, v.end) for iv in intervals
            ):
                continue
            variants.append(v)
        keys = np.array(
            [variant_key(header, v) for v in variants], dtype=np.int64
        )
        pos = np.array([v.pos for v in variants], dtype=np.int64)
        end = np.array([v.end for v in variants], dtype=np.int64)
        return VariantBatch(
            header=header, variants=variants, keys=keys, pos=pos, end=end
        )

    def _split_payload(
        self, split: ByteSplit, data: Optional[bytes]
    ) -> Tuple[str, bytes, int, int]:
        """(header_text, text_payload, line_scan_start, line_scan_end).

        Without a preloaded buffer the read is split-local: plain text
        reads only the split's window (+ margins), BGZF reads a bounded
        raw window and inflates just the blocks overlapping the split
        (guesser-anchored chain — the BGZFCodec+BGZFSplitGuesser path).
        Plain gzip is unsplittable and falls back to the whole payload.
        """
        if data is None:
            # Same classification get_splits used (a BGZF BC subfield may
            # sit beyond byte 18 when other extra fields precede it, so an
            # 18-byte sniff under-detects BGZF and would misroute a
            # splittable file to the whole-gzip path).
            head = read_range(split.path, 0, 1 << 16)
            is_bgzf_file = head[:2] == b"\x1f\x8b" and (
                bgzf.parse_block_header(head, 0) is not None
                or bgzf.is_bgzf(head)
            )
            if is_bgzf_file:
                return self._bgzf_split_payload(split)
            if head[:2] == b"\x1f\x8b":
                data = read_all(split.path)  # plain gzip: whole file
            else:
                window, rsplit = read_split_window(split)
                return (
                    _header_prefix_text(split.path),
                    window,
                    rsplit.start,
                    rsplit.end,
                )
        if data[:2] == b"\x1f\x8b" and not bgzf.is_bgzf(data):
            payload = gzip.decompress(data)
            return _header_text(payload), payload, split.start, len(payload)
        if bgzf.is_bgzf(data):
            # Snap [start, end) to BGZF blocks (the BGZFCodec+guesser path,
            # util/BGZFCodec.java:56-63).  The previous block is inflated too
            # so the standard skip-partial-first-line protocol sees whether
            # local offset 0 really starts a line; one extra trailing block
            # completes the last straddling line.
            htext = _bgzf_header_text(data)
            starts = bgzf.scan_blocks(data)[0].tolist()
            i0 = bisect.bisect_left(starts, split.start)
            i1 = bisect.bisect_left(starts, split.end)
            if i0 >= i1:
                return htext, b"", 0, 0  # no block starts inside this split

            def inflate(i: int) -> bytes:
                return bgzf.inflate_block(data, starts[i])[0]

            prev = inflate(i0 - 1) if i0 > 0 else b""
            mine = b"".join(inflate(i) for i in range(i0, i1))
            extra = inflate(i1) if i1 < len(starts) else b""
            chunk = prev + mine + extra
            return htext, chunk, len(prev), len(prev) + len(mine)
        return _header_text(data), data, split.start, split.end

    def _bgzf_split_payload(self, split: ByteSplit) -> Tuple[str, bytes, int, int]:
        """Split-local BGZF VCF: inflate only the blocks overlapping the
        split, located by walking the block chain from a CRC-verified
        guessed boundary inside a bounded raw window (blocks are ≤64KiB,
        so a 2·64KiB back-margin always contains a block start; the
        forward margin covers the one-extra-block line-completion rule)."""
        size = file_size(split.path)
        end = min(split.end, size)
        w0 = max(0, split.start - 2 * 0xFFFF)
        w1 = min(size, end + 4 * 0xFFFF)
        window = read_range(split.path, w0, w1 - w0)
        # Growing prefix reads until the inflated header is complete — a
        # *terminated* #CHROM line (an unterminated fragment would silently
        # drop trailing sample columns on large cohorts) — O(header) bytes.
        n = 1 << 20
        while True:
            prefix = (
                window if w0 == 0 and size <= len(window)
                else read_range(split.path, 0, min(n, size))
            )
            chunk = _bgzf_header_chunk(prefix)
            i = chunk.find(b"\n#CHROM")
            if (i >= 0 and chunk.find(b"\n", i + 1) >= 0) or n >= size:
                htext = _header_text(bytes(chunk))
                break
            n *= 4
        # Walk the chain from the first verified boundary in the window.
        at = 0 if w0 == 0 else guess_bgzf_block_start(window, 0, len(window))
        if at is None or w0 + at >= end:
            return htext, b"", 0, 0
        prev = b""
        mine: List[bytes] = []
        extra = b""
        pos = at
        while pos < len(window):
            try:
                payload, csize = bgzf.inflate_block(window, pos)
            except bgzf.BgzfError:
                break  # window truncated mid-block: chain is complete
            abs_off = w0 + pos
            if abs_off < split.start:
                prev = payload  # only the last pre-split block is kept
            elif abs_off < end:
                mine.append(payload)
            else:
                extra = payload  # one block past the split end
                break
            pos += csize
        if not mine:
            return htext, b"", 0, 0
        body = b"".join(mine)
        chunk = prev + body + extra
        return htext, chunk, len(prev), len(prev) + len(body)


# Byte classes for the vectorized structural validation (exactly the
# conditions parse_variant_line raises on; anything murkier bails to the
# per-line path so error semantics — STRICT raise / LENIENT skip — stay
# bit-identical).
_ALT_OK = np.zeros(256, dtype=bool)
for _c in b"ACGTNacgtn*.0123456789_=-,":
    _ALT_OK[_c] = True
# Symbolic-allele / breakend markers: fields containing these fall back to
# the exact per-token parser (token-level validation doesn't vectorize).
_ALT_SYM = np.zeros(256, dtype=bool)
for _c in b"<>[]:":
    _ALT_SYM[_c] = True
_QUAL_OK = np.zeros(256, dtype=bool)
for _c in b"0123456789.":
    _QUAL_OK[_c] = True
del _c


def _read_vectorized(
    header: VcfHeader,
    payload: bytes,
    lo: int,
    hi: int,
    intervals,
) -> Optional["VariantBatch"]:
    """One-pass vectorized tokenizer for the VCF hot path: a newline scan builds the line table, one tab scan builds the
    8-column field table, and CHROM→contig-index, POS, REF-length and the
    64-bit keys come out as array ops — no per-line Python.

    Returns None when any line needs the exact per-line parser: structural
    problems (missing tabs, non-digit POS, unusual QUAL/ALT syntax) or a
    CHROM outside the header dictionary (murmur3 key fallback).  The
    VariantContext rows themselves stay lazy (materialized from the line
    table only if a consumer asks)."""
    a = np.frombuffer(payload, np.uint8)
    if lo > 0:
        # Split resync: drop the (possibly partial) first line, exactly as
        # SplitLineReader does — a mid-line fragment can otherwise pass
        # the structural screen and emit a spurious variant.
        nl = payload.find(b"\n", lo - 1)
        lo = len(payload) if nl < 0 else nl + 1
        if lo >= hi:
            return VariantBatch(header=header)
    starts, lens = line_table(a, lo, hi)
    keep = (lens > 0) & (a[np.minimum(starts, len(a) - 1)] != 0x23)
    starts, lens = starts[keep], lens[keep]
    n = len(starts)
    if n == 0:
        return VariantBatch(header=header)
    line_end = starts + lens
    # A line cut off by line_table's bounded scan window (giant-cohort
    # rows) must not be materialized half-parsed: bail to the exact path,
    # whose reader walks to the real newline.
    window_end = min(len(a), hi + 4 * (MAX_LINE_LENGTH + 1))
    if window_end < len(a) and bool((line_end >= window_end).any()):
        return None

    # ---- field table: the k-th tab of line i ---------------------------
    wlo, whi = int(starts[0]), int(line_end.max())
    tabs = wlo + np.nonzero(a[wlo:whi] == 0x09)[0]
    t0 = np.searchsorted(tabs, starts)
    tk = t0[:, None] + np.arange(7)
    if len(tabs) == 0:
        return None
    exists = tk < len(tabs)
    T = tabs[np.minimum(tk, len(tabs) - 1)]
    if not (exists & (T < line_end[:, None])).all():
        return None  # a line with < 8 fields: exact error text needed
    fstart = np.concatenate([starts[:, None], T + 1], axis=1)  # field starts
    # INFO ends at the 8th tab when genotype columns follow, else line end.
    tk7 = t0 + 7
    has8 = (tk7 < len(tabs)) & (
        tabs[np.minimum(tk7, len(tabs) - 1)] < line_end
    )
    info_end = np.where(
        has8, tabs[np.minimum(tk7, len(tabs) - 1)], line_end
    )
    fe = np.concatenate([T, info_end[:, None]], axis=1)  # field ends
    flen = fe - fstart

    if (flen[:, 0] == 0).any() or (flen[:, 3] == 0).any():
        return None  # empty CHROM/REF
    # REF length feeds `end` in CHARACTERS (the exact parser's len(str));
    # any non-ASCII byte would make byte length diverge — exact path.
    rlen = flen[:, 3]
    Wr = int(rlen.max())
    rmat = gather_padded(a, fstart[:, 3], rlen, Wr)
    if (rmat >= 0x80).any():
        return None

    # ---- POS: strict [0-9]{1,10} --------------------------------------
    plen = flen[:, 1]
    if (plen == 0).any() or (plen > 10).any():
        return None
    pmat = gather_padded(a, fstart[:, 1], plen, int(plen.max()))
    pdig = pmat - 48
    col = np.arange(pmat.shape[1])[None, :]
    pvalid = col < plen[:, None]
    if ((pdig < 0) | (pdig > 9))[pvalid].any():
        return None
    pos = np.zeros(n, dtype=np.int64)
    for c in range(pmat.shape[1]):
        live = pvalid[:, c]
        pos = np.where(live, pos * 10 + pdig[:, c], pos)

    # ---- QUAL: '.' or empty or [0-9]+(.[0-9]*)? ------------------------
    qlen = flen[:, 5]
    W = int(qlen.max()) if n else 0
    if W:
        qmat = gather_padded(a, fstart[:, 5], qlen, W)
        qcol = np.arange(W)[None, :]
        qvalid = qcol < qlen[:, None]
        is_dot = (qlen == 1) & (qmat[:, 0] == 0x2E)
        plain = qlen == 0
        charset = (~qvalid | _QUAL_OK[qmat]).all(axis=1)
        ndots = ((qmat == 0x2E) & qvalid).sum(axis=1)
        ndigs = ((qmat >= 48) & (qmat <= 57) & qvalid).sum(axis=1)
        numeric = charset & (ndots <= 1) & (ndigs >= 1)
        if not (is_dot | plain | numeric).all():
            return None

    # ---- ALT charset (incl. ',' separators), no empty tokens -----------
    alen = flen[:, 4]
    Wa = int(alen.max()) if n else 0
    if Wa:
        amat = gather_padded(a, fstart[:, 4], alen, Wa)
        acol = np.arange(Wa)[None, :]
        avalid = acol < alen[:, None]
        if (avalid & _ALT_SYM[amat]).any():
            return None  # symbolic/breakend alleles: exact token parser
        if not (~avalid | _ALT_OK[amat]).all():
            return None
        comma = (amat == 0x2C) & avalid
        if comma.any():
            # reject ',,', leading/trailing comma → exact parser decides
            nxt = np.pad(comma[:, 1:], ((0, 0), (0, 1)))
            edge = comma[:, 0:1].any(axis=1) | (
                comma & (acol == (alen - 1)[:, None])
            ).any(axis=1)
            if (comma & nxt).any() or edge.any():
                return None
        if (alen == 0).any():
            return None

    # ---- CHROM → contig index (all must be in the header dict) ---------
    # A split holds few distinct CHROMs; unique-ify the padded rows once
    # and do one dict lookup per distinct name (a per-contig matrix
    # compare would be O(contigs·lines·width) — GRCh38 headers carry
    # thousands of contig lines).
    if not header.contigs:
        return None
    clen = flen[:, 0]
    Wc = int(clen.max())
    cmat = gather_padded(a, fstart[:, 0], clen, Wc)
    if Wc <= 16:
        # Pack each padded row into 1-2 machine words: scalar np.unique is
        # an order of magnitude faster than the axis=0 (row-sort) form.
        packed = np.zeros((n, 16), np.uint8)
        packed[:, :Wc] = cmat
        key2 = packed.view(np.uint64).reshape(n, 2)
        uniq, inv = np.unique(
            key2[:, 0] ^ (key2[:, 1] * np.uint64(0x9E3779B97F4A7C15)),
            return_inverse=True,
        )
        # The xor-mix is only a bucketing key; recover each bucket's name
        # from its first row (collisions across distinct names are broken
        # by re-checking the name text below).
        first_row = np.zeros(len(uniq), np.int64)
        first_row[inv[::-1]] = np.arange(n - 1, -1, -1)
        names = [
            bytes(cmat[r]).rstrip(b"\x00").decode(errors="replace")
            for r in first_row
        ]
        # Guard against (astronomically unlikely) mix collisions: every
        # row in a bucket must equal the bucket's representative row.
        if not (cmat == cmat[first_row[inv]]).all():
            return None
    else:
        uniq_rows, inv = np.unique(cmat, axis=0, return_inverse=True)
        names = [
            bytes(u).rstrip(b"\x00").decode(errors="replace")
            for u in uniq_rows
        ]
    lut = np.empty(len(names), dtype=np.int64)
    for u, name in enumerate(names):
        idx = header._contig_idx.get(name)
        if idx is None:
            return None  # unknown contig: murmur3 key path, exact parser
        lut[u] = idx
    cidx = lut[inv]

    # ---- END: pos + len(REF) - 1, with the INFO END= override ----------
    end = pos + flen[:, 3].astype(np.int64) - 1
    # Lines whose INFO contains an END= key (at the field start or after
    # ';') re-derive end through the exact parser — rare (SV records).
    # Scan only the split's byte window (INFO fields can't point outside).
    w = a[wlo : int(line_end.max())]
    if len(w) >= 4:
        m4 = (
            (w[:-3] == 0x45) & (w[1:-2] == 0x4E)
            & (w[2:-1] == 0x44) & (w[3:] == 0x3D)
        )
        hits = wlo + np.nonzero(m4)[0]
    else:
        hits = np.empty(0, np.int64)
    if len(hits):
        i0 = np.searchsorted(hits, fstart[:, 7])
        i1 = np.searchsorted(hits, fe[:, 7] - 3)
        flagged = np.nonzero(i1 > i0)[0]
        for r in flagged:
            line = bytes(a[starts[r] : line_end[r]]).decode()
            try:
                end[r] = parse_variant_line(line).end
            except FormatException:
                return None

    keys = (cidx << np.int64(32)) | (pos - 1)

    if intervals is not None:
        ivkeep = np.zeros(n, dtype=bool)
        for iv in intervals:
            iv_idx = header._contig_idx.get(iv.contig)
            if iv_idx is None:
                continue  # known-contig lines can't string-match it
            ivkeep |= (
                (cidx == iv_idx) & (pos <= iv.end) & (end >= iv.start)
            )
        starts, line_end = starts[ivkeep], line_end[ivkeep]
        keys, pos, end = keys[ivkeep], pos[ivkeep], end[ivkeep]

    l_starts = starts.copy()
    l_ends = line_end.copy()

    def materialize(rows=None) -> List[VariantContext]:
        mv = memoryview(payload)
        s_, e_ = (l_starts, l_ends) if rows is None else (l_starts[rows], l_ends[rows])
        return [
            parse_variant_line(str(mv[int(s) : int(e)], "utf-8"))
            for s, e in zip(s_, e_)
        ]

    return VariantBatch(
        header=header,
        keys=keys.astype(np.int64),
        pos=pos.astype(np.int64),
        end=end.astype(np.int64),
        materializer=materialize,
    )


def _header_prefix_text(path: str) -> str:
    """Leading ``#`` header lines of a plain-text VCF via growing prefix
    reads — O(header), not O(file)."""
    return _header_text(read_header_prefix(path, b"#"))


def _bgzf_header_chunk(data: bytes) -> bytes:
    """Inflate only as many leading BGZF blocks as the header occupies
    (stops once a terminated #CHROM line is present, or the available
    blocks run out)."""
    chunk = bytearray()
    pos = 0
    while pos < len(data):
        try:
            p, csize = bgzf.inflate_block(data, pos)
        except bgzf.BgzfError:
            break
        chunk.extend(p)
        pos += csize
        if b"\n#CHROM" in chunk and b"\n" in chunk[chunk.find(b"\n#CHROM") + 1 :]:
            break
    return bytes(chunk)


def _bgzf_header_text(data: bytes) -> str:
    """Header lines of a BGZF VCF, inflating only as many leading blocks as
    the header occupies."""
    return _header_text(_bgzf_header_chunk(data))


def _header_text(payload: bytes) -> str:
    lines = []
    for raw in payload.split(b"\n"):
        if raw.startswith(b"#"):
            lines.append(raw.decode())
        else:
            break
    return "\n".join(lines)


class VcfRecordWriter:
    """Text VCF writer with swallowed-header part mode and optional BGZF
    output (VCFRecordWriter.java:51-177, KeyIgnoringVCFOutputFormat:93-114).
    """

    def __init__(
        self,
        stream,
        header: VcfHeader,
        write_header: bool = True,
        compress_bgzf: bool = False,
        append_terminator: bool = False,
    ):
        self._compress = compress_bgzf
        if compress_bgzf:
            self._w = bgzf.BgzfWriter(
                stream, append_terminator=append_terminator
            )
        else:
            self._w = stream
        if write_header:
            self._w.write(header.encode())

    def write(self, v: VariantContext) -> None:
        self._w.write(v.format_line().encode() + b"\n")

    def close(self) -> None:
        if self._compress:
            self._w.close()


def merge_vcf_parts(
    part_dir: str,
    out_path: str,
    header: VcfHeader,
    check_success: bool = True,
) -> None:
    """Concatenate headerless parts after the header; block-compressed parts
    get the BGZF terminator appended (util/VCFFileMerger.java:44-134)."""
    if check_success:
        nio.check_success(part_dir)
    parts = nio.list_parts(part_dir)
    first = parts[0].read_bytes() if parts else b""
    if first[:3] == b"BCF":
        raise ValueError("BCF merging is not supported")  # :63-65
    block_compressed = bgzf.is_bgzf(first)
    plain_gzip = not block_compressed and first[:2] == b"\x1f\x8b"
    with open(out_path, "wb") as out:
        hdr_bytes = header.encode()
        if block_compressed:
            w = bgzf.BgzfWriter(out, append_terminator=False)
            w.write(hdr_bytes)
            w.close()
        elif plain_gzip:
            out.write(gzip.compress(hdr_bytes))
        else:
            out.write(hdr_bytes)
        nio.concat_files(parts, out)
        if block_compressed:
            out.write(bgzf.TERMINATOR)


def read_vcf_header(path: str) -> VcfHeader:
    """Header from VCF / gz-VCF / BGZF-VCF / BCF without knowing which
    (try-VCF-then-BCF, util/VCFHeaderReader.java:51-78)."""
    raw = read_range(path, 0, 1 << 22)
    probe = raw
    if bgzf.is_bgzf(raw):
        try:
            probe = bgzf.inflate_block(raw, 0)[0]
        except bgzf.BgzfError:
            probe = raw
    if probe[:3] == b"BCF":
        from .bcf import read_bcf_header

        return read_bcf_header(raw)[0].vcf
    if raw[:2] == b"\x1f\x8b":
        if bgzf.is_bgzf(raw):
            chunk = bytearray()
            pos = 0
            while pos < len(raw):
                try:
                    p, csize = bgzf.inflate_block(raw, pos)
                except bgzf.BgzfError:
                    break
                chunk.extend(p)
                pos += csize
                if b"\n#CHROM" in chunk:
                    break
            raw = bytes(chunk)
        else:
            raw = gzip.decompress(read_all(path))
    return VcfHeader.parse(_header_text(raw))

"""Index formats: ``.splitting-bai``, ``.bai``, ``.tbi`` (tabix), ``.bgzfi``.

Counterpart of ``hadoop_bam_tpu/spec/indices.py``:

- ``SplittingBai``: big-endian u64 virtual offsets of every g-th alignment,
  terminated by ``fileSize << 16`` (SplittingBAMIndexer.java semantics);
  ``build_splitting_bai`` derives one from a whole BAM;
- ``Bai``: the standard BAM index (SAM spec §5.2) with linear-index access
  and interval → chunk-span queries (the getFileSpan path of
  filterByInterval); ``build_bai`` derives one from a coordinate-sorted
  BAM, byte for byte the reference's per-record ``BaiBuilder`` walk, from
  the SoA columns of the whole file at once;
- ``Tabix``: the ``.tbi`` of a BGZF text file (VCF) with interval → chunk
  span queries, which filter VCF splits (VCFInputFormat.java:387-471);
- ``BgzfBlockIndex``: ``.bgzfi``, 48-bit big-endian offsets of every Nth
  BGZF block and the file size (util/BGZFBlockIndexer.java:109-127).
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import bgzf

SPLITTING_BAI_EXT = ".splitting-bai"
DEFAULT_GRANULARITY = 4096
BAI_MAGIC = b"BAI\x01"
TBI_MAGIC = b"TBI\x01"
BGZFI_EXT = ".bgzfi"
MAX_BIN = 37450  # pseudo-bin holding file-level metadata


class SplittingBai:
    """Reader: the sorted virtual offsets, queried by floor/higher."""

    def __init__(self, voffsets: Sequence[int]):
        if len(voffsets) < 1:
            raise IOError(
                "Invalid splitting BAM index: should contain at least the file size"
            )
        if any(b < a for a, b in zip(voffsets, voffsets[1:])):
            raise IOError("Invalid splitting BAM index; offsets not in order")
        self.voffsets: List[int] = list(voffsets)

    @staticmethod
    def load(source: Union[str, bytes, BinaryIO]) -> "SplittingBai":
        if isinstance(source, str):
            with open(source, "rb") as f:
                raw = f.read()
        elif isinstance(source, bytes):
            raw = source
        else:
            raw = source.read()
        if len(raw) % 8 != 0:
            raise IOError("Invalid splitting BAM index: truncated")
        return SplittingBai(list(struct.unpack(f">{len(raw) // 8}Q", raw)))

    def save(self, stream: BinaryIO) -> None:
        stream.write(struct.pack(f">{len(self.voffsets)}Q", *self.voffsets))

    def prev_alignment(self, file_pos: int) -> Optional[int]:
        i = bisect.bisect_right(self.voffsets, file_pos << 16)
        return self.voffsets[i - 1] if i > 0 else None

    def next_alignment(self, file_pos: int) -> Optional[int]:
        i = bisect.bisect_right(self.voffsets, file_pos << 16)
        return self.voffsets[i] if i < len(self.voffsets) else None

    def bam_size(self) -> int:
        return self.voffsets[-1] >> 16

    def size(self) -> int:
        return len(self.voffsets)


class SplittingBaiBuilder:
    """Records the offset of alignment 0 and of every alignment whose
    ``(count + 1) % granularity == 0``; finishes with ``fileSize << 16``."""

    def __init__(self, granularity: int = DEFAULT_GRANULARITY):
        if granularity < 1:
            raise ValueError("granularity must be >= 1")
        self.granularity = granularity
        self.count = 0
        self.voffsets: List[int] = []

    def process_alignment(self, virtual_offset: int) -> None:
        if self.count == 0 or (self.count + 1) % self.granularity == 0:
            self.voffsets.append(virtual_offset)
        self.count += 1

    def finish(self, input_size: int) -> SplittingBai:
        self.voffsets.append(input_size << 16)
        return SplittingBai(self.voffsets)


def build_splitting_bai(
    bam_path_or_bytes: Union[str, bytes],
    granularity: int = DEFAULT_GRANULARITY,
) -> SplittingBai:
    """The ``.splitting-bai`` of a whole BAM (SplittingBAMIndexer.index,
    :248-290): the reference skips the header and walks the records one at
    a time through a BGZF reader; this inflates every member at once and
    takes the same virtual offsets from the record chain.  A truncated
    record raises :class:`~.bgzf.BgzfError`; fewer than four trailing
    bytes end the walk."""
    if isinstance(bam_path_or_bytes, str):
        with open(bam_path_or_bytes, "rb") as f:
            raw = f.read()
    else:
        raw = bam_path_or_bytes
    offs, _, _, co, cs, uoffs = _record_chain(raw)
    builder = SplittingBaiBuilder(granularity)
    n = len(offs)
    if n:
        pick = (np.arange(n) + 1) % granularity == 0
        pick[0] = True
        builder.voffsets = _reader_voffsets(offs[pick], co, cs, uoffs).tolist()
        builder.count = n
    return builder.finish(len(raw))


def merge_splitting_bais(
    indices: Sequence[SplittingBai],
    part_lengths: Sequence[int],
    header_length: int,
    total_length: int,
    out: BinaryIO,
) -> None:
    """Shift each part's offsets by the bytes before it and concatenate."""
    shift = header_length
    merged: List[int] = []
    for idx, plen in zip(indices, part_lengths):
        for v in idx.voffsets[:-1]:
            merged.append(((v >> 16) + shift) << 16 | (v & 0xFFFF))
        shift += plen
    merged.append(total_length << 16)
    SplittingBai(merged).save(out)


# ---------------------------------------------------------------------------
# .bai
# ---------------------------------------------------------------------------


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end), 0-based half-open (SAM spec §5.3)."""
    if beg >= end:
        return [0]
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


@dataclass
class Chunk:
    beg: int  # virtual offsets
    end: int


@dataclass
class RefIndex:
    bins: Dict[int, List[Chunk]] = field(default_factory=dict)
    linear: List[int] = field(default_factory=list)  # 16 KiB-window voffsets


def _read_ref_index(buf: bytes, p: int) -> Tuple[RefIndex, int]:
    (n_bin,) = struct.unpack_from("<i", buf, p)
    p += 4
    ref = RefIndex()
    for _ in range(n_bin):
        bin_, n_chunk = struct.unpack_from("<Ii", buf, p)
        p += 8
        chunks = []
        for _ in range(n_chunk):
            beg, end = struct.unpack_from("<QQ", buf, p)
            p += 16
            chunks.append(Chunk(beg, end))
        ref.bins[bin_] = chunks
    (n_intv,) = struct.unpack_from("<i", buf, p)
    p += 4
    ref.linear = list(struct.unpack_from(f"<{n_intv}Q", buf, p))
    p += 8 * n_intv
    return ref, p


def _query_ref(ref: RefIndex, beg: int, end: int) -> List[Chunk]:
    """Interval → merged chunk list, clipped by the linear index."""
    min_off = 0
    if ref.linear:
        min_off = ref.linear[min(beg >> 14, len(ref.linear) - 1)]
    chunks: List[Chunk] = []
    for b in reg2bins(beg, end):
        if b == MAX_BIN:
            continue
        for c in ref.bins.get(b, ()):
            if c.end > min_off:
                chunks.append(Chunk(max(c.beg, min_off), c.end))
    chunks.sort(key=lambda c: (c.beg, c.end))
    merged: List[Chunk] = []
    for c in chunks:
        if merged and c.beg <= merged[-1].end:
            merged[-1].end = max(merged[-1].end, c.end)
        else:
            merged.append(Chunk(c.beg, c.end))
    return merged


class Bai:
    """Standard ``.bai`` reader with linear-index access and span queries."""

    def __init__(self, refs: List[RefIndex], n_no_coor: Optional[int] = None):
        self.refs = refs
        self.n_no_coor = n_no_coor

    @staticmethod
    def load(source: Union[str, bytes]) -> "Bai":
        if isinstance(source, str):
            with open(source, "rb") as f:
                raw = f.read()
        else:
            raw = source
        if raw[:4] != BAI_MAGIC:
            raise IOError("missing BAI magic")
        (n_ref,) = struct.unpack_from("<i", raw, 4)
        p = 8
        refs = []
        for _ in range(n_ref):
            ref, p = _read_ref_index(raw, p)
            refs.append(ref)
        n_no_coor = None
        if p + 8 <= len(raw):
            (n_no_coor,) = struct.unpack_from("<Q", raw, p)
        return Bai(refs, n_no_coor)

    def linear_index(self, refid: int) -> List[int]:
        return self.refs[refid].linear

    def query(self, refid: int, beg: int, end: int) -> List[Chunk]:
        """Chunk spans possibly holding records that overlap [beg, end)
        (0-based)."""
        if refid < 0 or refid >= len(self.refs):
            return []
        return _query_ref(self.refs[refid], beg, end)

    def _chunks(self):
        for ref in self.refs:
            for b, chunks in ref.bins.items():
                if b != MAX_BIN:
                    yield from chunks

    def first_offset(self) -> Optional[int]:
        """Smallest chunk start across the whole index."""
        return min((c.beg for c in self._chunks()), default=None)

    def unmapped_span_start(self) -> Optional[int]:
        """Largest chunk end of the mapped chunks: where the unmapped tail
        begins (BAMInputFormat.java:576-584 semantics)."""
        return max((c.end for c in self._chunks()), default=None)

    def save(self, stream: BinaryIO) -> None:
        stream.write(BAI_MAGIC)
        stream.write(struct.pack("<i", len(self.refs)))
        for ref in self.refs:
            stream.write(struct.pack("<i", len(ref.bins)))
            for bin_ in sorted(ref.bins):
                chunks = ref.bins[bin_]
                stream.write(struct.pack("<Ii", bin_, len(chunks)))
                for c in chunks:
                    stream.write(struct.pack("<QQ", c.beg, c.end))
            stream.write(struct.pack("<i", len(ref.linear)))
            stream.write(struct.pack(f"<{len(ref.linear)}Q", *ref.linear))
        stream.write(struct.pack("<Q", self.n_no_coor or 0))


class BaiBuilder:
    """A ``.bai`` from (record, virtual offset) pairs, one record at a time:
    the standard 16 KiB linear windows; a record extends the last chunk of
    its bin when that chunk ends where the record starts."""

    def __init__(self, n_refs: int):
        self.refs = [RefIndex() for _ in range(n_refs)]
        self.n_no_coor = 0

    def add(self, refid: int, pos: int, end_pos: int, bin_: int,
            vstart: int, vend: int) -> None:
        """``end_pos`` is the 0-based exclusive alignment end; ``vstart`` /
        ``vend`` bracket the record's bytes in the BGZF stream."""
        if refid < 0 or pos < 0:
            self.n_no_coor += 1
            return
        ref = self.refs[refid]
        chunks = ref.bins.setdefault(bin_, [])
        if chunks and chunks[-1].end == vstart:
            chunks[-1].end = vend
        else:
            chunks.append(Chunk(vstart, vend))
        win_lo = pos >> 14
        win_hi = max(pos, end_pos - 1) >> 14
        if len(ref.linear) <= win_hi:
            ref.linear.extend([0] * (win_hi + 1 - len(ref.linear)))
        for w in range(win_lo, win_hi + 1):
            if ref.linear[w] == 0 or vstart < ref.linear[w]:
                ref.linear[w] = vstart

    def build(self) -> Bai:
        return Bai(self.refs, self.n_no_coor)

    def save(self, stream: BinaryIO) -> None:
        self.build().save(stream)


def _reader_voffsets(p: np.ndarray, coffs: np.ndarray, csizes: np.ndarray,
                     uoffs: np.ndarray) -> np.ndarray:
    """The virtual offset a sequential BGZF reader reports after consuming
    payload bytes ``[0, p)``: inside the member holding byte ``p - 1``, or
    the next member's start (uoffset 0) once that member is used up.
    ``uoffs`` are the members' payload starts plus the total (``n + 1``
    entries); every ``p`` is at least 1."""
    ends = uoffs[1:]
    bi = np.searchsorted(ends, p - 1, side="right")
    inside = p < ends[bi]
    return np.where(
        inside,
        (coffs[bi] << 16) | (p - uoffs[bi]),
        (coffs[bi] + csizes[bi]) << 16,
    )


def _record_chain(raw: bytes):
    """``(record offsets, payload, header, coffsets, csizes, payload
    starts)`` of a whole BAM: every member inflated, the header skipped by
    a BGZF reader, the record chain walked to the end."""
    from . import bam as bam_mod

    reader = bgzf.BgzfReader(raw)
    hdr = bam_mod.read_header_stream(reader)
    v0 = reader.tell_voffset()
    co, cs, us = bgzf.scan_blocks(raw)
    out, uoffs = bgzf.inflate_blocks(raw, co, cs, us)
    co = co.astype(np.int64)
    cs = cs.astype(np.int64)
    b0 = int(np.searchsorted(co, v0 >> 16))
    p0 = int(uoffs[b0]) + (v0 & 0xFFFF) if b0 < len(co) else len(out)
    offs, resume = bam_mod.record_chain_partial(out, p0, len(out))
    if len(out) - resume >= 4:
        raise bgzf.BgzfError("EOF: truncated record at the end of the BAM")
    return offs, out, hdr, co, cs, uoffs


def build_bai(bam_path_or_bytes: Union[str, bytes]) -> Bai:
    """Build a ``.bai`` of a coordinate-sorted BAM.

    The reference walks the records one at a time through a BGZF reader
    into :class:`BaiBuilder`; this inflates every member at once, walks
    the record chain, decodes the fixed fields and reference spans as
    columns and forms the same chunks (runs of consecutive placed records
    of one bin) and linear windows (the least start of the records
    covering each window), so :meth:`Bai.save` writes the same bytes.  A
    truncated record raises :class:`~.bgzf.BgzfError`; fewer than four
    trailing bytes end the walk, as in the reference."""
    from ..ops.cigar import reference_lengths_np
    from . import bam as bam_mod

    if isinstance(bam_path_or_bytes, str):
        with open(bam_path_or_bytes, "rb") as f:
            raw = f.read()
    else:
        raw = bam_path_or_bytes
    offs, out, hdr, co, cs, uoffs = _record_chain(raw)
    builder = BaiBuilder(hdr.n_refs)
    n = len(offs)
    if n == 0:
        return builder.build()
    soa = bam_mod.soa_decode(
        out, offs, fields=("refid", "pos", "bin", "l_read_name", "n_cigar_op", "rec_off",
                           "rec_len"))
    span = np.maximum(reference_lengths_np(out, soa), 1)
    vstart = _reader_voffsets(offs, co, cs, uoffs)
    vend = _reader_voffsets(offs + 4 + soa["rec_len"], co, cs, uoffs)
    refid = soa["refid"].astype(np.int64)
    pos = soa["pos"].astype(np.int64)
    bins = soa["bin"].astype(np.int64)
    placed = (refid >= 0) & (pos >= 0)
    builder.n_no_coor = int(n - placed.sum())
    if placed.any() and int(refid[placed].max()) >= hdr.n_refs:
        raise IndexError("a record's refid is past the header's references")
    # A record extends its bin's last chunk exactly when the record before
    # it in the file was placed in the same bin: chunks are runs.
    same = np.zeros(n, dtype=bool)
    same[1:] = placed[1:] & placed[:-1] & (refid[1:] == refid[:-1]) & (bins[1:] == bins[:-1])
    first = np.nonzero(placed & ~same)[0]
    last = np.nonzero(placed & ~np.append(same[1:], False))[0]
    for r, b, vb, ve in zip(refid[first].tolist(), bins[first].tolist(),
                            vstart[first].tolist(), vend[last].tolist()):
        builder.refs[r].bins.setdefault(b, []).append(Chunk(vb, ve))
    # Linear index: every placed record covers windows pos >> 14 through
    # (pos + span - 1) >> 14; a window holds the least start covering it.
    rows = np.nonzero(placed)[0]
    lo = pos[rows] >> 14
    hi = (pos[rows] + span[rows] - 1) >> 14
    reps = hi - lo + 1
    win = np.repeat(lo, reps) + (np.arange(int(reps.sum())) - np.repeat(np.cumsum(reps) - reps, reps))
    wref = np.repeat(refid[rows], reps)
    wv = np.repeat(vstart[rows], reps)
    for r in np.unique(wref).tolist():
        sel = wref == r
        lin = np.full(int(win[sel].max()) + 1, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(lin, win[sel], wv[sel])
        lin[lin == np.iinfo(np.int64).max] = 0
        builder.refs[r].linear = lin.tolist()
    return builder.build()


# ---------------------------------------------------------------------------
# .tbi
# ---------------------------------------------------------------------------


class Tabix:
    """``.tbi`` reader (BGZF-compressed or plain) with interval span
    queries."""

    def __init__(
        self,
        refs: List[RefIndex],
        names: List[str],
        fmt: int,
        col_seq: int,
        col_beg: int,
        col_end: int,
        meta_char: str,
        skip: int,
    ):
        self.refs = refs
        self.names = names
        self.fmt = fmt
        self.col_seq = col_seq
        self.col_beg = col_beg
        self.col_end = col_end
        self.meta_char = meta_char
        self.skip = skip
        self._name_to_id = {n: i for i, n in enumerate(names)}

    @staticmethod
    def load(source: Union[str, bytes]) -> "Tabix":
        if isinstance(source, str):
            with open(source, "rb") as f:
                raw = f.read()
        else:
            raw = source
        buf = bgzf.decompress_all(raw) if bgzf.is_bgzf(raw) else raw
        if buf[:4] != TBI_MAGIC:
            raise IOError("missing TBI magic")
        n_ref, fmt, col_seq, col_beg, col_end, meta, skip, l_nm = struct.unpack_from("<8i", buf, 4)
        p = 36
        names = [n.decode() for n in buf[p : p + l_nm].rstrip(b"\x00").split(b"\x00")]
        p += l_nm
        refs = []
        for _ in range(n_ref):
            ref, p = _read_ref_index(buf, p)
            refs.append(ref)
        return Tabix(refs, names, fmt, col_seq, col_beg, col_end, chr(meta), skip)

    def ref_id(self, name: str) -> int:
        return self._name_to_id.get(name, -1)

    def query(self, contig: str, beg: int, end: int) -> List[Chunk]:
        """The merged chunk spans of 0-based ``[beg, end)`` on ``contig``;
        none for a contig the index lacks."""
        rid = self.ref_id(contig)
        if rid < 0:
            return []
        return _query_ref(self.refs[rid], beg, end)


# ---------------------------------------------------------------------------
# .bgzfi
# ---------------------------------------------------------------------------


class BgzfBlockIndex:
    """``.bgzfi``: 48-bit big-endian offsets of every Nth BGZF block, the
    file size last (util/BGZFBlockIndexer.java:109-127)."""

    def __init__(self, offsets: Sequence[int]):
        self.offsets = sorted(offsets)

    @staticmethod
    def load(source: Union[str, bytes]) -> "BgzfBlockIndex":
        if isinstance(source, str):
            with open(source, "rb") as f:
                raw = f.read()
        else:
            raw = source
        if len(raw) % 6 != 0:
            raise IOError("invalid .bgzfi: not a multiple of 6 bytes")
        return BgzfBlockIndex(
            [int.from_bytes(raw[i : i + 6], "big") for i in range(0, len(raw), 6)])

    def save(self, stream: BinaryIO) -> None:
        for o in self.offsets:
            stream.write(o.to_bytes(6, "big"))

    @staticmethod
    def build(bgzf_bytes: bytes, granularity: int = 1024) -> "BgzfBlockIndex":
        """Every ``granularity``-th block and the file size
        (util/BGZFBlockIndexer.java:37-41: g = 1024 by default)."""
        co = bgzf.scan_blocks(bgzf_bytes)[0]
        return BgzfBlockIndex(co[::granularity].tolist() + [len(bgzf_bytes)])

    def prev_block(self, pos: int) -> Optional[int]:
        i = bisect.bisect_right(self.offsets, pos)
        return self.offsets[i - 1] if i > 0 else None

    def next_block(self, pos: int) -> Optional[int]:
        i = bisect.bisect_right(self.offsets, pos)
        return self.offsets[i] if i < len(self.offsets) else None

    def size(self) -> int:
        return len(self.offsets)

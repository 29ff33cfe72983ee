"""BAM input format: split planning, split reading, part writing.

Counterpart of ``hadoop_bam_tpu/io/bam.py`` for the in-core coordinate sort
and the region reads: ``BamInputFormat.get_splits`` (``.splitting-bai``
index, else the ``.bai`` splitter when enabled, else the split guesser;
then the interval filter of bounded traversal, with its unplaced-unmapped
pass), ``read_split`` with the strict path of ``read_virtual_range`` (batched
member inflate on the device or the host, spill blocks for a tail record,
the host chain walk, the split's resident window), ``RecordBatch``,
``ChunkedRecords`` (with the write path's flat resident stream), the
chunk-span cut of interval traversal (``_voffset_mask``),
``gather_record_array``, ``patch_flags``, ``rebuild_record_stream`` (the
fixmate rewrite) and ``write_part_fast`` (device-resident assembly, host
gather + deflate lanes, host gather + zlib).
Only local paths are read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..conf import (
    BAM_BOUNDED_TRAVERSAL,
    BAM_ENABLE_BAI_SPLITTER,
    BAM_INTERVALS,
    BAM_TRAVERSE_UNPLACED_UNMAPPED,
    ERRORS_MODE,
    Configuration,
)
from ..ops import flate
from ..spec import bam, bgzf, indices
from ..utils.intervals import Interval, parse_intervals
from ..utils.tracing import Metrics
from .guesser import BamSplitGuesser, find_record_start_in_payload
from .splits import FileVirtualSplit

SPLITTING_BAI_EXT = indices.SPLITTING_BAI_EXT
DEFAULT_SPLIT_SIZE = 4 << 20

#: The columns the sort needs: key inputs + record extents.
SORT_FIELDS = ("refid", "pos", "flag", "rec_off", "rec_len")


@dataclass
class RecordBatch:
    """A decoded split: SoA fixed fields, the record stream, host keys.

    Record i's body is ``data[soa['rec_off'][i] : + soa['rec_len'][i]]``.
    ``device_data``, when set, is a uint8 tensor on the device holding the
    same bytes as ``data`` — the inflate kernel's output left resident for
    the chain kernel.  ``salvaged`` marks a batch of the salvage reader:
    its records are no back-to-back chain, it never has a window, and its
    keys come from the host."""

    soa: dict
    data: np.ndarray
    keys: np.ndarray
    device_data: Optional[object] = None
    salvaged: bool = False

    @property
    def n_records(self) -> int:
        off = self.soa.get("rec_off")
        return len(off) if off is not None else len(self.keys)


@dataclass
class ChunkedRecords:
    """Several batches as one, without copying their payloads: record r
    lives at ``chunks[chunk_id[r]][rec_off[r] - 4 : rec_off[r] + rec_len[r]]``.

    ``device_flat``, when set, is the batches' resident windows as one uint8
    tensor on the device (chunk c starts at ``chunk_base[c]``): the device
    part write gathers from it."""

    chunks: List[np.ndarray]
    chunk_id: np.ndarray
    soa: dict
    device_flat: Optional[torch.Tensor] = None
    chunk_base: Optional[np.ndarray] = None
    keys: Optional[np.ndarray] = None  # int64, with ``from_batches(with_keys=True)``

    @property
    def n_records(self) -> int:
        return len(self.soa["rec_off"])

    def release_device(self) -> None:
        """Drop the resident stream once the parts are written."""
        self.device_flat = None
        self.chunk_base = None

    @classmethod
    def from_batches(
        cls, batches: Sequence[RecordBatch], keep_device: bool = False, with_keys: bool = False
    ) -> "ChunkedRecords":
        """``keep_device`` keeps the windows as :attr:`device_flat` (one
        ``torch.cat``, no copy for a single batch), and only when every
        batch has one, as the reference does; ``with_keys`` concatenates
        the batches' host keys into :attr:`keys`."""
        if not batches:
            return cls([], np.empty(0, np.int32), {
                "rec_off": np.empty(0, np.int64), "rec_len": np.empty(0, np.int64)},
                keys=np.empty(0, np.int64) if with_keys else None)
        flat = base = None
        if keep_device and all(b.device_data is not None for b in batches):
            parts = [b.device_data for b in batches]
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            base = np.cumsum([0] + [len(b.data) for b in batches[:-1]]).astype(np.int64)
        return cls(
            chunks=[b.data for b in batches],
            chunk_id=np.concatenate(
                [np.full(b.n_records, i, dtype=np.int32) for i, b in enumerate(batches)]
            ),
            soa={
                k: np.concatenate([b.soa[k] for b in batches])
                for k in ("rec_off", "rec_len")
            },
            device_flat=flat,
            chunk_base=base,
            keys=np.concatenate([b.keys for b in batches]) if with_keys else None,
        )


def splitting_bai_path(path: str) -> str:
    return path + SPLITTING_BAI_EXT


def _find_bai(path: str) -> Optional[str]:
    """The companion ``.bai`` (htsjdk's SamFiles.findIndex convention:
    ``x.bam.bai``, else ``x.bai``), or None."""
    for cand in (path + ".bai", os.path.splitext(path)[0] + ".bai"):
        if os.path.exists(cand):
            return cand
    return None


def _load_bai(path: str) -> indices.Bai:
    """The companion ``.bai``, else one built from the BAM."""
    bai_path = _find_bai(path)
    return indices.build_bai(path) if bai_path is None else indices.Bai.load(bai_path)


def _read_all(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _read_range(path: str, start: int, length: int) -> bytearray:
    """``length`` bytes from ``start`` (fewer at EOF), in a writable buffer
    so tensors can be made from it without a copy."""
    buf = bytearray(length)
    with open(path, "rb") as f:
        f.seek(start)
        n = f.readinto(buf)
    del buf[n:]
    return buf


def _read_header(data) -> Tuple[bam.BamHeader, int]:
    """Header + the virtual offset of the first record."""
    r = bgzf.BgzfReader(data)
    hdr = bam.read_header_stream(r)
    return hdr, r.tell_voffset()


def read_header_voffset(path: str) -> Tuple[bam.BamHeader, int]:
    """Header + first-record virtual offset, reading the file in growing
    prefixes."""
    size = os.path.getsize(path)
    chunk = 1 << 20
    while True:
        try:
            return _read_header(_read_range(path, 0, chunk))
        except (bgzf.BgzfError, bam.BamError):
            if chunk >= size:
                raise
            chunk *= 8


def read_header(path: str) -> bam.BamHeader:
    return read_header_voffset(path)[0]


class BamInputFormat:
    """Split planning + split reading for BAM files.  Reads without a
    stream count into ``metrics``."""

    def __init__(self, conf: Optional[Configuration] = None, metrics: Optional[Metrics] = None):
        self.conf = conf or Configuration()
        self.metrics = metrics if metrics is not None else Metrics()
        self._nrefs_cache: dict = {}

    def errors_mode(self) -> str:
        """``hadoopbam.errors``: "strict" (default) or "salvage"."""
        return self.conf.get(ERRORS_MODE, "strict") or "strict"

    def _nrefs(self, path: str) -> int:
        """The header's reference count, cached per path: the salvage
        reader's record re-sync rules need it."""
        if path not in self._nrefs_cache:
            self._nrefs_cache[path] = read_header(path).n_refs
        return self._nrefs_cache[path]

    def get_splits(
        self, paths: Sequence[str], split_size: int = DEFAULT_SPLIT_SIZE
    ) -> List[FileVirtualSplit]:
        splits: List[FileVirtualSplit] = []
        for path in sorted(paths):
            splits.extend(self._splits_for_file(path, split_size))
        intervals = self._traversal_intervals()
        unmapped_only = self.conf.get_boolean(BAM_TRAVERSE_UNPLACED_UNMAPPED)
        if intervals is not None or (
            unmapped_only and self.conf.get_boolean(BAM_BOUNDED_TRAVERSAL)
        ):
            splits = self.filter_by_interval(splits, intervals, unmapped_only)
        return splits

    def _traversal_intervals(self) -> Optional[List[Interval]]:
        if not self.conf.get_boolean(BAM_BOUNDED_TRAVERSAL):
            return None
        return parse_intervals(self.conf.get(BAM_INTERVALS))

    def _splits_for_file(self, path: str, split_size: int) -> List[FileVirtualSplit]:
        size = os.path.getsize(path)
        byte_splits = [(s, min(s + split_size, size)) for s in range(0, size, split_size)]
        if not byte_splits:
            return []
        idx_path = splitting_bai_path(path)
        if os.path.exists(idx_path):
            try:
                idx = indices.SplittingBai.load(idx_path)
                if idx.bam_size() != size:
                    raise IOError("splitting-bai does not match file size")
                return self._indexed_splits(path, byte_splits, idx)
            except IOError:
                pass  # a bad index: plan with the guesser
        if self.conf.get_boolean(BAM_ENABLE_BAI_SPLITTER):
            bai_path = _find_bai(path)
            if bai_path is not None:
                try:
                    bai = indices.Bai.load(bai_path)
                    return self._bai_splits(path, byte_splits, bai)
                except IOError:
                    pass  # an unreadable or stale .bai: plan with the guesser
        return self._probabilistic_splits(path, byte_splits)

    def _bai_splits(self, path, byte_splits, bai: indices.Bai) -> List[FileVirtualSplit]:
        """Splits from the ``.bai``'s linear index (BAMInputFormat.addBAISplits):
        every linear entry is a record boundary; a split starts at the first
        boundary at or after its byte start, the first at the first record;
        a split with no boundary inside it asks the guesser, and on a miss
        takes the next boundary, so starts stay monotone and every record is
        read exactly once.  A boundary past the end of the file raises
        ``IOError`` (a stale index)."""
        voffs: List[int] = []
        for rid in range(len(bai.refs)):
            voffs.extend(v for v in bai.linear_index(rid) if v > 0)
        first = bai.first_offset()
        if first is not None:
            voffs.append(first)
        if not voffs:
            raise IOError("empty .bai: no linear index entries")
        varr = np.unique(np.asarray(voffs, dtype=np.int64))
        coffs = varr >> 16
        size = byte_splits[-1][1]
        if int(coffs[-1]) >= size:
            raise IOError(".bai does not match file: offset past EOF")
        end_sentinel = (size << 16) | 0xFFFF
        guesser: Optional[BamSplitGuesser] = None
        starts: List[int] = []
        for j, (start, end) in enumerate(byte_splits):
            if j == 0:
                starts.append(read_header_voffset(path)[1])
                continue
            k = int(np.searchsorted(coffs, start, side="left"))
            if k < len(varr) and coffs[k] < end:
                starts.append(int(varr[k]))
                continue
            if guesser is None:
                data = _read_all(path)
                guesser = BamSplitGuesser(data, _read_header(data)[0].n_refs)
            g = guesser.guess_next_record_start(start, end)
            if g != end:
                starts.append(g)
            else:
                starts.append(int(varr[k]) if k < len(varr) else end_sentinel)
        out: List[FileVirtualSplit] = []
        for j, vstart in enumerate(starts):
            vend = starts[j + 1] if j + 1 < len(starts) else end_sentinel
            if vstart < vend:
                out.append(FileVirtualSplit(path, vstart, vend))
        if not out:
            raise IOError(f"'{path}': no reads found via .bai splitter")
        return out

    def _indexed_splits(self, path, byte_splits, idx) -> List[FileVirtualSplit]:
        if idx.size() == 1:
            return []  # no alignments
        out: List[FileVirtualSplit] = []
        for j, (start, end) in enumerate(byte_splits):
            vstart = idx.next_alignment(start)
            if j == len(byte_splits) - 1:
                prev = idx.prev_alignment(end)
                vend = None if prev is None else prev | 0xFFFF
            else:
                vend = idx.next_alignment(end)
            if vstart is None or vend is None:
                return self._probabilistic_splits(path, byte_splits)
            if vstart < vend:
                out.append(FileVirtualSplit(path, vstart, vend))
        return out

    def _probabilistic_splits(self, path, byte_splits) -> List[FileVirtualSplit]:
        with open(path, "rb") as f:
            data = f.read()
        hdr, _ = _read_header(data)
        guesser = BamSplitGuesser(data, hdr.n_refs)
        out: List[FileVirtualSplit] = []
        for beg, end in byte_splits:
            aligned_beg = guesser.guess_next_record_start(beg, end)
            aligned_end = (end << 16) | 0xFFFF
            if aligned_beg == end:
                if not out:
                    raise IOError(
                        f"'{path}': no reads in first split: bad BAM file or "
                        "tiny split size?"
                    )
                out[-1].vend = aligned_end
            else:
                out.append(FileVirtualSplit(path, aligned_beg, aligned_end))
        return out

    def filter_by_interval(
        self,
        splits: List[FileVirtualSplit],
        intervals: Optional[List[Interval]],
        traverse_unplaced_unmapped: bool = False,
    ) -> List[FileVirtualSplit]:
        """Bounded traversal (BAMInputFormat.java:532-634): per file, the
        ``.bai`` (the companion file, else one built from the BAM) turns the
        intervals into chunk spans; a split that meets any span is kept with
        its spans cut to it.  Intervals on contigs the header lacks are
        skipped.  With ``traverse_unplaced_unmapped`` every split that
        reaches past the last mapped chunk also yields a split of the
        unmapped tail, whatever the intervals hit."""
        out: List[FileVirtualSplit] = []
        by_path: dict = {}
        for s in splits:
            by_path.setdefault(s.path, []).append(s)
        for path, file_splits in by_path.items():
            hdr = read_header(path)
            bai = _load_bai(path)
            chunks: List[indices.Chunk] = []
            for iv in intervals or ():
                try:
                    rid = hdr.ref_index(iv.contig)
                except KeyError:
                    continue
                chunks.extend(bai.query(rid, iv.start - 1, iv.end))
            unmapped_start = bai.unmapped_span_start()
            for s in file_splits:
                overlapping = [
                    (max(c.beg, s.vstart), min(c.end, s.vend))
                    for c in chunks
                    if c.beg < s.vend and c.end > s.vstart
                ]
                if overlapping:
                    out.append(FileVirtualSplit(s.path, s.vstart, s.vend, overlapping))
            if traverse_unplaced_unmapped and unmapped_start is not None:
                for s in file_splits:
                    if s.vend > unmapped_start:
                        out.append(FileVirtualSplit(s.path, max(s.vstart, unmapped_start), s.vend))
        return out

    def read_split(
        self,
        split: FileVirtualSplit,
        fields: Optional[Sequence[str]] = None,
        with_keys: bool = True,
        stream=None,
        errors: Optional[str] = None,
    ) -> RecordBatch:
        """Inflate the split's members and decode its records as one batch.

        Only the split's byte window (plus a margin for a tail record that
        spills past it) is read; the margin widens until the tail fits.
        With a :class:`~hadoop_bam_tpu_torch.device_stream.DeviceStream`
        whose policy has inflate on, members inflate on its device.  A
        split with ``interval_chunks`` keeps only the records that start
        inside one of them.  ``errors`` (default :meth:`errors_mode`):
        "strict" raises on corrupt input, "salvage" quarantines corrupt
        members and unparseable records and returns what survived
        (``salvage.*`` counters, into the stream's metrics or
        :attr:`metrics`)."""
        if errors is None:
            errors = self.errors_mode()
        n_refs = self._nrefs(split.path) if errors == "salvage" else None
        metrics = stream.metrics if stream is not None else self.metrics
        size = os.path.getsize(split.path)
        cstart = min(split.vstart >> 16, size)
        cend = min(split.vend >> 16, size)
        margin = 4 << 20
        while True:
            end_byte = min(cend + margin, size)
            window = _read_range(split.path, cstart, end_byte - cstart)
            at_eof = end_byte >= size
            shift = cstart << 16
            chunks = None
            if split.interval_chunks is not None:
                chunks = [(max(b - shift, 0), e - shift) for b, e in split.interval_chunks]
            try:
                return read_virtual_range(
                    window, split.vstart - shift, split.vend - shift,
                    with_keys=with_keys, fields=fields, stream=stream,
                    interval_chunks=chunks, errors=errors, n_refs=n_refs,
                    window_at_eof=at_eof, metrics=metrics,
                )
            except (bam.BamError, bgzf.BgzfError):
                if at_eof:
                    raise
                margin *= 4


def _empty_soa(fields: Optional[Sequence[str]] = None) -> dict:
    return {
        k: np.empty(0, dtype=np.int64)
        for k in (bam.SOA_FIELDS if fields is None else fields)
    }


def read_virtual_range(
    data: bytes,
    vstart: int,
    vend: int,
    with_keys: bool = True,
    fields: Optional[Sequence[str]] = None,
    stream=None,
    interval_chunks: Optional[List[Tuple[int, int]]] = None,
    errors: str = "strict",
    n_refs: Optional[int] = None,
    window_at_eof: bool = True,
    metrics: Optional[Metrics] = None,
) -> RecordBatch:
    """Decode all records whose start voffset lies in ``[vstart, vend)``.

    Members from ``vstart >> 16`` through the one holding ``vend`` inflate
    in one batch; the record chain is walked from ``vstart & 0xffff``;
    records at or past ``vend`` are cut off, and a record spanning past the
    window pulls in spill members, inflated on the host.  The device copy
    of the window is kept as the batch's ``device_data`` only when it is
    exact: no spill member was needed (tier-downs already drop it).  With
    ``interval_chunks`` (voffset spans relative to ``data``) only the
    records starting inside a span are kept (``bam.records_kept`` on the
    stream's metrics); there is no record-level overlap cut here.

    ``errors="salvage"`` (with ``n_refs`` from the header) runs this strict
    read first and, when it raises a data error, counts
    ``salvage.strict_fallbacks`` and reads the range again with the
    quarantining reader (:func:`_read_virtual_range_salvage`), on the host.
    ``window_at_eof=False`` says that ``data`` stops short of the file's
    end, so that trouble near its edge raises (the caller widens the
    window) instead of passing for corruption.  Counters go to the
    stream's metrics, else to ``metrics``."""
    if fields is not None and with_keys:
        fields = tuple(dict.fromkeys(tuple(fields) + SORT_FIELDS))
    if errors == "salvage":
        if n_refs is None:
            raise ValueError("salvage mode needs n_refs from the header")
        m = stream.metrics if stream is not None else (metrics or Metrics())
        try:
            return read_virtual_range(data, vstart, vend, with_keys=with_keys, fields=fields,
                                      stream=stream, interval_chunks=interval_chunks)
        except (bgzf.BgzfError, bam.BamError):
            m.count("salvage.strict_fallbacks", 1)
        return _read_virtual_range_salvage(
            data, vstart, vend, n_refs=n_refs, with_keys=with_keys,
            interval_chunks=interval_chunks, fields=fields, window_at_eof=window_at_eof,
            metrics=m,
        )
    if vstart >= vend:
        return RecordBatch(
            soa=_empty_soa(fields), data=np.empty(0, np.uint8), keys=np.empty(0, np.int64)
        )
    file_end = len(data)
    cstart = vstart >> 16
    cend = min(vend >> 16, file_end)

    co_l: List[int] = []
    cs_l: List[int] = []
    us_l: List[int] = []
    pos = cstart
    while pos < file_end and pos <= cend:
        csize, usize = bgzf.read_block_at(data, pos)
        co_l.append(pos)
        cs_l.append(csize)
        us_l.append(usize)
        pos += csize
    spill_pos = pos

    dev = None
    if stream is not None and stream.policy.inflate_lanes:
        out, offs, dev = stream.decode_members(data, co_l, cs_l, us_l)
    else:
        out, offs = bgzf.inflate_blocks(data, co_l, cs_l, us_l)
    buf = out
    plen = len(out)
    uoffs_l: List[int] = [int(x) for x in offs[:-1]]
    voffs_l: List[int] = list(co_l)
    usize_l: List[int] = list(us_l)

    up0 = vstart & 0xFFFF
    if up0 > (us_l[0] if us_l else 0):
        raise bgzf.BgzfError("vstart uoffset beyond block payload")

    def spill_one() -> bool:
        nonlocal spill_pos, buf, plen
        if spill_pos >= file_end:
            return False
        csize, usize = bgzf.read_block_at(data, spill_pos)
        sp_out, _ = bgzf.inflate_blocks(data, [spill_pos], [csize], [usize])
        if plen + usize > len(buf):
            grown = np.empty(max(2 * len(buf), plen + usize), dtype=np.uint8)
            grown[:plen] = buf[:plen]
            buf = grown
        buf[plen : plen + usize] = sp_out
        uoffs_l.append(plen)
        voffs_l.append(spill_pos)
        usize_l.append(usize)
        plen += usize
        spill_pos += csize
        return True

    # The payload offset equivalent to "record voffset >= vend".
    vc = vend >> 16
    if vc >= file_end or not voffs_l:
        vend_off = None  # the last split takes everything
    else:
        bi = max(0, int(np.searchsorted(voffs_l, vc, side="right")) - 1)
        if voffs_l[bi] == vc:
            vend_off = uoffs_l[bi] + min(vend & 0xFFFF, usize_l[bi])
        else:
            vend_off = uoffs_l[bi] + usize_l[bi]

    # The host chain walk; a tail record past the window pulls in spill
    # members and resumes.
    rec_parts: List[np.ndarray] = []
    p = uoffs_l[0] + up0 if uoffs_l else 0
    while True:
        offs_k, resume = bam.record_chain_partial(buf, p, plen)
        k = int(np.searchsorted(offs_k, vend_off, side="left")) if vend_off is not None else len(offs_k)
        rec_parts.append(offs_k[:k])
        if k < len(offs_k):
            break
        if vend_off is not None and resume >= vend_off:
            break
        if resume + 4 <= plen:
            if not spill_one():
                raise bam.BamError("truncated record at end of file")
        elif spill_pos < file_end:
            spill_one()
        else:
            break  # <= 3 trailing bytes at EOF
        p = resume

    # A spill grows the buffer by doubling: keep only the payload's bytes.
    arr = buf[:plen] if buf is out else buf[:plen].copy()
    offsets = np.concatenate(rec_parts) if rec_parts else np.empty(0, dtype=np.int64)
    soa = bam.soa_decode(arr, offsets, fields=fields) if len(offsets) else _empty_soa(fields)
    if interval_chunks is not None and len(offsets):
        keep = _voffset_mask(
            offsets, np.asarray(uoffs_l, dtype=np.int64), np.asarray(voffs_l, dtype=np.int64),
            usize_l, interval_chunks,
        )
        soa = {k: v[keep] for k, v in soa.items()}
    if interval_chunks is not None and stream is not None:
        stream.metrics.count("bam.records_kept", len(soa["rec_off"]))
    keys = (
        bam.soa_keys(soa, arr)
        if with_keys and len(soa["rec_off"])
        else np.empty(0, dtype=np.int64)
    )
    device_data = None
    if dev is not None and plen == len(out):
        device_data = stream.attach_window(dev)
    return RecordBatch(soa=soa, data=arr, keys=keys, device_data=device_data)


def _next_member(data, start: int) -> Optional[int]:
    """The next offset at or after ``start`` holding a parseable member
    header whose member fits in ``data`` with a plausible ISIZE (the
    guesser's phase-1 scan), or None."""
    data = bytes(data)
    pos = start
    while True:
        pos = bgzf.find_next_block(data, pos)
        if pos < 0:
            return None
        bsize = bgzf.parse_block_header(data, pos)[0]
        if int.from_bytes(bytes(data[pos + bsize - 4 : pos + bsize]), "little") \
                <= bgzf.MAX_BLOCK_SIZE:
            return pos
        pos += 1


def _read_virtual_range_salvage(
    data,
    vstart: int,
    vend: int,
    n_refs: int,
    with_keys: bool = True,
    interval_chunks: Optional[List[Tuple[int, int]]] = None,
    fields: Optional[Sequence[str]] = None,
    window_at_eof: bool = True,
    metrics: Optional[Metrics] = None,
) -> RecordBatch:
    """The quarantining split reader: every record that is provably intact
    survives corrupt members and torn record chains.

    1. Member scan with re-sync: an unparseable header quarantines the
       bytes up to the next plausible one (:func:`_next_member`).
    2. Per-member inflate under the CRC32 and ISIZE gates; a member that
       fails is quarantined.
    3. Segmented chain walk: file-contiguous runs of good members form
       segments; each segment but a first that starts at the split's own
       ``vstart`` re-syncs its first record with the guesser's rules
       (:func:`~.guesser.find_record_start_in_payload`).  A record cut by a
       gap, or failing mid-segment, is dropped and the walk re-syncs past
       it.
    4. Spill continuation: a tail record past the split's end completes
       through the following members, as in the strict read.

    Counters (``salvage.*``, into ``metrics``): quarantined members and
    bytes, counted once per file region (members at or past the split's
    end member belong to the next split), re-syncs and failed re-syncs,
    dropped and salvaged records.  The device tiers are bypassed: the
    batch has no window, and ``salvaged`` is set."""
    m = metrics if metrics is not None else Metrics()
    if vstart >= vend:
        return RecordBatch(soa=_empty_soa(fields), data=np.empty(0, np.uint8),
                           keys=np.empty(0, np.int64), salvaged=True)
    file_end = len(data)
    cstart = vstart >> 16
    cend = min(vend >> 16, file_end)
    last_split = (vend >> 16) >= file_end

    def count_quarantine(co: int, nbytes: int) -> None:
        # A member at or past the end member belongs to the next split.
        if co < cend or last_split:
            m.count("salvage.members_quarantined", 1)
            m.count("salvage.bytes_quarantined", nbytes)

    def widen_guard(pos: int) -> None:
        # Trouble within one member of a window edge that is not the
        # file's end may be the window's cut: let the caller widen.
        if not window_at_eof and pos + bgzf.MAX_BLOCK_SIZE > file_end:
            raise bgzf.BgzfError(f"salvage: window too small to classify bytes at {pos}")

    # 1 + 2: the member scan with re-sync, the per-member inflate.
    good_co: List[int] = []
    good_cs: List[int] = []
    good_us: List[int] = []
    payloads: List[bytes] = []
    pos = cstart
    while pos < file_end and pos <= cend:
        try:
            csize, _ = bgzf.read_block_at(data, pos)
        except bgzf.BgzfError:
            widen_guard(pos)
            nxt = _next_member(data, pos + 1)
            npos = nxt if nxt is not None else file_end
            if nxt is None:
                widen_guard(npos)
            count_quarantine(pos, npos - pos)
            pos = npos
            continue
        try:
            payload, _ = bgzf.inflate_block(data, pos, metrics=m)
        except bgzf.BgzfError:
            count_quarantine(pos, csize)
            pos += csize
            continue
        good_co.append(pos)
        good_cs.append(csize)
        good_us.append(len(payload))
        payloads.append(payload)
        pos += csize
    spill_pos = pos

    buf = bytearray()
    uoffs: List[int] = []
    for p_ in payloads:
        uoffs.append(len(buf))
        buf.extend(p_)

    # Segments: contiguity breaks at every quarantined member.
    seg_starts = [k for k in range(len(good_co))
                  if k == 0 or good_co[k] != good_co[k - 1] + good_cs[k - 1]]
    seg_bounds = [(s, seg_starts[i + 1] if i + 1 < len(seg_starts) else len(good_co))
                  for i, s in enumerate(seg_starts)]

    # The vend cutoff over the good members (monotone, as in the strict read).
    vc = vend >> 16
    vend_off: Optional[int]
    if vc >= file_end or not good_co:
        vend_off = None
    elif vc < good_co[0]:
        vend_off = 0
    else:
        bi = max(0, int(np.searchsorted(good_co, vc, side="right")) - 1)
        if good_co[bi] == vc:
            vend_off = uoffs[bi] + min(vend & 0xFFFF, good_us[bi])
        else:
            vend_off = uoffs[bi] + good_us[bi]

    rec_parts: List[np.ndarray] = []
    up0 = vstart & 0xFFFF
    done = False

    def spill_one() -> bool:
        """Extend the frontier segment by one member; a corrupt spill
        member ends the chain (its record is counted by the caller, the
        member by the next split)."""
        nonlocal spill_pos
        if spill_pos >= file_end:
            if not window_at_eof:
                raise bgzf.BgzfError("salvage: window too small for spilled tail record")
            return False
        try:
            csize, _ = bgzf.read_block_at(data, spill_pos)
            payload, _ = bgzf.inflate_block(data, spill_pos, metrics=m)
        except bgzf.BgzfError:
            widen_guard(spill_pos)
            return False
        good_co.append(spill_pos)
        good_cs.append(csize)
        good_us.append(len(payload))
        uoffs.append(len(buf))
        buf.extend(payload)
        spill_pos += csize
        return True

    for si, (k0, k1) in enumerate(seg_bounds):
        if done:
            break
        seg_u0 = uoffs[k0]
        seg_u1 = uoffs[k1 - 1] + good_us[k1 - 1]
        if vend_off is not None and seg_u0 >= vend_off:
            break
        # The frontier segment ends at the scan cursor: only it may spill.
        at_frontier = (si == len(seg_bounds) - 1
                       and good_co[k1 - 1] + good_cs[k1 - 1] == spill_pos)
        # The split's vstart is a planned record boundary if its member
        # survived; any other segment re-syncs.
        if si == 0 and k0 == 0 and good_co[0] == cstart and up0 <= good_us[0]:
            p = seg_u0 + up0
        else:
            m.count("salvage.resyncs", 1)
            r = find_record_start_in_payload(
                np.frombuffer(bytes(buf[seg_u0:seg_u1]), np.uint8), n_refs)
            if r is None:
                m.count("salvage.resync_failed", 1)
                continue
            p = seg_u0 + r
        guard = 0
        while p < seg_u1 and guard < 1000:
            guard += 1
            offs, resume = bam.record_chain_partial(buf, p, seg_u1)
            k = (int(np.searchsorted(offs, vend_off, side="left")) if vend_off is not None
                 else len(offs))
            rec_parts.append(np.asarray(offs[:k], dtype=np.int64))
            if k < len(offs) or (vend_off is not None and resume >= vend_off):
                done = True
                break
            if resume + 4 > seg_u1 and not at_frontier:
                break  # <= 3 trailing bytes at a gap, as at a strict EOF
            if at_frontier:
                if resume + 4 > seg_u1 and spill_pos >= file_end:
                    break  # <= 3 trailing bytes at the file's end
                if spill_one():
                    seg_u1 = uoffs[-1] + good_us[-1]
                    p = resume
                    continue
                if resume < seg_u1:
                    m.count("salvage.records_dropped", 1)  # a torn tail record
                break
            # A record cut by the next gap, or unparseable mid-segment:
            # drop it and re-sync past its start.
            m.count("salvage.records_dropped", 1)
            m.count("salvage.resyncs", 1)
            r = find_record_start_in_payload(
                np.frombuffer(bytes(buf[seg_u0:seg_u1]), np.uint8), n_refs,
                start=resume - seg_u0 + 1)
            if r is None:
                m.count("salvage.resync_failed", 1)
                break
            p = seg_u0 + r

    arr = np.frombuffer(bytes(buf), dtype=np.uint8)
    offsets = np.concatenate(rec_parts) if rec_parts else np.empty(0, dtype=np.int64)
    soa = bam.soa_decode(arr, offsets, fields=fields) if len(offsets) else _empty_soa(fields)
    if interval_chunks is not None and len(offsets):
        keep = _voffset_mask(offsets, np.asarray(uoffs, dtype=np.int64),
                             np.asarray(good_co, dtype=np.int64), good_us, interval_chunks)
        soa = {k: v[keep] for k, v in soa.items()}
    keys = (bam.soa_keys(soa, arr) if with_keys and len(soa["rec_off"])
            else np.empty(0, dtype=np.int64))
    m.count("salvage.records_salvaged", len(offsets))
    if interval_chunks is not None:
        m.count("bam.records_kept", len(soa["rec_off"]))
    return RecordBatch(soa=soa, data=arr, keys=keys, salvaged=True)


def _voffset_mask(offsets, block_uoffs, block_voffs, us_l, chunks) -> np.ndarray:
    """Records whose start voffset lies in any chunk span: the coarse
    chunk-span cut of bounded traversal.  A record starting exactly at a
    member's end is addressed at the next member's start."""
    bi = np.searchsorted(block_uoffs, offsets, side="right") - 1
    in_block = offsets - block_uoffs[bi]
    us = np.asarray(us_l, dtype=np.int64)
    over = (bi + 1 < len(us)) & (in_block >= us[np.minimum(bi, len(us) - 1)])
    bi = np.where(over, bi + 1, bi)
    in_block = offsets - block_uoffs[bi]
    voffs = (block_voffs[bi] << 16) | in_block
    keep = np.zeros(len(offsets), dtype=bool)
    for beg, end in chunks:
        keep |= (voffs >= beg) & (voffs < end)
    return keep


_GATHER_BLOCK = 8192  # records joined at a time by gather_record_array


def gather_record_array(batch, order: Optional[np.ndarray] = None) -> np.ndarray:
    """Size word + body of every record, permuted by ``order``."""
    soa = batch.soa
    if len(soa["rec_off"]) == 0:
        return np.empty(0, np.uint8)
    if isinstance(batch, ChunkedRecords):
        views = [memoryview(c) for c in batch.chunks]
        cid = batch.chunk_id
    else:
        views = [memoryview(batch.data)]
        cid = np.zeros(len(soa["rec_off"]), dtype=np.int32)
    off = np.asarray(soa["rec_off"], dtype=np.int64)
    end = off + np.asarray(soa["rec_len"], dtype=np.int64)
    if order is not None:
        order = np.asarray(order, dtype=np.int64)
        cid, off, end = cid[order], off[order], end[order]
    out = np.empty(int((end - off).sum()) + 4 * len(off), dtype=np.uint8)
    at = 0
    # A block of records at a time, so that the slices held stay few.
    for b0 in range(0, len(off), _GATHER_BLOCK):
        b1 = b0 + _GATHER_BLOCK
        block = b"".join([views[c][s - 4 : e] for c, s, e in zip(
            cid[b0:b1].tolist(), off[b0:b1].tolist(), end[b0:b1].tolist())])
        out[at : at + len(block)] = np.frombuffer(block, dtype=np.uint8)
        at += len(block)
    return out


def patch_flags(stream: np.ndarray, rec_starts: np.ndarray, bits: int = 0x400) -> None:
    """OR ``bits`` into the flag field (bytes 18/19 past the size word) of
    the records whose size words sit at ``rec_starts`` of a gathered stream,
    in place: the duplicate-marking write, applied to the gathered copy and
    never to the source payloads."""
    if len(rec_starts) == 0:
        return
    stream[rec_starts + 18] |= np.uint8(bits & 0xFF)
    stream[rec_starts + 19] |= np.uint8((bits >> 8) & 0xFF)


def _ragged_copy(dst: np.ndarray, dst_off: np.ndarray, src: np.ndarray, src_off: np.ndarray,
                 lens: np.ndarray) -> None:
    """``dst[dst_off[i] : + lens[i]] = src[src_off[i] : + lens[i]]`` for every
    i, as one fancy-index pass."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return
    base = np.cumsum(lens) - lens
    within = np.arange(total, dtype=np.int64) - np.repeat(base, lens)
    dst[np.repeat(dst_off.astype(np.int64), lens) + within] = src[
        np.repeat(src_off.astype(np.int64), lens) + within]


def rebuild_record_stream(
    data: np.ndarray,
    rec_off: np.ndarray,
    rec_len: np.ndarray,
    cut_off: np.ndarray,
    cut_len: np.ndarray,
    append_blob: np.ndarray,
    append_off: np.ndarray,
    append_len: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-emit records with one cut and one append each (fixmate's MC tag):
    record i becomes its size word (the new body length), ``body[:cut_off]``,
    ``body[cut_off + cut_len:]`` and ``append_blob[append_off : +
    append_len]``.  A record with no cut (``cut_off = rec_len``) and no
    append comes out byte for byte; ``data`` is not changed.  Returns
    ``(stream, body offsets, body lengths)`` in the new stream."""
    rec_off = rec_off.astype(np.int64)
    rec_len = rec_len.astype(np.int64)
    cut_off = cut_off.astype(np.int64)
    cut_len = cut_len.astype(np.int64)
    append_len = append_len.astype(np.int64)
    new_len = rec_len - cut_len + append_len
    full = 4 + new_len
    starts = np.cumsum(full) - full
    out = np.empty(int(full.sum()), dtype=np.uint8)
    for b in range(4):  # little-endian u32 size words
        out[starts + b] = ((new_len >> (8 * b)) & 0xFF).astype(np.uint8)
    _ragged_copy(out, starts + 4, data, rec_off, cut_off)
    _ragged_copy(out, starts + 4 + cut_off, data, rec_off + cut_off + cut_len,
                 rec_len - cut_off - cut_len)
    _ragged_copy(out, starts + 4 + rec_len - cut_len, append_blob, append_off, append_len)
    return out, starts + 4, new_len


def write_part_fast(
    out,
    batch,
    order: Optional[np.ndarray] = None,
    level: int = 6,
    splitting_bai_stream=None,
    granularity: int = indices.DEFAULT_GRANULARITY,
    threads: Optional[int] = None,
    device_deflate: Optional[bool] = None,
    device_write: Optional[bool] = None,
    dup_mask: Optional[np.ndarray] = None,
    device_stream=None,
) -> int:
    """Write a headerless, terminator-less part; returns the bytes written.

    ``device_write`` (default: ``device_stream``'s policy, else off) takes
    the device-resident assembly
    (:meth:`~hadoop_bam_tpu_torch.device_stream.DeviceStream.encode_part`):
    gather, flag patch, CRC32 and deflate on the card from the batch's
    resident stream.  Without residency, or past the int32 domain, it tiers
    down (counted) to the host gather.  ``device_deflate`` (default:
    ``device_stream``'s policy, else off) sends the host-gathered stream
    through the deflate lanes; otherwise host zlib at ``level``.  Both
    device forms cut a member every ``DEV_LZ_PAYLOAD`` bytes and write the
    same bytes; the host form every ``MAX_PAYLOAD``.  ``dup_mask`` (bool per
    batch row) ORs ``FLAG_DUPLICATE`` into the written copies of those
    rows.  The ``.splitting-bai`` offsets follow from the fixed blocking
    and the member sizes.  The device paths run on ``device_stream``'s
    device and count into its metrics."""
    if device_stream is None and (device_write or device_deflate):
        raise ValueError("device_write / device_deflate need a device_stream")
    if device_write is None:
        device_write = device_stream is not None and device_stream.policy.device_write
    if device_deflate is None:
        device_deflate = device_stream is not None and device_stream.policy.deflate_lanes
    metrics = device_stream.metrics if device_stream is not None else Metrics()
    res = None
    if device_write:
        res = device_stream.encode_part(batch, order=order, dup_mask=dup_mask, level=level)
    if res is not None:
        blob, sizes = res
        block_payload = flate.DEV_LZ_PAYLOAD
    else:
        payload = gather_record_array(batch, order)
        if dup_mask is not None:
            dm = dup_mask[order] if order is not None else dup_mask
            if dm.any():
                ln = batch.soa["rec_len"].astype(np.int64) + 4
                if order is not None:
                    ln = ln[order]
                payload = payload.copy()
                patch_flags(payload, (np.cumsum(ln) - ln)[dm])
                metrics.count("bam.duplicate_flags_patched", int(dm.sum()))
        if device_deflate:
            block_payload = flate.DEV_LZ_PAYLOAD
            blob, sizes = flate.deflate_blocks_device(
                payload, level=level, block_payload=block_payload,
                device=device_stream.device, metrics=metrics,
            )
        else:
            block_payload = bgzf.MAX_PAYLOAD
            blob, sizes = bgzf.deflate_blocks(
                payload, level=level, threads=threads, block_payload=block_payload
            )
    out.write(blob)
    if splitting_bai_stream is not None:
        ln = batch.soa["rec_len"].astype(np.int64) + 4
        if order is not None:
            ln = ln[order]
        logical = np.cumsum(ln) - ln
        co = np.cumsum(sizes) - sizes
        bi = logical // block_payload
        voffs = (co[bi] << 16) | (logical % block_payload)
        n = len(voffs)
        pick = np.zeros(n, dtype=bool)
        if n:
            pick[0] = True
            pick |= (np.arange(n) + 1) % granularity == 0
        b = indices.SplittingBaiBuilder(granularity)
        b.voffsets = [int(v) for v in voffs[pick]]
        b.count = n
        b.finish(len(blob)).save(splitting_bai_stream)
    return len(blob)

"""BCF input/output: record-aligned split planning, split reading, writer.

Counterpart of ``hadoop_bam_tpu/io/bcf.py`` (the BCF arm of the reference's
VCFInputFormat):

- ``BcfSplitGuesser``: the first verifiable record start in a byte range of
  a BGZF or uncompressed BCF (candidate sanity scan, then a decode of two
  BGZF blocks or a 0x80000-byte window; BCFSplitGuesser.java:61-360);
- ``BcfInputFormat``: byte splits fixed up to record starts
  (VCFInputFormat.java:302-385) and the split reader: the device
  record-chain walk and the ragged interval join when the stream's gate is
  armed, else the exact ``spec/bcf.decode_record`` loop; under
  ``errors="salvage"`` a corrupt member is quarantined and the torn chain
  re-synced by the guesser (``_salvage_walk``);
- ``BcfRecordWriter``: BGZF output with the headerless part mode
  (BCFRecordWriter.java:49-178).

Not ported: the reference's vectorized host tier needs its C ``bcf_scan`` (ROADMAP A.9), so with the
gate off every split takes the exact loop, as the reference does without
its native library.  Counters go to the format's
:class:`~..utils.tracing.Metrics`.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..conf import ERRORS_MODE, VCF_INTERVALS, VCFRECORDREADER_VALIDATION_STRINGENCY, Configuration
from ..ops.overlap import ragged_overlap_mask
from ..spec import bcf, bgzf
from ..spec.vcf import VcfHeader, variant_key
from ..utils.intervals import Interval, parse_intervals
from ..utils.tracing import Metrics
from .splits import FileVirtualSplit
from .vcf import VariantBatch

# Verification bounds (BCFSplitGuesser.java:61-75).
BGZF_BLOCKS_NEEDED_FOR_GUESS = 2
UNCOMPRESSED_BYTES_NEEDED_FOR_GUESS = 0x80000

_DATA_ERRORS = (bgzf.BgzfError, zlib.error)
_RECORD_ERRORS = (bcf.BcfError, struct.error, IndexError, ValueError, KeyError)


def _read_range(path: str, start: int, length: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(start)
        return f.read(length)


class BcfSplitGuesser:
    """Find the first real BCF record start in ``[beg, end)``."""

    def __init__(self, data: bytes, header: bcf.BcfHeader, compressed: Optional[bool] = None,
                 metrics: Optional[Metrics] = None):
        self.data = data
        self.header = header
        self.compressed = bgzf.is_bgzf(data) if compressed is None else compressed
        self.metrics = metrics if metrics is not None else Metrics()

    def _candidate_offsets(self, payload: np.ndarray) -> np.ndarray:
        """Offsets passing the sanity rules (BCFSplitGuesser.java:273-360)."""
        n = len(payload)
        # minimal record: 8-byte lengths + 24-byte fixed shared fields
        if n < 33:
            return np.empty(0, dtype=np.int64)
        count = n - 32
        a = np.concatenate([payload, np.zeros(40, dtype=np.uint8)])

        def u32(off: int) -> np.ndarray:
            return (
                a[off : off + count].astype(np.uint64)
                | (a[off + 1 : off + count + 1].astype(np.uint64) << 8)
                | (a[off + 2 : off + count + 2].astype(np.uint64) << 16)
                | (a[off + 3 : off + count + 3].astype(np.uint64) << 24)
            )

        l_shared = u32(0)
        l_indiv = u32(4)
        chrom = u32(8).astype(np.int64).astype(np.int32)
        pos = u32(12).astype(np.int64).astype(np.int32)
        rlen = u32(16).astype(np.int64).astype(np.int32)
        n_allele = (u32(24) >> np.uint64(16)).astype(np.int64)
        n_sample = (u32(28) & np.uint64(0xFFFFFF)).astype(np.int64)

        ok = (l_shared >= 24) & (l_shared < 1 << 24) & (l_indiv < 1 << 28)
        ok &= (chrom >= 0) & (chrom < len(self.header.contigs))
        ok &= (pos >= -1) & (rlen >= 0)
        ok &= n_allele < 0xFFFF
        ok &= n_sample == self.header.n_samples
        # The ID field follows the 24 fixed shared bytes: its typed
        # descriptor must be a string (char) or missing (:340-352).
        id_desc = a[32 : 32 + count]
        ok &= ((id_desc & 0xF) == bcf.T_CHAR) | (id_desc == 0)
        return np.nonzero(ok)[0].astype(np.int64)

    def _decodes_from(self, payload: bytes, p: int, need_bytes: int) -> bool:
        """True iff consecutive records decode from ``p`` until the window is
        exhausted (truncation mid-record after >= 1 success is acceptable)."""
        decoded = 0
        limit = min(len(payload), p + need_bytes)
        while p + 8 <= limit:
            l_shared, l_indiv = struct.unpack_from("<II", payload, p)
            if p + 8 + l_shared + l_indiv > len(payload):
                return decoded > 0
            try:
                _, p = bcf.decode_record(payload, p, self.header)
            except _RECORD_ERRORS:
                return False
            decoded += 1
        return decoded > 0

    def guess_next_record_start(self, beg: int, end: int) -> Optional[int]:
        """Virtual offset of the first verifiable record in the byte range
        ``[beg, end)``, or None.  Uncompressed files use the ``offset << 16``
        form so both kinds share the split type.  Counted as
        ``bcf.guess.{windows,candidates,verified}``."""
        self.metrics.count("bcf.guess.windows")
        g = self._guess_bgzf(beg, end) if self.compressed else self._guess_plain(beg, end)
        if g is not None:
            self.metrics.count("bcf.guess.verified")
        return g

    def _guess_plain(self, beg: int, end: int) -> Optional[int]:
        window = self.data[beg : min(len(self.data), end + UNCOMPRESSED_BYTES_NEEDED_FOR_GUESS)]
        cands = self._candidate_offsets(np.frombuffer(window, dtype=np.uint8))
        self.metrics.count("bcf.guess.candidates", len(cands))
        for off in cands:
            if off >= end - beg:
                break
            if self._decodes_from(window, int(off), UNCOMPRESSED_BYTES_NEEDED_FOR_GUESS):
                return (beg + int(off)) << 16
        return None

    def _guess_bgzf(self, beg: int, end: int) -> Optional[int]:
        pos = beg
        while True:
            cp = bgzf.find_next_block(self.data, pos, min(end, len(self.data)))
            if cp < 0 or cp >= end:
                return None
            # Inflate this block and enough successors for verification.
            co, cs_l, us_l = [], [], []
            p = cp
            while len(co) < BGZF_BLOCKS_NEEDED_FOR_GUESS + 2 and p < len(self.data):
                try:
                    csize, usize = bgzf.read_block_at(self.data, p)
                except bgzf.BgzfError:
                    break
                co.append(p)
                cs_l.append(csize)
                us_l.append(usize)
                p += csize
            if co:
                try:
                    out, offs = bgzf.inflate_blocks(self.data, co, cs_l, us_l, threads=1)
                    payload = out.tobytes()
                    first_len = int(offs[1] - offs[0]) if len(offs) > 1 else len(payload)
                    cands = self._candidate_offsets(
                        np.frombuffer(payload[:first_len], dtype=np.uint8)
                    )
                    self.metrics.count("bcf.guess.candidates", len(cands))
                    for up in cands:
                        if self._decodes_from(
                            payload, int(up), sum(us_l[:BGZF_BLOCKS_NEEDED_FOR_GUESS])
                        ):
                            return (cp << 16) | int(up)
                except bgzf.BgzfError:
                    pass
            pos = cp + 1


def read_bcf_header(data: bytes, compressed: Optional[bool] = None) -> Tuple[bcf.BcfHeader, int]:
    """(header, offset of the first record in the *uncompressed* stream),
    inflating only as many leading blocks as the header occupies."""
    if compressed is None:
        compressed = bgzf.is_bgzf(data)
    if not compressed:
        return bcf.decode_header(data)
    chunk = bytearray()
    pos = 0
    while pos < len(data):
        payload, csize = bgzf.inflate_block(data, pos)
        chunk.extend(payload)
        pos += csize
        if len(chunk) >= 9:
            (l_text,) = struct.unpack_from("<I", chunk, 5)
            if len(chunk) >= 9 + l_text:
                break
    return bcf.decode_header(bytes(chunk))


def _read_bcf_header_prefix(path: str):
    """(header, compressed?) through growing prefix reads: O(header) bytes."""
    size = os.path.getsize(path)
    n = 8 << 10
    while True:
        prefix = _read_range(path, 0, min(n, size))
        compressed = bgzf.is_bgzf(prefix)
        try:
            hdr, _ = read_bcf_header(prefix, compressed)
            return hdr, compressed
        except (bcf.BcfError, bgzf.BgzfError, struct.error, IndexError):
            if n >= size:
                raise
            n *= 4


class BcfInputFormat:
    """BCF split planning and split reading (the VCFInputFormat BCF arm)."""

    def __init__(self, conf: Optional[Configuration] = None, metrics: Optional[Metrics] = None):
        self.conf = conf or Configuration()
        self.metrics = metrics if metrics is not None else Metrics()

    def _stringency(self) -> str:
        return (self.conf.get(VCFRECORDREADER_VALIDATION_STRINGENCY, "STRICT") or "STRICT").upper()

    def _intervals(self) -> Optional[List[Interval]]:
        return parse_intervals(self.conf.get(VCF_INTERVALS))

    def get_splits(self, paths, split_size: int = 4 << 20) -> List[FileVirtualSplit]:
        """Byte ranges fixed up to record starts with the guesser
        (VCFInputFormat.java:302-385): virtual offsets for BGZF files,
        ``offset << 16`` for uncompressed ones."""
        out: List[FileVirtualSplit] = []
        for path in sorted(paths):
            with open(path, "rb") as f:
                data = f.read()
            compressed = bgzf.is_bgzf(data)
            hdr, first = read_bcf_header(data, compressed)
            guesser = BcfSplitGuesser(data, hdr, compressed, self.metrics)
            size = len(data)
            starts: List[int] = []
            for beg in range(0, size, split_size):
                g = guesser.guess_next_record_start(beg, min(beg + split_size, size))
                if g is not None:
                    starts.append(g)
            # The file's first record is authoritative for split 0.
            if compressed:
                acc = 0
                v0 = 0
                co, _, us = bgzf.scan_blocks(data)
                for coffset, usize in zip(co.tolist(), us.tolist()):
                    if first < acc + usize:
                        v0 = bgzf.make_voffset(coffset, first - acc)
                        break
                    acc += usize
            else:
                v0 = first << 16
            starts = sorted(set([v0] + [s for s in starts if s > v0]))
            vend = (size << 16) | 0xFFFF if compressed else size << 16
            for i, s in enumerate(starts):
                e = starts[i + 1] if i + 1 < len(starts) else vend
                if e > s:
                    out.append(FileVirtualSplit(path, s, e))
        return out

    def read_split(
        self,
        split: FileVirtualSplit,
        stream=None,
        inflate_fn=None,
        errors: Optional[str] = None,
    ) -> VariantBatch:
        """Decode one split, reading only its byte window and the header's
        prefix.  ``stream`` (a ``DeviceStream``) arms the
        device record-chain walk and, when its inflate gate is armed,
        inflates the window through ``stream.decode_members`` (unless the
        caller passes ``inflate_fn``, with that contract).  ``errors``
        (default ``hadoopbam.errors``, else "strict"): strict raises on a
        corrupt member through the CRC gate, and on a bad record under
        STRICT stringency; salvage quarantines exactly the bad member
        (``salvage.*`` counters) and, when that tears the chain, walks it
        with the guesser's re-sync and the exact decoder; a clean window
        still takes the device walk."""
        if errors is None:
            errors = self.conf.get(ERRORS_MODE, "strict") or "strict"
        stringency = self._stringency()
        intervals = self._intervals()
        if inflate_fn is None and stream is not None and stream.policy.inflate_lanes:
            inflate_fn = stream.decode_members
        hdr, payload, p, end, resident, breaks = _read_bcf_split_local(
            split, errors=errors, inflate_fn=inflate_fn, metrics=self.metrics)
        if breaks:
            return _salvage_walk(payload, p, end, breaks, hdr, intervals, self.metrics)
        if stream is not None:
            dev = _read_device(payload, p, end, hdr, intervals, stream, resident)
            if dev is not None:
                return dev
        variants: List[bcf.BcfVariant] = []
        while p + 8 <= end:
            try:
                v, p = bcf.decode_record(payload, p, hdr)
            except _RECORD_ERRORS:
                if stringency == "STRICT":
                    raise
                break
            if intervals is not None and not any(
                iv.overlaps(v.chrom, v.start, v.end) for iv in intervals
            ):
                continue
            variants.append(v)
        keys = np.array([variant_key(hdr.vcf, v) for v in variants], dtype=np.int64)
        pos = np.array([v.pos for v in variants], dtype=np.int64)
        endp = np.array([v.end for v in variants], dtype=np.int64)
        return VariantBatch(header=hdr.vcf, variants=variants, keys=keys, pos=pos, end=endp)


def _read_device(payload, p: int, end: int, hdr: bcf.BcfHeader, intervals, stream,
                 resident: Optional[torch.Tensor] = None):
    """The armed read: the record-chain walk on the stream's device, the
    key/pos/end columns as tensor ops there (BCF→VCF contig map, Java sign
    extension of a negative POS-1) and the ragged interval join there;
    columns equal the exact loop's.  ``end`` is ``pos + rlen``, which the
    encoder writes from ``VariantContext.end`` (INFO END included).
    Returns None to send the window to the exact loop: the gate is off, the
    framing is corrupt or truncated, or a CHROM lies outside the
    dictionary (the exact loop owns those errors)."""
    res = stream.walk_bcf_records(payload, p, end, resident=resident)
    if res is None:
        return None
    cols, n, ok, tier = res
    m = stream.metrics
    if tier == "device":
        m.count("bcf.chain.device_walks")
    else:
        m.count("bcf.chain.host_walks")
        m.count("bcf.chain.tierdowns")
    if not ok:
        m.count("bcf.chain.oracle_fallbacks")
        return None
    m.count("bcf.chain.records", n)
    dev = stream.device
    cols = cols.to(dev).to(torch.int64)
    offs, chrom_i, pos0, rlen = cols[0], cols[1], cols[2], cols[3]
    if n:
        lo, hi = (int(x) for x in torch.stack([chrom_i.min(), chrom_i.max()]).cpu())
        if lo < 0 or hi >= len(hdr.contigs):
            return None
    vmap = torch.tensor(
        [hdr.vcf.contig_index(name) for name in hdr.contigs] or [0], dtype=torch.int64,
        device=dev,
    )
    keys = vmap[chrom_i] * (1 << 32) | torch.where(pos0 < 0, pos0, pos0 & 0xFFFFFFFF)
    pos1 = pos0 + 1
    endp = pos0 + rlen
    kept = offs
    if intervals is not None:
        name_to_ci = {name: ci for ci, name in enumerate(hdr.contigs)}
        q = [(name_to_ci[iv.contig], iv.start - 1, iv.end) for iv in intervals
             if iv.contig in name_to_ci]
        q_rid = np.asarray([r for r, _, _ in q], np.int64)
        q_beg = np.asarray([b for _, b, _ in q], np.int64)
        q_end = np.asarray([e for _, _, e in q], np.int64)
        # The join's device form runs on int32 coordinates; a coordinate
        # outside that domain sends this window's join to the host twin.
        use_dev = bool(n == 0 or (int(endp.max()) < 2**31 and int(q_end.max(initial=0)) < 2**31))
        m.count("variants.join_device" if use_dev else "variants.join_host")
        keep = ragged_overlap_mask(chrom_i, pos0, endp, q_rid, q_beg, q_end,
                                   use_device=use_dev, device=dev)
        keep = torch.as_tensor(keep, device=dev)
        kept, keys, pos1, endp = kept[keep], keys[keep], pos1[keep], endp[keep]
    host = torch.stack([kept, keys, pos1, endp]).cpu().numpy()
    if dev.type == "cuda":
        m.count_d2h(host.nbytes, "bcf_columns")
    kept_h = host[0]

    def materialize(rows=None) -> List[bcf.BcfVariant]:
        at = kept_h if rows is None else kept_h[rows]
        return [bcf.decode_record(payload, int(o), hdr)[0] for o in at]

    return VariantBatch(header=hdr.vcf, keys=host[1], pos=host[2], end=host[3],
                        materializer=materialize, device_columns=(keys, pos1, endp))


def _find_resync(payload, start: int, hdr: bcf.BcfHeader, metrics: Metrics) -> Optional[int]:
    """The first verifiable record start at or after ``start``: the
    guesser's candidate and verify passes over an inflated stream (the
    salvage re-sync after a quarantined member)."""
    g = BcfSplitGuesser(b"", hdr, compressed=False, metrics=metrics)
    window = payload[start : start + UNCOMPRESSED_BYTES_NEEDED_FOR_GUESS]
    cands = g._candidate_offsets(np.frombuffer(window, dtype=np.uint8))
    metrics.count("bcf.guess.candidates", len(cands))
    for off in cands:
        if g._decodes_from(payload, start + int(off), UNCOMPRESSED_BYTES_NEEDED_FOR_GUESS):
            return start + int(off)
    return None


def _salvage_walk(payload, p: int, end: int, breaks: List[int], hdr: bcf.BcfHeader, intervals,
                  metrics: Metrics) -> VariantBatch:
    """The exact decoder over a chain torn by quarantined members.
    ``breaks`` are the payload offsets where inflated bytes are missing: a
    record across one is torn (dropped, ``salvage.records_dropped``) and the
    walk re-syncs at the next guesser-verified record start."""
    variants: List[bcf.BcfVariant] = []
    bq = sorted(b for b in breaks if b is not None)
    bi = 0
    while bq and bi < len(bq) and bq[bi] <= p:
        # The chain is torn at or before the split's start.
        r = _find_resync(payload, bq[bi], hdr, metrics)
        bi += 1
        if r is None:
            break
        p = r
    while p + 8 <= end:
        b = bq[bi] if bi < len(bq) else None
        if b is not None and p >= b:
            bi += 1
            r = _find_resync(payload, b, hdr, metrics)
            if r is None:
                break
            p = r
            continue
        torn = False
        if b is not None:
            l_shared, l_indiv = struct.unpack_from("<II", payload, p)
            torn = p + 8 + l_shared + l_indiv > b
        if torn:
            # The rest of this record went with its member.
            metrics.count("salvage.records_dropped", 1)
            bi += 1
            r = _find_resync(payload, b, hdr, metrics)
            if r is None:
                break
            p = r
            continue
        try:
            v, p = bcf.decode_record(payload, p, hdr)
        except _RECORD_ERRORS:
            metrics.count("salvage.records_dropped", 1)
            break
        if intervals is not None and not any(
            iv.overlaps(v.chrom, v.start, v.end) for iv in intervals
        ):
            continue
        variants.append(v)
    keys = np.array([variant_key(hdr.vcf, v) for v in variants], dtype=np.int64)
    pos = np.array([v.pos for v in variants], dtype=np.int64)
    endp = np.array([v.end for v in variants], dtype=np.int64)
    return VariantBatch(header=hdr.vcf, variants=variants, keys=keys, pos=pos, end=endp)


def _read_bcf_split_local(split: FileVirtualSplit, errors: str = "strict", inflate_fn=None,
                          metrics: Optional[Metrics] = None):
    """(header, payload, start, record-start limit, resident window, chain
    breaks) read from the split's own byte window and a growing header
    prefix."""
    hdr, compressed = _read_bcf_header_prefix(split.path)
    if compressed:
        c0 = split.vstart >> 16
        c1 = split.vend >> 16
        # The end block's full extent (<= 64 KiB) plus slack.
        window = _read_range(split.path, c0, (c1 - c0) + 0x20000)
        shift = c0 << 16
        payload, p, end, resident, breaks = _inflate_range(
            window, split.vstart - shift, split.vend - shift, errors=errors,
            inflate_fn=inflate_fn, metrics=metrics,
        )
        return hdr, payload, p, end, resident, breaks
    p = split.vstart >> 16
    end = split.vend >> 16
    return hdr, _read_range(split.path, p, end - p), 0, end - p, None, []


def _inflate_range(data: bytes, vstart: int, vend: int, errors: str = "strict",
                   inflate_fn=None, metrics: Optional[Metrics] = None):
    """Inflate the BGZF blocks covering ``[vstart, vend)``: ``(payload,
    start offset, record-start limit, resident, chain breaks)``.  Records
    start strictly before the limit; the block at vend's coffset is
    included, so a record straddling the boundary completes
    (BCFRecordReader.java:176-236).

    ``inflate_fn(data, coffsets, csizes, usizes) -> (out, offsets, dev)``
    (``DeviceStream.decode_members``) inflates the member table as one
    batch; ``resident`` is its ``dev``, the payload on the device, when
    every member came from the kernel, else None.  A data error there
    (``BgzfError``, ``zlib.error``) sends the window to the per-member host
    loop; anything else raises.

    ``errors="strict"`` raises the bad member's ``BgzfError``; "salvage"
    quarantines exactly it (``salvage.members_quarantined`` and
    ``salvage.bytes_quarantined``, into ``metrics``) and records a chain
    break at the payload offset where its bytes are missing."""
    m = metrics if metrics is not None else Metrics()
    c0, u0 = bgzf.split_voffset(vstart)
    c1, u1 = bgzf.split_voffset(vend)
    members: List[Tuple[int, int, int]] = []  # (coffset, csize, usize)
    bad: List[int] = []  # member-order positions of the breaks
    pos = c0
    end_block_index = None
    while pos < len(data) and pos <= c1:
        if pos == c1:
            end_block_index = len(members)
        try:
            csize, usize = bgzf.read_block_at(data, pos)
        except bgzf.BgzfError:
            if errors != "salvage":
                raise
            # An unreadable header: quarantine up to the next plausible one.
            nxt = bgzf.find_next_block(data, pos + 1, min(len(data), c1 + 1))
            if nxt < 0:
                nxt = len(data)
            m.count("salvage.members_quarantined", 1)
            m.count("salvage.bytes_quarantined", nxt - pos)
            bad.append(len(members))
            pos = nxt
            continue
        members.append((pos, csize, usize))
        pos += csize
    chunks: List[Optional[bytes]] = [None] * len(members)
    resident = None
    if inflate_fn is not None and members:
        try:
            out, offs, resident = inflate_fn(
                np.frombuffer(data, np.uint8),
                np.asarray([mm[0] for mm in members], np.int64),
                np.asarray([mm[1] for mm in members], np.int32),
                np.asarray([mm[2] for mm in members], np.int32),
            )
            raw = out.tobytes()
            for i in range(len(members)):
                chunks[i] = raw[int(offs[i]) : int(offs[i + 1])]
        except _DATA_ERRORS:
            chunks = [None] * len(members)
            resident = None
    for i, (mpos, csize, _) in enumerate(members):
        if chunks[i] is not None:
            continue
        try:
            chunks[i], _ = bgzf.inflate_block(data, mpos, metrics=m)
        except bgzf.BgzfError:
            if errors != "salvage":
                raise
            m.count("salvage.members_quarantined", 1)
            m.count("salvage.bytes_quarantined", csize)
            chunks[i] = b""
            bad.append(i)
    # A break lands where the quarantined bytes would have been.
    acc_before_end_block = None
    acc = 0
    break_at: List[int] = []
    bad = sorted(set(bad))
    bj = 0
    for i in range(len(members) + 1):
        while bj < len(bad) and bad[bj] == i:
            break_at.append(acc)
            bj += 1
        if i == end_block_index:
            acc_before_end_block = acc
        if i < len(members):
            acc += len(chunks[i])
    blob = b"".join(chunks)
    limit = len(blob) if acc_before_end_block is None else min(acc_before_end_block + u1, len(blob))
    return blob, u0, limit, resident, sorted(set(break_at))


class BcfRecordWriter:
    """Always-BGZF BCF writer with the headerless part mode
    (BCFRecordWriter.java:49-138)."""

    def __init__(self, stream, header: VcfHeader, write_header: bool = True,
                 append_terminator: bool = False):
        self.header = bcf.BcfHeader(header)
        self._w = bgzf.BgzfWriter(stream, append_terminator=append_terminator)
        if write_header:
            self._w.write(bcf.encode_header(header))

    def write(self, v) -> None:
        self._w.write(bcf.encode_record(self.header, v))

    def close(self) -> None:
        self._w.close()

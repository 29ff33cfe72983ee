"""Request endpoints: ranged ``view``, ``flagstat`` and ``depth`` of an
alignment file, and the ranged variant query of a BCF call set.

Counterpart of ``hadoop_bam_tpu/serve/endpoints.py`` (``view_records``,
``view_blob``, ``flagstat``, ``depth_stat``, ``_variant_rows``,
``variants_records``, ``variants_blob``), the code the reference's
``view``, ``flagstat``, ``depth`` and ``variants`` CLI one-shots and daemon
ops run.  The reference's ``ServeContext`` (conf, resource cache, residency
arena, lane batcher, the daemon's stream) becomes explicit
``conf``/``device``/``stream`` arguments: the cache, arena and batcher come
with the serve slice (ROADMAP A.11), so every call plans and reads cold,
as the reference's one-shot does.

``view ref:start-end`` of a BAM is bounded traversal as a request: the
``.bai`` (the companion file, else one built from the BAM) turns the
region into chunk spans, each span is read (member inflate on the stream's
device under its inflate gate, the record walk on the host), and kernel
row 6 cuts the records of all of them that overlap the region in one
launch on the stream's device.  A CRAM has no ``.bai``: every split is
read and cut the same way.  The reply
is a small BAM compressed by host BGZF, the reference's bytes.  Per split
of a BCF call set: the inflate kernel, the BCF record-chain kernel and the
ragged interval join on the stream's device; the kept rows are decoded
and re-encoded on the host.
"""

from __future__ import annotations

import io
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..conf import Configuration
from ..device_stream import DeviceStream
from ..io.anysam import AnySamInputFormat, infer_from_file_path
from ..io.bam import BamInputFormat, _load_bai, gather_record_array, read_header_voffset
from ..io.bcf import BcfInputFormat, BcfRecordWriter, _read_bcf_header_prefix
from ..io.cram import read_cram_header
from ..io.merger import prepare_bam_header_block
from ..io.splits import FileVirtualSplit
from ..ops import cigar
from ..ops.kernels import overlap as koverlap
from ..ops.overlap import ragged_overlap_mask
from ..ops.pileup import depth_profile, depth_summary
from ..spec import bam, bgzf
from ..utils.backend import resolve_device
from ..utils.intervals import MAX_END, FormatError, parse_interval

#: SoA columns the view reads: the overlap inputs (refid, pos and the CIGAR
#: geometry of the reference spans) and the record extents of the gather.
VIEW_FIELDS = (
    "refid", "pos", "flag", "rec_off", "rec_len", "l_read_name", "n_cigar_op",
)
FLAGSTAT_FIELDS = ("flag", "rec_off", "rec_len")
#: samtools-flagstat-class counter names, in report order.
FLAGSTAT_KEYS = (
    "total", "secondary", "supplementary", "duplicates", "mapped",
    "paired", "read1", "read2", "properly_paired",
    "with_itself_and_mate_mapped", "singletons",
)
#: Decoded bytes of batches a view holds uncut: once its batches reach
#: this many they are cut together and those without a hit dropped, so a
#: view of a small region of a large CRAM (whose every split it reads)
#: never holds the whole file.  A ``.bai``-bounded BAM view of a contig
#: (one or a few members a chunk span) is one cut.
VIEW_CUT_BYTES = 128 << 20
#: Hard cap on a per-base depth reply (one int per base).
DEPTH_PER_BASE_MAX = 1 << 20


def _stream(stream: Optional[DeviceStream], device, conf) -> DeviceStream:
    return stream if stream is not None else DeviceStream(resolve_device(device), conf=conf)


def _no_deadline(deadline, what: str) -> None:
    if deadline is not None:
        raise NotImplementedError(f"{what} deadlines (the serve path) are not ported: ROADMAP A.11")


def _header(path: str) -> bam.BamHeader:
    """The alignment file's header: the CRAM file-header container, else
    the BAM header."""
    if infer_from_file_path(path) == "cram":
        return read_cram_header(path)
    return read_header_voffset(path)[0]


def _endpoint_format(conf: Optional[Configuration], path: str):
    """``(kind, reader)``: the BAM input format for ``.bam``, the AnySAM
    dispatcher otherwise."""
    if infer_from_file_path(path) == "bam":
        return "bam", BamInputFormat(conf)
    fmt = AnySamInputFormat(conf)
    return fmt.get_format(path), fmt


def _split_span(s) -> Tuple[int, int]:
    """A split's span: virtual offsets of a BAM split, bytes of a CRAM one."""
    if hasattr(s, "vstart"):
        return s.vstart, s.vend
    return s.start, s.start + s.length


def _cut_view(batches, rid: int, beg0: int, end0: int, stream: DeviceStream) -> List[np.ndarray]:
    """Row indices of each batch's records that overlap ``[beg0, end0)`` on
    refid ``rid``, in file order: one cut of all of them on the stream's
    device (kernel row 6, :func:`~.ops.kernels.overlap.overlap_rows`).  The
    host packs every batch's refid, pos and reference length (the CIGAR
    walk, :func:`~.ops.cigar.reference_lengths_np`) and the interval into
    one int32 buffer (pinned for the card): one upload, one cut, one
    read-back of the count and the rows, which ``np.searchsorted`` on the
    batch offsets splits again.  Each non-empty batch counts
    ``serve.view.overlap_device``, as the reference counts each window it
    cuts.  The reference's NumPy fallback behind a catch-all is not ported:
    a kernel failure raises."""
    sizes = np.asarray([b.n_records for b in batches], dtype=np.int64)
    n = int(sizes.sum())
    if n == 0:
        return [np.empty(0, dtype=np.int64) for _ in batches]
    dev = stream.device
    on_card = dev.type == "cuda"
    host = torch.empty(3 * n + 3, dtype=torch.int32, pin_memory=on_card)
    h = host.numpy()
    at = 0
    for b in batches:
        k = b.n_records
        if k:
            h[at : at + k] = b.soa["refid"]
            h[n + at : n + at + k] = b.soa["pos"]
            h[2 * n + at : 2 * n + at + k] = cigar.reference_lengths_np(b.data, b.soa)
            at += k
    h[3 * n :] = (rid, beg0, end0)
    cols = host.to(dev, non_blocking=True)
    out = koverlap.overlap_rows(cols[3 * n :].view(1, 3), cols[:n], cols[n : 2 * n],
                                cols[2 * n : 3 * n])
    if on_card:
        back = torch.empty(n + 1, dtype=torch.int32, pin_memory=True)
        back.copy_(out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        stream.metrics.count_h2d(4 * (3 * n + 3), "overlap_columns")
        stream.metrics.count_d2h(4 * (n + 1), "overlap_rows")
    else:
        back = out
    rows = back[1 : 1 + int(back[0])].numpy().astype(np.int64)
    stream.metrics.count("serve.view.overlap_device", int(np.count_nonzero(sizes)))
    ends = np.cumsum(sizes)
    cuts = np.searchsorted(rows, ends)
    return [rows[lo:hi] - (e - k) for lo, hi, e, k in zip(np.r_[0, cuts[:-1]], cuts, ends, sizes)]


def view_records(
    path: str,
    region: str,
    deadline=None,
    conf: Optional[Configuration] = None,
    device=None,
    stream: Optional[DeviceStream] = None,
    timings: Optional[dict] = None,
) -> Tuple[bam.BamHeader, List[Tuple[object, np.ndarray]]]:
    """Resolve a ranged alignment query to ``(header, [(batch, row
    indices)])``, batches with a hit in file order.  BAM: the ``.bai``'s
    chunk spans of the region, each read as a split; CRAM: every split.
    The batches are cut together (:func:`_cut_view`) once they hold
    :data:`VIEW_CUT_BYTES` of records, and at the end.  An unknown contig
    raises ``FormatError``.  ``timings`` receives the seconds of the
    ``index``, ``read`` and ``overlap`` phases."""
    _no_deadline(deadline, "view")
    iv = parse_interval(region)
    stream = _stream(stream, device, conf)
    t = {"index": 0.0, "read": 0.0, "overlap": 0.0}
    t0 = time.perf_counter()
    hdr = _header(path)
    try:
        rid = hdr.ref_index(iv.contig)
    except KeyError:
        raise FormatError(f"unknown contig {iv.contig!r} in {path!r}") from None
    beg0 = iv.start - 1  # 1-based inclusive -> 0-based half-open
    end0 = min(iv.end, MAX_END)
    kind, fmt = _endpoint_format(conf, path)
    if kind == "bam":
        chunks = _load_bai(path).query(rid, beg0, end0)
        splits = [FileVirtualSplit(path, c.beg, c.end) for c in chunks]
    else:
        splits = fmt.get_splits([path])
    t["index"] = time.perf_counter() - t0
    picks, held, size = [], [], 0
    for i, s in enumerate(splits):
        t1 = time.perf_counter()
        held.append(fmt.read_split(s, with_keys=False, fields=VIEW_FIELDS, stream=stream))
        size += held[-1].data.nbytes
        t2 = time.perf_counter()
        t["read"] += t2 - t1
        if size >= VIEW_CUT_BYTES or i == len(splits) - 1:
            picks += [(b, rows) for b, rows in zip(held, _cut_view(held, rid, beg0, end0, stream))
                      if len(rows)]
            held, size = [], 0
            t["overlap"] += time.perf_counter() - t2
    if timings is not None:
        timings.update(t)
    return hdr, picks


def view_blob(
    path: str,
    region: str,
    level: int = 6,
    deadline=None,
    conf: Optional[Configuration] = None,
    device=None,
    stream: Optional[DeviceStream] = None,
    timings: Optional[dict] = None,
) -> bytes:
    """A complete small BAM (header, the records overlapping ``region`` in
    file order, terminator), like ``samtools view -b file region``: BGZF at
    ``level`` on the host, the reference's bytes.  Runs on the card unless
    ``device="cpu"`` is passed.  ``timings`` also receives the ``encode``
    phase (record gather and BGZF)."""
    t = {} if timings is None else timings
    stream = _stream(stream, device, conf)
    hdr, picks = view_records(path, region, deadline=deadline, conf=conf, stream=stream,
                              timings=t)
    t0 = time.perf_counter()
    payloads = [gather_record_array(batch, rows) for batch, rows in picks]
    n_records = sum(len(rows) for _, rows in picks)
    payload = np.concatenate(payloads) if payloads else np.empty(0, np.uint8)
    body = bgzf.deflate_blocks(payload, level=level)[0] if len(payload) else b""
    blob = prepare_bam_header_block(hdr, level=level) + body + bgzf.TERMINATOR
    t["encode"] = time.perf_counter() - t0
    stream.metrics.count("serve.view.requests")
    stream.metrics.count("serve.view.records", n_records)
    return blob


def flagstat(
    path: str,
    deadline=None,
    conf: Optional[Configuration] = None,
    device=None,
    stream: Optional[DeviceStream] = None,
    timings: Optional[dict] = None,
) -> dict:
    """Whole-file flag census, samtools-flagstat class (:data:`FLAGSTAT_KEYS`):
    every split read through the stream (the flag column only), the counts
    NumPy popcounts.  ``timings`` receives ``index`` (the split plan) and
    ``read``."""
    _no_deadline(deadline, "flagstat")
    stream = _stream(stream, device, conf)
    t0 = time.perf_counter()
    _, fmt = _endpoint_format(conf, path)
    splits = fmt.get_splits([path])
    t = {"index": time.perf_counter() - t0, "read": 0.0}
    counts = {k: 0 for k in FLAGSTAT_KEYS}
    for s in splits:
        t1 = time.perf_counter()
        batch = fmt.read_split(s, with_keys=False, fields=FLAGSTAT_FIELDS, stream=stream)
        t["read"] += time.perf_counter() - t1
        flag = np.asarray(batch.soa["flag"], dtype=np.int64)
        mapped = (flag & bam.FLAG_UNMAPPED) == 0
        paired = (flag & bam.FLAG_PAIRED) != 0
        mate_mapped = (flag & bam.FLAG_MATE_UNMAPPED) == 0
        counts["total"] += len(flag)
        counts["secondary"] += int(((flag & bam.FLAG_SECONDARY) != 0).sum())
        counts["supplementary"] += int(((flag & bam.FLAG_SUPPLEMENTARY) != 0).sum())
        counts["duplicates"] += int(((flag & bam.FLAG_DUPLICATE) != 0).sum())
        counts["mapped"] += int(mapped.sum())
        counts["paired"] += int(paired.sum())
        counts["read1"] += int((paired & ((flag & bam.FLAG_FIRST_OF_PAIR) != 0)).sum())
        counts["read2"] += int((paired & ((flag & bam.FLAG_SECOND_OF_PAIR) != 0)).sum())
        counts["properly_paired"] += int(
            (paired & mapped & ((flag & bam.FLAG_PROPER_PAIR) != 0)).sum())
        counts["with_itself_and_mate_mapped"] += int((paired & mapped & mate_mapped).sum())
        counts["singletons"] += int((paired & mapped & ~mate_mapped).sum())
    if timings is not None:
        timings.update(t)
    stream.metrics.count("serve.flagstat.requests")
    return counts


def depth_stat(
    path: str,
    region: str,
    bin_size: int = 1 << 12,
    per_base: bool = False,
    deadline=None,
    conf: Optional[Configuration] = None,
    device=None,
    stream: Optional[DeviceStream] = None,
    timings: Optional[dict] = None,
) -> dict:
    """Pileup depth over an alignment region, like ``samtools depth -r``:
    the view's records, their reference spans and the segmented depth
    profile (:mod:`~.ops.pileup`): binned summaries always, the per-base
    vector with ``per_base`` up to :data:`DEPTH_PER_BASE_MAX` bases (past
    it ``FormatError``).  The window is clipped to the contig's length.
    The profile runs on the stream's device under the reference's gate
    (the BCF-chain gate), else on the host.  ``timings`` receives the
    view's phases and ``pileup``."""
    t = {} if timings is None else timings
    stream = _stream(stream, device, conf)
    iv = parse_interval(region)
    hdr, picks = view_records(path, region, deadline=deadline, conf=conf, stream=stream,
                              timings=t)
    rid = hdr.ref_index(iv.contig)
    beg0 = iv.start - 1
    end0 = min(iv.end, MAX_END)
    ref_len = hdr.refs[rid][1]
    if ref_len > 0:
        end0 = min(end0, ref_len)
    if end0 <= beg0:
        raise FormatError(f"empty depth window {region!r} (contig length {ref_len})")
    t0 = time.perf_counter()
    starts_l: List[np.ndarray] = []
    ends_l: List[np.ndarray] = []
    for batch, rows in picks:
        pos = np.asarray(batch.soa["pos"], dtype=np.int64)[rows]
        rl = cigar.reference_lengths_np(batch.data, batch.soa).astype(np.int64)[rows]
        starts_l.append(pos)
        ends_l.append(pos + np.maximum(rl, 1))
    starts = np.concatenate(starts_l) if starts_l else np.empty(0, np.int64)
    ends = np.concatenate(ends_l) if ends_l else np.empty(0, np.int64)
    kw = dict(use_device=stream.policy.use_bcf_chain, device=stream.device,
              metrics=stream.metrics)
    out = {"contig": iv.contig, "beg": beg0 + 1, "end": end0, "n_records": int(len(starts))}
    out.update(depth_summary(starts, ends, beg0, end0, bin_size=bin_size, **kw))
    if per_base:
        if end0 - beg0 > DEPTH_PER_BASE_MAX:
            raise FormatError(
                f"per-base depth span {end0 - beg0} exceeds cap "
                f"{DEPTH_PER_BASE_MAX}; use binned summaries"
            )
        out["per_base"] = [int(x) for x in depth_profile(starts, ends, beg0, end0, **kw)]
    t["pileup"] = time.perf_counter() - t0
    stream.metrics.count("serve.depth.requests")
    return out


def _variant_rows(batch, rid: int, beg0: int, end0: int, use_device: bool,
                  stream: Optional[DeviceStream] = None) -> np.ndarray:
    """Row indices of the batch's records overlapping ``[beg0, end0)`` on
    VCF contig index ``rid``: the ragged interval join over the key/pos/end
    columns (a record spans ``[pos - 1, end)``).  With ``use_device`` the
    join runs on ``stream``'s device (on the batch's device columns when it
    has them, else on an upload of its host columns) inside the int32
    coordinate domain; outside it the host twin answers.  Counted as
    ``variants.join_device``/``variants.join_host``."""
    n = batch.n_records
    if n == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.asarray(batch.pos, dtype=np.int64) - 1
    ends = np.asarray(batch.end, dtype=np.int64)
    use_dev = use_device and bool(
        starts.size
        and int(starts.min()) >= -(2**31)
        and int(ends.max()) < 2**31 - 8
        and end0 < 2**31 - 8
    )
    q = (np.asarray([rid], np.int64), np.asarray([beg0], np.int64), np.asarray([end0], np.int64))
    if use_dev:
        dev = stream.device
        if batch.device_columns is not None:
            keys_t, pos_t, end_t = batch.device_columns
        else:
            keys_t, pos_t, end_t = (
                torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                for a in (batch.keys, batch.pos, batch.end)
            )
            if dev.type == "cuda":
                stream.metrics.count_h2d(24 * n, "variant_columns")
        mask = ragged_overlap_mask(keys_t >> 32, pos_t - 1, end_t, *q, use_device=True,
                                   device=dev)
        rows = torch.nonzero(mask).flatten().cpu().numpy()
    else:
        refid = np.asarray(batch.keys, dtype=np.int64) >> 32
        rows = np.nonzero(ragged_overlap_mask(refid, starts, ends, *q))[0]
    if stream is not None:
        stream.metrics.count("variants.join_device" if use_dev else "variants.join_host")
    return rows.astype(np.int64)


def variants_records(
    path: str,
    region: str,
    deadline=None,
    conf: Optional[Configuration] = None,
    device=None,
    stream: Optional[DeviceStream] = None,
    timings: Optional[dict] = None,
) -> Tuple[object, List[Tuple[object, np.ndarray]]]:
    """Resolve a ranged BCF query to ``(BcfHeader, [(batch, row indices)])``.

    The split plan is the reference's one-shot plan (the guesser over the
    whole file at the default 4 MiB split size; BCF has no index here, so
    every split is read); each split is read through ``stream`` (a new
    ``DeviceStream`` on ``device``, resolved as every entry point of the
    port does, when none is given) and cut by the join.  An unknown contig
    raises ``FormatError``.  ``timings``, when given, receives the seconds
    of the ``plan``, ``read`` and ``join`` phases."""
    _no_deadline(deadline, "variants")
    iv = parse_interval(region)
    if stream is None:
        stream = DeviceStream(resolve_device(device), conf=conf)
    t = {"plan": 0.0, "read": 0.0, "join": 0.0}
    t0 = time.perf_counter()
    hdr, _ = _read_bcf_header_prefix(path)
    splits = BcfInputFormat(Configuration(), metrics=stream.metrics).get_splits([path])
    if iv.contig not in hdr.contigs:
        raise FormatError(f"unknown contig {iv.contig!r} in {path!r}") from None
    rid = hdr.vcf.contig_index(iv.contig)
    beg0 = iv.start - 1  # 1-based inclusive -> 0-based half-open
    end0 = min(iv.end, MAX_END)
    t["plan"] = time.perf_counter() - t0
    fmt = BcfInputFormat(conf, metrics=stream.metrics)
    use_dev = stream.policy.use_bcf_chain
    picks: List[Tuple[object, np.ndarray]] = []
    for s in splits:
        t1 = time.perf_counter()
        batch = fmt.read_split(s, stream=stream)
        t2 = time.perf_counter()
        rows = _variant_rows(batch, rid, beg0, end0, use_dev, stream)
        t["join"] += time.perf_counter() - t2
        t["read"] += t2 - t1
        if len(rows):
            picks.append((batch, rows))
    if timings is not None:
        timings.update(t)
    return hdr, picks


def variants_blob(
    path: str,
    region: str,
    deadline=None,
    conf: Optional[Configuration] = None,
    device=None,
    stream: Optional[DeviceStream] = None,
    timings: Optional[dict] = None,
) -> bytes:
    """A complete small BCF (header, the records overlapping ``region`` in
    file order, terminator), like ``bcftools view -r``.  Runs on the card
    unless ``device="cpu"`` is passed.  ``timings`` also receives the
    ``encode`` phase (decode of the kept rows, BCF encode, BGZF)."""
    t = {} if timings is None else timings
    if stream is None:
        stream = DeviceStream(resolve_device(device), conf=conf)
    hdr, picks = variants_records(path, region, deadline=deadline, conf=conf, stream=stream,
                                  timings=t)
    t0 = time.perf_counter()
    buf = io.BytesIO()
    w = BcfRecordWriter(buf, hdr.vcf, append_terminator=True)
    n_records = 0
    for batch, rows in picks:
        for v in batch.select(rows):
            w.write(v)
        n_records += len(rows)
    w.close()
    t["encode"] = time.perf_counter() - t0
    stream.metrics.count("serve.variants.requests")
    stream.metrics.count("serve.variants.records", n_records)
    return buf.getvalue()

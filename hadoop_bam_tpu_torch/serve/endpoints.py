"""Request endpoints: ranged ``view``, ``flagstat`` and ``depth`` of an
alignment file, the ranged variant query of a BCF call set, and the
daemon's warm state they share.

Counterpart of ``hadoop_bam_tpu/serve/endpoints.py``.  One implementation,
two surfaces: the daemon (:mod:`.server`) and a one-shot caller both pass
a :class:`ServeContext`, the bundle of the conf, the header/index cache
(:mod:`.cache`), the decoded-window arena (:mod:`.arena`), the lane
batcher (:mod:`.batching`, the daemon's) and the
:class:`~..device_stream.DeviceStream` on the context's device, whose
metrics are the context's registry.  A one-shot context is built per call
(``ServeContext.from_conf(with_batcher=False)``), cold; the daemon keeps
one for its life.

``view ref:start-end`` of a BAM is bounded traversal as a request: the
cached ``.bai`` (the companion file, else one built from the BAM) turns
the region into chunk spans, each span's decoded window comes from the
arena or is read (member inflate through the lane batcher, else the
stream's inflate gate; the record walk on the host) and held, and kernel
row 6 cuts the records of all of them that overlap the region in one
launch on the stream's device.  A CRAM has no ``.bai``: every split is
read and cut the same way.  The reply is a small BAM compressed by host
BGZF, the reference's bytes.  Per split of a BCF call set (the plan
cached): the inflate kernel, the BCF record-chain kernel and the ragged
interval join on the stream's device; the kept rows are decoded and
re-encoded on the host.  A ``deadline`` is checked before every window
(the ``endpoint`` seam).
"""

from __future__ import annotations

import io
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..conf import SERVE_ARENA_BYTES, SERVE_BATCH_WINDOW_MS, SERVE_CACHE_BYTES, Configuration
from ..device_stream import DeviceStream
from ..io.anysam import AnySamInputFormat, infer_from_file_path
from ..io.bam import BamInputFormat, gather_record_array
from ..io.bcf import BcfInputFormat, BcfRecordWriter
from ..io.merger import prepare_bam_header_block
from ..io.splits import FileVirtualSplit
from ..ops import cigar
from ..ops.kernels import overlap as koverlap
from ..ops.overlap import ragged_overlap_mask
from ..ops.pileup import depth_profile, depth_summary
from ..spec import bam, bgzf
from ..utils.backend import is_resource_exhausted, resolve_device
from ..utils.deadline import Deadline, current_deadline
from ..utils.intervals import MAX_END, FormatError, parse_interval
from ..utils.tracing import TRACER, MetricsRegistry, current_request, span
from .arena import HbmArena
from .batching import LaneBatcher
from .cache import ResourceCache

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
#: this many they are cut together and those without a hit dropped from
#: the view (the arena keeps what its budget allows).  A ``.bai``-bounded
#: BAM view of a contig is one cut.
VIEW_CUT_BYTES = 128 << 20
#: Hard cap on a per-base depth reply (one int per base).
DEPTH_PER_BASE_MAX = 1 << 20

DEFAULT_CACHE_BYTES = 256 << 20
DEFAULT_ARENA_BYTES = 1 << 30
DEFAULT_BATCH_WINDOW_MS = 2


@dataclass
class ServeContext:
    """The daemon's warm state: conf, cache, arena, the lane batcher and
    the daemon's :class:`~..device_stream.DeviceStream`.  The cache, arena
    and batcher count into the stream's metrics, the context's registry."""

    conf: Configuration
    cache: ResourceCache
    arena: HbmArena
    batcher: Optional[LaneBatcher] = None
    stream: Optional[DeviceStream] = None

    @classmethod
    def from_conf(cls, conf: Optional[Configuration] = None, with_batcher: bool = True,
                  device=None) -> "ServeContext":
        """A context on ``device`` (default cuda; raises without a card)
        whose counters go to a new registry."""
        conf = conf or Configuration()
        registry = MetricsRegistry()
        stream = DeviceStream(resolve_device(device), conf=conf, metrics=registry)
        window_ms = conf.get_int(SERVE_BATCH_WINDOW_MS, DEFAULT_BATCH_WINDOW_MS)
        batcher = LaneBatcher(window_s=window_ms / 1e3, stream=stream) if with_batcher else None
        return cls(
            conf=conf,
            cache=ResourceCache(conf.get_int(SERVE_CACHE_BYTES, DEFAULT_CACHE_BYTES),
                                metrics=registry),
            arena=HbmArena(conf.get_int(SERVE_ARENA_BYTES, DEFAULT_ARENA_BYTES),
                           metrics=registry),
            batcher=batcher,
            stream=stream,
        )

    @property
    def metrics(self) -> MetricsRegistry:
        return self.stream.metrics

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()
            self.batcher = None
        self.arena.release_all()

    def _inflate_fn(self):
        """The read path's member inflate: the lane batcher inside the
        out-of-memory ladder, or None without a batcher.

        A card out of memory (a real ``torch.cuda.OutOfMemoryError``, or
        the ``arena.oom`` fault directive) never kills the daemon: the
        arena's least recently used window is evicted and the shared launch
        retried once; if the card is still out of memory, this request
        decodes its members on the host's member inflate
        (``serve.oom.tierdowns``) while every other request keeps the
        card.  Any other failure, a kernel that cannot build or launch
        among them, raises to the request.  The ambient deadline rides into
        the batcher."""
        if self.batcher is None:
            return None
        b = self.batcher
        arena = self.arena
        metrics = self.metrics

        def inflate(raw, co, cs, us):
            d = current_deadline()
            rctx = current_request()
            try:
                return b.submit(raw, co, cs, us, deadline=d)
            except Exception as e:
                if not is_resource_exhausted(e):
                    raise
            if rctx is not None:
                rctx.annotate("oom.evict")
            arena.evict_lru()
            try:
                return b.submit(raw, co, cs, us, deadline=d)
            except Exception as e:
                if not is_resource_exhausted(e):
                    raise
            metrics.count("serve.oom.tierdowns", 1)
            if rctx is not None:
                rctx.annotate("oom.tierdown", tier="host")
            if TRACER.armed:
                TRACER.instant("serve.oom.tierdown", "tier", {"tier": "host"})
            t_host = time.perf_counter()
            out, offs = bgzf.inflate_blocks(raw, co, cs, us)
            if rctx is not None:
                rctx.annotate("oom.host_decode", ms=(time.perf_counter() - t_host) * 1e3)
            return out, offs, None

        return inflate


def _endpoint_format(ctx: ServeContext, path: str):
    """``(kind, reader)``: the BAM input format for ``.bam``, the AnySAM
    dispatcher otherwise."""
    if infer_from_file_path(path) == "bam":
        return "bam", BamInputFormat(ctx.conf)
    fmt = AnySamInputFormat(ctx.conf)
    return fmt.get_format(path), fmt


def _split_span(s) -> Tuple[int, int]:
    """A split's span: virtual offsets of a BAM split, bytes of a CRAM one."""
    if hasattr(s, "vstart"):
        return s.vstart, s.vend
    return s.start, s.start + s.length


def _read_kw(ctx: ServeContext, kind: str) -> dict:
    """The read's codec keywords: the stream, and for BAM the batcher."""
    kw = {"stream": ctx.stream}
    if kind == "bam":
        kw["inflate_fn"] = ctx._inflate_fn()
    return kw


def _cut_view(batches, rid: int, beg0: int, end0: int, stream: DeviceStream) -> List[np.ndarray]:
    """Row indices of each batch's records that overlap ``[beg0, end0)`` on
    refid ``rid``, in file order: one cut of all of them on the stream's
    device (kernel row 6, :func:`~..ops.kernels.overlap.overlap_rows`).  The
    host packs every batch's refid, pos and reference length (the CIGAR
    walk, :func:`~..ops.cigar.reference_lengths_np`) and the interval into
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
        # The daemon's threads launch on one stream: this thread's cut is
        # in it, so the sync covers it whichever thread launched what.
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
    ctx: ServeContext,
    path: str,
    region: str,
    deadline: Optional[Deadline] = None,
    timings: Optional[dict] = None,
) -> Tuple[bam.BamHeader, List[Tuple[object, np.ndarray]]]:
    """Resolve a ranged alignment query to ``(header, [(batch, row
    indices)])``, batches with a hit in file order.  BAM: the cached
    ``.bai``'s chunk spans of the region, CRAM: every split; each window
    from the arena, else read and held.  The windows are cut together
    (:func:`_cut_view`) once they hold :data:`VIEW_CUT_BYTES` of records,
    and at the end.  An unknown contig raises ``FormatError``; ``deadline``
    is checked before every window.  ``timings`` receives the seconds of
    the ``index``, ``read`` and ``overlap`` phases."""
    iv = parse_interval(region)
    rctx = current_request()
    t = {"index": 0.0, "read": 0.0, "overlap": 0.0}
    t0 = time.perf_counter()
    hdr, _ = ctx.cache.header(path)
    try:
        rid = hdr.ref_index(iv.contig)
    except KeyError:
        raise FormatError(f"unknown contig {iv.contig!r} in {path!r}") from None
    beg0 = iv.start - 1  # 1-based inclusive -> 0-based half-open
    end0 = min(iv.end, MAX_END)
    kind, fmt = _endpoint_format(ctx, path)
    if kind == "bam":
        chunks = ctx.cache.bai(path).query(rid, beg0, end0)
        splits = [FileVirtualSplit(path, c.beg, c.end) for c in chunks]
    else:
        splits = fmt.get_splits([path])
    ident = ctx.cache.identity(path)
    # Revalidation: windows decoded under an older identity of the file go.
    ctx.arena.evict_stale(path, ident)
    t["index"] = time.perf_counter() - t0
    if rctx is not None:
        rctx.annotate("view.index", ms=t["index"] * 1e3)
    kw = _read_kw(ctx, kind)
    picks, held, size = [], [], 0
    for i, s in enumerate(splits):
        if deadline is not None:
            deadline.check("endpoint", ctx.metrics)
        a, b = _split_span(s)
        key = ("view", ident, a, b)
        batch = ctx.arena.get(key)
        if batch is None:
            t1 = time.perf_counter()
            with span("serve.view.read", ctx.metrics):
                batch = fmt.read_split(s, with_keys=False, fields=VIEW_FIELDS, **kw)
            ctx.arena.hold(key, batch)
            dt = time.perf_counter() - t1
            t["read"] += dt
            if rctx is not None:
                rctx.annotate("window.read", ms=dt * 1e3)
        held.append(batch)
        size += batch.data.nbytes
        if size >= VIEW_CUT_BYTES or i == len(splits) - 1:
            t2 = time.perf_counter()
            picks += [(b, rows) for b, rows in zip(held, _cut_view(held, rid, beg0, end0,
                                                                   ctx.stream)) if len(rows)]
            held, size = [], 0
            t["overlap"] += time.perf_counter() - t2
    if rctx is not None and splits:
        rctx.annotate("view.overlap", ms=t["overlap"] * 1e3, windows=len(splits))
    if timings is not None:
        timings.update(t)
    return hdr, picks


def view_blob(
    ctx: ServeContext,
    path: str,
    region: str,
    level: int = 6,
    deadline: Optional[Deadline] = None,
    timings: Optional[dict] = None,
) -> bytes:
    """A complete small BAM (header, the records overlapping ``region`` in
    file order, terminator), like ``samtools view -b file region``: BGZF at
    ``level`` on the host, the reference's bytes.  ``timings`` also
    receives the ``encode`` phase (record gather and BGZF)."""
    t = {} if timings is None else timings
    t0 = time.perf_counter()
    with span("serve.view", ctx.metrics):
        hdr, picks = view_records(ctx, path, region, deadline=deadline, timings=t)
        t1 = time.perf_counter()
        payloads = [gather_record_array(batch, rows) for batch, rows in picks]
        n_records = sum(len(rows) for _, rows in picks)
        payload = np.concatenate(payloads) if payloads else np.empty(0, np.uint8)
        body = bgzf.deflate_blocks(payload, level=level)[0] if len(payload) else b""
        blob = prepare_bam_header_block(hdr, level=level) + body + bgzf.TERMINATOR
        t["encode"] = time.perf_counter() - t1
        rctx = current_request()
        if rctx is not None:
            rctx.annotate("view.encode", ms=t["encode"] * 1e3, records=n_records)
    m = ctx.metrics
    m.count("serve.view.requests")
    m.count("serve.view.records", n_records)
    m.observe("serve.view.ms", (time.perf_counter() - t0) * 1e3)
    return blob


def flagstat(
    ctx: ServeContext,
    path: str,
    deadline: Optional[Deadline] = None,
    timings: Optional[dict] = None,
) -> dict:
    """Whole-file flag census, samtools-flagstat class (:data:`FLAGSTAT_KEYS`):
    every split read (the flag column only; each window held in the arena,
    so a warm census reads nothing), the counts NumPy popcounts.
    ``timings`` receives ``index`` (the split plan) and ``read``."""
    t0 = time.perf_counter()
    with span("serve.flagstat", ctx.metrics):
        ctx.cache.header(path)
        ident = ctx.cache.identity(path)
        ctx.arena.evict_stale(path, ident)
        kind, fmt = _endpoint_format(ctx, path)
        splits = fmt.get_splits([path])
        t = {"index": time.perf_counter() - t0, "read": 0.0}
        kw = _read_kw(ctx, kind)
        rctx = current_request()
        counts = {k: 0 for k in FLAGSTAT_KEYS}
        for s in splits:
            if deadline is not None:
                deadline.check("endpoint", ctx.metrics)
            a, b = _split_span(s)
            key = ("flagstat", ident, a, b)
            batch = ctx.arena.get(key)
            if batch is None:
                t1 = time.perf_counter()
                batch = fmt.read_split(s, with_keys=False, fields=FLAGSTAT_FIELDS, **kw)
                ctx.arena.hold(key, batch)
                dt = time.perf_counter() - t1
                t["read"] += dt
                if rctx is not None:
                    rctx.annotate("window.read", ms=dt * 1e3)
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
    m = ctx.metrics
    m.count("serve.flagstat.requests")
    m.observe("serve.flagstat.ms", (time.perf_counter() - t0) * 1e3)
    return counts


def depth_stat(
    ctx: ServeContext,
    path: str,
    region: str,
    bin_size: int = 1 << 12,
    per_base: bool = False,
    deadline: Optional[Deadline] = None,
    timings: Optional[dict] = None,
) -> dict:
    """Pileup depth over an alignment region, like ``samtools depth -r``:
    the view's records, their reference spans and the segmented depth
    profile (:mod:`~..ops.pileup`): binned summaries always, the per-base
    vector with ``per_base`` up to :data:`DEPTH_PER_BASE_MAX` bases (past
    it ``FormatError``).  The window is clipped to the contig's length.
    The profile runs on the stream's device under the reference's gate
    (the BCF-chain gate), else on the host.  ``timings`` receives the
    view's phases and ``pileup``."""
    t = {} if timings is None else timings
    t0 = time.perf_counter()
    stream = ctx.stream
    with span("serve.depth", ctx.metrics):
        iv = parse_interval(region)
        hdr, picks = view_records(ctx, path, region, deadline=deadline, timings=t)
        rid = hdr.ref_index(iv.contig)
        beg0 = iv.start - 1
        end0 = min(iv.end, MAX_END)
        ref_len = hdr.refs[rid][1]
        if ref_len > 0:
            end0 = min(end0, ref_len)
        if end0 <= beg0:
            raise FormatError(f"empty depth window {region!r} (contig length {ref_len})")
        t1 = time.perf_counter()
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
        t["pileup"] = time.perf_counter() - t1
        rctx = current_request()
        if rctx is not None:
            rctx.annotate("depth.pileup", ms=t["pileup"] * 1e3, records=int(len(starts)))
    m = ctx.metrics
    m.count("serve.depth.requests")
    m.observe("serve.depth.ms", (time.perf_counter() - t0) * 1e3)
    return out


def _variant_batch_nbytes(batch) -> int:
    """The arena's charge for a variant batch: the int64 columns and a flat
    64 bytes a record for the materializer's payload."""
    n = batch.n_records
    return (getattr(batch.keys, "nbytes", 8 * n) + getattr(batch.pos, "nbytes", 8 * n)
            + getattr(batch.end, "nbytes", 8 * n) + 64 * n + 4096)


def _variant_rows(batch, rid: int, beg0: int, end0: int, use_device: bool,
                  stream: DeviceStream) -> np.ndarray:
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
    stream.metrics.count("variants.join_device" if use_dev else "variants.join_host")
    return rows.astype(np.int64)


def variants_records(
    ctx: ServeContext,
    path: str,
    region: str,
    deadline: Optional[Deadline] = None,
    timings: Optional[dict] = None,
) -> Tuple[object, List[Tuple[object, np.ndarray]]]:
    """Resolve a ranged BCF query to ``(BcfHeader, [(batch, row indices)])``.

    The split plan comes from the cache (:meth:`~.cache.ResourceCache.bcf_plan`:
    the guesser over the whole file at the default 4 MiB split size; BCF
    has no index here, so every split is read); each split's batch comes
    from the arena, else is read through the stream (and the batcher) and
    held unfiltered, and is cut by the join.  An unknown contig raises
    ``FormatError``.  ``timings`` receives the seconds of the ``plan``,
    ``read`` and ``join`` phases."""
    iv = parse_interval(region)
    rctx = current_request()
    t = {"plan": 0.0, "read": 0.0, "join": 0.0}
    t0 = time.perf_counter()
    hdr, splits = ctx.cache.bcf_plan(path)
    if iv.contig not in hdr.contigs:
        raise FormatError(f"unknown contig {iv.contig!r} in {path!r}") from None
    rid = hdr.vcf.contig_index(iv.contig)
    beg0 = iv.start - 1  # 1-based inclusive -> 0-based half-open
    end0 = min(iv.end, MAX_END)
    t["plan"] = time.perf_counter() - t0
    if rctx is not None:
        rctx.annotate("variants.plan", ms=t["plan"] * 1e3)
    ident = ctx.cache.identity(path)
    ctx.arena.evict_stale(path, ident)
    fmt = BcfInputFormat(ctx.conf, metrics=ctx.metrics)
    use_dev = ctx.stream.policy.use_bcf_chain
    picks: List[Tuple[object, np.ndarray]] = []
    for s in splits:
        if deadline is not None:
            deadline.check("endpoint", ctx.metrics)
        key = ("variants", ident, s.vstart, s.vend)
        batch = ctx.arena.get(key)
        if batch is None:
            t1 = time.perf_counter()
            with span("serve.variants.read", ctx.metrics):
                batch = fmt.read_split(s, stream=ctx.stream, inflate_fn=ctx._inflate_fn())
            ctx.arena.hold(key, batch, nbytes=_variant_batch_nbytes(batch))
            dt = time.perf_counter() - t1
            t["read"] += dt
            if rctx is not None:
                rctx.annotate("window.read", ms=dt * 1e3)
        t2 = time.perf_counter()
        rows = _variant_rows(batch, rid, beg0, end0, use_dev, ctx.stream)
        t["join"] += time.perf_counter() - t2
        if len(rows):
            picks.append((batch, rows))
    if rctx is not None and splits:
        rctx.annotate("variants.join", ms=t["join"] * 1e3, windows=len(splits))
    if timings is not None:
        timings.update(t)
    return hdr, picks


def variants_blob(
    ctx: ServeContext,
    path: str,
    region: str,
    deadline: Optional[Deadline] = None,
    timings: Optional[dict] = None,
) -> bytes:
    """A complete small BCF (header, the records overlapping ``region`` in
    file order, terminator), like ``bcftools view -r``.  ``timings`` also
    receives the ``encode`` phase (decode of the kept rows, BCF encode,
    BGZF)."""
    t = {} if timings is None else timings
    t0 = time.perf_counter()
    with span("serve.variants", ctx.metrics):
        hdr, picks = variants_records(ctx, path, region, deadline=deadline, timings=t)
        t1 = time.perf_counter()
        buf = io.BytesIO()
        w = BcfRecordWriter(buf, hdr.vcf, append_terminator=True)
        n_records = 0
        for batch, rows in picks:
            for v in batch.select(rows):
                w.write(v)
            n_records += len(rows)
        w.close()
        t["encode"] = time.perf_counter() - t1
        rctx = current_request()
        if rctx is not None:
            rctx.annotate("variants.encode", ms=t["encode"] * 1e3, records=n_records)
    m = ctx.metrics
    m.count("serve.variants.requests")
    m.count("serve.variants.records", n_records)
    m.observe("serve.variants.ms", (time.perf_counter() - t0) * 1e3)
    return buf.getvalue()

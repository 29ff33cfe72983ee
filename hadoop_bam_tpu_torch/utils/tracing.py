"""Counters, the serve daemon's metrics registry, the timeline tracer,
request-scoped tracing, the batch tracer's stage spans and run provenance.

Counterpart of ``hadoop_bam_tpu/utils/tracing.py``: the counter half
(:class:`Metrics`), the registry (:class:`Histogram`,
:class:`MetricsRegistry`, :func:`snapshot`, :func:`delta`,
:func:`prometheus_text`), the timeline ring (:class:`Tracer`, with its
counter tracks), the request half (:class:`RequestContext`,
:func:`current_request`, :func:`request_scope`, :func:`span`), the batch
half (:func:`trace_ctx`, :func:`stage`, :func:`device_trace`,
:class:`Progress`) and run provenance (:class:`RunManifest`,
:func:`run_manifest`; a multi-process run's :class:`ClusterManifest`,
:func:`cluster_manifest`).  Counter names are the reference's, so the two
packages' counts can be compared.

Counters are passed, not global: a :class:`Metrics` belongs to the job
that creates it, and the serve daemon owns one :class:`MetricsRegistry`
that it hands down as ``metrics=``; :func:`run_manifest` reads the
counters it is given.  The tracer ring and the ambient request and
``trace_ctx`` scopes are process-wide, as in the reference: the ring is
one timeline, and the scopes are per thread.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

#: Every counter, span, histogram and gauge name: dotted lowercase, at
#: least two components (``subsystem.metric``).
METRIC_NAME_PATTERN = r"^[a-z0-9_]+(\.[a-z0-9_]+)+$"


class Metrics:
    def __init__(self) -> None:
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def get(self, name: str) -> int:
        return self._counters.get(name, 0)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def count_h2d(self, nbytes: int, what: str) -> None:
        self.count("transfers.h2d_bytes", nbytes)
        self.count(f"transfers.h2d.{what}", nbytes)

    def count_d2h(self, nbytes: int, what: str) -> None:
        self.count("transfers.d2h_bytes", nbytes)
        self.count(f"transfers.d2h.{what}", nbytes)


class Histogram:
    """Fixed log2-bucket value distribution.  Bucket ``i`` counts values
    ``2**(i-1) < v <= 2**i`` (bucket 0 takes ``v <= 1``, the last takes
    the rest); :meth:`percentile` is the upper bound of the bucket holding
    the rank, a <= 2x overestimate by construction."""

    N_BUCKETS = 64

    __slots__ = ("counts", "n", "total")

    def __init__(self) -> None:
        self.counts = [0] * self.N_BUCKETS
        self.n = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        if v <= 1.0:
            i = 0
        else:
            m, e = math.frexp(v)
            i = min(self.N_BUCKETS - 1, e - 1 if m == 0.5 else e)
        self.counts[i] += 1
        self.n += 1
        self.total += v

    @staticmethod
    def bucket_upper(i: int) -> float:
        return float(2**i)

    def percentile(self, q: float) -> float:
        if self.n == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.n))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.bucket_upper(i)
        return self.bucket_upper(self.N_BUCKETS - 1)

    def as_dict(self) -> Dict[str, object]:
        return {
            "count": self.n,
            "sum": self.total,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "buckets": {str(self.bucket_upper(i)): c for i, c in enumerate(self.counts) if c},
        }

    def copy(self) -> "Histogram":
        h = Histogram()
        h.counts = list(self.counts)
        h.n = self.n
        h.total = self.total
        return h


class MetricsRegistry(Metrics):
    """Counters plus span sums, log2 histograms and gauges: the serve
    daemon's registry."""

    def __init__(self) -> None:
        super().__init__()
        self._spans: Dict[str, float] = {}
        self._span_counts: Dict[str, int] = {}
        self._hists: Dict[str, Histogram] = {}
        self._gauges: Dict[str, float] = {}

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def add_span(self, name: str, seconds: float) -> None:
        with self._lock:
            self._spans[name] = self._spans.get(name, 0.0) + seconds
            self._span_counts[name] = self._span_counts.get(name, 0) + 1

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "span_seconds": dict(self._spans),
                "span_counts": dict(self._span_counts),
                "histograms": {k: h.as_dict() for k, h in self._hists.items()},
                "gauges": dict(self._gauges),
            }

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            h = self._hists.get(name)
            return h.copy() if h is not None else None


def snapshot(registry: MetricsRegistry) -> Dict[str, Dict[str, float]]:
    """A point-in-time copy of ``registry``: pair with :func:`delta`."""
    return registry.report()


def delta(
    before: Dict[str, Dict[str, float]],
    after: Optional[Dict[str, Dict[str, float]]] = None,
    registry: Optional[MetricsRegistry] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-section difference of two :func:`snapshot` reports (``after``
    defaults to a fresh snapshot of ``registry``); only keys that moved
    are kept.  Histograms diff on ``count``/``sum``; gauges carry the
    ``after`` levels."""
    if after is None:
        after = snapshot(registry)
    out: Dict[str, Dict[str, float]] = {}
    for section in ("counters", "span_seconds", "span_counts"):
        b = before.get(section, {})
        a = after.get(section, {})
        d = {}
        for k in set(a) | set(b):
            v = a.get(k, 0) - b.get(k, 0)
            if v:
                d[k] = v
        out[section] = d
    hd: Dict[str, Dict[str, float]] = {}
    bh = before.get("histograms", {})
    for k, av in after.get("histograms", {}).items():
        bv = bh.get(k, {})
        dc = av.get("count", 0) - bv.get("count", 0)
        if dc:
            hd[k] = {"count": dc, "sum": av.get("sum", 0.0) - bv.get("sum", 0.0)}
    out["histograms"] = hd
    out["gauges"] = dict(after.get("gauges", {}))
    return out


def transfers_report(counters: Dict[str, int]) -> Dict[str, int]:
    """Every ``transfers.`` counter with the prefix stripped."""
    return {k[len("transfers."):]: v for k, v in counters.items() if k.startswith("transfers.")}


# -- the timeline tracer ------------------------------------------------------

DEFAULT_TRACE_EVENTS = 1 << 16


class Tracer:
    """Opt-in bounded ring of timeline events ``(name, category, t0, t1,
    thread, args)``.  Disarmed, no ring exists and :func:`span` pays one
    attribute check.  When the ring is full the oldest event is dropped
    and counted, in total and per category (an exemplar whose categories
    lost events is stamped incomplete)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ring: Optional[List] = None
        self._cap = 0
        self._head = 0
        self._count = 0
        self._epoch = 0.0
        self.armed = False
        self.dropped_events = 0
        self.dropped_by_category: Dict[str, int] = {}

    def start(self, capacity: int = DEFAULT_TRACE_EVENTS) -> None:
        with self._lock:
            self._cap = max(16, int(capacity))
            self._ring = [None] * self._cap
            self._head = 0
            self._count = 0
            self.dropped_events = 0
            self.dropped_by_category = {}
            self._epoch = time.perf_counter()
            self.armed = True

    def stop(self) -> None:
        with self._lock:
            self.armed = False
            self._ring = None
            self._cap = 0
            self._head = 0
            self._count = 0

    def emit(self, name: str, category: str, t0: float, t1: float,
             args: Optional[dict] = None, merge_ctx: bool = True) -> None:
        """Append one event (perf_counter endpoints).  The ambient
        :func:`trace_ctx` key/values merge under ``args``, and with a
        request in scope its trace id rides as ``args["trace"]``
        (``merge_ctx=False`` keeps ``args`` as given: counter samples)."""
        if merge_ctx:
            ctx = getattr(_TLS, "ctx", None)
            if ctx:
                args = {**ctx, **args} if args else dict(ctx)
            rctx = getattr(_TLS, "request", None)
            if rctx is not None:
                args = {**args, "trace": rctx.trace_id} if args else {"trace": rctx.trace_id}
        ev = (name, category, t0 - self._epoch, t1 - self._epoch, threading.get_ident(), args)
        with self._lock:
            if self._ring is None:
                return
            old = self._ring[self._head]
            self._ring[self._head] = ev
            self._head = (self._head + 1) % self._cap
            if self._count < self._cap:
                self._count += 1
            else:
                self.dropped_events += 1
                cat = old[1] if old else ""
                self.dropped_by_category[cat] = self.dropped_by_category.get(cat, 0) + 1

    def instant(self, name: str, category: str, args: Optional[dict] = None) -> None:
        t = time.perf_counter()
        self.emit(name, category, t, t, args)

    #: The category of counter-track samples (``ph: "C"`` on export).
    COUNTER_CATEGORY = "counter"

    def counter(self, name: str, values: Dict[str, float]) -> None:
        """A Chrome counter-track sample (``ph: "C"``): the HBM ledger's
        ``hbm.live_bytes`` by kind.  Ambient :func:`trace_ctx` args are
        not merged (they would become series)."""
        if not self.armed:
            return
        t = time.perf_counter()
        self.emit(name, self.COUNTER_CATEGORY, t, t, dict(values), merge_ctx=False)

    def events(self) -> List[tuple]:
        with self._lock:
            if self._ring is None or self._count == 0:
                return []
            if self._count < self._cap:
                return list(self._ring[: self._count])
            return self._ring[self._head:] + self._ring[: self._head]

    def chrome_events(self) -> List[dict]:
        """The events as Chrome trace-event dicts: ``ph: "X"``, counter
        samples ``ph: "C"``."""
        pid = os.getpid()
        out = []
        for name, cat, t0, t1, tid, args in self.events():
            if cat == self.COUNTER_CATEGORY:
                out.append({"name": name, "ph": "C", "ts": round(t0 * 1e6, 3), "pid": pid,
                            "tid": tid, "args": args or {}})
                continue
            ev = {"name": name, "cat": cat, "ph": "X", "ts": round(t0 * 1e6, 3),
                  "dur": round((t1 - t0) * 1e6, 3), "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def chrome_events_for_trace(self, trace_id: str) -> List[dict]:
        """The events of one trace: ``args["trace"]``, or membership of a
        shared launch's ``args["traces"]``."""
        out = []
        for e in self.chrome_events():
            a = e.get("args") or {}
            if a.get("trace") == trace_id or trace_id in a.get("traces", ()):
                out.append(e)
        return out

    def now_us(self) -> float:
        """The armed ring's clock, microseconds since :meth:`start` (0.0
        disarmed): the mesh trace shards' anchor, stamped by every process
        right after one shared barrier."""
        if not self.armed:
            return 0.0
        return (time.perf_counter() - self._epoch) * 1e6

    def drops_snapshot(self) -> Tuple[int, Dict[str, int]]:
        with self._lock:
            return self.dropped_events, dict(self.dropped_by_category)

    def export_chrome(self, path_or_stream, other: Optional[dict] = None) -> int:
        """Write the Chrome trace-event JSON; returns the event count.
        ``other`` merges extra keys into ``otherData``."""
        evs = self.chrome_events()
        other_data = {"dropped_events": self.dropped_events,
                      "dropped_by_category": dict(self.dropped_by_category)}
        if other:
            other_data.update(other)
        doc = {"traceEvents": evs, "displayTimeUnit": "ms", "otherData": other_data}
        if hasattr(path_or_stream, "write"):
            json.dump(doc, path_or_stream)
        else:
            with open(path_or_stream, "w") as f:
                json.dump(doc, f)
        return len(evs)


#: The process-wide timeline ring (the serve daemon and ``--trace`` arm it).
TRACER = Tracer()

_TLS = threading.local()


@contextlib.contextmanager
def trace_ctx(**kw) -> Iterator[None]:
    """Ambient event arguments for the current thread: every event emitted
    inside the scope carries these key/values (``split=3``, ``part=0``:
    the stall reducer's per-item attribution).  Free when the tracer is
    disarmed."""
    if not TRACER.armed:
        yield
        return
    old = getattr(_TLS, "ctx", None)
    _TLS.ctx = {**old, **kw} if old else dict(kw)
    try:
        yield
    finally:
        _TLS.ctx = old


# -- request-scoped tracing ----------------------------------------------------

#: Hop annotations kept per request.
MAX_REQUEST_HOPS = 256


def _rand_hex(n_bytes: int) -> str:
    """``n_bytes`` of entropy as lowercase hex from a per-thread buffer
    refilled by one ``os.urandom(1024)``."""
    n = n_bytes * 2
    buf = getattr(_TLS, "idbuf", "")
    if len(buf) < n:
        buf = os.urandom(1024).hex()
    out = buf[:n]
    _TLS.idbuf = buf[n:]
    return out


class RequestContext:
    """One served request: a 128-bit ``trace_id`` (the client originates
    it, the daemon continues it), this process's 64-bit ``span_id``,
    ``baggage``, and a bounded list of hop annotations (queue wait, batch
    wait and decode, window reads, executor attempts, OOM rungs, deadline
    expiry) that the exemplars and the access log fold.  ``metrics``, when
    set (the daemon sets its registry), counts ``serve.trace.hops_dropped``."""

    __slots__ = ("trace_id", "span_id", "parent_id", "op", "baggage", "t0", "t0_wall", "hops",
                 "hops_dropped", "metrics")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str] = None,
                 op: str = "", baggage: Optional[Dict[str, str]] = None, metrics=None) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.op = op
        self.baggage = baggage or {}
        self.t0 = time.perf_counter()
        self.t0_wall = time.time()
        self.hops: List[dict] = []
        self.hops_dropped = 0
        self.metrics = metrics

    @classmethod
    def new(cls, op: str = "", baggage: Optional[Dict[str, str]] = None,
            metrics=None) -> "RequestContext":
        return cls(_rand_hex(16), _rand_hex(8), op=op, baggage=baggage, metrics=metrics)

    def child(self, op: str = "") -> "RequestContext":
        """A new span of the same trace."""
        return RequestContext(self.trace_id, _rand_hex(8), parent_id=self.span_id,
                              op=op or self.op, baggage=dict(self.baggage), metrics=self.metrics)

    def to_wire(self) -> dict:
        """The serve protocol's ``trace`` field."""
        d: dict = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.baggage:
            d["baggage"] = dict(self.baggage)
        return d

    @classmethod
    def from_wire(cls, d, op: str = "", metrics=None) -> Optional["RequestContext"]:
        """Continue a trace from a request's ``trace`` field; a garbled
        field is None (the daemon then originates a fresh id)."""
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not (isinstance(tid, str) and isinstance(sid, str)
                and 8 <= len(tid) <= 64 and 4 <= len(sid) <= 32):
            return None
        try:
            int(tid, 16), int(sid, 16)
        except ValueError:
            return None
        bg = d.get("baggage")
        return cls(tid, _rand_hex(8), parent_id=sid, op=op,
                   baggage=dict(bg) if isinstance(bg, dict) else None, metrics=metrics)

    def annotate(self, hop: str, ms: Optional[float] = None, **extras) -> None:
        """Record one hop (``ms`` its duration; omitted for point events)."""
        if len(self.hops) >= MAX_REQUEST_HOPS:
            self.hops_dropped += 1
            if self.metrics is not None:
                self.metrics.count("serve.trace.hops_dropped", 1)
            return
        h = {"hop": hop, "t_ms": (time.perf_counter() - self.t0) * 1e3}
        if ms is not None:
            h["ms"] = float(ms)
        if extras:
            h.update(extras)
        self.hops.append(h)

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3


def current_request() -> Optional[RequestContext]:
    """This thread's ambient request (None outside the serve path)."""
    return getattr(_TLS, "request", None)


@contextlib.contextmanager
def request_scope(ctx: Optional[RequestContext]) -> Iterator[None]:
    """Ambient request context for the current thread (None: leave it)."""
    if ctx is None:
        yield
        return
    old = getattr(_TLS, "request", None)
    _TLS.request = ctx
    try:
        yield
    finally:
        _TLS.request = old


@contextlib.contextmanager
def request_hop(name: str, **extras) -> Iterator[None]:
    """The enclosed phase as one hop on the ambient request (a serve job's
    waterfall shows its read, sort and write durations without the ring);
    outside a request, one ``is None`` branch."""
    rctx = current_request()
    if rctx is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        rctx.annotate(name, ms=(time.perf_counter() - t0) * 1e3, **extras)


@contextlib.contextmanager
def span(name: str, registry: Optional[MetricsRegistry] = None, category: str = "span",
         args: Optional[dict] = None) -> Iterator[None]:
    """A timed scope: its seconds add to ``registry`` (when given) and,
    with the :data:`TRACER` armed, one ring event is recorded."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        if registry is not None:
            registry.add_span(name, t1 - t0)
        if TRACER.armed:
            TRACER.emit(name, category, t0, t1, args)


def stage(name: str):
    """Decorator form of ``span(name, category="stage")``: the whole
    function is one pipeline stage (the codec wrappers)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with span(name, category="stage"):
                return fn(*a, **k)

        return wrapper

    return deco


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[object]:
    """``torch.profiler`` over the enclosed scope, its Chrome trace written
    into ``log_dir`` as ``device_trace.<pid>.json`` on exit: the card's
    activity (kernels, copies, sets) when there is a card, else the CPU's
    ops; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"device_trace.{os.getpid()}.json"))


# -- run provenance --------------------------------------------------------------

#: Counter prefixes that record a device-tier decision or fallback: the
#: manifest collects every counter under them.
TIER_DECISION_PREFIXES = (
    "flate.inflate.",
    "flate.deflate.",
    "bam.device_write_tierdown.",
    "bam.device_write_fallback",
    "bam.device_write_parts",
    "bam.device_inflate_fallback",
    "bam.device_deflate_fallback",
    "bam.write_residency_kept",
    "sort_bam.device_parse_error",
    "sort_bam.device_parse_fallback",
    "sort_bam.device_parse_residency",
    "flate.inflate_device_residency",
    "flate.oom_tierdown",
    "bam.oom_tierdown",
    "serve.oom.",
)

#: Counter prefixes that record a degraded or error mode the run survived.
FAULT_MODE_PREFIXES = (
    "salvage.", "bgzf.missing_eof", "faults.",
    "serve.admission.shed", "serve.deadline.", "serve.journal.",
    "hbm.leaked", "hbm.double_copy",
)


class RunManifest:
    """Provenance of one run: the backend used, the device it ran on, the
    tier-decision counters, the fault and salvage mode, the explicit conf
    keys; ``degraded`` with a reason for each fallback-class counter that
    fired, each salvage loss, each HBM leak or double copy, and a
    backend other than the one ``requested``."""

    def __init__(
        self,
        backend: Optional[str] = None,
        platform: Optional[str] = None,
        tier_decisions: Optional[Dict[str, int]] = None,
        modes: Optional[Dict[str, object]] = None,
        conf_deltas: Optional[Dict[str, str]] = None,
        degraded: bool = False,
        reasons: Optional[List[str]] = None,
        device: Optional[str] = None,
    ) -> None:
        self.backend = backend
        self.platform = platform
        self.device = device
        self.tier_decisions = tier_decisions or {}
        self.modes = modes or {}
        self.conf_deltas = conf_deltas or {}
        self.degraded = degraded
        self.reasons = reasons or []

    def as_dict(self) -> dict:
        return {
            "backend": self.backend,
            "platform": self.platform,
            "device": self.device,
            "tier_decisions": dict(self.tier_decisions),
            "modes": dict(self.modes),
            "conf_deltas": dict(self.conf_deltas),
            "degraded": self.degraded,
            "reasons": list(self.reasons),
        }


#: Fallback-class counters: a higher tier was attempted and lost.
_FALLBACK_REASONS = {
    "bam.device_write_fallback": "device part write errored; host gather took the part",
    "bam.device_inflate_fallback": "device inflate tier errored; native zlib took the window",
    "bam.device_deflate_fallback": "device deflate tier errored; native zlib took the part",
    "sort_bam.device_parse_error": "device parse errored on a split",
    "sort_bam.device_parse_fallback": "device parse disagreed with the host walk; host keys used",
    "serve.oom.tierdowns": "device memory exhausted; the host codec took the affected request(s)",
    "flate.oom_tierdown": "device memory exhausted during a codec launch; members tiered down",
    "bam.oom_tierdown": "device memory exhausted during a window inflate; native zlib took the window",
}


def run_manifest(
    backend: Optional[str] = None,
    conf=None,
    counters: Optional[Dict[str, int]] = None,
    requested: Optional[str] = None,
    device=None,
) -> RunManifest:
    """A :class:`RunManifest` from a job's ``counters`` (its
    ``SortStats.counters`` and the HBM ledger's delta; none: empty).

    ``device`` is the device the job ran on (a ``torch.device`` or its
    string): ``platform`` is "cuda" for the card and "cpu" for the CPU,
    and ``device`` names the card (``torch.cuda.get_device_name``) or
    "cpu"; a CPU run is never reported as the card.  ``conf`` contributes
    the errors mode, the fault plan and its explicit keys as
    ``conf_deltas``.  The reference's read-depth and auto-rtt modes come
    from gauges of its global registry, which the port's jobs do not set."""
    counters = counters or {}
    tiers = {k: v for k, v in counters.items() if k.startswith(TIER_DECISION_PREFIXES)}
    modes: Dict[str, object] = {k: v for k, v in counters.items()
                                if k.startswith(FAULT_MODE_PREFIXES)}
    if conf is not None:
        from ..conf import ERRORS_MODE, FAULTS_PLAN

        modes["errors"] = conf.get(ERRORS_MODE, "strict") or "strict"
        if conf.get(FAULTS_PLAN):
            modes["faults_plan"] = conf.get(FAULTS_PLAN)
    from .. import faults

    modes["faults_armed"] = faults.ACTIVE is not None
    platform = name = None
    if device is not None:
        platform = "cuda" if str(device).startswith("cuda") else "cpu"
        if platform == "cuda":
            import torch

            name = torch.cuda.get_device_name(torch.device(device))
        else:
            name = "cpu"
    reasons: List[str] = []
    for k, why in _FALLBACK_REASONS.items():
        if counters.get(k):
            reasons.append(f"{why} ({k}={counters[k]})")
    leaked = counters.get("hbm.leaked_bytes", 0)
    if leaked:
        holders = {k[len("hbm.leaked."):]: v for k, v in counters.items()
                   if k.startswith("hbm.leaked.")}
        top = max(holders, key=holders.get) if holders else "unknown"
        reasons.append(f"HBM residency leaked: {leaked} bytes never released "
                       f"by their holder (top holder {top}; hbm.leaked_bytes)")
    if counters.get("hbm.double_copy"):
        reasons.append("HBM double-copy: the same logical payload was resident "
                       f"under two holders (hbm.double_copy={counters['hbm.double_copy']})")
    if counters.get("salvage.members_quarantined") or counters.get("salvage.records_dropped"):
        reasons.append("salvage mode quarantined data "
                       f"(members={counters.get('salvage.members_quarantined', 0)}, "
                       f"records={counters.get('salvage.records_dropped', 0)})")
    if requested is not None and backend is not None and requested != backend:
        reasons.append(f"requested backend {requested!r} but ran {backend!r}")
    conf_deltas = {k: conf.get(k) for k in conf} if conf is not None else {}
    return RunManifest(backend=backend, platform=platform, tier_decisions=tiers, modes=modes,
                       conf_deltas=conf_deltas, degraded=bool(reasons), reasons=reasons,
                       device=name)


class ClusterManifest:
    """Provenance of one multi-process run: every process's host manifest
    (its :class:`RunManifest` and byte-plane accounting) folded into one
    verdict.  ``degraded`` when any host's manifest is, when an edge of
    the shuffle byte matrix does not balance (the sender's bytes against
    the receiver's), or when a host never published."""

    def __init__(
        self,
        hosts: List[dict],
        byte_plane: Optional[str] = None,
        degraded: bool = False,
        reasons: Optional[List[str]] = None,
        edges_balanced: bool = True,
        skew_ratio: Optional[float] = None,
        shuffle_bytes: int = 0,
        keys_bytes: int = 0,
        records: int = 0,
        shuffle_raw_bytes: int = 0,
        shuffle_ratio: Optional[float] = None,
        repartition: Optional[dict] = None,
        speculation: Optional[dict] = None,
    ) -> None:
        self.hosts = hosts
        self.byte_plane = byte_plane
        self.degraded = degraded
        self.reasons = reasons or []
        self.edges_balanced = edges_balanced
        self.skew_ratio = skew_ratio
        self.shuffle_bytes = shuffle_bytes
        self.keys_bytes = keys_bytes
        self.records = records
        self.shuffle_raw_bytes = shuffle_raw_bytes
        self.shuffle_ratio = shuffle_ratio
        self.repartition = repartition
        self.speculation = speculation

    def as_dict(self) -> dict:
        return {
            "num_hosts": len(self.hosts),
            "hosts": [dict(h) for h in self.hosts],
            "byte_plane": self.byte_plane,
            "edges_balanced": self.edges_balanced,
            "skew_ratio": self.skew_ratio,
            "shuffle_bytes": self.shuffle_bytes,
            "shuffle_raw_bytes": self.shuffle_raw_bytes,
            "shuffle_ratio": self.shuffle_ratio,
            "keys_bytes": self.keys_bytes,
            "records": self.records,
            "repartition": dict(self.repartition) if self.repartition else None,
            "speculation": dict(self.speculation) if self.speculation else None,
            "degraded": self.degraded,
            "reasons": list(self.reasons),
        }


def cluster_manifest(host_manifests: List[dict],
                     byte_plane: Optional[str] = None) -> ClusterManifest:
    """Fold host manifests (``parallel/multihost.py``'s: ``host``,
    ``num_processes``, ``run_manifest``, ``records_local``,
    ``records_out``, the byte and key matrices' rows, ``skew_ratio``, the
    ``repartition`` and ``speculation`` blocks) into a
    :class:`ClusterManifest`; a pure function of its inputs."""
    hosts = sorted((dict(h) for h in host_manifests), key=lambda h: h.get("host", 0))
    reasons: List[str] = []
    n_expect = max([len(hosts)] + [int(h.get("num_processes", 0)) for h in hosts])
    seen = {int(h.get("host", -1)) for h in hosts}
    for p in range(n_expect):
        if p not in seen:
            reasons.append(f"host {p} never published a manifest")
    for h in hosts:
        rm = h.get("run_manifest") or {}
        if rm.get("degraded"):
            why = "; ".join(rm.get("reasons", [])) or "unspecified"
            reasons.append(f"host {h.get('host')} degraded: {why}")
    # What host s measured writing for q must equal what q measured
    # fetching from s, edge by edge.
    edges_balanced = True
    shuffle_bytes = 0
    for hs in hosts:
        s = hs.get("host")
        sent = hs.get("shuffle_sent_bytes") or {}
        for hq in hosts:
            q = hq.get("host")
            b_sent = int(sent.get(str(q), 0))
            b_recv = int((hq.get("shuffle_recv_bytes") or {}).get(str(s), 0))
            shuffle_bytes += b_sent
            if b_sent != b_recv:
                edges_balanced = False
                reasons.append(f"shuffle byte matrix imbalanced on edge {s}->{q}: "
                               f"sent {b_sent} != received {b_recv}")
    keys_bytes = sum(int(b) for h in hosts for b in (h.get("keys_sent_bytes") or {}).values())
    shuffle_raw_bytes = sum(int(b) for h in hosts
                            for b in (h.get("shuffle_sent_raw_bytes") or {}).values())
    shuffle_ratio = (round(shuffle_raw_bytes / shuffle_bytes, 4)
                     if shuffle_bytes and shuffle_raw_bytes else None)
    records = sum(int(h.get("records_local", 0)) for h in hosts)
    skews = [h["skew_ratio"] for h in hosts if h.get("skew_ratio")]
    # The repartition is collective (one census, one decision), so any
    # host's block speaks for the round; speculation differs by host (the
    # speculator's launches and wins, the straggler's lost parts).
    repartition = next((dict(h["repartition"]) for h in hosts if h.get("repartition")), None)
    spec_events: List[dict] = []
    spec_launched = spec_won = spec_wasted = 0
    for h in hosts:
        sp = h.get("speculation") or {}
        if not sp:
            continue
        spec_launched += int(sp.get("launched", 0))
        spec_won += int(sp.get("won_parts", 0))
        spec_wasted += int(sp.get("wasted_bytes", 0))
        if sp.get("launched"):
            spec_events.append({"by": h.get("host"), "target": sp.get("target"),
                                "won_parts": int(sp.get("won_parts", 0))})
    speculation = ({"launched": spec_launched, "won_parts": spec_won,
                    "wasted_bytes": spec_wasted, "events": spec_events}
                   if spec_launched or spec_wasted else None)
    return ClusterManifest(
        hosts=hosts, byte_plane=byte_plane or (hosts[0].get("byte_plane") if hosts else None),
        degraded=bool(reasons), reasons=reasons, edges_balanced=edges_balanced,
        skew_ratio=max(skews) if skews else None, shuffle_bytes=shuffle_bytes,
        keys_bytes=keys_bytes, records=records, shuffle_raw_bytes=shuffle_raw_bytes,
        shuffle_ratio=shuffle_ratio, repartition=repartition, speculation=speculation)


class Progress:
    """Byte-cadence progress ticks (SplittingBAMIndexer.java:277-282 prints
    one ``-`` per 500MB): a callback, else, with the :data:`TRACER` armed, a
    ``progress.tick`` instant, else a ``-`` on stderr."""

    DEFAULT_CADENCE = 500 << 20

    def __init__(self, total_bytes: Optional[int] = None, cadence: int = DEFAULT_CADENCE,
                 sink=None) -> None:
        self.total = total_bytes
        self.cadence = cadence
        self.done = 0
        self._next = cadence
        self._sink = sink if sink is not None else self._default_sink
        self._lock = threading.Lock()

    @staticmethod
    def _default_sink(progress: "Progress") -> None:
        if TRACER.armed:
            TRACER.instant("progress.tick", "progress",
                           {"done": progress.done, "total": progress.total})
            return
        sys.stderr.write("-")
        sys.stderr.flush()

    def advance(self, nbytes: int) -> None:
        with self._lock:
            self.done += nbytes
            fire = self.done >= self._next
            if fire:
                self._next += self.cadence * (1 + (self.done - self._next) // self.cadence)
        if fire:
            self._sink(self)

    def fraction(self) -> float:
        """Hadoop ``getProgress()``: 0.0 when the total is unknown."""
        if not self.total:
            return 0.0
        return min(1.0, self.done / self.total)


# -- Prometheus text exposition ------------------------------------------------


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def prometheus_text(report: Dict[str, Dict[str, float]], gauges: Optional[Dict[str, float]] = None,
                    prefix: str = "hbam") -> str:
    """A :meth:`MetricsRegistry.report` in Prometheus text format:
    counters ``<prefix>_<name>_total``, span sums ``..._seconds_total`` and
    ``..._count``, histograms the cumulative ``_bucket{le=}`` / ``_sum`` /
    ``_count`` triplet, gauges (the report's, then ``gauges`` over them)
    plain samples."""
    merged = dict(report.get("gauges", {}))
    if gauges:
        merged.update(gauges)
    lines: List[str] = []
    for k in sorted(report.get("counters", {})):
        n = f"{prefix}_{_prom_name(k)}_total"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {report['counters'][k]}")
    spans_s = report.get("span_seconds", {})
    spans_n = report.get("span_counts", {})
    for k in sorted(spans_s):
        n = f"{prefix}_{_prom_name(k)}_seconds_total"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {spans_s[k]:.6f}")
        n = f"{prefix}_{_prom_name(k)}_count"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {spans_n.get(k, 0)}")
    for k in sorted(report.get("histograms", {})):
        h = report["histograms"][k]
        n = f"{prefix}_{_prom_name(k)}"
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for le, c in sorted(h.get("buckets", {}).items(), key=lambda kv: float(kv[0])):
            cum += c
            lines.append(f'{n}_bucket{{le="{float(le):g}"}} {cum}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {h.get("count", 0)}')
        lines.append(f"{n}_sum {h.get('sum', 0.0):.6f}")
        lines.append(f"{n}_count {h.get('count', 0)}")
    for k in sorted(merged):
        n = f"{prefix}_{_prom_name(k)}"
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {merged[k]}")
    return "\n".join(lines) + "\n"

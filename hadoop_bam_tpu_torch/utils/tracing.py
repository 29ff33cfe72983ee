"""Counters, the serve daemon's metrics registry, the timeline tracer and
request-scoped tracing.

Counterpart of ``hadoop_bam_tpu/utils/tracing.py``: the counter half
(:class:`Metrics`), the registry (:class:`Histogram`,
:class:`MetricsRegistry`, :func:`snapshot`, :func:`delta`,
:func:`prometheus_text`), the timeline ring (:class:`Tracer`) and the
request half (:class:`RequestContext`, :func:`current_request`,
:func:`request_scope`, :func:`span`).  Counter names are the reference's,
so the two packages' counts can be compared.

Counters are passed, not global: a :class:`Metrics` belongs to the job
that creates it, and the serve daemon owns one :class:`MetricsRegistry`
that it hands down as ``metrics=``.  The tracer ring and the ambient
request scope are process-wide, as in the reference: the ring is one
timeline, and the scope is per thread.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
        """Append one event (perf_counter endpoints).  With a request in
        scope its trace id rides as ``args["trace"]`` (``merge_ctx=False``
        keeps ``args`` as given)."""
        if merge_ctx:
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

    def events(self) -> List[tuple]:
        with self._lock:
            if self._ring is None or self._count == 0:
                return []
            if self._count < self._cap:
                return list(self._ring[: self._count])
            return self._ring[self._head:] + self._ring[: self._head]

    def chrome_events(self) -> List[dict]:
        """The events as Chrome trace-event dicts (``ph: "X"``)."""
        pid = os.getpid()
        out = []
        for name, cat, t0, t1, tid, args in self.events():
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

    def drops_snapshot(self) -> Tuple[int, Dict[str, int]]:
        with self._lock:
            return self.dropped_events, dict(self.dropped_by_category)

    def export_chrome(self, path_or_stream) -> int:
        """Write the Chrome trace-event JSON; returns the event count."""
        evs = self.chrome_events()
        other_data = {"dropped_events": self.dropped_events,
                      "dropped_by_category": dict(self.dropped_by_category)}
        doc = {"traceEvents": evs, "displayTimeUnit": "ms", "otherData": other_data}
        if hasattr(path_or_stream, "write"):
            json.dump(doc, path_or_stream)
        else:
            with open(path_or_stream, "w") as f:
                json.dump(doc, f)
        return len(evs)


#: The process-wide timeline ring (the serve daemon arms it).
TRACER = Tracer()

_TLS = threading.local()


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

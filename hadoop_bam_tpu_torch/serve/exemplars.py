"""Tail-latency exemplars: the slow or failed request, reconstructable.

Counterpart of ``hadoop_bam_tpu/serve/exemplars.py``.  Every traced
request's :class:`~..utils.tracing.RequestContext` gathers hop
annotations (queue wait, batch wait and decode, window reads, executor
attempts, tier decisions, deadline expiry); at completion
:func:`request_summary` folds them into a compact record, and
:class:`TailSampler` copies a request's full event set out of the tracer
ring into the bounded :class:`ExemplarStore` when it breached (latency
over the threshold, a ``SHED``/``RETRY_AFTER``/``DEADLINE_EXCEEDED``/
error outcome, or an out-of-memory tier-down), optionally spilled as one
``<dir>/<trace_id>.json`` file each, in the format the reference's
stdlib-only ``tools/request_report.py`` renders.  An exemplar is stamped
``incomplete`` when a category it holds lost ring events.  Counters go to
``metrics``, the daemon's registry.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Dict, List, Optional

from ..utils.tracing import TRACER, MetricsRegistry, RequestContext

DEFAULT_THRESHOLD_MS = 1000.0
DEFAULT_MAX_EXEMPLARS = 64

#: Outcome codes that always earn an exemplar regardless of latency:
#: the request classes whose post-mortem question is "why this one?".
TRIGGER_OUTCOMES = frozenset(
    ("SHED", "RETRY_AFTER", "DEADLINE_EXCEEDED", "ERROR", "JOB_LOST")
)

#: Hop-name prefixes that mark a degradation the sampler triggers on
#: even when the request finished in budget (a tier-down answered fast
#: *this* time; the exemplar is the evidence trail for why it happened).
TIERDOWN_HOP_PREFIXES = ("oom.", "tier.")


def request_summary(
    rctx: RequestContext,
    outcome: str,
    duration_ms: float,
    op: Optional[str] = None,
    extra: Optional[dict] = None,
) -> dict:
    """The compact per-request record: identity, outcome, duration, and
    the waterfall-relevant aggregates (queue wait, batch wait, decode,
    tier decisions) reduced from the hop annotations.  This is what the
    access log writes per line and what ``exemplars`` lists."""
    hops = list(rctx.hops)
    agg: Dict[str, float] = {}
    tiers: List[str] = []
    for h in hops:
        name = h["hop"]
        if "ms" in h:
            agg[name] = agg.get(name, 0.0) + h["ms"]
        if name.startswith(TIERDOWN_HOP_PREFIXES):
            tiers.append(name)
    s = {
        "trace_id": rctx.trace_id,
        "span_id": rctx.span_id,
        "parent_id": rctx.parent_id,
        "op": op or rctx.op,
        "outcome": outcome,
        "t_wall": rctx.t0_wall,
        "duration_ms": round(float(duration_ms), 3),
        "queue_wait_ms": round(agg.get("queue.wait", 0.0), 3),
        "batch_wait_ms": round(agg.get("batch.wait", 0.0), 3),
        "decode_ms": round(agg.get("batch.decode", 0.0), 3),
        "tier_decisions": tiers,
        "shed": outcome in ("SHED", "RETRY_AFTER"),
        "deadline_exceeded": outcome == "DEADLINE_EXCEEDED",
        "oom": any(t.startswith("oom.") for t in tiers),
        "hops": hops,
        "hops_dropped": rctx.hops_dropped,
    }
    if rctx.baggage:
        s["baggage"] = dict(rctx.baggage)
    if extra:
        s.update(extra)
    return s


def access_record(summary: dict) -> dict:
    """The JSONL access-log line: the summary minus the per-hop detail
    (one structured line per completed request; joins with the exemplar
    store on ``trace_id``)."""
    return {k: v for k, v in summary.items() if k != "hops"}


def build_exemplar(
    summary: dict, events: List[dict],
    dropped_by_category: Optional[Dict[str, int]] = None,
) -> dict:
    """An exemplar: summary + the request's full ring events + the
    completeness verdict.  ``incomplete`` is true when any category
    present in (or plausibly missing from) the tree lost ring events —
    with zero surviving events and *any* drops, completeness is
    unknowable, so the stamp stays honest and pessimistic."""
    dropped = dropped_by_category or {}
    cats = {e.get("cat", "") for e in events}
    incomplete = any(dropped.get(c, 0) for c in cats)
    if not events and any(dropped.values()):
        incomplete = True
    return {
        "summary": summary,
        "events": events,
        "categories": sorted(cats),
        "dropped_by_category": {k: v for k, v in dropped.items() if v},
        "incomplete": incomplete,
    }


class ExemplarStore:
    """Bounded per-daemon store of full request traces, keyed by trace
    id; oldest evicted beyond ``max_exemplars``.  With ``spill_dir``
    set, each exemplar is also written as ``<dir>/<trace_id>.json`` at
    admission — the on-disk copy outlives both the bound and the
    daemon."""

    def __init__(
        self,
        max_exemplars: int = DEFAULT_MAX_EXEMPLARS,
        spill_dir: Optional[str] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.max_exemplars = max(1, int(max_exemplars))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.spill_dir = spill_dir
        self._lock = threading.Lock()
        self._by_id: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict()
        )
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def add(self, exemplar: dict) -> None:
        tid = exemplar["summary"]["trace_id"]
        with self._lock:
            self._by_id[tid] = exemplar
            self._by_id.move_to_end(tid)
            while len(self._by_id) > self.max_exemplars:
                self._by_id.popitem(last=False)
                self.metrics.count("serve.trace.exemplars_evicted", 1)
            n = len(self._by_id)
        self.metrics.count("serve.trace.exemplars", 1)
        self.metrics.set_gauge("serve.trace.exemplar_count", n)
        if self.spill_dir:
            try:
                path = os.path.join(self.spill_dir, f"{tid}.json")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(exemplar, f, sort_keys=True)
                os.replace(tmp, path)
            except OSError:
                self.metrics.count("serve.trace.spill_errors", 1)

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            return self._by_id.get(trace_id)

    def summaries(self) -> List[dict]:
        """Newest-last list of exemplar summaries (the ``exemplars``
        serve op's listing; full trees fetched per trace id)."""
        with self._lock:
            return [
                {**access_record(ex["summary"]),
                 "incomplete": ex["incomplete"],
                 "n_events": len(ex["events"])}  # listing stays compact
                for ex in self._by_id.values()
            ]

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_id)


class TailSampler:
    """The always-on summary path + the breach trigger.

    ``observe`` is called once per completed request with its summary:
    it counts the request, and when the request breached — latency over
    ``threshold_ms``, a trigger outcome, or a tier-down hop — copies the
    request's full event set out of the (armed) tracer ring into the
    store.  ``threshold_ms <= 0`` disables the latency trigger (outcome
    and tier-down triggers stay live: a shed request is exemplar-worthy
    at any speed).
    """

    def __init__(
        self,
        store: ExemplarStore,
        threshold_ms: float = DEFAULT_THRESHOLD_MS,
        per_op_threshold_ms: Optional[Dict[str, float]] = None,
    ) -> None:
        self.store = store
        self.metrics = store.metrics
        self.threshold_ms = float(threshold_ms)
        self.per_op_threshold_ms = dict(per_op_threshold_ms or {})

    def _threshold(self, op: str) -> float:
        return self.per_op_threshold_ms.get(op, self.threshold_ms)

    def would_sample(
        self, op: str, outcome: str, duration_ms: float, hops
    ) -> bool:
        """The trigger decision from the raw completion facts, without a
        built summary — the server's fast path skips the whole summary
        construction for the (vast majority of) requests that neither
        sample nor have an access log to feed.  Must stay equivalent to
        :meth:`should_sample`; tests/test_torch_request_tracing.py pins the
        equivalence."""
        if outcome in TRIGGER_OUTCOMES:
            return True
        for h in hops:
            if h["hop"].startswith(TIERDOWN_HOP_PREFIXES):
                return True
        thr = self._threshold(op)
        return thr > 0 and duration_ms > thr

    def should_sample(self, summary: dict) -> Optional[str]:
        """The trigger that fired (None = no exemplar)."""
        if summary["outcome"] in TRIGGER_OUTCOMES:
            return f"outcome:{summary['outcome']}"
        if summary["tier_decisions"]:
            return f"tierdown:{summary['tier_decisions'][0]}"
        thr = self._threshold(summary["op"])
        if thr > 0 and summary["duration_ms"] > thr:
            return f"latency:{summary['duration_ms']:.1f}ms>{thr:.0f}ms"
        return None

    def observe(self, summary: dict) -> Optional[dict]:
        """One completed request; returns the exemplar if one was taken."""
        self.metrics.count("serve.trace.requests", 1)
        trigger = self.should_sample(summary)
        if trigger is None:
            return None
        events: List[dict] = []
        dropped: Dict[str, int] = {}
        if TRACER.armed:
            events = TRACER.chrome_events_for_trace(summary["trace_id"])
            _, dropped = TRACER.drops_snapshot()
        ex = build_exemplar(dict(summary, trigger=trigger), events, dropped)
        self.store.add(ex)
        return ex

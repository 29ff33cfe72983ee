"""The port's request tracing (``utils/tracing.py``'s request half and
ring, ``serve/exemplars.py``, ``serve/slo.py``, ``serve/flightrec.py``)
against the reference's, on the CPU: request contexts and their wire
form, the ring's per-category drops, the tail sampler and the exemplar
store, the SLO monitor, the access log, the live drills through a port
daemon (a stalled reply, an out-of-memory tier-down, a clean run, an SLO
breach, tracing off), the reference's stdlib ``tools/request_report.py``
rendering the port's exemplars, and the dispatch lint."""

import importlib.util
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from hadoop_bam_tpu_torch import faults
from hadoop_bam_tpu_torch.conf import (
    SERVE_ACCESS_LOG,
    SERVE_EXEMPLAR_DIR,
    SERVE_EXEMPLAR_THRESHOLD_MS,
    SERVE_FLIGHTREC,
    SERVE_FLIGHTREC_CADENCE_MS,
    SERVE_REQUEST_TRACING,
    SERVE_SLO,
    SERVE_SLO_WINDOWS,
    Configuration,
)
from hadoop_bam_tpu_torch.pipeline import sort_bam
from hadoop_bam_tpu_torch.serve import (
    BamDaemon,
    ExemplarStore,
    ServeClient,
    ServeContext,
    SloMonitor,
    TailSampler,
    parse_objectives,
    view_blob,
)
from hadoop_bam_tpu_torch.serve import exemplars as exemplars_mod
from hadoop_bam_tpu_torch.serve import flightrec as flightrec_mod
from hadoop_bam_tpu_torch.serve import slo as slo_mod
from hadoop_bam_tpu_torch.utils.tracing import (
    MAX_REQUEST_HOPS,
    TRACER,
    MetricsRegistry,
    RequestContext,
    Tracer,
    current_request,
    delta,
    prometheus_text,
    request_scope,
    snapshot,
    span,
)
from test_request_tracing import _write_sorted_bam

pytestmark = pytest.mark.serve

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "hadoop_bam_tpu_torch"


def request_report_mod():
    spec = importlib.util.spec_from_file_location("request_report",
                                                  REPO / "tools" / "request_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# RequestContext: ids, wire form, ambient scope, hop annotations
# ---------------------------------------------------------------------------


def test_request_context_ids_and_child():
    a, b = RequestContext.new(op="view"), RequestContext.new(op="view")
    assert a.trace_id != b.trace_id
    assert len(a.trace_id) == 32 and len(a.span_id) == 16
    int(a.trace_id, 16)
    c = a.child(op="sort.job")
    assert c.trace_id == a.trace_id and c.span_id != a.span_id and c.parent_id == a.span_id


def test_request_context_wire_round_trip():
    """The port's wire form continues in the reference's context and back."""
    from hadoop_bam_tpu.utils.tracing import RequestContext as JContext

    a = RequestContext.new(op="view", baggage={"tenant": "t1"})
    for other in (RequestContext, JContext):
        b = other.from_wire(a.to_wire(), op="view")
        assert b is not None and b.trace_id == a.trace_id and b.span_id != a.span_id
        assert b.parent_id == a.span_id and b.baggage == {"tenant": "t1"}
    j = JContext.new(op="view")
    assert RequestContext.from_wire(j.to_wire()).trace_id == j.trace_id
    for bad in (None, "x", 7, {}, {"trace_id": 3, "span_id": "ab" * 4},
                {"trace_id": "zz" * 16, "span_id": "ab" * 4},
                {"trace_id": "a" * 100, "span_id": "ab" * 4}):
        assert RequestContext.from_wire(bad) is None


def test_request_scope_is_ambient_and_restores():
    assert current_request() is None
    ctx = RequestContext.new(op="view")
    with request_scope(ctx):
        assert current_request() is ctx
        inner = RequestContext.new(op="flagstat")
        with request_scope(inner):
            assert current_request() is inner
        assert current_request() is ctx
    assert current_request() is None
    with request_scope(None):
        assert current_request() is None


def test_armed_tracer_merges_trace_id_into_events():
    ctx = RequestContext.new(op="view")
    reg = MetricsRegistry()
    TRACER.start(capacity=64)
    try:
        with request_scope(ctx):
            with span("reqtrace.stage_a", reg, category="stage"):
                pass
        with span("reqtrace.stage_b", reg, category="stage"):
            pass
        evs = TRACER.chrome_events()
        mine = TRACER.chrome_events_for_trace(ctx.trace_id)
    finally:
        TRACER.stop()
    a = next(e for e in evs if e["name"] == "reqtrace.stage_a")
    b = next(e for e in evs if e["name"] == "reqtrace.stage_b")
    assert a["args"]["trace"] == ctx.trace_id and "trace" not in (b.get("args") or {})
    assert [e["name"] for e in mine] == ["reqtrace.stage_a"]
    assert reg.report()["span_counts"] == {"reqtrace.stage_a": 1, "reqtrace.stage_b": 1}


def test_hop_annotations_bounded():
    reg = MetricsRegistry()
    ctx = RequestContext.new(op="view", metrics=reg)
    ctx.annotate("queue.wait", ms=2.0, op="view")
    ctx.annotate("batch.wait", ms=5.0)
    ctx.annotate("deadline.endpoint")
    assert [h["hop"] for h in ctx.hops] == ["queue.wait", "batch.wait", "deadline.endpoint"]
    assert ctx.hops[0]["ms"] == 2.0 and "ms" not in ctx.hops[2]
    for i in range(MAX_REQUEST_HOPS + 10):
        ctx.annotate("executor.part", ms=1.0, part=i)
    assert len(ctx.hops) == MAX_REQUEST_HOPS and ctx.hops_dropped > 0
    assert reg.get("serve.trace.hops_dropped") == ctx.hops_dropped


def test_tracer_counts_drops_per_category():
    t = Tracer()
    t.start(capacity=16)
    try:
        for i in range(16):
            t.emit(f"cat_a.ev_{i}", "aaa", 0.0, 1.0)
        for i in range(10):
            t.emit(f"cat_b.ev_{i}", "bbb", 0.0, 1.0)
        assert t.dropped_events == 10
        assert t.drops_snapshot() == (10, {"aaa": 10})
        buf = io.StringIO()
        t.export_chrome(buf)
    finally:
        t.stop()
    doc = json.loads(buf.getvalue())
    assert doc["otherData"] == {"dropped_events": 10, "dropped_by_category": {"aaa": 10}}


def test_exemplar_incomplete_stamp_from_category_drops():
    summary = {"trace_id": "ab" * 16, "op": "view", "outcome": "OK", "duration_ms": 1.0,
               "tier_decisions": [], "hops": []}
    evs = [{"name": "x", "cat": "stage", "ph": "X", "ts": 0.0}]
    assert exemplars_mod.build_exemplar(summary, evs, {"queue": 3})["incomplete"] is False
    assert exemplars_mod.build_exemplar(summary, evs, {"stage": 1})["incomplete"] is True
    assert exemplars_mod.build_exemplar(summary, [], {"queue": 1})["incomplete"] is True
    assert exemplars_mod.build_exemplar(summary, [], {})["incomplete"] is False


# ---------------------------------------------------------------------------
# Tail sampler, exemplar store
# ---------------------------------------------------------------------------


def _summary(op="view", outcome="OK", ms=1.0, tiers=()):
    s = exemplars_mod.request_summary(RequestContext.new(op=op), outcome, ms, op=op)
    s["tier_decisions"] = list(tiers)
    return s


def test_request_summary_equals_the_reference():
    """The same hops fold into the reference's summary and access record."""
    from hadoop_bam_tpu.serve import exemplars as jex
    from hadoop_bam_tpu.utils.tracing import RequestContext as JContext

    ctx = RequestContext.new(op="view", baggage={"t": "1"})
    jctx = JContext(ctx.trace_id, ctx.span_id, op="view", baggage={"t": "1"})
    for c in (ctx, jctx):
        c.t0_wall = 1.0
        c.annotate("queue.wait", ms=2.0)
        c.annotate("batch.wait", ms=3.5, members=2)
        c.annotate("oom.tierdown", tier="host")
        for h in c.hops:
            h["t_ms"] = 0.0
    got = exemplars_mod.request_summary(ctx, "OK", 12.34567, op="view", extra={"job": "x"})
    want = jex.request_summary(jctx, "OK", 12.34567, op="view", extra={"job": "x"})
    assert got == want
    assert exemplars_mod.access_record(got) == jex.access_record(want)


def test_tail_sampler_triggers():
    store = ExemplarStore(max_exemplars=8)
    sampler = TailSampler(store, threshold_ms=50.0)
    assert sampler.observe(_summary(ms=10.0)) is None
    assert sampler.observe(_summary(ms=80.0)) is not None
    assert sampler.observe(_summary(outcome="SHED", ms=1.0)) is not None
    assert sampler.observe(_summary(outcome="DEADLINE_EXCEEDED", ms=1.0)) is not None
    assert sampler.observe(_summary(ms=1.0, tiers=["oom.tierdown"])) is not None
    assert len(store) == 4 and store.metrics.get("serve.trace.requests") == 5
    s0 = TailSampler(store, threshold_ms=0.0)
    assert s0.observe(_summary(ms=10_000.0)) is None
    assert s0.observe(_summary(outcome="ERROR")) is not None
    s1 = TailSampler(store, threshold_ms=50.0, per_op_threshold_ms={"sort.job": 0.0})
    assert s1.observe(_summary(op="sort.job", ms=10_000.0)) is None


def test_would_sample_equivalent_to_should_sample():
    sampler = TailSampler(ExemplarStore(), threshold_ms=50.0,
                          per_op_threshold_ms={"sort.job": 0.0})
    cases = [
        _summary(ms=10.0), _summary(ms=80.0), _summary(outcome="SHED", ms=1.0),
        _summary(outcome="RETRY_AFTER", ms=1.0), _summary(outcome="DEADLINE_EXCEEDED", ms=1.0),
        _summary(outcome="ERROR", ms=1.0), _summary(ms=1.0, tiers=["oom.tierdown"]),
        _summary(op="sort.job", ms=10_000.0), _summary(op="sort.job", outcome="ERROR", ms=1.0),
    ]
    for s in cases:
        hops = list(s["hops"]) + [{"hop": t, "t_ms": 0.0} for t in s["tier_decisions"]]
        assert sampler.would_sample(s["op"], s["outcome"], s["duration_ms"], hops) == (
            sampler.should_sample(s) is not None), s


def test_exemplar_store_bound_and_spill(tmp_path):
    spill = str(tmp_path / "ex")
    store = ExemplarStore(max_exemplars=2, spill_dir=spill)
    ids = []
    for i in range(3):
        s = _summary(ms=float(i))
        ids.append(s["trace_id"])
        store.add(exemplars_mod.build_exemplar(s, [], {}))
    assert len(store) == 2 and store.get(ids[0]) is None and store.get(ids[2]) is not None
    assert sorted(os.listdir(spill)) == sorted(f"{t}.json" for t in ids)
    with open(os.path.join(spill, f"{ids[0]}.json")) as f:
        assert json.load(f)["summary"]["trace_id"] == ids[0]
    assert store.metrics.get("serve.trace.exemplars_evicted") == 1
    assert store.metrics.gauges()["serve.trace.exemplar_count"] == 2


# ---------------------------------------------------------------------------
# The SLO monitor and the Prometheus text
# ---------------------------------------------------------------------------


def test_slo_objective_grammar():
    objs = parse_objectives("view:latency=100;view:availability=0.999;sort:latency=2000@0.95")
    assert [o.name for o in objs] == ["view:latency<100ms", "view:availability",
                                      "sort:latency<2000ms"]
    assert objs[0].target == slo_mod.DEFAULT_TARGET
    assert objs[2].target == 0.95 and objs[2].threshold_ms == 2000
    for bad in ("view", "view:latency", "view:p99=10", "view:latency=x",
                "view:availability=1.5"):
        with pytest.raises(ValueError):
            parse_objectives(bad)


def _mon(spec, reg, fast=10.0, slow=100.0, **kw):
    return SloMonitor(parse_objectives(spec), fast_s=fast, slow_s=slow, registry=reg, **kw)


def test_slo_burn_rate_math_on_synthetic_windows():
    reg = MetricsRegistry()
    mon = _mon("view:latency=100@0.9", reg)
    for _ in range(10):
        reg.observe("serve.op.view.ms", 10.0)
    ev = mon.evaluate(now=1000.0)
    assert ev["objectives"][0]["windows"]["fast"]["burn"] == 0.0 and ev["compliant"] is True
    for i in range(10):
        reg.observe("serve.op.view.ms", 500.0 if i % 2 else 10.0)
    w = mon.evaluate(now=1005.0)["objectives"][0]["windows"]["fast"]
    assert w["total"] == 10 and w["bad"] == 5 and w["burn"] == pytest.approx(5.0)
    assert w["compliant"] is False
    w = mon.evaluate(now=1200.0)["objectives"][0]["windows"]["fast"]
    assert w["burn"] == 0.0 and w["compliant"] is True


def test_slo_availability_and_alert_transitions():
    reg = MetricsRegistry()
    mon = _mon("view:availability=0.9", reg, fast=10.0, slow=40.0, fast_burn=2.0, slow_burn=1.0)
    mon.evaluate(now=0.0)
    for t in (5.0, 10.0, 15.0, 20.0):
        for i in range(10):
            reg.observe("serve.op.view.ms", 1.0)
            if i % 2:
                reg.count("serve.op.view.errors", 1)
        ev = mon.evaluate(now=t)
    assert ev["objectives"][0]["alerting"] is True
    assert ev["alerting"] == ["view:availability"] and ev["compliant"] is False
    assert reg.get("serve.slo.alerts") == 1
    assert "hbam_slo_view_availability_burn_fast" in prometheus_text(reg.report())
    for t in (60.0, 70.0, 80.0, 90.0, 100.0, 110.0):
        for _ in range(10):
            reg.observe("serve.op.view.ms", 1.0)
        ev = mon.evaluate(now=t)
    assert ev["objectives"][0]["alerting"] is False and ev["compliant"] is True
    for t in (115.0, 120.0, 125.0, 130.0, 140.0, 150.0):
        for _ in range(10):
            reg.observe("serve.op.view.ms", 1.0)
            reg.count("serve.op.view.errors", 1)
        ev = mon.evaluate(now=t)
    assert ev["objectives"][0]["alerting"] is True and reg.get("serve.slo.alerts") == 2


def test_slo_format_block_renders():
    txt = slo_mod.format_slo_block(_mon("view:latency=100", MetricsRegistry()).evaluate(now=0.0))
    assert "COMPLIANT" in txt and "view:latency<100ms" in txt
    assert "no monitor" in slo_mod.format_slo_block({})


def test_slo_judgment_and_prometheus_text_equal_the_reference():
    """The same observations give the reference's SLO windows, fold and
    Prometheus text (histograms, counters and gauges)."""
    from hadoop_bam_tpu.serve import slo as jslo
    from hadoop_bam_tpu.utils.tracing import MetricsRegistry as JRegistry
    from hadoop_bam_tpu.utils.tracing import prometheus_text as jprom

    spec = "view:latency=100@0.9;view:availability=0.95;sort:availability=0.99"
    reg, jreg = MetricsRegistry(), JRegistry()
    mon = _mon(spec, reg)
    jmon = jslo.SloMonitor(jslo.parse_objectives(spec), fast_s=10.0, slow_s=100.0, registry=jreg)
    evals = []
    for step in range(6):
        for i in range(7):
            v = [0.5, 3.0, 70.0, 130.0, 1000.0, 1e6, 2.0][(i + step) % 7]
            for r in (reg, jreg):
                r.observe("serve.op.view.ms", v)
                r.count("serve.op.view", 1)
                if (i + step) % 5 == 0:
                    r.count("serve.op.view.errors", 1)
        evals.append((mon.evaluate(now=3.0 * step), jmon.evaluate(now=3.0 * step)))
    for got, want in evals:
        assert got == want
    assert slo_mod.fold_slo([e for e, _ in evals]) == jslo.fold_slo([e for _, e in evals])
    gauges = {"serve.arena.used_bytes": 5.0}
    # The reference's registry keeps its SLO gauges in its global registry.
    assert prometheus_text(reg.report(), gauges=gauges) == jprom(
        {**jreg.report(), "gauges": reg.gauges()}, gauges=gauges)
    assert reg.histogram("serve.op.view.ms").as_dict() == jreg.histogram("serve.op.view.ms").as_dict()


# ---------------------------------------------------------------------------
# The access log and the flight recorder's files
# ---------------------------------------------------------------------------


def test_access_log_lines_and_rotation(tmp_path):
    base = str(tmp_path / "access.jsonl")
    log = flightrec_mod.AccessLog(base, max_bytes=16 << 10)
    n = 200
    for i in range(n):
        log.log(exemplars_mod.access_record(_summary(ms=float(i))))
    log.close()
    recs, torn = flightrec_mod.load_access_log(base)
    assert torn == 0 and 0 < len(recs) < n
    for r in recs:
        assert set(r) >= {"trace_id", "op", "outcome", "duration_ms", "queue_wait_ms",
                          "batch_wait_ms", "tier_decisions", "shed", "oom"}
        assert "hops" not in r
    s0, s1 = flightrec_mod.segment_paths(base)
    assert os.path.exists(s0) and os.path.exists(s1)
    assert os.path.getsize(s0) + os.path.getsize(s1) <= 20 << 10
    assert log.metrics.get("serve.accesslog.lines") == n
    assert log.metrics.get("serve.accesslog.rotations") >= 1


def test_flight_recorder_ring_reads_back_in_the_reference(tmp_path):
    """A ring the port's recorder wrote (torn tail appended) loads the same
    through the reference's loader."""
    from hadoop_bam_tpu.serve import flightrec as jfr

    reg = MetricsRegistry()
    reg.count("serve.admission.shed", 3)
    reg.count("serve.view.requests", 9)
    reg.set_gauge("serve.arena.entries", 2)
    base = str(tmp_path / "fr.jsonl")
    fr = flightrec_mod.FlightRecorder(base, cadence_s=0.02, max_bytes=8 << 10, metrics=reg)
    fr.start()
    time.sleep(0.1)
    fr.stop(final=True)
    with open(flightrec_mod.segment_paths(base)[0], "ab") as f:
        f.write(b'{"seq": 99, "fin')
    snaps, torn = flightrec_mod.load_ring(base)
    assert (snaps, torn) == jfr.load_ring(base)
    assert torn == 1 and snaps[-1]["final"] is True and len(snaps) >= 3
    assert snaps[0]["counters"] == {"serve.admission.shed": 3}
    assert snaps[0]["gauges"] == {"serve.arena.entries": 2.0}
    assert reg.get("serve.flightrec.snapshots") == len(snaps)


# ---------------------------------------------------------------------------
# A live daemon: propagation, drills, the stats, metrics and flight-recorder
# surfaces
# ---------------------------------------------------------------------------


@pytest.fixture()
def sorted_bam(tmp_path):
    return _write_sorted_bam(tmp_path)


class _Live:
    """A port daemon on the CPU in a thread; ``close`` always stops it."""

    def __init__(self, conf=None):
        self.dir = tempfile.mkdtemp(prefix="hbt")
        self.d = BamDaemon(conf=conf, socket_path=os.path.join(self.dir, "d.sock"),
                           warmup=False, device="cpu")
        ready = threading.Event()
        self.t = threading.Thread(target=self.d.serve_forever, args=(ready,), daemon=True)
        self.t.start()
        assert ready.wait(30), "daemon did not come up"
        self.client = ServeClient(socket_path=self.d.socket_path, timeout=60)

    def close(self):
        if self.t.is_alive():
            try:
                ServeClient(socket_path=self.d.socket_path, timeout=60, retries=0).shutdown()
            except Exception:  # noqa: BLE001 - stop it whatever the socket did
                self.d.stop()
            self.t.join(timeout=60)
        shutil.rmtree(self.dir, ignore_errors=True)
        assert not self.t.is_alive()


def test_trace_id_propagates_client_to_daemon(sorted_bam):
    conf = Configuration()
    conf.set_int(SERVE_EXEMPLAR_THRESHOLD_MS, 0)
    live = _Live(conf)
    try:
        client = live.client
        client.view(sorted_bam, "chr1:1-100000")
        tid = client.last_trace_id
        assert tid and len(tid) == 32
        with pytest.raises(Exception):
            client.view(sorted_bam, "nope:1-10")
        bad_tid = client.last_trace_id
        assert bad_tid != tid
        ex = client.exemplars(bad_tid)
        assert ex["summary"]["outcome"] == "ERROR" and ex["summary"]["trace_id"] == bad_tid
        assert [e["trace_id"] for e in client.exemplars()] == [bad_tid]
    finally:
        live.close()


def test_stall_drill_waterfall_names_injected_seam_and_sums(sorted_bam, tmp_path):
    """A request slowed by an injected ``serve.stall`` leaves an exemplar,
    spilled to the exemplar directory, whose waterfall in the reference's
    ``tools/request_report.py`` names the stall as the dominant hop and
    whose hops account for the client's latency."""
    conf = Configuration()
    conf.set_int(SERVE_EXEMPLAR_THRESHOLD_MS, 60)
    exdir = str(tmp_path / "ex")
    conf.set(SERVE_EXEMPLAR_DIR, exdir)
    live = _Live(conf)
    try:
        client = live.client
        client.view(sorted_bam, "chr1:1-100000")
        faults.arm("seed=1;serve.stall:op=view,ms=150,n=1")
        t0 = time.perf_counter()
        client.view(sorted_bam, "chr1:1-100000")
        client_ms = (time.perf_counter() - t0) * 1e3
        tid = client.last_trace_id
        ex = client.exemplars(tid)
    finally:
        faults.disarm()
        live.close()
    assert ex["summary"]["trigger"].startswith("latency:")
    rr = request_report_mod()
    rep = rr.waterfall(ex)
    assert rep["dominant"]["hop"] == "reply.stall" and rep["incomplete"] is False
    assert rep["dominant"]["ms"] >= 140.0
    assert "queue.wait" in {h["hop"] for h in rep["hops"]}
    assert rep["attributed_ms"] + rep["unattributed_ms"] == pytest.approx(rep["duration_ms"],
                                                                         abs=0.01)
    assert rep["duration_ms"] <= client_ms + 1.0 and rep["attributed_ms"] >= 0.8 * client_ms
    assert os.path.exists(os.path.join(exdir, f"{tid}.json"))
    txt = rr.format_waterfall(rep)
    assert "dominant" in txt and "reply stall" in txt


def test_oom_drill_exemplar_names_tierdown(sorted_bam):
    faults.arm("seed=1;arena.oom:n=2")
    conf = Configuration()
    conf.set_int(SERVE_EXEMPLAR_THRESHOLD_MS, 0)
    try:
        live = _Live(conf)
        try:
            client = live.client
            assert len(client.view(sorted_bam, "chr1:1-100000")) > 0
            ex = client.exemplars(client.last_trace_id)
            counters = client.stats()["metrics"]["counters"]
        finally:
            live.close()
    finally:
        faults.disarm()
    s = ex["summary"]
    assert s["trigger"].startswith("tierdown:") and s["oom"] is True
    hops = [h["hop"] for h in s["hops"]]
    assert {"oom.evict", "oom.tierdown", "oom.host_decode"} <= set(hops)
    assert hops.index("oom.evict") < hops.index("oom.tierdown")
    assert counters["serve.oom.tierdowns"] == 1 and counters["faults.fired.arena.oom"] == 2


def test_clean_run_yields_zero_exemplars(sorted_bam):
    conf = Configuration()
    conf.set_int(SERVE_EXEMPLAR_THRESHOLD_MS, 60_000)
    live = _Live(conf)
    try:
        client = live.client
        for _ in range(5):
            client.view(sorted_bam, "chr1:1-100000")
        client.flagstat(sorted_bam)
        assert client.exemplars() == []
        st = client.stats()
        assert st["slo"]["compliant"] is True and st["slo"]["alerting"] == []
        assert st["gauges"]["serve.trace.exemplar_count"] == 0
        assert st["metrics"]["counters"]["serve.trace.requests"] == 6
    finally:
        live.close()


def test_access_log_joins_exemplars_on_trace_id(sorted_bam, tmp_path):
    conf = Configuration()
    base = str(tmp_path / "access.jsonl")
    conf.set(SERVE_ACCESS_LOG, base)
    conf.set_int(SERVE_EXEMPLAR_THRESHOLD_MS, 0)
    live = _Live(conf)
    try:
        client = live.client
        client.view(sorted_bam, "chr1:1-100000")
        ok_tid = client.last_trace_id
        with pytest.raises(Exception):
            client.view(sorted_bam, "nope:1-10")
        bad_tid = client.last_trace_id
    finally:
        live.close()
    recs, torn = flightrec_mod.load_access_log(base)
    assert torn == 0
    by_id = {r["trace_id"]: r for r in recs}
    assert by_id[ok_tid]["outcome"] == "OK" and by_id[bad_tid]["outcome"] == "ERROR"
    assert by_id[ok_tid]["op"] == "view" and by_id[ok_tid]["duration_ms"] > 0


def test_slo_breach_surfaces_in_stats_prometheus_and_flightrec(sorted_bam, tmp_path):
    conf = Configuration()
    conf.set(SERVE_SLO, "view:latency=0.001@0.99")
    conf.set(SERVE_SLO_WINDOWS, "5,10")
    fr = str(tmp_path / "fr.jsonl")
    conf.set(SERVE_FLIGHTREC, fr)
    conf.set_int(SERVE_FLIGHTREC_CADENCE_MS, 50)
    live = _Live(conf)
    try:
        client = live.client
        live.d.slo.fast_burn = 1.0
        live.d.slo.slow_burn = 1.0
        for _ in range(10):
            client.view(sorted_bam, "chr1:1-100000")
        slo = client.stats()["slo"]
        assert slo["compliant"] is False and slo["alerting"] == ["view:latency<0.001ms"]
        assert slo["worst"]["op"] == "view" and slo["worst"]["burn_fast"] > 1.0
        txt = client.metrics()
        assert "hbam_slo_view_latency_burn_fast" in txt
        assert "hbam_slo_view_latency_alerting 1.0" in txt
        assert "hbam_serve_slo_alerts_total" in txt
        time.sleep(0.15)
    finally:
        live.close()
    snaps, _ = flightrec_mod.load_ring(fr)
    assert snaps[-1]["final"] is True
    with_slo = [s for s in snaps if "slo" in s]
    assert with_slo and any(s["slo"]["alerting"] == ["view:latency<0.001ms"] for s in with_slo)


def test_request_tracing_off_leaves_no_trail(sorted_bam):
    conf = Configuration()
    conf.set_boolean(SERVE_REQUEST_TRACING, False)
    live = _Live(conf)
    try:
        client = live.client
        s0 = snapshot(live.d.metrics)
        client.view(sorted_bam, "chr1:1-100000")
        with pytest.raises(Exception):
            client.view(sorted_bam, "nope:1-10")
        assert client.exemplars() == []
        de = delta(s0, registry=live.d.metrics)
        assert not any(k.startswith("serve.trace.") for k in de["counters"])
        assert not TRACER.armed
    finally:
        live.close()


def test_batch_pipeline_records_zero_request_context_events(tmp_path):
    """Outside a request no ring event carries a trace id: a plain sort and
    a one-shot view under an armed ring; the same view inside a request
    scope carries it."""
    src = _write_sorted_bam(tmp_path, n=150)
    out = str(tmp_path / "resorted.bam")
    ctx = ServeContext.from_conf(with_batcher=False, device="cpu")
    rctx = RequestContext.new(op="view")
    TRACER.start(capacity=4096)
    try:
        st = sort_bam([src], out, device="cpu", backend="host")
        view_blob(ctx, src, "chr1:1-100000")
        n_plain = len(TRACER.chrome_events())
        with request_scope(rctx):
            view_blob(ctx, src, "chr1:1-200000")
        evs = TRACER.chrome_events()
    finally:
        TRACER.stop()
        ctx.close()
    assert n_plain > 0, "the one-shot view left no event at all"
    traced = [e for e in evs[:n_plain] if "trace" in (e.get("args") or {})]
    assert traced == []
    assert {e["name"] for e in evs[n_plain:]} >= {"serve.view"}
    assert all(e["args"]["trace"] == rctx.trace_id for e in evs[n_plain:])
    assert not any(k.startswith("serve.trace.") for k in st.counters)
    assert current_request() is None


# ---------------------------------------------------------------------------
# The reference's tools/request_report.py on the port's exemplars
# ---------------------------------------------------------------------------


def _fixture_exemplar():
    ctx = RequestContext.new(op="view")
    ctx.annotate("queue.wait", ms=2.0, op="view")
    ctx.annotate("batch.wait", ms=10.0, members=3, coalesced=2)
    ctx.annotate("batch.decode", ms=4.0)
    ctx.annotate("view.overlap", ms=1.0)
    ctx.annotate("reply.stall", ms=80.0, injected=True)
    s = exemplars_mod.request_summary(ctx, "OK", 100.0, op="view")
    s["trigger"] = "latency:100.0ms>50ms"
    return exemplars_mod.build_exemplar(
        s, [{"name": "serve.view", "cat": "stage", "ph": "X", "ts": 0.0, "dur": 1000.0,
             "args": {"trace": ctx.trace_id}}], {})


def test_request_report_waterfall_reduction():
    rr = request_report_mod()
    rep = rr.waterfall(_fixture_exemplar())
    assert rep["dominant"]["hop"] == "reply.stall"
    assert rep["attributed_ms"] == pytest.approx(97.0)
    assert rep["unattributed_ms"] == pytest.approx(3.0) and rep["incomplete"] is False
    assert [h["hop"] for h in rep["hops"]] == ["queue.wait", "batch.wait", "batch.decode",
                                               "view.overlap", "reply.stall"]
    assert rep["hops"][-1]["share"] == pytest.approx(0.8)
    txt = rr.format_waterfall(rep)
    assert "reply stall (injected fault)" in txt and "<- dominant" in txt
    assert "INCOMPLETE" not in txt
    assert "INCOMPLETE" in rr.format_waterfall(rr.waterfall(dict(_fixture_exemplar(),
                                                                 incomplete=True)))


def test_request_report_cli_runs_on_a_spilled_exemplar(sorted_bam, tmp_path):
    """The reference's stdlib-only CLI renders an exemplar the port's
    daemon spilled (an out-of-memory tier-down, sampled at any speed)."""
    exdir = str(tmp_path / "ex")
    conf = Configuration()
    conf.set(SERVE_EXEMPLAR_DIR, exdir)
    faults.arm("seed=1;arena.oom:n=2")
    try:
        live = _Live(conf)
        try:
            live.client.view(sorted_bam, "chr1:1-100000")
            tid = live.client.last_trace_id
        finally:
            live.close()
    finally:
        faults.disarm()
    assert os.listdir(exdir) == [f"{tid}.json"]
    tool = str(REPO / "tools" / "request_report.py")
    r = subprocess.run([sys.executable, tool, tid, "--exemplar-dir", exdir],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert "host tier-down (device OOM)" in r.stdout and "dominant hop:" in r.stdout
    rj = subprocess.run([sys.executable, tool, tid[:8], "--exemplar-dir", exdir, "--json"],
                        capture_output=True, text=True, timeout=60)
    assert rj.returncode == 0, rj.stderr
    rep = json.loads(rj.stdout)
    assert rep["trace_id"] == tid and "oom.tierdown" in {h["hop"] for h in rep["hops"]}


# ---------------------------------------------------------------------------
# Lint: dispatch and seam coverage
# ---------------------------------------------------------------------------

#: Files that emit stage/queue ring events without the request API
#: themselves (their callers hold the scope): the reference's list, the
#: split reader, the collation and fixmate cores and the CRAM spec layer,
#: whose serve callers run them under the request scope, and the
#: multi-process sort, a batch job of one process group that no serve
#: request dispatches (no request to attribute its ``mh.*`` events to).
_AMBIENT_EXEMPT = ("utils/tracing.py", "io/bam.py", "collate/fixmate.py", "collate/host.py",
                   "spec/cram.py", "spec/cram_codecs.py", "parallel/multihost.py")
_EMIT = re.compile(r'category="(?:stage|queue)"|\.emit\(\s*[^,()]+,\s*"(?:stage|queue)"')


def test_lint_every_dispatch_op_is_registered_and_scoped():
    from hadoop_bam_tpu_torch.serve.server import KNOWN_OPS

    src = (PKG / "serve" / "server.py").read_text()
    dispatch_src = src.split("def _dispatch", 1)[1].split("\n    def ")[0]
    assert set(re.findall(r'if op == "(\w+)"', dispatch_src)) == set(KNOWN_OPS)
    handle_src = src.split("def _handle(", 1)[1].split("\n    def ")[0]
    scope_at = handle_src.find("with request_scope(rctx):")
    call_at = handle_src.find("self._dispatch(req)")
    assert 0 <= scope_at < call_at, "_dispatch is not invoked under the request_scope wrapper"


def test_lint_stage_queue_seams_run_under_request_context():
    bad, emitters = [], []
    for f in sorted(PKG.rglob("*.py")):
        rel = str(f.relative_to(PKG)).replace("\\", "/")
        src = f.read_text()
        if not _EMIT.search(src) or rel in _AMBIENT_EXEMPT:
            continue
        emitters.append(rel)
        if not re.search(r"current_request\(|request_scope\(|request_hop\(", src):
            bad.append(rel)
    assert {"serve/admission.py", "serve/batching.py"} <= set(emitters), emitters
    assert not bad, bad


def test_lint_client_code_mapping_covers_every_op():
    from hadoop_bam_tpu_torch.serve.server import KNOWN_OPS

    src = (PKG / "serve" / "client.py").read_text()
    for op in KNOWN_OPS:
        assert f'"op": "{op}"' in src, f"client never issues op {op!r}"

"""The port's batch tracer and run provenance (``utils/tracing.py``'s
spans, histograms, ring, ``trace_ctx``, counter tracks, ``Progress`` and
``run_manifest``) against the reference's, on the CPU: the cases of
``tests/test_tracing.py`` that ``tests/test_torch_request_tracing.py`` does
not already mirror.  A traced port sort is reduced by the unchanged
``tools/trace_report.py``; the metric-name lint and the literal checks read
the port's source (a name the port counts through an f-string matches
with its placeholder as any component).

Left out: ``test_bench_finalize_round_flags_cpu_fallback`` (the port's
bench entry is ROADMAP A.12b).  ``test_skew_healing_metric_literals_present``
is the "skew_healing" family below, less ``pipeline.auto_rtt_ms``/
``effective_rtt_ms`` (the reference's read-depth gauges, which the port's
jobs do not set)."""

import importlib.util
import io
import json
import pathlib
import re
import threading

import pytest

from hadoop_bam_tpu.utils import tracing as jtracing
from hadoop_bam_tpu_torch.utils.tracing import (
    METRIC_NAME_PATTERN,
    TRACER,
    Histogram,
    MetricsRegistry,
    Progress,
    Tracer,
    delta,
    prometheus_text,
    run_manifest,
    snapshot,
    span,
    stage,
    trace_ctx,
)
from test_torch_markdup import write_bam

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "hadoop_bam_tpu_torch"


def trace_report_mod():
    spec = importlib.util.spec_from_file_location("trace_report",
                                                  REPO / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_accumulates():
    reg = MetricsRegistry()
    for _ in range(3):
        with span("phase.x", reg):
            pass
    rep = reg.report()
    assert rep["span_counts"]["phase.x"] == 3
    assert rep["span_seconds"]["phase.x"] >= 0.0


def test_counters_threadsafe():
    reg = MetricsRegistry()

    def work():
        for _ in range(1000):
            reg.count("n")

    ts = [threading.Thread(target=work) for _ in range(8)]
    [t.start() for t in ts]
    [t.join(timeout=30) for t in ts]
    assert not any(t.is_alive() for t in ts)
    assert reg.report()["counters"]["n"] == 8000


def _ticks(cls, advances, **kw):
    ticks = []
    p = cls(sink=lambda pr: ticks.append(pr.done), **kw)
    for n in advances:
        p.advance(n)
    return ticks, p.fraction()


def test_progress_cadence():
    """Driven by explicit advances: ticks and fractions equal the
    reference's."""
    for advances in ([25, 4, 1], [9, 1, 30, 5], [100]):
        got = _ticks(Progress, advances, total_bytes=100, cadence=10)
        assert got == _ticks(jtracing.Progress, advances, total_bytes=100, cadence=10)
    ticks, frac = _ticks(Progress, [25, 4, 1], total_bytes=100, cadence=10)
    assert len(ticks) == 2 and frac == 0.3


def test_progress_unknown_total():
    p = Progress(sink=lambda pr: None)
    p.advance(10)
    assert p.fraction() == 0.0


def test_pipeline_emits_metrics(tmp_path):
    """The port's sort counts into its own stats (no global registry): the
    records, the phase seconds, one part attempt a split."""
    from hadoop_bam_tpu_torch.pipeline import sort_bam

    src = _mini_bam(tmp_path, n=200)
    st = sort_bam(src, str(tmp_path / "out.bam"), device="cpu")
    assert st.n_records == 200
    assert set(st.seconds) == {"read", "sort", "write"}
    assert st.counters["executor.attempts"] == st.n_splits


def test_histogram_bucket_placement_and_percentiles():
    values = (0.5, 1.0, 3.0, 3.0, 3.0, 100.0, 2.0, 2.1, 900.0)
    h, jh = Histogram(), jtracing.Histogram()
    for v in values:
        h.observe(v)
        jh.observe(v)
    assert h.as_dict() == jh.as_dict()
    for q in (0.5, 0.95, 0.99):
        assert h.percentile(q) == jh.percentile(q)
    assert Histogram().percentile(0.99) == 0.0


def test_registry_observe_and_delta():
    reg = MetricsRegistry()
    before = snapshot(reg)
    reg.observe("op.latency_ms", 3.0)
    reg.observe("op.latency_ms", 900.0)
    rep = reg.report()
    assert rep["histograms"]["op.latency_ms"]["count"] == 2
    assert rep["histograms"]["op.latency_ms"]["p99"] == 1024.0
    d = delta(before, snapshot(reg))
    assert d["histograms"]["op.latency_ms"] == {"count": 2, "sum": 903.0}


# ---------------------------------------------------------------------------
# The ring: the disarmed contract, overflow, export schema, counter tracks
# ---------------------------------------------------------------------------


def test_tracer_disarmed_contract():
    """Tracing off: no ring, ``span`` does its registry work only, and
    ``trace_ctx`` sets nothing."""
    t = Tracer()
    assert not t.armed and t._ring is None
    reg = MetricsRegistry()
    assert not TRACER.armed, "the tracer must be disarmed between tests"
    with trace_ctx(split=1), span("contract.check", reg):
        pass
    assert TRACER._ring is None
    assert TRACER.events() == []
    assert reg.report()["span_counts"]["contract.check"] == 1


def test_ring_buffer_overflow_drops_oldest_counters_intact():
    reg = MetricsRegistry()
    TRACER.start(capacity=16)
    try:
        for i in range(40):
            with span(f"ring.ev_{i:02d}", reg):
                pass
        evs = TRACER.events()
        assert len(evs) == 16 and TRACER.dropped_events == 24
        assert [e[0] for e in evs] == [f"ring.ev_{i:02d}" for i in range(24, 40)]
        assert sum(reg.report()["span_counts"].values()) == 40
    finally:
        TRACER.stop()
    assert TRACER._ring is None


def test_trace_export_chrome_schema():
    TRACER.start(capacity=64)
    try:
        with trace_ctx(split=3):
            with span("schema.stage_a", category="stage"):
                pass
            with trace_ctx(part=1):
                stage("schema.stage_b")(lambda: None)()
        TRACER.instant("schema.marker", "xfer", {"bytes": 10})
        buf = io.StringIO()
        n = TRACER.export_chrome(buf, other={"host": 0})
    finally:
        TRACER.stop()
    doc = json.loads(buf.getvalue())
    evs = doc["traceEvents"]
    assert n == len(evs) == 3
    for e in evs:
        for k in ("ts", "dur", "ph", "name", "tid", "pid", "cat"):
            assert k in e, f"event missing {k}: {e}"
        assert e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
    by_name = {e["name"]: e for e in evs}
    assert by_name["schema.stage_a"]["args"] == {"split": 3}
    assert by_name["schema.stage_b"]["args"] == {"split": 3, "part": 1}
    assert by_name["schema.stage_b"]["cat"] == "stage"
    assert by_name["schema.marker"]["args"] == {"bytes": 10}
    assert doc["otherData"] == {"dropped_events": 0, "dropped_by_category": {}, "host": 0}


def test_tracer_counter_events_export_as_ph_c():
    """Counter samples export as ``ph: "C"`` with pure series args: the
    ambient ``trace_ctx`` does not merge in."""
    t = Tracer()
    t.start(capacity=32)
    TRACER.start(capacity=32)  # trace_ctx is live only with the process ring armed
    try:
        with trace_ctx(split=3):
            t.counter("hbm.live_bytes", {"total": 100, "split_window": 100})
        evs = t.chrome_events()
    finally:
        t.stop()
        TRACER.stop()
    assert len(evs) == 1
    e = evs[0]
    assert e["ph"] == "C" and e["name"] == "hbm.live_bytes"
    assert e["args"] == {"total": 100, "split_window": 100}
    assert "dur" not in e and "cat" not in e
    Tracer().counter("hbm.live_bytes", {"total": 1})  # disarmed: a no-op


def test_progress_routes_through_tracer(capsys):
    TRACER.start(capacity=32)
    try:
        p = Progress(total_bytes=100, cadence=10)
        p.advance(25)
        ticks = [e for e in TRACER.events() if e[0] == "progress.tick"]
        assert len(ticks) == 1 and ticks[0][5]["done"] == 25
    finally:
        TRACER.stop()
    assert capsys.readouterr().err == ""
    p = Progress(total_bytes=100, cadence=10)
    p.advance(25)
    assert capsys.readouterr().err == "-"


# ---------------------------------------------------------------------------
# End to end: a traced port sort, reduced by the unchanged tool
# ---------------------------------------------------------------------------


def _mini_bam(tmp_path, n=800):
    """``tests/test_tracing.py``'s fixture in stored 2,048-byte members, so
    that an 8 KiB split size cuts it into several splits."""
    from hadoop_bam_tpu.spec import bam

    recs = [bam.build_record(f"r{i}", 0, (97 * i) % 90000, 60, 0, [(10, "M")],
                             "ACGTACGTAC", bytes([30] * 10)) for i in range(n)]
    return write_bam(str(tmp_path / "m.bam"), recs, refs=[("c", 100000)], level=0)


@pytest.mark.parametrize("gates", ["host", "lanes"])
def test_sort_trace_e2e_stage_events(tmp_path, gates):
    """A traced sort: valid Chrome JSON whose per-split stage events come in
    pipeline order, write-side events that carry ``part``, and a reduction
    that names a top stall (with the inflate gate on, through the inflate
    kernel's plain version, the HBM track and a clean memory verdict)."""
    from hadoop_bam_tpu_torch.conf import INFLATE_LANES, Configuration
    from hadoop_bam_tpu_torch.pipeline import sort_bam

    src = _mini_bam(tmp_path)
    out = tmp_path / "sorted.bam"
    trace = tmp_path / "t.json"
    conf = Configuration({INFLATE_LANES: "true" if gates == "lanes" else "false"})
    TRACER.start()
    try:
        st = sort_bam(src, str(out), split_size=8 << 10, device="cpu", conf=conf)
        TRACER.export_chrome(str(trace))
    finally:
        TRACER.stop()
    assert st.n_splits > 1
    doc = json.loads(trace.read_text())
    evs = doc["traceEvents"]
    for e in evs:
        keys = ("ts", "ph", "name", "tid") if e.get("ph") == "C" else (
            "ts", "dur", "ph", "name", "tid")
        for k in keys:
            assert k in e
    stage_evs = [e for e in evs if e.get("cat") == "stage"]
    splits = sorted({e["args"]["split"] for e in stage_evs
                     if "args" in e and "split" in e["args"]})
    assert splits == list(range(st.n_splits))
    order = ["bam.stage.read", "bam.stage.inflate", "bam.stage.parse", "bam.stage.key"]
    for si in splits:
        mine = {e["name"]: e["ts"] for e in stage_evs
                if e.get("args", {}).get("split") == si and e["name"] in order}
        assert set(mine) == set(order), f"split {si} missing stages"
        ts = [mine[n] for n in order]
        assert ts == sorted(ts), f"split {si} stages out of order: {mine}"
    parts = {e["args"]["part"] for e in stage_evs
             if e["name"].startswith("bam.stage.") and "part" in e.get("args", {})}
    assert parts == set(range(st.n_splits))
    tr = trace_report_mod()
    rep = tr.stage_report(tr.load_events(str(trace)))
    assert rep["top_stall"]["stage"] in rep["stages"]
    for s in rep["stages"].values():
        assert 0.0 <= s["busy_frac"] <= 1.0 + 1e-9
        assert 0.0 <= s["overlap_frac"] <= 1.0 + 1e-9
    mem = tr.memory_report(tr.load_trace(str(trace))[0])
    if gates == "lanes":
        assert "flate.stage.inflate_device" in rep["stages"]
        assert any(e.get("ph") == "C" and e["name"] == "hbm.live_bytes" for e in evs)
        assert mem["peak_bytes"] > 0 and mem["leaked_bytes"] == 0
        assert mem["verdict"] == "clean"
    else:
        assert mem is None


def test_armed_tracer_records_admission_queue_events():
    from hadoop_bam_tpu_torch.serve.admission import AdmissionController

    ctrl = AdmissionController(tokens=1, max_queue=4)
    TRACER.start(capacity=64)
    try:
        ctrl.acquire("view").release()
        evs = [e for e in TRACER.chrome_events() if e["cat"] == "queue"]
        assert evs and evs[0]["name"] == "serve.admission.wait"
        assert evs[0]["args"]["op"] == "view"
    finally:
        TRACER.stop()


# ---------------------------------------------------------------------------
# Run provenance
# ---------------------------------------------------------------------------

_MANIFEST_CASES = [
    {"flate.inflate.lanes": 10, "flate.inflate.host": 2, "bam.device_inflate_fallback": 1,
     "salvage.members_quarantined": 3, "unrelated.counter": 7},
    {},
    {"hbm.leaked_bytes": 4096, "hbm.leaked.bam.split_window": 4000, "hbm.leaked.t.x": 96,
     "hbm.double_copy": 2, "serve.oom.tierdowns": 1, "salvage.records_dropped": 5},
    {"bam.device_write_parts": 4, "bam.device_write_tierdown.no_residency": 7,
     "sort_bam.device_parse_residency": 11, "faults.fired.exec.crash": 2,
     "serve.deadline.expired": 1},
]


@pytest.mark.parametrize("counters", _MANIFEST_CASES)
def test_run_manifest_collects_tiers_and_degradation(counters):
    """The port's manifest equals the reference's on the same counters
    (the device fields aside), and the reference's case holds."""
    from hadoop_bam_tpu.conf import Configuration as JConf
    from hadoop_bam_tpu_torch.conf import Configuration

    kv = {"hadoopbam.errors": "salvage", "hadoopbam.faults.plan": "exec.crash:items=0"}
    got = run_manifest(backend="single-device", counters=counters, conf=Configuration(kv),
                       requested="single-device").as_dict()
    want = jtracing.run_manifest(backend="single-device", counters=counters, conf=JConf(kv),
                                 requested="single-device").as_dict()
    assert got.pop("device") is None and got.pop("platform") is None
    want.pop("platform")
    # The reference adds modes from its global registry's gauges, which its
    # earlier jobs in this process set; the port's jobs set none.
    for k in ("read_depth", "auto_rtt_ms", "effective_rtt_ms"):
        want["modes"].pop(k, None)
    assert got == want
    if counters is _MANIFEST_CASES[0]:
        assert got["tier_decisions"]["flate.inflate.lanes"] == 10
        assert "unrelated.counter" not in got["tier_decisions"]
        joined = " ".join(got["reasons"])
        assert "device inflate tier errored" in joined and "salvage mode quarantined" in joined
    assert got["degraded"] is bool(got["reasons"])


def test_run_manifest_names_the_device_and_a_backend_mismatch():
    man = run_manifest(backend="host", counters={}, requested="single-device", device="cpu")
    assert man.degraded and "requested backend" in man.reasons[0]
    assert (man.platform, man.device) == ("cpu", "cpu")
    assert run_manifest(backend="single-device", counters={}).degraded is False


# ---------------------------------------------------------------------------
# Prometheus exposition, gauges, the metrics-namespace lint
# ---------------------------------------------------------------------------


def test_prometheus_text_format():
    def fill(reg):
        reg.count("serve.op.view", 3)
        reg.add_span("serve.view", 0.25)
        reg.observe("serve.op.view.ms", 3.0)
        reg.observe("serve.op.view.ms", 100.0)
        return reg

    txt = prometheus_text(fill(MetricsRegistry()).report(),
                          gauges={"serve.arena.used_bytes": 42})
    assert txt == jtracing.prometheus_text(fill(jtracing.MetricsRegistry()).report(),
                                           gauges={"serve.arena.used_bytes": 42})
    assert 'hbam_serve_op_view_ms_bucket{le="+Inf"} 2' in txt
    les = [float(m.group(1)) for m in re.finditer(r'_bucket\{le="([0-9.]+)"\}', txt)]
    assert les == sorted(les)


def test_registry_gauges_in_report_delta_and_prometheus():
    reg = MetricsRegistry()
    reg.set_gauge("serve.arena.used_bytes", 4096)
    reg.set_gauge("hbm.live_bytes", 123)
    assert reg.report()["gauges"]["serve.arena.used_bytes"] == 4096.0
    assert delta(snapshot(reg), registry=reg)["gauges"]["hbm.live_bytes"] == 123.0
    txt = prometheus_text(reg.report())
    assert "# TYPE hbam_hbm_live_bytes gauge" in txt and "hbam_hbm_live_bytes 123" in txt


#: A metric-name call in the port: a registry's or a job's ``count``
#: (``metrics.count``, ``m.count``, the CRAM reader's local ``count``), a
#: histogram, a gauge, a span, a stage, a transfer or a counter track.
_NAME_CALL = re.compile(
    r'(?:\.count|[^.\w]count|\.observe|\.set_gauge|\.add_span|[^.\w]span|_trace_stage'
    r'|count_h2d|count_d2h|\.counter)\(\s*\n?\s*(f?)"([^"]+)'
)


def _port_names():
    names = set()
    for f in sorted(PKG.rglob("*.py")):
        for m in _NAME_CALL.finditer(f.read_text()):
            names.add((m.group(1), m.group(2)))
    return names


def test_metric_names_are_dotted_lowercase():
    pat = re.compile(METRIC_NAME_PATTERN)
    bad = []
    names = _port_names()
    for is_f, name in names:
        if not pat.match(re.sub(r"\{[^}]*\}", "x0", name) if is_f else name):
            bad.append(name)
    assert len(names) > 150
    assert not bad, "non-conforming metric names:\n" + "\n".join(sorted(bad))


def _present(want):
    names = _port_names()
    literal = {n for is_f, n in names if not is_f}
    patterns = [re.compile("^" + re.sub(r"\\\{[^}]*\\\}", "[a-z0-9_]+", re.escape(n)) + "$")
                for is_f, n in names if is_f]
    return [w for w in want if w not in literal and not any(p.match(w) for p in patterns)]


_LITERALS = {
    "cram_rans": ("cram.rans.lanes_slices", "cram.rans.host_slices", "cram.rans.tierdown.size",
                  "cram.rans.tierdown.vmem", "cram.rans.tierdown.ctx",
                  "cram.rans.tierdown.format", "cram.rans.tierdown.ok0",
                  "cram.codec.unsupported", "cram.codec.corrupt", "cram.slice.quarantined",
                  "cram.container.quarantined", "cram.stage.rans", "cram.stage.series"),
    "ingest": ("ingest.records", "ingest.pairs", "ingest.orphans", "ingest.out_bytes",
               "ingest.inflate.members", "ingest.inflate.bytes", "ingest.inflate.repacked",
               "ingest.inflate.host_members", "fastq.scan.chunks", "fastq.scan.lanes",
               "fastq.scan.host", "fastq.scan.serial_fallback", "fastq.scan.reconciled",
               "salvage.ingest_members", "salvage.ingest_frames", "salvage.ingest_tail_records",
               "ingest.stage.decode", "ingest.stage.scan", "ingest.stage.collate",
               "ingest.stage.write", "fleet.eager_refused"),
    "variant_plane": ("bcf.chain.device_walks", "bcf.chain.host_walks", "bcf.chain.tierdowns",
                      "bcf.chain.oracle_fallbacks", "bcf.chain.records", "bcf.guess.windows",
                      "bcf.guess.candidates", "bcf.guess.verified", "variants.join_device",
                      "variants.join_host", "pileup.device_chunks", "pileup.tierdowns",
                      "serve.variants.requests", "serve.variants.records",
                      "serve.variants.ms", "serve.depth.requests", "serve.depth.ms",
                      "salvage.members_quarantined", "salvage.bytes_quarantined",
                      "salvage.records_dropped"),
    "skew_healing": ("mh.rank.names", "mh.repartition.triggered", "mh.repartition.sample_keys",
                     "mh.repartition.ratio_before", "mh.repartition.ratio_after",
                     "mh.shuffle.capacity_retry", "mh.shuffle.store_fallback", "mh.records",
                     "mh.skew_ratio", "mh.peak_bytes", "mh.keys.sent.0", "mh.keys.recv.1",
                     "mh.shuffle.sent.0", "mh.shuffle.recv_raw.1", "mh.http.requests",
                     "mh.http.range_requests", "mh.http.bytes_served",
                     "mh.byte_shuffle.deflate", "mh.byte_shuffle.inflate", "mh.range_merge",
                     "mh.speculate.launched", "mh.speculate.won", "mh.speculate.wasted_bytes",
                     "mh.speculate.fetch_bytes"),
    "batch_tracer": ("bam.stage.read", "bam.stage.inflate", "bam.stage.parse", "bam.stage.key",
                     "bam.stage.gather", "bam.stage.deflate", "bam.stage.write",
                     "pipeline.stage.read_split", "pipeline.stage.device_parse",
                     "pipeline.stage.write_part", "flate.stage.inflate_device",
                     "flate.stage.deflate_device", "collate.stage.signature",
                     "collate.stage.device", "collate.stage.verify", "collate.stage.rank",
                     "fixmate.stage.edits", "fixmate.stage.tag_walk", "fixmate.stage.apply",
                     "hbm.leaked_bytes", "hbm.double_copy", "hbm.allocs", "hbm.frees",
                     "hbm.transfers", "hbm.live_bytes", "hbm.peak_bytes"),
}


@pytest.mark.parametrize("family", sorted(_LITERALS))
def test_metric_literals_present(family):
    """The names the reference's drills read (its ``test_*_metric_literals``
    cases: the CRAM codec family, the ingest plane, the variant plane, the
    multi-process sort's skew healing and byte plane) and
    the batch tracer's stage and ledger names exist in the port's source."""
    missing = _present(_LITERALS[family])
    assert not missing, f"metric names missing from the port: {missing}"

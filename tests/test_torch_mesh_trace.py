"""The port's mesh trace (``parallel/multihost.py``'s ``_MeshObservability``,
``utils/tracing.py``'s ``ClusterManifest``) against the reference's, on the
CPU.  Case list: the cases of ``tests/test_mesh_observability.py`` that
``test_torch_multihost.py`` left out:

- the four ``cluster_manifest`` fold drills on ``tests/data/mesh_trace``
  (clean, a degraded host, an imbalanced edge, a host that never
  published): the port's ``as_dict()`` is the reference's;
- one process on 8 shards, armed against disarmed: the same bytes, the
  three files, the stage names and counter tracks, no trace event when
  disarmed, the tracer stopped after;
- ``LAST_CLUSTER_MANIFEST`` against the reference's armed run: records,
  records out, the key and shuffle matrices, balance and skew (the run
  manifests differ only in the port's platform and device);
- under a budget: the peak gauge, the manifest's peak and its matrix;
- two processes on the http plane under ``exec.delay`` of host 1's reads:
  the unchanged ``tools/mesh_report.py`` merges the shards, balances the
  matrix and names host 1 the straggler, and host 1's injected salvage
  count degrades the cluster."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from hadoop_bam_tpu.parallel import multihost as jm
from hadoop_bam_tpu.utils import tracing as jtracing
from hadoop_bam_tpu_torch.parallel import multihost as tm
from hadoop_bam_tpu_torch.spec import bgzf
from hadoop_bam_tpu_torch.utils import tracing as ttracing
from hadoop_bam_tpu_torch.utils.tracing import TRACER, MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from bench import synth_bam  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "mesh_trace")
SPLIT = 1 << 18
N = 20_000


def _mesh_report():
    spec = importlib.util.spec_from_file_location("mesh_report",
                                                  os.path.join(REPO, "tools", "mesh_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream(path):
    with open(path, "rb") as f:
        return bgzf.decompress_all(f.read())


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("mesh_trace") / "in.bam")
    synth_bam(p, N)
    return p


def _fixture_manifests():
    out = []
    for name in ("manifest-h000.json", "manifest-h001.json"):
        with open(os.path.join(FIXTURE, name)) as f:
            out.append(json.load(f))
    return out


def _drill(name):
    m0, m1 = _fixture_manifests()
    if name == "clean":
        return [m0, m1], "fs"
    if name == "degraded_host":
        return [m0, dict(m1, run_manifest=dict(m1["run_manifest"], degraded=True,
                                                reasons=["salvage mode quarantined data"]))], None
    if name == "imbalanced_edge":
        return [dict(m0, shuffle_recv_bytes={"0": 100, "1": 299}), m1], None
    return [m0], None  # a host that never published


@pytest.mark.parametrize("name", ["clean", "degraded_host", "imbalanced_edge", "missing_host"])
def test_cluster_manifest_fold_drills(name):
    """The fold of the fixture's manifests and of each damaged set: the
    reference's dict, and the reference's verdicts."""
    hosts, plane = _drill(name)
    cm = ttracing.cluster_manifest(hosts, byte_plane=plane).as_dict()
    assert cm == jtracing.cluster_manifest(hosts, byte_plane=plane).as_dict()
    if name == "clean":
        assert not cm["degraded"] and cm["edges_balanced"]
        assert (cm["num_hosts"], cm["records"], cm["shuffle_bytes"], cm["keys_bytes"]) == \
            (2, 100, 1000, 210)
    elif name == "degraded_host":
        assert cm["degraded"] and any("host 1 degraded" in r for r in cm["reasons"])
    elif name == "imbalanced_edge":
        assert cm["degraded"] and not cm["edges_balanced"]
        assert any("edge 1->0" in r for r in cm["reasons"])
    else:
        assert cm["degraded"] and any("host 1 never published" in r for r in cm["reasons"])


def _port_sort(src, out, **kw):
    m = MetricsRegistry()
    n = tm.sort_bam_multihost(src, out, ctx=tm.initialize(device="cpu", shards=8),
                              split_size=SPLIT, level=1, device="cpu", metrics=m, **kw)
    return n, m


def test_armed_run_publishes_and_stays_byte_identical(src, tmp_path):
    """Disarmed then armed, one process on 8 shards: the same bytes; the
    disarmed run records no trace event and leaves the tracer off; the
    armed one writes the shard, the manifest and the cluster manifest,
    with the stages, the barriers and the counter tracks, and stops the
    tracer it started."""
    assert not TRACER.armed
    off, on, td = str(tmp_path / "off.bam"), str(tmp_path / "on.bam"), str(tmp_path / "mt")
    _port_sort(src, off)
    assert not TRACER.armed and TRACER.events() == []
    _, m = _port_sort(src, on, mesh_trace=True, mesh_trace_dir=td)
    assert not TRACER.armed
    with open(on, "rb") as f, open(off, "rb") as g:
        assert f.read() == g.read()
    assert sorted(os.listdir(td)) == ["cluster_manifest.json", "manifest-h000.json",
                                      "trace-h000.json"]
    with open(os.path.join(td, "trace-h000.json")) as f:
        shard = json.load(f)
    mesh = shard["otherData"]["mesh"]
    assert mesh["host"] == 0 and mesh["num_hosts"] == 1
    assert mesh["anchor_us"] > 0 and mesh["anchors_us"] == [mesh["anchor_us"]]
    evs = shard["traceEvents"]
    stages = {e["name"] for e in evs if e.get("cat") == "stage"}
    for want in ("mh.read", "mh.key_shuffle", "mh.byte_shuffle.write", "mh.byte_shuffle.fetch",
                 "mh.merge", "mh.barrier.read_done", "mh.barrier.parts_written"):
        assert want in stages, f"missing {want} in {sorted(stages)}"
    assert {"mh.shuffle.sent", "mh.shuffle.recv", "mh.keys.sent"} <= {
        e["name"] for e in evs if e.get("ph") == "C"}
    cm = tm.LAST_CLUSTER_MANIFEST
    assert cm and not cm["degraded"] and cm["edges_balanced"] and cm["records"] == N
    h0 = cm["hosts"][0]
    assert len(h0["records_out"]) == 8 and sum(h0["records_out"]) == N
    assert h0["shuffle_sent_bytes"] == h0["shuffle_recv_bytes"]
    assert h0["keys_sent_bytes"]["0"] == N * 21 and h0["barrier_wait_ms"]
    assert tm.LAST_MANIFEST["host"] == 0
    assert m.gauges()["mh.skew_ratio"] == pytest.approx(cm["skew_ratio"], rel=1e-6)
    assert m.histogram("mh.barrier.parts_written") is not None
    with open(os.path.join(td, "cluster_manifest.json")) as f:
        assert json.load(f) == cm


def _without_device(cm):
    """The manifest less the timings, the run manifest's platform and
    device, and the reference's read-depth and auto-rtt modes (gauges of
    its process-global registry, set by whatever ran before in the
    process; the port's jobs set none, ROADMAP C)."""
    out = json.loads(json.dumps(cm))
    for h in out["hosts"]:
        rm = h["run_manifest"]
        for k in ("platform", "device"):
            rm.pop(k, None)
        for k in ("read_depth", "auto_rtt_ms", "effective_rtt_ms"):
            rm["modes"].pop(k, None)
        h.pop("barrier_wait_ms")
        h.pop("anchor_us")
    return out


@pytest.mark.parametrize("kw", [{}, {"memory_budget": 5 << 20}], ids=["in_core", "budget"])
def test_cluster_manifest_equals_the_reference_run(src, tmp_path, kw):
    """The same armed sort in both packages (8 shards, 8 host devices):
    the port's cluster manifest is the reference's but for the timings and
    the run manifest's platform and device; under a budget the peak rides
    ``mh.peak_bytes`` and the manifest, at or under the budget."""
    td, jtd = str(tmp_path / "mt"), str(tmp_path / "jmt")
    _, m = _port_sort(src, str(tmp_path / "port.bam"), mesh_trace=True, mesh_trace_dir=td, **kw)
    cm = tm.LAST_CLUSTER_MANIFEST
    jm.sort_bam_multihost([src], str(tmp_path / "ref.bam"), ctx=jm.initialize(),
                          split_size=SPLIT, level=1, mesh_trace=True, mesh_trace_dir=jtd, **kw)
    jcm = jm.LAST_CLUSTER_MANIFEST
    assert _without_device(cm) == _without_device(jcm)
    assert cm["records"] == N and cm["edges_balanced"] and not cm["degraded"]
    assert cm["hosts"][0]["run_manifest"]["platform"] == "cpu"
    if kw:
        peak = tm.LAST_STATS["peak_bytes"]
        assert 0 < peak <= kw["memory_budget"]
        assert m.gauges()["mh.peak_bytes"] == float(peak) == cm["hosts"][0]["peak_bytes"]
        assert cm["hosts"][0]["memory_budget"] is True and cm["edges_balanced"]
        assert sum(cm["hosts"][0]["records_out"]) == N


_OBS_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
sys.modules["jax"] = None  # the port's processes never load JAX
pid, rdv, src, out, trace_dir = (int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
                                 sys.argv[5])
from hadoop_bam_tpu_torch import faults
from hadoop_bam_tpu_torch.parallel import multihost
from hadoop_bam_tpu_torch.utils.tracing import MetricsRegistry
if pid == 1:
    # A salvage-class count in the middle of the run makes host 1's run
    # manifest degraded; the cluster manifest must carry it.
    _write = multihost._write_byte_runs
    def _inject_then_write(*a, **k):
        a[6].metrics.count("salvage.records_dropped", 1)
        return _write(*a, **k)
    multihost._write_byte_runs = _inject_then_write
faults.arm("exec.delay:items=1,ms=150,n=*")  # host 1's reads, a split at a time
ctx = multihost.initialize(init_method="file://" + rdv, num_processes=2, process_id=pid,
                           device="cpu", shards=4, timeout_s=120)
n = multihost.sort_bam_multihost(src, out, ctx=ctx, split_size={split}, level=1,
                                 byte_plane="http", mesh_trace=True, mesh_trace_dir=trace_dir,
                                 device="cpu", metrics=MetricsRegistry())
ctx.close()
print(f"MH_OK pid={{pid}} n={{n}}", flush=True)
"""


def test_two_process_mesh_report_names_the_straggler(src, tmp_path):
    """Two port processes on the http plane with the trace armed and host
    1's reads delayed: the single-process sort's bytes, the five files
    collected by host 0, and ``tools/mesh_report.py`` (unchanged) merging
    the shards, balancing the byte matrix over real cross-host traffic,
    naming host 1 the straggler, and folding host 1's degradation; the
    http counters and the fired delay are in the manifests."""
    from hadoop_bam_tpu_torch import pipeline as tpipeline
    from test_torch_multihost import _run_pair

    out, trace_dir = str(tmp_path / "mh.bam"), str(tmp_path / "mesh-trace")
    worker = _OBS_WORKER.format(repo=REPO, split=1 << 16)
    env = dict(os.environ, PYTHONPATH=REPO, HBAM_SHUFFLE_HOST="127.0.0.1")
    outs = _run_pair(lambda pid: [sys.executable, "-c", worker, str(pid),
                                  str(tmp_path / "rendezvous"), src, out, trace_dir], env)
    for pid, o in enumerate(outs):
        assert f"MH_OK pid={pid} n={N}" in o, o[-2000:]
    oracle = str(tmp_path / "oracle.bam")
    tpipeline.sort_bam(src, oracle, split_size=1 << 16, level=1, device="cpu")
    assert _stream(out) == _stream(oracle)
    assert sorted(os.listdir(trace_dir)) == [
        "cluster_manifest.json", "manifest-h000.json", "manifest-h001.json",
        "trace-h000.json", "trace-h001.json"]
    mr = _mesh_report()
    rep = mr.mesh_report(trace_dir)
    assert rep["num_hosts"] == 2 and rep["events"] > 0
    mx = rep["matrix"]
    assert mx["balanced"], mx["mismatches"]
    assert mx["records"] == N and mx["shuffle_bytes_cross_host"] > 0 and mx["skew_ratio"] >= 1.0
    st = rep["straggler_table"]
    assert st["straggler"]["host"] == 1 and st["straggler"]["blame_ms"] > 100, st
    assert st["stages"]["mh.read"]["1"] > st["stages"]["mh.read"]["0"]
    cm = rep["cluster_manifest"]
    assert cm["degraded"] and cm["edges_balanced"]
    assert any("host 1 degraded" in r for r in cm["reasons"]), cm["reasons"]
    manifests = mr.load_manifests(trace_dir)
    assert any(m["http"].get("requests", 0) > 0 for m in manifests)
    assert any(m["http"].get("bytes_served", 0) > 0 for m in manifests)
    h1 = [m for m in manifests if m["host"] == 1][0]
    assert h1["run_manifest"]["modes"].get("faults.fired.exec.delay")
    assert mr.main([trace_dir]) == 0


def test_report_carries_the_cluster_manifest(src, tmp_path, monkeypatch):
    """The CLI's ``--metrics`` block: ``cluster_manifest`` once a traced
    multi-process sort folded one in this process, absent before."""
    from hadoop_bam_tpu_torch import cli

    monkeypatch.setattr(tm, "LAST_CLUSTER_MANIFEST", {})
    assert "cluster_manifest" not in cli.with_cluster_manifest({})
    _port_sort(src, str(tmp_path / "x.bam"), mesh_trace=True)
    assert os.path.isdir(str(tmp_path / "x.bam") + ".mesh-trace")
    rep = cli.with_cluster_manifest({"counters": {}})
    assert rep["cluster_manifest"] == tm.LAST_CLUSTER_MANIFEST
    assert rep["cluster_manifest"]["records"] == N


def test_now_us_is_the_armed_ring_clock():
    """``Tracer.now_us``: 0.0 disarmed, the armed ring's microseconds
    since its start, as the reference's."""
    from hadoop_bam_tpu_torch.utils.tracing import Tracer

    t = Tracer()
    assert t.now_us() == 0.0 == jtracing.Tracer().now_us()
    t.start()
    a = t.now_us()
    b = t.now_us()
    t.stop()
    assert 0.0 <= a <= b and t.now_us() == 0.0
    assert np.isfinite(b)

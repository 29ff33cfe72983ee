"""The port's multi-process sort (``parallel/multihost.py``) against the
reference's, on the CPU.  Case list: the reference's
``tests/test_multihost.py`` (the one-process 8-device sort, in core and
under a budget; two processes on fs and http, in core and under a budget;
``_RemoteNpy``), the http plane's counters
(``test_mesh_observability.py``), and the wire's units and ``mh.corrupt``
drill (``test_mesh_shuffle.py``):

(a) one process on an 8-shard CPU mesh against the reference's one
    process on its 8 host devices: equal bytes and equal ``mh.*`` counter
    deltas, in core on both planes compressed and raw, under a budget on
    both planes, and queryname; and with the gates armed (rows 1 and 3's
    plain versions), the same bytes and a drained HBM ledger;
(b) two port processes on gloo (a ``file://`` rendezvous), 4 CPU shards
    each: the reference's single-host ``sort_bam(backend="host")`` record
    stream, in core and under a budget, fs and http; each process's sent
    equals its peer's received, keys and bytes;
(c) the reference's two-process run against the port's: equal bytes and
    equal counters a process (both place with ``0x5EED + pid``);
(d) ``_RemoteNpy``'s ranged slices; (e) the http server's counters and
    the fetch retries, counted into the port's registry; (f)
    ``errors="salvage"`` under ``mh.corrupt``; (g) the speculation and
    mesh-trace switches: each arms its piece, a trace directory alone arms
    nothing, and the argument beats the conf key and the env var.

Every spawned worker has its own ``communicate(timeout=…)``; on expiry
every worker of the pair is killed."""

import json
import os
import socket
import struct
import subprocess
import sys

import numpy as np
import pytest

from hadoop_bam_tpu import faults as jfaults
from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.parallel import multihost as jm
from hadoop_bam_tpu_torch import faults as tfaults
from hadoop_bam_tpu_torch.conf import (
    DEFLATE_LANES,
    INFLATE_LANES,
    MESH_SPECULATE_FACTOR,
    MESH_TRACE,
    MESH_TRACE_DIR,
    SHUFFLE_COMPRESS,
    SHUFFLE_FETCH_THREADS,
    SHUFFLE_MEMBER_BYTES,
    Configuration,
)
from hadoop_bam_tpu_torch.device_stream import DeviceStream
from hadoop_bam_tpu_torch.io.fs import HttpFilesystem
from hadoop_bam_tpu_torch.ops.flate import DEV_MAX_PAYLOAD
from hadoop_bam_tpu_torch.parallel import multihost as tm
from hadoop_bam_tpu_torch.spec import bgzf
from hadoop_bam_tpu_torch.spec.bgzf import BgzfError
from hadoop_bam_tpu_torch.utils.hbm import LEDGER
from hadoop_bam_tpu_torch.utils.tracing import MetricsRegistry
from test_torch_sort_bam import _read, _write_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = 16384
N = 3000
BUDGET = 1 << 20
WORKER_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("mh") / "in.bam")
    _write_bam(p, n=N, seed=5)
    return p


@pytest.fixture(scope="module")
def oracle(src, tmp_path_factory):
    """The reference's single-host host-backend sort of ``src``,
    decompressed."""
    out = str(tmp_path_factory.mktemp("mh_oracle") / "oracle.bam")
    jpipeline.sort_bam([src], out, level=1, backend="host", split_size=SPLIT)
    return _stream(out)


@pytest.fixture
def shuffle_host(monkeypatch):
    monkeypatch.setenv("HBAM_SHUFFLE_HOST", "127.0.0.1")


def _stream(path):
    with open(path, "rb") as f:
        return bgzf.decompress_all(f.read())


def _jcounters():
    from hadoop_bam_tpu.utils.tracing import METRICS

    return dict(METRICS.report()["counters"])


def _mh(d):
    return {k: v for k, v in d.items() if k.startswith("mh.") and v}


def _port(src, out, shards=8, conf=None, **kw):
    """The port's one-process sort on ``shards`` CPU shards: ``(n, mh.*
    counters, registry)``."""
    m = MetricsRegistry()
    ctx = tm.initialize(device="cpu", shards=shards)
    assert ctx.num_processes == 1 and ctx.global_device_count == shards
    n = tm.sort_bam_multihost(src, out, ctx=ctx, conf=Configuration(conf or {}),
                              split_size=SPLIT, level=1, device="cpu", metrics=m, **kw)
    return n, _mh(m.counters()), m


def _ref(src, out, conf=None, **kw):
    """The reference's one-process sort on its 8 host devices: ``(n, mh.*
    counter deltas)``."""
    before = _jcounters()
    n = jm.sort_bam_multihost([src], out, ctx=jm.initialize(), conf=JConf(conf or {}),
                              split_size=SPLIT, level=1, **kw)
    after = _jcounters()
    return n, _mh({k: after.get(k, 0) - before.get(k, 0) for k in after})


ONE_PROCESS = {
    "fs_compressed": ({}, {}),
    "fs_raw": ({}, {SHUFFLE_COMPRESS: "false"}),
    "http_compressed": ({"byte_plane": "http"}, {}),
    "http_raw": ({"byte_plane": "http"}, {SHUFFLE_COMPRESS: "false"}),
    "budget_fs": ({"memory_budget": BUDGET}, {}),
    "budget_http": ({"memory_budget": BUDGET, "byte_plane": "http"}, {}),
    "budget_fs_raw": ({"memory_budget": BUDGET}, {SHUFFLE_COMPRESS: "false"}),
    "queryname": ({"sort_order": "queryname"}, {}),
}


@pytest.mark.parametrize("case", list(ONE_PROCESS))
def test_one_process_writes_the_reference_bytes_and_counters(src, tmp_path, shuffle_host, case):
    """(a) The same sort in one process on 8 shards: the reference's
    bytes and ``mh.*`` counter deltas (the byte and key matrices, the
    records, the store fallbacks, the queryname ranks) and its
    ``peak_bytes``, at or under the budget."""
    kw, conf = ONE_PROCESS[case]
    t_out, j_out = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    n, got, m = _port(src, t_out, conf=conf, **kw)
    peak = tm.LAST_STATS["peak_bytes"]
    jn, want = _ref(src, j_out, conf=conf, **kw)
    assert n == jn == N
    assert _read(t_out) == _read(j_out)
    assert got == want
    assert got["mh.records"] == N and got["mh.keys.sent.0"] == got["mh.keys.recv.0"]
    assert got["mh.shuffle.sent.0"] == got["mh.shuffle.recv.0"]
    assert peak == jm.LAST_STATS["peak_bytes"]
    assert m.gauges()["mh.peak_bytes"] == peak
    if "memory_budget" in kw:
        assert 0 < peak <= BUDGET
    if conf.get(SHUFFLE_COMPRESS) == "false":
        assert got["mh.shuffle.sent.0"] == got["mh.shuffle.sent_raw.0"]
    else:
        assert got["mh.shuffle.sent.0"] < got["mh.shuffle.sent_raw.0"]
    if case == "queryname":
        assert got["mh.keys.sent.0"] == 29 * N
        assert b"SO:queryname" in _stream(t_out)[:4096]


@pytest.mark.parametrize("kw", [{}, {"memory_budget": BUDGET, "byte_plane": "http"}],
                         ids=["in_core", "budget_http"])
def test_the_gates_send_the_wire_through_rows_1_and_3(src, tmp_path, shuffle_host, kw):
    """(a) With the inflate and deflate lanes armed on the CPU, the wire's
    members go through rows 1 and 3's plain versions: the reference's
    output bytes, members on the lanes, and every window given back to the
    HBM ledger."""
    conf = {INFLATE_LANES: "true", DEFLATE_LANES: "true", SHUFFLE_MEMBER_BYTES: "2048"}
    t_out, j_out = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    LEDGER._reset_for_tests()
    n, got, m = _port(src, t_out, conf=conf, **kw)
    verdict = LEDGER.assert_drained()
    jn, _ = _ref(src, j_out, **kw)
    assert n == jn == N and _read(t_out) == _read(j_out)
    c = m.counters()
    assert c["device_stream.deflates"] > 0 and c["flate.deflate.lanes"] > 0
    assert c["device_stream.decodes"] > 0
    assert c.get("flate.lanes_tierdown", 0) == 0
    assert got["mh.shuffle.sent.0"] == got["mh.shuffle.recv.0"]
    assert verdict["leaked_entries"] == 0, verdict


# ---------------------------------------------------------------------------
# (b), (c): two processes.
# ---------------------------------------------------------------------------

_PORT_WORKER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
sys.modules["jax"] = None  # the port's processes never load JAX
pid = int(sys.argv[1]); rdv = sys.argv[2]; src = sys.argv[3]; outdir = sys.argv[4]
legs = json.loads(sys.argv[5])
from hadoop_bam_tpu_torch.conf import Configuration
from hadoop_bam_tpu_torch.parallel import multihost
from hadoop_bam_tpu_torch.utils.hbm import LEDGER
from hadoop_bam_tpu_torch.utils.tracing import MetricsRegistry
ctx = multihost.initialize(init_method="file://" + rdv, num_processes=2, process_id=pid,
                           device="cpu", shards=4, timeout_s=120)
assert ctx.mesh.layout.transport == "gloo" and ctx.global_device_count == 8
for tag, kw, conf in legs:
    m = MetricsRegistry()
    n = multihost.sort_bam_multihost(src, os.path.join(outdir, tag + ".bam"), ctx=ctx,
                                     conf=Configuration(conf), split_size={split}, level=1,
                                     device="cpu", metrics=m, **kw)
    leaked = LEDGER.assert_drained()["leaked_entries"]
    c = {{k: v for k, v in m.counters().items() if k.startswith("mh.") and v}}
    print("LEG " + json.dumps({{"tag": tag, "pid": pid, "n": n, "leaked": leaked,
                               "peak": multihost.LAST_STATS["peak_bytes"], "mh": c}}),
          flush=True)
ctx.close()
print(f"MH_OK pid={{pid}}", flush=True)
"""

_REF_WORKER = r"""
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
sys.path.insert(0, {repo!r})
pid = int(sys.argv[1]); port = sys.argv[2]; src = sys.argv[3]; outdir = sys.argv[4]
legs = json.loads(sys.argv[5])
from hadoop_bam_tpu.conf import Configuration
from hadoop_bam_tpu.parallel import multihost
from hadoop_bam_tpu.utils.tracing import METRICS
ctx = multihost.initialize(f"127.0.0.1:{{port}}", num_processes=2, process_id=pid)
for tag, kw, conf in legs:
    c0 = dict(METRICS.report()["counters"])
    n = multihost.sort_bam_multihost([src], os.path.join(outdir, tag + ".bam"), ctx=ctx,
                                     conf=Configuration(conf), split_size={split}, level=1, **kw)
    c1 = dict(METRICS.report()["counters"])
    c = {{k: c1[k] - c0.get(k, 0) for k in c1 if k.startswith("mh.") and c1[k] - c0.get(k, 0)}}
    print("LEG " + json.dumps({{"tag": tag, "pid": pid, "n": n,
                               "peak": multihost.LAST_STATS["peak_bytes"], "mh": c}}), flush=True)
print(f"MH_OK pid={{pid}}", flush=True)
"""

#: The two-process legs: (tag, keyword arguments, conf).
LEGS = [
    ("fs", {}, {}),
    ("http", {"byte_plane": "http"}, {SHUFFLE_FETCH_THREADS: "1"}),
    ("budget_fs", {"memory_budget": BUDGET}, {}),
    ("budget_http", {"memory_budget": BUDGET, "byte_plane": "http"}, {}),
    ("raw_fs", {}, {SHUFFLE_COMPRESS: "false"}),
    ("queryname_http", {"sort_order": "queryname", "byte_plane": "http"}, {}),
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(argv_of, env) -> list:
    """Start two workers, wait for each with its own timeout (killing both
    on expiry), and return their outputs; a worker that fails fails the
    test."""
    procs = [subprocess.Popen(argv_of(pid), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid}:\n{o[-3000:]}"
        assert f"MH_OK pid={pid}" in o, o[-2000:]
    return outs


def _legs(outs) -> dict:
    got = {}
    for o in outs:
        for line in o.splitlines():
            if line.startswith("LEG "):
                d = json.loads(line[4:])
                got[(d["tag"], d["pid"])] = d
    return got


@pytest.fixture(scope="module")
def port_pair(src, tmp_path_factory):
    """Two port processes, 4 CPU shards each, every leg of :data:`LEGS` in
    one rendezvous: ``(output directory, {(tag, pid): leg})``."""
    outdir = str(tmp_path_factory.mktemp("mh_port_pair"))
    rdv = os.path.join(outdir, "rendezvous")
    worker = _PORT_WORKER.format(repo=REPO, split=SPLIT)
    env = dict(os.environ, HBAM_SHUFFLE_HOST="127.0.0.1", PYTHONPATH=REPO)
    outs = _run_pair(lambda pid: [sys.executable, "-c", worker, str(pid), rdv, src, outdir,
                                  json.dumps(LEGS)], env)
    return outdir, _legs(outs)


@pytest.mark.parametrize("tag", [leg[0] for leg in LEGS])
def test_two_processes_write_the_single_host_record_stream(port_pair, oracle, src, tmp_path,
                                                           tag):
    """(b) Two gloo processes, 4 CPU shards each: the single-host sort's
    record stream (queryname: the single-host queryname sort's); each
    process's sent bytes and keys equal what its peer received; budget
    runs at or under the budget; the ledger drained in each process."""
    outdir, legs = port_pair
    a, b = legs[(tag, 0)], legs[(tag, 1)]
    assert a["n"] == b["n"] == N
    if tag.startswith("queryname"):
        want = str(tmp_path / "qn.bam")
        jpipeline.sort_bam([src], want, sort_order="queryname", level=1, split_size=SPLIT)
        assert _stream(os.path.join(outdir, tag + ".bam")) == _stream(want)
        assert a["mh"]["mh.rank.names"] == b["mh"]["mh.rank.names"] == N
    else:
        assert _stream(os.path.join(outdir, tag + ".bam")) == oracle
    for me, peer, p, q in ((a, b, 0, 1), (b, a, 1, 0)):
        for plane in ("keys", "shuffle"):
            assert me["mh"][f"mh.{plane}.sent.{q}"] == peer["mh"][f"mh.{plane}.recv.{p}"], plane
        assert me["mh"][f"mh.shuffle.sent_raw.{q}"] == peer["mh"][f"mh.shuffle.recv_raw.{p}"]
        assert me["leaked"] == 0
        if tag.startswith("budget"):
            assert 0 < me["peak"] <= BUDGET
    assert a["mh"]["mh.records"] == b["mh"]["mh.records"] == N
    if tag.endswith("http"):  # the peers' files crossed the sockets
        assert a["mh"]["mh.http.bytes_served"] > 0 and b["mh"]["mh.http.bytes_served"] > 0


@pytest.fixture(scope="module")
def ref_pair(src, tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("mh_ref_pair"))
    port = _free_port()
    worker = _REF_WORKER.format(repo=REPO, split=SPLIT)
    env = dict(os.environ, HBAM_SHUFFLE_HOST="127.0.0.1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    outs = _run_pair(lambda pid: [sys.executable, "-c", worker, str(pid), str(port), src, outdir,
                                  json.dumps(LEGS)], env)
    return outdir, _legs(outs)


@pytest.mark.parametrize("tag", [leg[0] for leg in LEGS])
def test_two_processes_match_the_reference_pair(port_pair, ref_pair, tag):
    """(c) The reference's own two-process run (jax.distributed, 4 host
    devices a process) and the port's on the same input: equal bytes and
    equal ``mh.*`` counters in each process, both placing with
    ``0x5EED + pid``."""
    (t_dir, t_legs), (j_dir, j_legs) = port_pair, ref_pair
    assert _read(os.path.join(t_dir, tag + ".bam")) == _read(os.path.join(j_dir, tag + ".bam"))
    for pid in range(2):
        t, j = t_legs[(tag, pid)], j_legs[(tag, pid)]
        assert t["n"] == j["n"] and t["peak"] == j["peak"]
        assert t["mh"] == j["mh"], pid


@pytest.mark.parametrize("idents,want", [
    (["cuda/a", "cuda/b"], "nccl"),
    (["cuda/a"], "nccl"),
    (["cuda/a", "cuda/a"], "gloo"),
    (["cpu", "cpu"], "gloo"),
    (["cuda/a", "cpu"], "gloo"),
], ids=["own_cards", "one_rank", "shared_card", "host", "mixed"])
def test_the_transport_follows_the_layout(idents, want):
    """The key plane's transport comes from the ranks' devices: NCCL only
    when every rank holds a card of its own (a card cannot host two NCCL
    ranks), gloo otherwise."""
    from hadoop_bam_tpu_torch.parallel.mesh import choose_transport

    assert choose_transport(idents) == want


# ---------------------------------------------------------------------------
# (d), (e): the HTTP plane.
# ---------------------------------------------------------------------------


def test_remote_npy_ranged_slices(tmp_path, shuffle_host):
    """(d) ``_RemoteNpy`` slices an int64 ``.npy`` over ranged reads as
    ``np.load`` does, and a wrong token is refused outright."""
    arr = np.arange(10_000, dtype=np.int64) * 3 - 7
    np.save(tmp_path / "side.npy", arr)
    srv, base = tm._serve_dir(str(tmp_path), "tok")
    try:
        rn = tm._RemoteNpy(HttpFilesystem(headers={"X-Hbam-Token": "tok"}), f"{base}/side.npy")
        for i0, i1 in ((0, 1), (0, 100), (5000, 5001), (9990, 10000), (3, 3)):
            np.testing.assert_array_equal(rn.slice(i0, i1), arr[i0:i1])
        with pytest.raises(OSError):
            tm._RemoteNpy(HttpFilesystem(headers={"X-Hbam-Token": "wrong"}, retries=0),
                          f"{base}/side.npy")
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_plane_server_counters_and_fetch_retries(tmp_path, shuffle_host):
    """(e) The data server counts requests, range requests and bytes
    served into the registry it is given, exactly; a fetch from a dead
    endpoint counts each retry as ``mh.http.fetch_retries`` into the
    caller's registry (no wall-clock bound anywhere)."""
    blob = os.urandom(4096)
    (tmp_path / "payload.bin").write_bytes(blob)
    m = MetricsRegistry()
    srv, base = tm._serve_dir(str(tmp_path), "tok", metrics=m)
    try:
        fs = HttpFilesystem(headers={"X-Hbam-Token": "tok"})
        assert fs.read_all(f"{base}/payload.bin") == blob
        assert fs.read_range(f"{base}/payload.bin", 100, 200) == blob[100:300]
        assert fs.size(f"{base}/payload.bin") == 4096  # a HEAD
        with pytest.raises(OSError):  # a 403, not retried
            HttpFilesystem(headers={"X-Hbam-Token": "no"}).read_all(f"{base}/payload.bin")
    finally:
        srv.shutdown()
        srv.server_close()
    c = m.counters()
    assert (c["mh.http.requests"], c["mh.http.range_requests"],
            c["mh.http.bytes_served"]) == (4, 1, 4096 + 200)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    r = MetricsRegistry()
    flaky = HttpFilesystem(retries=2, timeout=2.0, retry_metric="mh.http.fetch_retries")
    with pytest.raises(OSError):
        flaky.read_all(f"http://127.0.0.1:{dead}/nope", metrics=r)
    assert r.counters() == {"mh.http.fetch_retries": 2}


# ---------------------------------------------------------------------------
# The wire's units and (f) the corruption drill.
# ---------------------------------------------------------------------------


def _cpu_stream(conf=None) -> DeviceStream:
    import torch

    return DeviceStream(torch.device("cpu"), conf=Configuration(conf or {}),
                        metrics=MetricsRegistry())


@pytest.mark.parametrize("lanes", [False, True], ids=["host_zlib", "rows_1_3"])
def test_member_table_roundtrip(lanes):
    """The member table follows the blocking, tiles raw and compressed
    space, and the receiver's inflate returns the input; the host tier's
    members are the reference's bytes."""
    rng = np.random.default_rng(7)
    raw = np.concatenate([np.tile(np.arange(256, dtype=np.uint8), 40),
                          rng.integers(0, 4, 2000).astype(np.uint8)])
    member = 2048
    ds = _cpu_stream({INFLATE_LANES: "true", DEFLATE_LANES: "true"} if lanes else None)
    comp, mtab = tm._deflate_member_stream(raw, ds, 1, member)
    m = mtab.reshape(-1, 4)
    assert len(m) == -(-len(raw) // member)
    assert list(m[:, 0]) == [i * member for i in range(len(m))]
    assert int(m[:, 1].sum()) == len(raw)
    assert int(m[0, 2]) == 0 and int(m[-1, 2] + m[-1, 3]) == len(comp)
    assert np.array_equal(m[1:, 2], m[:-1, 2] + m[:-1, 3])
    out, bad = tm._inflate_member_stream(np.frombuffer(comp, np.uint8), mtab, ds, None)
    assert bad == [] and np.array_equal(out, raw)
    if lanes:
        assert ds.metrics.get("device_stream.deflates") == 1
        assert ds.metrics.get("device_stream.decodes") == 1
    else:
        jcomp, jmtab = jm._deflate_member_stream(raw, None, 1, member)
        assert comp == jcomp and np.array_equal(mtab, jmtab)


def test_member_table_empty_and_cover():
    ds = _cpu_stream()
    comp, mtab = tm._deflate_member_stream(np.empty(0, np.uint8), ds, 1, 2048)
    assert comp == b"" and len(mtab) == 0
    out, bad = tm._inflate_member_stream(np.empty(0, np.uint8), mtab, ds, None)
    assert len(out) == 0 and bad == []
    m = np.array([[0, 100, 0, 50], [100, 100, 50, 60], [200, 50, 110, 30]], np.int64).reshape(-1)
    for b0, b1 in ((0, 100), (0, 101), (99, 100), (100, 200), (150, 220), (5, 5)):
        assert tm._member_cover(m, b0, b1) == jm._member_cover(m, b0, b1)
        assert tm._cover_comp_bytes(m, b0, b1) == jm._cover_comp_bytes(m, b0, b1)
    assert tm._member_cover(m, 150, 220) == (1, 3) and tm._cover_comp_bytes(m, 150, 220) == 90


def test_store_mode_fallback_on_incompressible():
    """A stream the deflate grows is stored instead, counted, exact."""
    raw = np.random.default_rng(13).integers(0, 256, 10_000).astype(np.uint8)
    ds = _cpu_stream()
    comp, mtab = tm._deflate_member_stream(raw, ds, 1, 2048)
    assert ds.metrics.counters() == {"mh.shuffle.store_fallback": 1}
    assert len(raw) < len(comp) < len(raw) + 40 * len(mtab.reshape(-1, 4))
    out, bad = tm._inflate_member_stream(np.frombuffer(comp, np.uint8), mtab, ds, None)
    assert bad == [] and np.array_equal(out, raw)
    assert comp == jm._deflate_member_stream(raw, None, 1, 2048)[0]


def test_shuffle_conf_resolution(monkeypatch):
    """The wire's keys resolve as the reference's: conf, then env, then
    the default; the member payload clamps to the codec's cap."""
    from hadoop_bam_tpu.conf import Configuration as JC

    for var in ("HBAM_SHUFFLE_COMPRESS", "HBAM_SHUFFLE_FETCH_THREADS",
                "HBAM_SHUFFLE_MEMBER_BYTES", "HBAM_MESH_SKEW_BOUND",
                "HBAM_MESH_REPARTITION_SAMPLES", "HBAM_MESH_SPECULATE_FACTOR"):
        monkeypatch.delenv(var, raising=False)
    cases = [
        ("_resolve_shuffle_compress", {}, {}),
        ("_resolve_shuffle_compress", {SHUFFLE_COMPRESS: "false"}, {}),
        ("_resolve_shuffle_compress", {}, {"HBAM_SHUFFLE_COMPRESS": "0"}),
        ("_resolve_shuffle_compress", {SHUFFLE_COMPRESS: "on"}, {"HBAM_SHUFFLE_COMPRESS": "0"}),
        ("_resolve_fetch_threads", {}, {}),
        ("_resolve_fetch_threads", {}, {"HBAM_SHUFFLE_FETCH_THREADS": "3"}),
        ("_resolve_fetch_threads", {SHUFFLE_FETCH_THREADS: "5"}, {}),
        ("_resolve_member_bytes", {}, {}),
        ("_resolve_member_bytes", {SHUFFLE_MEMBER_BYTES: "2048"}, {}),
        ("_resolve_member_bytes", {SHUFFLE_MEMBER_BYTES: str(1 << 20)}, {}),
        ("_resolve_member_bytes", {SHUFFLE_MEMBER_BYTES: "7"}, {}),
        ("_resolve_skew_bound", {}, {}),
        ("_resolve_skew_bound", {"hadoopbam.mesh.skew-bound": "0"}, {}),
        ("_resolve_skew_bound", {}, {"HBAM_MESH_SKEW_BOUND": "2.5"}),
        ("_resolve_repartition_samples", {}, {}),
        ("_resolve_repartition_samples", {}, {"HBAM_MESH_REPARTITION_SAMPLES": "64"}),
        ("_resolve_speculate_factor", {}, {}),
        ("_resolve_speculate_factor", {MESH_SPECULATE_FACTOR: "1.5"}, {}),
        ("_resolve_speculate_factor", {}, {"HBAM_MESH_SPECULATE_FACTOR": "2"}),
    ]
    for fn, conf, env in cases:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert getattr(tm, fn)(Configuration(conf)) == getattr(jm, fn)(JC(conf)), (fn, conf, env)
        for k in env:
            monkeypatch.delenv(k)
    assert tm._resolve_member_bytes(None) == DEV_MAX_PAYLOAD
    assert tm._resolve_member_bytes(Configuration({SHUFFLE_MEMBER_BYTES: "7"})) == 512


def _records_of(path):
    raw = _stream(path)
    l_text = struct.unpack_from("<I", raw, 4)[0]
    pos = 8 + l_text
    n_ref = struct.unpack_from("<I", raw, pos)[0]
    pos += 4
    for _ in range(n_ref):
        pos += 4 + struct.unpack_from("<I", raw, pos)[0] + 4
    header, recs = raw[:pos], []
    while pos < len(raw):
        sz = struct.unpack_from("<I", raw, pos)[0]
        recs.append(raw[pos : pos + 4 + sz])
        pos += 4 + sz
    return header, recs


@pytest.fixture
def corrupt_plan():
    yield "mh.corrupt:members=0,n=1"
    tfaults.disarm()
    jfaults.disarm()


def test_member_corruption_strict_raises_salvage_quarantines(src, tmp_path, corrupt_plan):
    """(f) A member corrupted in flight fails a strict sort with the
    codec's error; under ``errors="salvage"`` exactly that member is
    quarantined and the survivors are the reference's salvage run's bytes,
    with its ``salvage.*`` counts, in the clean run's order."""
    conf = {SHUFFLE_MEMBER_BYTES: "2048"}
    tfaults.arm(corrupt_plan)
    with pytest.raises(BgzfError):
        _port(src, str(tmp_path / "strict.bam"), conf=conf)
    tfaults.disarm()
    clean = str(tmp_path / "clean.bam")
    _port(src, clean, conf=conf)
    t_out, j_out = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    tfaults.arm(corrupt_plan)
    _, _, m = _port(src, t_out, conf=conf, errors="salvage")
    tfaults.disarm()
    jfaults.arm(corrupt_plan)
    before = _jcounters()
    jm.sort_bam_multihost([src], j_out, ctx=jm.initialize(), conf=JConf(conf), split_size=SPLIT,
                          level=1, errors="salvage")
    after = _jcounters()
    jfaults.disarm()
    salv = {k: v for k, v in m.counters().items() if k.startswith("salvage.")}
    want = {k: after[k] - before.get(k, 0) for k in after
            if k.startswith("salvage.") and after[k] - before.get(k, 0)}
    assert salv == want and salv["salvage.members_quarantined"] == 1
    assert salv["salvage.records_dropped"] > 0
    assert _read(t_out) == _read(j_out)
    hdr_c, recs_c = _records_of(clean)
    hdr_s, recs_s = _records_of(t_out)
    assert hdr_s == hdr_c and len(recs_s) == len(recs_c) - salv["salvage.records_dropped"]
    it = iter(recs_c)
    assert all(r in it for r in recs_s)


def test_salvage_does_not_catch_a_kernel_failure(src, tmp_path, monkeypatch, corrupt_plan):
    """(f) Salvage catches the wire's data errors by class: a failure of
    the inflate itself (a kernel or the card) propagates."""
    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tm, "_decode_wire", broken)
    tfaults.arm(corrupt_plan)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _port(src, str(tmp_path / "x.bam"), errors="salvage")


#: Each switch of speculation or the mesh trace: (name, keyword arguments,
#: conf, env); "TRACE" stands for a trace directory under the test's own.
SWITCHES = [
    ("param", {"mesh_trace": True}, {}, {}),
    ("param_dir", {"mesh_trace": True, "mesh_trace_dir": "TRACE"}, {}, {}),
    ("conf_trace", {}, {MESH_TRACE: "true"}, {}),
    ("conf_trace_dir", {}, {MESH_TRACE: "true", MESH_TRACE_DIR: "TRACE"}, {}),
    ("conf_speculate", {}, {MESH_SPECULATE_FACTOR: "3.0"}, {}),
    ("env_trace", {}, {}, {"HBAM_MESH_TRACE": "1"}),
    ("env_trace_dir", {}, {}, {"HBAM_MESH_TRACE": "1", "HBAM_MESH_TRACE_DIR": "TRACE"}),
    ("env_speculate", {}, {}, {"HBAM_MESH_SPECULATE_FACTOR": "2"}),
]


def _arm(tmp_path, monkeypatch, kw, conf, env):
    trace = str(tmp_path / "trace")
    fill = {k: trace if v == "TRACE" else v for k, v in {**kw, **conf, **env}.items()}
    for k in env:
        monkeypatch.setenv(k, fill[k])
    return ({k: fill[k] for k in kw}, Configuration({k: fill[k] for k in conf}), trace)


@pytest.mark.parametrize("how", SWITCHES, ids=lambda h: h[0])
def test_speculation_and_trace_switches_arm(src, oracle, tmp_path, monkeypatch, how):
    """(g) Each switch, by a parameter, a conf key or an env var, arms its
    piece: a trace switch writes the shard, the manifest and the cluster
    manifest (into the named directory, else beside the output), a
    speculate factor times the done markers' barrier; the output stays the
    single-host sort's."""
    name, kw, conf, env = how
    for var in ("HBAM_MESH_TRACE", "HBAM_MESH_TRACE_DIR", "HBAM_MESH_SPECULATE_FACTOR"):
        monkeypatch.delenv(var, raising=False)
    kw, conf, trace = _arm(tmp_path, monkeypatch, kw, conf, env)
    out = str(tmp_path / "x.bam")
    m = MetricsRegistry()
    n = tm.sort_bam_multihost(src, out, conf=conf, split_size=SPLIT, level=1, device="cpu",
                              metrics=m, **kw)
    assert n == N and _stream(out) == oracle
    spans = m.report()["span_seconds"]
    where = trace if name.endswith("_dir") else out + ".mesh-trace"
    if name.endswith("speculate"):
        assert "mh.barrier.parts_done" in spans
        assert not os.path.exists(where)
    else:
        assert "mh.barrier.parts_done" not in spans
        assert sorted(os.listdir(where)) == ["cluster_manifest.json", "manifest-h000.json",
                                             "trace-h000.json"]


@pytest.mark.parametrize("where", ["param", "conf", "env"])
def test_a_trace_dir_alone_arms_nothing(src, tmp_path, monkeypatch, where):
    """(g) A trace directory names a place and arms nothing, as in the
    reference: no directory, no trace, no done-marker barrier."""
    monkeypatch.delenv("HBAM_MESH_TRACE", raising=False)
    trace = str(tmp_path / "trace")
    kw, conf = {}, {}
    if where == "param":
        kw["mesh_trace_dir"] = trace
    elif where == "conf":
        conf[MESH_TRACE_DIR] = trace
    else:
        monkeypatch.setenv("HBAM_MESH_TRACE_DIR", trace)
    m = MetricsRegistry()
    tm.sort_bam_multihost(src, str(tmp_path / "x.bam"), conf=Configuration(conf),
                          split_size=SPLIT, level=1, device="cpu", metrics=m, **kw)
    assert not os.path.exists(trace) and not os.path.exists(str(tmp_path / "x.bam.mesh-trace"))
    assert not any(k.startswith("mh.barrier.trace") for k in m.report()["span_seconds"])
    assert tm._resolve_mesh_trace(Configuration(conf), None) is False
    assert jm._resolve_mesh_trace(JConf(conf), None) is False


def test_explicit_argument_beats_the_env_var(src, tmp_path, monkeypatch):
    """(g) The argument beats the conf key, which beats the env var, as the
    reference resolves them."""
    monkeypatch.setenv("HBAM_MESH_TRACE", "1")
    out = str(tmp_path / "n.bam")
    tm.sort_bam_multihost(src, out, mesh_trace=False, split_size=SPLIT, level=1, device="cpu")
    assert not os.path.exists(out + ".mesh-trace")
    off = Configuration({MESH_TRACE: "false"})
    tm.sort_bam_multihost(src, out, conf=off, split_size=SPLIT, level=1, device="cpu")
    assert not os.path.exists(out + ".mesh-trace")
    for conf, arg in (({}, None), ({}, False), ({MESH_TRACE: "false"}, None),
                      ({MESH_TRACE: "false"}, True), ({MESH_TRACE: "yes"}, None)):
        assert tm._resolve_mesh_trace(Configuration(conf), arg) == \
            jm._resolve_mesh_trace(JConf(conf), arg), (conf, arg)
    monkeypatch.setenv("HBAM_MESH_TRACE_DIR", "/env/dir")
    for conf, arg in (({}, None), ({MESH_TRACE_DIR: "/conf/dir"}, None),
                      ({MESH_TRACE_DIR: "/conf/dir"}, "/arg/dir")):
        assert tm._resolve_mesh_trace_dir(Configuration(conf), arg, out) == \
            jm._resolve_mesh_trace_dir(JConf(conf), arg, out)
    monkeypatch.delenv("HBAM_MESH_TRACE_DIR")
    assert tm._resolve_mesh_trace_dir(None, None, out) == os.path.abspath(out) + ".mesh-trace"

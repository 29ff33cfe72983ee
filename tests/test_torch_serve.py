"""The port's resident daemon (``hadoop_bam_tpu_torch/serve``) against the
reference's, on the CPU: the cache, the lane batcher, the arena, warm
views, the daemon over a UNIX socket (views, flagstat, jobs, drain),
admission and shedding, deadlines at every seam, the out-of-memory
ladder, the journal and restarts, the error codes, the observability
surface, and both wires crossed (each package's client against the
other's daemon).  The corpus is the reference's serve fixture
(``tests/test_serve.py``), sorted and indexed by the port.  Every daemon
runs with ``device="cpu"``, stops in a ``finally`` block, and every client
has a socket timeout."""

import base64
import contextlib
import io
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from hadoop_bam_tpu_torch import faults
from hadoop_bam_tpu_torch.conf import (
    SERVE_ADMISSION_TOKENS,
    SERVE_BATCH_WINDOW_MS,
    SERVE_MAX_QUEUE,
    Configuration,
)
from hadoop_bam_tpu_torch.device_stream import DeviceStream
from hadoop_bam_tpu_torch.io.bam import read_header
from hadoop_bam_tpu_torch.pipeline import sort_bam
from hadoop_bam_tpu_torch.serve import (
    BamDaemon,
    DeadlineExceededError,
    FleetLedger,
    HbmArena,
    JobLostError,
    LaneBatcher,
    LruByteCache,
    ResourceCache,
    ServeClient,
    ServeContext,
    ServeError,
    ServeShedError,
    admission,
    compile_count,
    flagstat,
    journal,
    view_blob,
    warm_kernels,
)
from hadoop_bam_tpu_torch.serve.batching import default_decode_fn
from hadoop_bam_tpu_torch.spec import bam, bgzf, indices
from hadoop_bam_tpu_torch.utils.backend import is_resource_exhausted
from hadoop_bam_tpu_torch.utils.deadline import Deadline, DeadlineExceeded
from hadoop_bam_tpu_torch.utils.tracing import METRIC_NAME_PATTERN, MetricsRegistry, delta, snapshot
from test_serve import _decode_blob_names, _oracle_names, _write_unsorted_bam

pytestmark = pytest.mark.serve

CPU = torch.device("cpu")
REGION = "chr1:100000-300000"


@pytest.fixture(scope="module")
def sorted_bam(tmp_path_factory) -> str:
    tmp = tmp_path_factory.mktemp("tserve")
    src, out = str(tmp / "unsorted.bam"), str(tmp / "sorted.bam")
    _write_unsorted_bam(src)
    sort_bam([src], out, device="cpu", backend="host")
    with open(out + ".bai", "wb") as f:
        indices.build_bai(out).save(f)
    return out


def _ctx(conf=None, with_batcher=False) -> ServeContext:
    return ServeContext.from_conf(conf, with_batcher=with_batcher, device="cpu")


@contextlib.contextmanager
def _daemon(**kw):
    """A port daemon on the CPU in a thread, on a socket in a short
    temporary directory; yields ``(daemon, thread, client)`` and always
    stops it."""
    sock_dir = tempfile.mkdtemp(prefix="hbs")
    d = BamDaemon(socket_path=os.path.join(sock_dir, "d.sock"), warmup=False, device="cpu", **kw)
    ready = threading.Event()
    t = threading.Thread(target=d.serve_forever, args=(ready,), daemon=True)
    t.start()
    try:
        assert ready.wait(30), "daemon did not come up"
        yield d, t, ServeClient(socket_path=d.socket_path, timeout=60)
    finally:
        if t.is_alive():
            try:
                ServeClient(socket_path=d.socket_path, timeout=60, retries=0).shutdown()
            except (OSError, ServeError):
                d.stop()
            t.join(timeout=60)
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# Cache: identity keys, hit/miss/stale, LRU byte budget, single flight
# ---------------------------------------------------------------------------


def test_cache_identity_hit_miss_and_mtime_invalidation(sorted_bam, tmp_path):
    path = str(tmp_path / "c.bam")
    shutil.copy(sorted_bam, path)
    shutil.copy(sorted_bam + ".bai", path + ".bai")
    reg = MetricsRegistry()
    cache = ResourceCache(budget_bytes=1 << 20, metrics=reg)
    s0 = snapshot(reg)
    h1 = cache.header(path)
    b1 = cache.bai(path)
    d = delta(s0, registry=reg)["counters"]
    assert d.get("serve.cache.miss") == 2 and "serve.cache.hit" not in d
    s0 = snapshot(reg)
    assert cache.header(path) is h1 and cache.bai(path) is b1
    d = delta(s0, registry=reg)["counters"]
    assert d.get("serve.cache.hit") == 2 and "serve.cache.miss" not in d
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    s0 = snapshot(reg)
    h2 = cache.header(path)
    d = delta(s0, registry=reg)["counters"]
    assert d.get("serve.cache.stale") == 1 and d.get("serve.cache.miss") == 1
    assert h2 is not h1 and h2[0].refs == h1[0].refs


def test_cache_lru_byte_budget_eviction(tmp_path):
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}"
        p.write_bytes(b"x")
        paths.append(str(p))
    reg = MetricsRegistry()
    cache = LruByteCache(budget_bytes=250, name="serve.cache", metrics=reg)
    for p in paths:
        cache.put("blob", p, b"v", 100)
    assert reg.get("serve.cache.evict") == 1
    assert cache.used_bytes <= 250
    assert cache.get("blob", paths[0]) is None
    assert cache.get("blob", paths[2]) == b"v"


def test_cache_stampede_single_loader_shared_result(tmp_path):
    p = tmp_path / "f"
    p.write_bytes(b"x")
    p = str(p)
    reg = MetricsRegistry()
    cache = LruByteCache(budget_bytes=1 << 20, name="serve.cache", metrics=reg)
    loads, results = [], []
    gate = threading.Event()
    barrier = threading.Barrier(9)

    def loader(path):
        loads.append(path)
        gate.wait(5)
        return object()

    def get():
        barrier.wait(10)
        results.append(cache.get_or_load("blob", p, loader, lambda v: 8))

    threads = [threading.Thread(target=get) for _ in range(8)]
    for t in threads:
        t.start()
    barrier.wait(10)
    time.sleep(0.2)
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert len(loads) == 1 and len(set(map(id, results))) == 1 and len(results) == 8
    assert reg.get("serve.cache.stampede_wait") == 7

    def boom(path):
        raise IOError("index went away")

    with pytest.raises(IOError):
        cache.get_or_load("blob2", p, boom, lambda v: 8)
    assert cache.get_or_load("blob2", p, lambda path: "v", lambda v: 8) == "v"


def test_cache_serves_every_index_kind_as_the_reference(sorted_bam, tmp_path):
    """``splitting_bai``, ``tabix`` and ``bcf_plan`` load what the
    reference's cache loads (None without a companion), counted per kind,
    and a second lookup is a hit."""
    from hadoop_bam_tpu.serve.cache import ResourceCache as JCache
    from test_torch_faults import _bcf_corpus
    from test_torch_vcf import bgzf_bytes, vcf_text, write_tbi

    bam_path = str(tmp_path / "s.bam")
    shutil.copy(sorted_bam, bam_path)
    vcf = tmp_path / "v.vcf.gz"
    vcf.write_bytes(bgzf_bytes(vcf_text()))
    bcf_path, _, _ = _bcf_corpus(tmp_path)
    reg = MetricsRegistry()
    cache, jcache = ResourceCache(metrics=reg), JCache()
    assert cache.splitting_bai(bam_path) is None and cache.tabix(str(vcf)) is None
    with open(bam_path + indices.SPLITTING_BAI_EXT, "wb") as f:
        indices.build_splitting_bai(bam_path).save(f)
    (tmp_path / "v.vcf.gz.tbi").write_bytes(write_tbi(vcf.read_bytes()))
    sb, tb = cache.splitting_bai(bam_path), cache.tabix(str(vcf))
    jsb, jtb = jcache.splitting_bai(bam_path), jcache.tabix(str(vcf))
    assert list(sb.voffsets) == list(jsb.voffsets)
    assert tb.names == jtb.names
    assert [sorted(r.bins) for r in tb.refs] == [sorted(r.bins) for r in jtb.refs]
    hdr, splits = cache.bcf_plan(bcf_path)
    jhdr, jsplits = jcache.bcf_plan(bcf_path)
    assert list(hdr.contigs) == list(jhdr.contigs)
    assert [(s.vstart, s.vend) for s in splits] == [(s.vstart, s.vend) for s in jsplits]
    assert cache.splitting_bai(bam_path) is sb and cache.bcf_plan(bcf_path)[1] is splits
    c = reg.counters()
    assert (c["serve.cache.miss.splitting-bai"], c["serve.cache.miss.tbi"],
            c["serve.cache.miss.bcf-plan"]) == (1, 1, 1)
    assert c["serve.cache.hit.splitting-bai"] == c["serve.cache.hit.bcf-plan"] == 1


# ---------------------------------------------------------------------------
# Lane batcher: concurrent requests share one launch
# ---------------------------------------------------------------------------


def _members(payload: np.ndarray, block_payload: int = 512):
    blob, _ = bgzf.deflate_blocks(payload, level=1, block_payload=block_payload)
    co, cs, us = bgzf.scan_blocks(blob)
    return np.frombuffer(blob, np.uint8), co, cs, us


def _submit_concurrently(batcher, works):
    res = [None] * len(works)

    def go(i):
        res[i] = batcher.submit(*works[i])

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(works))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    return res


def test_batcher_coalesces_two_requests_into_one_launch():
    p1 = np.frombuffer(bytes(range(256)) * 4, np.uint8)
    p2 = np.frombuffer(b"ACGT" * 256, np.uint8)
    works = [_members(p1), _members(p2)]
    b = LaneBatcher(window_s=0.25)
    try:
        res = _submit_concurrently(b, works)
    finally:
        b.close()
    d = b.metrics.counters()
    assert res[0][0].tobytes() == p1.tobytes() and res[1][0].tobytes() == p2.tobytes()
    assert res[0][1][0] == 0 and res[0][1][-1] == len(p1)
    assert res[0][2] is None  # the host tier leaves no window on a device
    assert d["serve.batch.launches"] == 1 and d["serve.batch.requests"] == 2
    assert d["serve.batch.coalesced_requests"] == 2
    assert d["serve.batch.members"] == len(works[0][1]) + len(works[1][1])


def test_batcher_shared_launch_on_device_tier():
    """With the inflate gate on, the coalesced launch is the stream's
    ``decode_members`` (here the plain version of kernel row 1 on the
    CPU): one launch, each request its own bytes and its own window."""
    stream = DeviceStream(CPU, Configuration({"hadoopbam.inflate.lanes": "true"}))
    p1 = np.frombuffer(b"serve-lane-batch!" * 32, np.uint8)
    p2 = np.frombuffer(bytes(range(128)) * 4, np.uint8)
    works = [_members(p1, 256), _members(p2, 256)]
    b = LaneBatcher(window_s=0.5, decode_fn=default_decode_fn(stream=stream),
                    metrics=stream.metrics)
    try:
        res = _submit_concurrently(b, works)
    finally:
        b.close()
    assert res[0][0].tobytes() == p1.tobytes() and res[1][0].tobytes() == p2.tobytes()
    assert res[1][2].numpy().tobytes() == p2.tobytes()
    m = stream.metrics
    assert m.get("serve.batch.launches") == 1 and m.get("serve.batch.coalesced_requests") == 2
    assert m.get("device_stream.decodes") == 1
    assert stream.inflate_stats.lanes == len(works[0][1]) + len(works[1][1])


def test_batcher_under_many_threads_hands_each_request_its_bytes():
    """More submitting threads than cores, with a short switch interval: each
    request gets its own members' bytes and offsets, and the counters add
    up (a lost update would break one of them)."""
    import sys

    rng = np.random.default_rng(5)
    works, payloads = [], []
    for i in range(24):
        p = rng.integers(0, 4, size=int(rng.integers(64, 3000)), dtype=np.uint8)
        payloads.append(p)
        works.append(_members(p, 256))
    b = LaneBatcher(window_s=0.001, max_lanes=16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        res = [None] * (3 * len(works))
        ts = [threading.Thread(target=lambda k=k: res.__setitem__(
            k, b.submit(*works[k % len(works)]))) for k in range(len(res))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        b.close()
    for k, (out, offs, _) in enumerate(res):
        p = payloads[k % len(works)]
        assert out.tobytes() == p.tobytes() and offs[0] == 0 and offs[-1] == len(p)
    m = b.metrics
    assert m.get("serve.batch.requests") == len(res)
    assert m.get("serve.batch.members") == 3 * sum(len(w[1]) for w in works)
    assert m.get("serve.batch.launches") <= len(res)


def test_batcher_error_propagates_to_all_waiters():
    def boom(raw, co, cs, us):
        raise RuntimeError("decode exploded")

    b = LaneBatcher(window_s=0.1, decode_fn=boom)
    try:
        with pytest.raises(RuntimeError, match="decode exploded"):
            b.submit(*_members(np.zeros(64, np.uint8)))
    finally:
        b.close()


# ---------------------------------------------------------------------------
# Warm-up, the view and its warmth, the arena
# ---------------------------------------------------------------------------


def test_warm_kernels_idempotent_compile_count():
    rep = warm_kernels(kinds=("overlap", "keys"), row_buckets=(64, 256), device="cpu")
    assert rep["warmed"] == {"overlap": 2, "keys": 2}
    rep2 = warm_kernels(kinds=("overlap", "keys"), row_buckets=(64, 256), device="cpu")
    assert rep2["compiles"] == 0


def test_view_matches_oracle_and_shorthand(sorted_bam):
    ctx = _ctx()
    try:
        got = set(_decode_blob_names(view_blob(ctx, sorted_bam, REGION)))
        exp = _oracle_names(sorted_bam, 0, 99_999, 300_000)
        assert got == exp and got
        assert view_blob(ctx, sorted_bam, "chr2") == view_blob(ctx, sorted_bam,
                                                              f"chr2:1-{(1 << 29) - 1}")
        names = _decode_blob_names(view_blob(ctx, sorted_bam, "chr2"))
        assert set(names) == _oracle_names(sorted_bam, 1, 0, (1 << 29) - 1)
    finally:
        ctx.close()


def test_warm_view_zero_compiles_zero_rereads(sorted_bam):
    """A warm view loads no kernel library and reads no header, index or
    window: asserted by the compile count and the cache and arena
    counters."""
    ctx = _ctx()
    try:
        cold = view_blob(ctx, sorted_bam, "chr1:200000-400000")
        c0 = compile_count()
        s0 = snapshot(ctx.metrics)
        warm = view_blob(ctx, sorted_bam, "chr1:200000-400000")
        d = delta(s0, registry=ctx.metrics)["counters"]
    finally:
        ctx.close()
    assert warm == cold and compile_count() == c0
    assert "serve.cache.miss" not in d and "serve.arena.miss" not in d, d
    assert d.get("serve.cache.hit", 0) >= 2 and d.get("serve.arena.hit", 0) >= 1


class _B:
    def __init__(self, n):
        self.data = np.zeros(n, np.uint8)
        self.soa = {}
        self.keys = None
        self.device_data = None


def test_arena_lru_eviction_and_stats():
    arena = HbmArena(budget_bytes=300)
    for k in "abc":
        arena.hold(k, _B(120))
    assert arena.metrics.get("serve.arena.evict") == 1
    assert arena.get("a") is None and arena.get("c") is not None
    st = arena.stats()
    assert st["entries"] == 2 and st["used_bytes"] <= 300
    g = arena.metrics.gauges()
    assert g["serve.arena.entries"] == 2 and g["serve.arena.budget_bytes"] == 300


def test_arena_drop_frees_the_device_window_with_the_last_reference():
    """An entry's ``device_data`` lives as long as the arena (or a caller)
    holds it: dropping the entry drops the arena's reference."""
    import gc
    import weakref

    arena = HbmArena(budget_bytes=1 << 20)
    b = _B(16)
    b.device_data = torch.zeros(16, dtype=torch.uint8)
    ref = weakref.ref(b.device_data)
    arena.hold("w", b)
    assert arena.stats()["device_resident"] == 1
    assert arena.metrics.get("serve.arena.device_resident") == 1
    del b
    gc.collect()
    assert ref() is not None
    assert arena.evict_lru() == 1 and arena.metrics.get("serve.oom.evictions") == 1
    gc.collect()
    assert ref() is None


# ---------------------------------------------------------------------------
# The daemon: round trip, coalescing, jobs, drain
# ---------------------------------------------------------------------------


def test_daemon_uds_roundtrip_byte_identical(sorted_bam):
    with _daemon() as (d, t, client):
        assert client.ping()["ok"]
        served = client.view(sorted_bam, REGION, level=6)
        ctx = _ctx()
        try:
            oneshot = view_blob(ctx, sorted_bam, REGION)
            direct_fs = flagstat(ctx, sorted_bam)
        finally:
            ctx.close()
        assert served == oneshot
        assert client.flagstat(sorted_bam) == direct_fs
        stats = client.stats()
        assert stats["metrics"]["counters"]["serve.op.view"] >= 1
        assert "cache" in stats and "arena" in stats
        with pytest.raises(ServeError, match="unknown op"):
            client._request({"op": "nonsense"})
        with pytest.raises(ServeError, match="unknown contig"):
            client.view(sorted_bam, "chrZZ:1-10")


def test_daemon_concurrent_views_share_one_launch(sorted_bam):
    conf = Configuration({SERVE_BATCH_WINDOW_MS: "200"})
    with _daemon(conf=conf) as (d, t, client):
        s0 = snapshot(d.metrics)
        res = [None, None]
        c1 = ServeClient(socket_path=d.socket_path, timeout=60)
        c2 = ServeClient(socket_path=d.socket_path, timeout=60)
        t1 = threading.Thread(target=lambda: res.__setitem__(0, c1.view(sorted_bam, REGION)))
        t2 = threading.Thread(target=lambda: res.__setitem__(
            1, c2.view(sorted_bam, "chr2:100000-300000")))
        t1.start()
        t2.start()
        t1.join(60)
        t2.join(60)
        dc = delta(s0, registry=d.metrics)["counters"]
        assert res[0] is not None and res[1] is not None
        assert dc.get("serve.batch.requests", 0) >= 2
        assert dc.get("serve.batch.coalesced_requests", 0) >= 2, dc
        assert dc["serve.batch.launches"] < dc["serve.batch.requests"]


def test_daemon_sort_job_and_graceful_drain(sorted_bam, tmp_path):
    out = str(tmp_path / "resorted.bam")
    with _daemon() as (d, t, client):
        client.sort(sorted_bam, out, level=1)
        r = client.shutdown()
        assert r["drained"] and r["jobs_total"] == 1
        assert r["jobs_done"] == 1 and r["jobs_failed"] == 0
        t.join(timeout=30)
        assert not t.is_alive()
        assert read_header(out).n_refs == 2
        with pytest.raises(OSError):
            client.ping()


def test_daemon_rejects_sort_while_draining(sorted_bam, tmp_path):
    with _daemon() as (d, t, client):
        d._draining.set()
        with pytest.raises(ServeError, match="draining"):
            client.sort(sorted_bam, str(tmp_path / "x.bam"))


def test_daemon_runs_on_the_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BamDaemon(socket_path=str(tmp_path / "x.sock"), warmup=False)


# ---------------------------------------------------------------------------
# Admission and shedding
# ---------------------------------------------------------------------------


def test_admission_tokens_queue_and_shed_reply_shape():
    ctrl = admission.AdmissionController(tokens=1, max_queue=0)
    t1 = ctrl.acquire("view")
    with pytest.raises(admission.ShedError) as ei:
        ctrl.acquire("view")
    assert ei.value.code == admission.SHED and ei.value.retry_after_ms >= 10
    assert ctrl.metrics.get("serve.admission.shed") == 1
    assert ctrl.metrics.get("serve.admission.shed.queue_full") == 1
    assert ctrl.acquire("ping") is admission.NULL_TICKET
    ctrl2 = admission.AdmissionController(tokens=1, max_queue=4)
    hold = ctrl2.acquire("view")
    got = []
    th = threading.Thread(target=lambda: got.append(ctrl2.acquire("view")))
    th.start()
    time.sleep(0.1)
    assert not got and ctrl2.gauges()["serve.admission.queue_depth"] == 1
    hold.release()
    th.join(timeout=5)
    assert got and got[0].cost == 1
    got[0].release()
    t1.release()


def test_admission_queued_deadline_expires_in_queue():
    ctrl = admission.AdmissionController(tokens=1, max_queue=4)
    hold = ctrl.acquire("view")
    with pytest.raises(DeadlineExceeded) as ei:
        ctrl.acquire("view", deadline=Deadline.after_ms(80))
    assert ei.value.seam == "admission"
    assert ctrl.metrics.get("serve.deadline.exceeded.admission") == 1
    hold.release()


def test_fleet_ledger_file_cap_pool_and_control_plane():
    """The router's ledger (``serve/router.py`` admits through it): the
    per-file cap sheds a hot file only, the pool sheds when full, and an
    op without a cost passes."""
    led = FleetLedger(tokens=64, file_tokens=2)
    key = "/hot.bam|1|1"
    r1, r2 = led.acquire("view", key), led.acquire("view", key)
    with pytest.raises(admission.ShedError) as ei:
        led.acquire("view", key)
    assert ei.value.code == admission.SHED and ei.value.retry_after_ms > 0
    r3 = led.acquire("view", "/cold.bam|1|1")
    assert led.metrics.get("fleet.admission.shed.file_hot") == 1
    assert led.metrics.get("fleet.admission.admitted") == 3
    for rel in (r1, r2, r3):
        rel()
        rel()
    assert led.gauges()["fleet.admission.tokens_in_use"] == 0
    led2 = FleetLedger(tokens=8, file_tokens=8)
    [led2.acquire("sort", f"/s{i}.bam|1|1") for i in range(2)]
    with pytest.raises(admission.ShedError):
        led2.acquire("view", "/v.bam|1|1")
    assert led2.metrics.get("fleet.admission.shed.pool_full") == 1
    led2.acquire("fleet", "/v.bam|1|1")()


def test_daemon_sheds_views_while_job_holds_tokens(sorted_bam, tmp_path):
    conf = Configuration({SERVE_ADMISSION_TOKENS: "1", SERVE_MAX_QUEUE: "0"})
    out = str(tmp_path / "shed_sorted.bam")
    faults.arm("exec.delay:items=*,attempts=0,ms=800,n=1")
    try:
        with _daemon(conf=conf) as (d, t, client):
            jid = client.sort(sorted_bam, out, level=1)
            shed_client = ServeClient(socket_path=d.socket_path, retries=0, timeout=60)
            with pytest.raises(ServeShedError) as ei:
                shed_client.view(sorted_bam, REGION)
            assert ei.value.code in (admission.SHED, admission.RETRY_AFTER)
            assert ei.value.retry_after_ms >= 10
            client.wait(jid, timeout=60)
            assert shed_client.view(sorted_bam, REGION)
            stats = client.stats()
            assert stats["metrics"]["counters"]["serve.admission.shed"] >= 1
            g = stats["gauges"]
            assert g["serve.admission.tokens"] == 1 and g["serve.admission.tokens_in_use"] == 0
    finally:
        faults.disarm()


# ---------------------------------------------------------------------------
# Deadlines at every seam
# ---------------------------------------------------------------------------


def test_deadline_expired_at_dispatch_is_typed(sorted_bam):
    with _daemon() as (d, t, client):
        with pytest.raises(DeadlineExceededError):
            client.view(sorted_bam, REGION, deadline_ms=0)
        assert client.stats()["metrics"]["counters"].get("serve.op.view", 0) == 0
        with pytest.raises(DeadlineExceededError):
            client._request({"op": "view", "path": sorted_bam, "region": REGION,
                             "deadline_ms": 0})
        cnt = client.stats()["metrics"]["counters"]
        assert cnt["serve.deadline.exceeded"] >= 1
        assert cnt["serve.deadline.exceeded.dispatch"] >= 1


def test_deadline_batcher_seam_never_burns_a_launch():
    p = np.frombuffer(b"deadline-batch" * 16, np.uint8)
    work = _members(p)
    b = LaneBatcher(window_s=0.3)
    try:
        with pytest.raises(DeadlineExceeded) as ei:
            b.submit(*work, deadline=Deadline.after_ms(0))
        assert ei.value.seam == "batcher"
        with pytest.raises(DeadlineExceeded):
            b.submit(*work, deadline=Deadline.after_ms(30))
    finally:
        b.close()
    d = b.metrics.counters()
    assert d["serve.deadline.exceeded.batcher"] == 2 and "serve.batch.launches" not in d
    b2 = LaneBatcher(window_s=0.0)
    try:
        out, _, _ = b2.submit(*work, deadline=Deadline.after_ms(60_000))
        assert out.tobytes() == p.tobytes()
    finally:
        b2.close()


def test_deadline_executor_seam_terminal_not_retried(tmp_path):
    from hadoop_bam_tpu_torch.parallel.executor import ElasticExecutor
    from hadoop_bam_tpu_torch.utils.tracing import Metrics

    calls = []

    def work(item, tmp):
        calls.append(item)
        with open(tmp, "wb") as f:
            f.write(bgzf.compress_block(b"x"))

    m = Metrics()
    ex = ElasticExecutor(str(tmp_path / "out"), max_attempts=3, deadline=Deadline.after_ms(0),
                         metrics=m)
    with pytest.raises(DeadlineExceeded) as ei:
        ex.run([0, 1], work)
    assert ei.value.seam == "executor" and calls == []
    assert m.get("executor.deadline_exceeded") >= 1

    def slow(item, tmp):
        time.sleep(5.0)

    ex2 = ElasticExecutor(str(tmp_path / "out2"), max_attempts=3, attempt_timeout=30.0,
                          deadline=Deadline.after_ms(200))
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded):
        ex2.run([0], slow)
    assert time.monotonic() - t0 < 5.0


def test_deadline_endpoint_seam_and_sort_job(sorted_bam, tmp_path):
    ctx = _ctx()
    try:
        with pytest.raises(DeadlineExceeded) as ei:
            view_blob(ctx, sorted_bam, REGION, deadline=Deadline.after_ms(0))
        assert ei.value.seam == "endpoint"
        assert ctx.metrics.get("serve.deadline.exceeded.endpoint") == 1
    finally:
        ctx.close()
    with _daemon() as (d, t, client):
        out = str(tmp_path / "dl_sorted.bam")
        faults.arm("exec.delay:items=*,attempts=*,ms=400,n=*")
        try:
            jid = client.sort(sorted_bam, out, level=1, deadline_ms=150)
            with pytest.raises(DeadlineExceededError):
                client.wait(jid, timeout=60)
        finally:
            faults.disarm()
        assert client.ping()["ok"]


# ---------------------------------------------------------------------------
# The out-of-memory ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("err,want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (faults.InjectedResourceExhausted("x"), True),
    (MemoryError("host"), False),
    (RuntimeError("CUDA error: an illegal memory access"), False),
], ids=["cuda_oom", "injected", "host_memory_error", "runtime_error"])
def test_is_resource_exhausted_classifies_only_card_oom(err, want):
    assert is_resource_exhausted(err) is want


def test_oom_evict_retry_then_tierdown_byte_exact(sorted_bam):
    oracle_ctx = _ctx()
    try:
        oracle = view_blob(oracle_ctx, sorted_bam, REGION)
    finally:
        oracle_ctx.close()
    ctx = _ctx(Configuration({SERVE_BATCH_WINDOW_MS: "1"}), with_batcher=True)
    try:
        view_blob(ctx, sorted_bam, "chr2:100000-300000")
        assert len(ctx.arena) >= 1
        faults.arm("arena.oom:n=1")
        s0 = snapshot(ctx.metrics)
        try:
            blob = view_blob(ctx, sorted_bam, REGION)
        finally:
            faults.disarm()
        d = delta(s0, registry=ctx.metrics)["counters"]
        assert blob == oracle
        assert d["serve.oom.evictions"] == 1 and "serve.oom.tierdowns" not in d
        assert d["faults.fired.arena.oom"] == 1
        ctx.arena.release_all()
        faults.arm("arena.oom:n=*")
        s0 = snapshot(ctx.metrics)
        try:
            blob = view_blob(ctx, sorted_bam, REGION)
        finally:
            faults.disarm()
        d = delta(s0, registry=ctx.metrics)["counters"]
        assert blob == oracle and d["serve.oom.tierdowns"] == 1
    finally:
        ctx.close()


def test_a_kernel_failure_is_an_error_reply_not_an_oom(sorted_bam, monkeypatch):
    """A decode that fails for another reason than memory raises to the
    request (an error reply); the ladder does not run and the daemon
    answers the next request."""
    from hadoop_bam_tpu_torch.serve import batching

    def broken(stream=None):
        def decode(raw, co, cs, us):
            raise RuntimeError("kernel launch failed")
        return decode

    monkeypatch.setattr(batching, "default_decode_fn", broken)
    with _daemon() as (d, t, client):
        with pytest.raises(ServeError, match="kernel launch failed"):
            client.view(sorted_bam, REGION)
        counters = client.stats()["metrics"]["counters"]
        assert "serve.oom.tierdowns" not in counters and "serve.oom.evictions" not in counters
        assert counters["serve.request_errors"] == 1
        assert client.ping()["ok"]


# ---------------------------------------------------------------------------
# The journal and restarts
# ---------------------------------------------------------------------------


def test_journal_append_replay_and_torn_tail(tmp_path, sorted_bam):
    path = str(tmp_path / "in.bam")
    shutil.copy(sorted_bam, path)
    jpath = str(tmp_path / "jobs.jsonl")
    j = journal.JobJournal(jpath)
    ident = journal.input_identity([path])
    j.submit("job-0001", {"bam": path, "output": "/o1"}, ident)
    j.state("job-0001", "running")
    j.state("job-0001", "done", stats={"n_records": 7})
    j.submit("job-0002", {"bam": path, "output": "/o2", "part_dir": str(tmp_path / "parts")},
             ident)
    j.state("job-0002", "running")
    j.close()
    assert j.metrics.get("serve.journal.appends") == 5
    jobs = journal.replay(jpath)
    assert jobs["job-0001"]["status"] == "done" and jobs["job-0001"]["stats"] == {"n_records": 7}
    assert jobs["job-0002"]["status"] == "running"
    assert journal.recovery_plan(jobs) == {"job-0002": "resume"}
    with open(jpath, "ab") as f:
        f.write(b'{"v":1,"event":"state","job":"job-0002","sta')
    reg = MetricsRegistry()
    assert journal.replay(jpath, reg) == jobs
    assert reg.get("serve.journal.torn_tail") == 1
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert journal.recovery_plan(journal.replay(jpath), reg) == {"job-0002": "lost"}
    assert reg.get("serve.journal.stale") == 1


def test_journal_replay_matches_the_reference(tmp_path, sorted_bam):
    """Both packages' journals are one format: each replays the other's."""
    from hadoop_bam_tpu.serve import journal as jjournal

    for write, read in ((journal, jjournal), (jjournal, journal)):
        jpath = str(tmp_path / f"{write.__name__.split('.')[0]}.jsonl")
        j = write.JobJournal(jpath)
        j.submit("job-0001", {"bam": sorted_bam, "output": "/o"},
                 write.input_identity([sorted_bam]))
        j.state("job-0001", "failed", error="boom")
        j.close()
        assert read.replay(jpath) == write.replay(jpath)


def test_daemon_restart_reports_terminal_states_and_job_lost(sorted_bam, tmp_path):
    jpath = str(tmp_path / "daemon.jsonl")
    out = str(tmp_path / "j_sorted.bam")
    with _daemon(journal_path=jpath) as (d, t, client):
        jid = client.sort(sorted_bam, out, level=1)
        st = client.wait(jid, timeout=60)
        assert st["status"] == "done"
    with _daemon(journal_path=jpath) as (d2, t2, client2):
        replayed = client2.job(jid)
        assert replayed["status"] == "done"
        assert replayed["stats"]["n_records"] == st["stats"]["n_records"]
        with pytest.raises(JobLostError):
            client2.job("job-9999")
        with pytest.raises(JobLostError):
            client2.wait("job-9999", timeout=10)


def test_daemon_restart_marks_unresumable_job_lost(sorted_bam, tmp_path):
    jpath = str(tmp_path / "lost.jsonl")
    j = journal.JobJournal(jpath)
    j.submit("job-0001", {"bam": sorted_bam, "output": str(tmp_path / "never.bam")},
             journal.input_identity([sorted_bam]))
    j.state("job-0001", "running")
    j.close()
    with _daemon(journal_path=jpath) as (d, t, client):
        assert client.job("job-0001")["status"] == "lost"
        with pytest.raises(JobLostError):
            client.wait("job-0001", timeout=10)
        jid = client.sort(sorted_bam, str(tmp_path / "next.bam"), level=1)
        assert jid != "job-0001"
        client.wait(jid, timeout=60)


def test_daemon_restart_resumes_a_part_dir_job_byte_identical(sorted_bam, tmp_path):
    """An interrupted job with a ``part_dir`` and unchanged inputs is
    resumed at restart and writes the bytes of an uninterrupted sort."""
    want = str(tmp_path / "want.bam")
    sort_bam(sorted_bam, want, device="cpu", level=1)
    jpath = str(tmp_path / "resume.jsonl")
    out = str(tmp_path / "resumed.bam")
    j = journal.JobJournal(jpath)
    j.submit("job-0007", {"bam": sorted_bam, "output": out, "level": 1,
                          "part_dir": str(tmp_path / "parts")},
             journal.input_identity([sorted_bam]))
    j.state("job-0007", "running")
    j.close()
    with _daemon(journal_path=jpath) as (d, t, client):
        st = client.wait("job-0007", timeout=60)
        assert st["status"] == "done"
        assert client.stats()["metrics"]["counters"]["serve.journal.resumed"] == 1
        assert client.sort(sorted_bam, str(tmp_path / "n.bam"), level=1) == "job-0008"
    with open(out, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_signal_drain_requests_same_path_as_shutdown(sorted_bam, tmp_path):
    out = str(tmp_path / "sig_sorted.bam")
    with _daemon() as (d, t, client):
        client.sort(sorted_bam, out, level=1)
        d._drain_requested.set()
        t.join(timeout=30)
        assert not t.is_alive()
        with pytest.raises(OSError):
            client.ping()
        assert read_header(out).n_refs == 2
        assert d.metrics.get("serve.drains") == 1


# ---------------------------------------------------------------------------
# Error codes, metric names, the observability surface
# ---------------------------------------------------------------------------


def test_error_codes_round_trip_client_server():
    from hadoop_bam_tpu_torch.serve.client import _CODE_ERRORS, error_from_reply

    assert set(_CODE_ERRORS) == set(admission.ERROR_CODES)
    for code in admission.ERROR_CODES:
        e = error_from_reply({"ok": False, "code": code, "error": "x", "retry_after_ms": 7})
        assert isinstance(e, ServeError) and type(e) is not ServeError and e.code == code
    e = error_from_reply({"ok": False, "code": admission.SHED, "error": "x",
                          "retry_after_ms": 123})
    assert isinstance(e, ServeShedError) and e.retry_after_ms == 123
    assert type(error_from_reply({"ok": False, "error": "x"})) is ServeError


def test_new_metric_names_match_dotted_lowercase_rule(sorted_bam):
    """Every counter, histogram and gauge a daemon run leaves obeys the
    dotted-lowercase rule."""
    import re

    pat = re.compile(METRIC_NAME_PATTERN)
    with _daemon() as (d, t, client):
        client.view(sorted_bam, REGION)
        client.flagstat(sorted_bam)
        with pytest.raises(DeadlineExceededError):
            client._request({"op": "view", "path": sorted_bam, "region": REGION,
                             "deadline_ms": 0})
        rep = d.metrics.report()
    names = list(rep["counters"]) + list(rep["histograms"]) + list(rep["gauges"])
    assert len(names) > 20
    for name in names:
        assert pat.match(name), name


def test_daemon_latency_histograms_gauges_and_prometheus(sorted_bam):
    with _daemon() as (d, t, client):
        for _ in range(3):
            client.view(sorted_bam, REGION, level=1)
        stats = client.stats()
        h = stats["metrics"]["histograms"]["serve.op.view.ms"]
        assert h["count"] >= 3 and 0 < h["p50"] <= h["p95"] <= h["p99"]
        assert sum(h["buckets"].values()) == h["count"]
        g = stats["gauges"]
        assert g["serve.arena.entries"] >= 1 and g["serve.arena.used_bytes"] > 0
        assert g["serve.cache.entries"] >= 1 and g["serve.jobs.running"] == 0
        assert g["serve.batch.queue_depth"] == 0
        assert g["serve.jobs.max_inflight"] == d.max_inflight
        assert stats["metrics"]["counters"]["serve.op.view"] >= 3
        text = client.metrics()
        assert "hbam_serve_op_view_total" in text
        assert 'hbam_serve_op_view_ms_bucket{le="+Inf"}' in text
        assert "hbam_serve_op_view_ms_sum" in text and "hbam_serve_arena_used_bytes" in text
        for line in text.strip().splitlines():
            if line.startswith("#"):
                continue
            name, value = line.rsplit(" ", 1)
            assert name and float(value) >= 0


# ---------------------------------------------------------------------------
# The wires crossed: each package's client against the other's daemon
# ---------------------------------------------------------------------------

#: Counters left out of the comparison: a "compile" is an XLA compile in
#: the reference and a kernel library load in the port (none on the CPU),
#: and ``job`` polls follow the job's wall time.
NOT_COMPARED = ("serve.jit_compiles", "serve.op.job")


def _sequence(client_mod, sock, sorted_bam, bcf_path, tmp, arm, disarm):
    """ping, view, flagstat, depth, variants, a sort job, a deadline
    refusal, a shed, stats: the replies without their latency fields."""
    c = client_mod.ServeClient(socket_path=sock, timeout=60)
    out = {"ping": sorted(k for k in c.ping() if k not in ("pid", "trace_id"))}
    out["view"] = c.view(sorted_bam, REGION, level=1)
    out["flagstat"] = c.flagstat(sorted_bam)
    out["depth"] = c.depth(sorted_bam, REGION, bin_size=10_000)
    out["variants"] = c.variants(bcf_path, "chr1:500-4000")
    jid = c.sort(sorted_bam, str(tmp / "job.bam"), level=1)
    st = c.wait(jid, timeout=60)
    out["job"] = (st["status"], st["stats"])
    out["job_bytes"] = (tmp / "job.bam").read_bytes()
    try:
        c._request({"op": "view", "path": sorted_bam, "region": REGION, "deadline_ms": 0})
    except client_mod.ServeError as e:
        out["deadline"] = e.code
    arm("exec.delay:items=*,attempts=0,ms=800,n=1")
    try:
        jid = c.sort(sorted_bam, str(tmp / "job2.bam"), level=1)
        try:
            client_mod.ServeClient(socket_path=sock, retries=0, timeout=60).view(sorted_bam,
                                                                                 REGION)
        except client_mod.ServeError as e:
            out["shed"] = (e.code, e.retry_after_ms > 0)
        c.wait(jid, timeout=60)
    finally:
        disarm()
    counters = c.stats()["metrics"]["counters"]
    out["counters"] = {k: v for k, v in counters.items()
                       if k.startswith("serve.") and not k.startswith(NOT_COMPARED)}
    c.shutdown()
    return out


def _serve_in_thread(daemon):
    ready = threading.Event()
    t = threading.Thread(target=daemon.serve_forever, args=(ready,), daemon=True)
    t.start()
    assert ready.wait(60)
    return t


@pytest.mark.parametrize("direction", ["reference_client_port_daemon",
                                       "port_client_reference_daemon"])
def test_the_wires_crossed_give_equal_replies(sorted_bam, tmp_path, direction):
    """The same request sequence through each package's client against the
    other's daemon: view and variants bytes, flagstat and depth dicts, the
    job's bytes and status, the error codes, and the ``stats`` op's
    ``serve.*`` counters equal, request for request, against the sequence
    through the reference's client to the reference's daemon."""
    from hadoop_bam_tpu import faults as jfaults
    from hadoop_bam_tpu.conf import Configuration as JConf
    from hadoop_bam_tpu.serve import BamDaemon as JDaemon
    from hadoop_bam_tpu.serve import client as jclient
    from hadoop_bam_tpu_torch.serve import client as tclient
    from test_torch_faults import _bcf_corpus

    bcf_path, _, _ = _bcf_corpus(tmp_path)
    conf = {SERVE_ADMISSION_TOKENS: "1", SERVE_MAX_QUEUE: "0"}
    sock_dir = tempfile.mkdtemp(prefix="hbx")
    runs = {}
    try:
        for name, make, client_mod, arm, disarm in (
            ("reference", lambda s: JDaemon(conf=JConf(conf), socket_path=s, warmup=False),
             jclient, jfaults.arm, jfaults.disarm),
            ("crossed", (lambda s: BamDaemon(conf=Configuration(conf), socket_path=s,
                                             warmup=False, device="cpu"))
             if direction.endswith("port_daemon")
             else (lambda s: JDaemon(conf=JConf(conf), socket_path=s, warmup=False)),
             jclient if direction.startswith("reference_client") else tclient,
             faults.arm if direction.endswith("port_daemon") else jfaults.arm,
             faults.disarm if direction.endswith("port_daemon") else jfaults.disarm),
        ):
            sock = os.path.join(sock_dir, f"{name}.sock")
            daemon = make(sock)
            t = _serve_in_thread(daemon)
            work = tmp_path / name
            work.mkdir()
            try:
                runs[name] = _sequence(client_mod, sock, sorted_bam, bcf_path, work, arm, disarm)
            finally:
                if t.is_alive():
                    daemon.stop()
                t.join(timeout=60)
            assert not t.is_alive()
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    want, got = runs["reference"], runs["crossed"]
    assert got["view"] == want["view"] and got["variants"] == want["variants"]
    assert len(base64.b64encode(got["view"])) > 0
    for key in ("ping", "flagstat", "depth", "job", "job_bytes", "deadline", "shed"):
        assert got[key] == want[key], key
    assert want["deadline"] == "DEADLINE_EXCEEDED" and want["shed"][0] in ("SHED", "RETRY_AFTER")
    assert got["counters"] == want["counters"]


def _tail_layout_bam(tmp_path):
    """A sorted BAM whose 16 kbp window 1 (chr1:16,385-32,768) holds only a
    placed unmapped read that the sort's hash key puts after every mapped
    record, with mapped reads in window 2: the unmapped read's name is the
    first whose key lands it in the tail."""
    from hadoop_bam_tpu_torch.io.bam import read_header_voffset, read_virtual_range

    hdr = bam.BamHeader("@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:chr1\tLN:1000000",
                        [("chr1", 1_000_000)])
    mapped = [bam.build_record(name=f"m{i}", refid=0, pos=33_000 + 40 * i, mapq=60, flag=0,
                               cigar=[(50, "M")], seq="A" * 50, qual=bytes([30] * 50))
              for i in range(6)]
    for k in range(64):
        unm = bam.build_record(name=f"u{k}", refid=0, pos=20_000, mapq=0, flag=bam.FLAG_UNMAPPED,
                               cigar=[], seq="C" * 50, qual=bytes([30] * 50))
        src, out = str(tmp_path / f"t{k}.bam"), str(tmp_path / f"s{k}.bam")
        buf = io.BytesIO()
        w = bgzf.BgzfWriter(buf, level=1, append_terminator=True)
        w.write(hdr.encode())
        for r in [unm] + mapped:
            w.write(r)
        w.close()
        with open(src, "wb") as f:
            f.write(buf.getvalue())
        sort_bam(src, out, device="cpu", level=1)
        with open(out, "rb") as f:
            data = f.read()
        v0 = read_header_voffset(out)[1]
        flags = read_virtual_range(data, v0, 1 << 62, with_keys=False, fields=("flag",)).soa["flag"]
        if flags[-1] & bam.FLAG_UNMAPPED:
            with open(out + ".bai", "wb") as f:
                indices.build_bai(out).save(f)
            return out
    raise AssertionError("no name put the unmapped read in the tail")


def test_a_view_misses_mapped_records_behind_a_tail_linear_offset_as_the_reference(tmp_path):
    """A reference behavior the port keeps: the sort puts placed unmapped
    reads in a hash-ordered tail, so a 16 kbp window whose only record is
    such a read gets a linear-index offset in the tail, and a view starting
    in that window clips the mapped records of the next window away.  The
    port's view is the reference's, and both miss them."""
    from hadoop_bam_tpu.conf import Configuration as JConf
    from hadoop_bam_tpu.serve import endpoints as jend

    path = _tail_layout_bam(tmp_path)
    region = "chr1:20001-40000"
    ctx = _ctx()
    try:
        got = view_blob(ctx, path, region)
    finally:
        ctx.close()
    want = jend.view_blob(jend.ServeContext.from_conf(JConf(), with_batcher=False), path, region)
    assert got == want
    names = _decode_blob_names(got)
    assert len(names) == 1 and names[0].startswith("u")  # the unmapped read alone
    assert set(_oracle_names(path, 0, 20_000, 40_000)) >= {f"m{i}" for i in range(6)}
    assert _decode_blob_names(view_blob(_ctx(), path, "chr1:32769-40000")) == [
        f"m{i}" for i in range(6)]

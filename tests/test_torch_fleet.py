"""The port's fleet (``hadoop_bam_tpu_torch/serve/fleet.py`` and
``router.py``, the daemon's membership, ``adopt`` and ``warmth``) against
the reference's, on the CPU: the ring, file keys, death verdicts, member
records, the heartbeater, the client's retry backoff, stale windows,
journal adoption, the router's placement, folding, adoption and aliases,
successor retry, planned leaves, eager burial, warmth migration, and the
packages crossed: the same ring owners, either router over the other's
daemons, journals adopted and windows installed both ways.

Every daemon runs with ``device="cpu"`` on a socket in a short temporary
directory, with its fleet directory, journal and flight recorder under the
test's ``tmp_path``; membership is driven with ``router.scan_members()``
and heartbeat timeouts far above the heartbeat, so no assertion rests on
the timing of the heartbeat thread.  Tolerances: exact bytes, equal dicts,
and the reference's ``fleet.*`` / ``serve.adopt.*`` counter deltas."""

import base64
import contextlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from hadoop_bam_tpu_torch import serve as tserve
from hadoop_bam_tpu_torch.conf import (
    FLEET_DIR,
    FLEET_HEARTBEAT_MS,
    FLEET_NAME,
    SERVE_FLIGHTREC_CADENCE_MS,
    Configuration,
)
from hadoop_bam_tpu_torch.ops import flate
from hadoop_bam_tpu_torch.pipeline import sort_bam
from hadoop_bam_tpu_torch.serve import (
    BamDaemon,
    FleetRouter,
    HashRing,
    ServeClient,
    ServeConnectionError,
    ServeError,
)
from hadoop_bam_tpu_torch.serve import fleet as fleet_mod
from hadoop_bam_tpu_torch.serve import journal as journal_mod
from hadoop_bam_tpu_torch.spec import indices
from hadoop_bam_tpu_torch.utils.tracing import RequestContext, delta, request_scope, snapshot
from test_serve import _write_unsorted_bam

pytestmark = [pytest.mark.serve, pytest.mark.fleet]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGION = "chr1:100000-300000"
#: A router heartbeat timeout far above the members' 100 ms heartbeat: a
#: live member never goes stale under load; deaths are staged records.
TIMEOUT_MS = 60_000.0


@pytest.fixture(scope="module")
def sorted_bam(tmp_path_factory) -> str:
    tmp = tmp_path_factory.mktemp("tfleet")
    src, out = str(tmp / "unsorted.bam"), str(tmp / "sorted.bam")
    _write_unsorted_bam(src)
    sort_bam([src], out, device="cpu", backend="host")
    with open(out + ".bai", "wb") as f:
        indices.build_bai(out).save(f)
    return out


@pytest.fixture()
def sock_dir():
    """A short directory for UNIX sockets (a path must stay under 108 bytes)."""
    d = tempfile.mkdtemp(prefix="hbf")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _copy_bam(src: str, dst: str) -> str:
    shutil.copyfile(src, dst)
    shutil.copyfile(src + ".bai", dst + ".bai")
    return dst


def _serve(daemon):
    ready = threading.Event()
    t = threading.Thread(target=daemon.serve_forever, args=(ready,), daemon=True)
    t.start()
    assert ready.wait(60), "did not come up"
    return t


def _stop(client, daemon, t) -> None:
    if t.is_alive():
        try:
            client.shutdown()
        except (OSError, ServeError):
            daemon.stop()
        t.join(timeout=60)
    assert not t.is_alive()


@contextlib.contextmanager
def _daemons(sock_dir, tmp_path, names, fdir=None, make=None):
    """Port daemons (or ``make(name, sock, conf_dict, journal)``'s) in
    threads, fleet members of ``fdir`` when given; yields ``{name: (daemon,
    client)}`` and always stops them."""
    started = {}
    try:
        for name in names:
            sock = os.path.join(sock_dir, f"{name}.sock")
            conf = {FLEET_DIR: fdir, FLEET_NAME: name, FLEET_HEARTBEAT_MS: "100"} if fdir else {}
            journal = str(tmp_path / f"{name}.jsonl")
            d = (make(name, sock, conf, journal) if make is not None else
                 BamDaemon(conf=Configuration(conf), socket_path=sock, warmup=False,
                           device="cpu", journal_path=journal))
            started[name] = (d, _serve(d), ServeClient(socket_path=sock, timeout=120))
        yield {n: (d, c) for n, (d, _, c) in started.items()}
    finally:
        for d, t, c in started.values():
            _stop(c, d, t)


@contextlib.contextmanager
def _router(sock_dir, fdir, cls=FleetRouter, **kw):
    router = cls(fleet_dir=fdir, socket_path=os.path.join(sock_dir, "router.sock"), **kw)
    t = _serve(router)
    try:
        yield router, ServeClient(socket_path=router.socket_path, timeout=120)
    finally:
        router.stop()
        t.join(timeout=60)
    assert not t.is_alive()


def _wait_job(client, jid, timeout=120.0) -> dict:
    deadline = time.time() + timeout
    while time.time() < deadline:
        jr = client._request({"op": "job", "id": jid}, idempotent=True)
        if jr["status"] in ("done", "failed", "lost"):
            return jr
        time.sleep(0.05)
    raise AssertionError(f"job {jid} never ended: {jr}")


def _counters(reg, s0, prefixes) -> dict:
    return {k: v for k, v in delta(s0, registry=reg)["counters"].items()
            if k.startswith(prefixes)}


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


def test_ring_is_deterministic_across_instances():
    members = ("alpha", "bravo", "charlie", "delta")
    keys = [f"/data/run{i}.bam|{1000 + i}|{i * 7}" for i in range(200)]
    r1, r2 = HashRing(members), HashRing(members)
    assert [r1.owner(k) for k in keys] == [r2.owner(k) for k in keys]
    shares = r1.shares()
    assert set(shares) == set(members)
    assert abs(sum(shares.values()) - 1.0) < 1e-9
    for k in keys[:20]:
        owners = r1.owners(k, n=2)
        assert owners[0] == r1.owner(k) and len(set(owners)) == 2


def test_ring_removal_moves_only_the_dead_members_keys():
    members = ("alpha", "bravo", "charlie", "delta")
    keys = [f"/data/s{i}.bam|{i}|{i}" for i in range(500)]
    ring = HashRing(members)
    before = {k: ring.owner(k) for k in keys}
    ring.remove("charlie")
    after = {k: ring.owner(k) for k in keys}
    for k in keys:
        if before[k] != "charlie":
            assert after[k] == before[k]
        else:
            assert after[k] != "charlie"
    fresh = HashRing(("alpha", "bravo", "delta"))
    assert after == {k: fresh.owner(k) for k in keys}
    assert HashRing().owner("x") is None and HashRing(("a",)).successor("a") is None
    with pytest.raises(ValueError):
        HashRing(vnodes=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_owners_equal_the_reference(seed):
    """Seeded member sets, vnode counts and file keys: the same owner,
    preference list, successor and shares from both packages' rings."""
    import numpy as np
    from hadoop_bam_tpu.serve import HashRing as JRing
    from hadoop_bam_tpu.serve import fleet as jfleet

    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    members = tuple(f"daemon-{int(x)}" for x in rng.integers(0, 1 << 30, n))
    vnodes = int(rng.choice([1, 7, 64]))
    keys = [f"/data/{int(x):x}.bam|{int(y)}|{int(z)}"
            for x, y, z in rng.integers(0, 1 << 40, (300, 3))]
    t, j = HashRing(members, vnodes=vnodes), JRing(members, vnodes=vnodes)
    assert [t.owner(k) for k in keys] == [j.owner(k) for k in keys]
    assert [t.owners(k, n=3) for k in keys] == [j.owners(k, n=3) for k in keys]
    assert [t.successor(m) for m in members] == [j.successor(m) for m in members]
    assert t.shares() == j.shares()
    gone = members[int(rng.integers(0, n))]
    t.remove(gone)
    j.remove(gone)
    assert [t.owner(k) for k in keys] == [j.owner(k) for k in keys]
    assert [fleet_mod.stable_hash(k) for k in keys] == [jfleet.stable_hash(k) for k in keys]


def test_file_key_tracks_cache_identity(tmp_path):
    from hadoop_bam_tpu.serve import fleet as jfleet

    p = str(tmp_path / "a.bam")
    with open(p, "wb") as f:
        f.write(b"x" * 10)
    k1 = fleet_mod.file_key(p)
    assert k1 == jfleet.file_key(p)
    st = os.stat(p)
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    k2 = fleet_mod.file_key(p)
    assert k1 != k2 and k2 == jfleet.file_key(p)
    missing = str(tmp_path / "missing.bam")
    assert fleet_mod.file_key(missing) == missing


# ---------------------------------------------------------------------------
# Death forensics
# ---------------------------------------------------------------------------


def _write_ring(base: str, lines) -> None:
    with open(base + ".0", "w") as f:
        for ln in lines:
            f.write(ln if ln.endswith("\n") else ln + "\n")


def _snap(seq: int, final: bool = False) -> str:
    return json.dumps({"seq": seq, "final": final, "t_wall": 1000.0 + seq})


def _both_verdicts(base):
    from hadoop_bam_tpu.serve import fleet as jfleet

    v = fleet_mod.classify_death(base)
    assert v == jfleet.classify_death(base)
    assert fleet_mod.should_adopt(v["verdict"]) == jfleet.should_adopt(v["verdict"])
    return v


def test_classify_death_clean_shutdown_no_adopt(tmp_path):
    base = str(tmp_path / "flight")
    _write_ring(base, [_snap(0), _snap(1), _snap(2, final=True)])
    v = _both_verdicts(base)
    assert v["verdict"] == "clean" and v["snapshots"] == 3
    assert not fleet_mod.should_adopt(v["verdict"])


def test_classify_death_truncated_final_record_adopts(tmp_path):
    base = str(tmp_path / "flight")
    final = _snap(3, final=True)
    _write_ring(base, [_snap(0), _snap(1), _snap(2)])
    with open(base + ".0", "a") as f:
        f.write(final[: len(final) // 2])
    v = _both_verdicts(base)
    assert v["verdict"] == "unclean" and v["snapshots"] == 3 and v["torn"] >= 1
    assert fleet_mod.should_adopt(v["verdict"])


def test_classify_death_missing_ring_is_unknown_and_adopts(tmp_path):
    v = _both_verdicts(str(tmp_path / "never-written"))
    assert v["verdict"] == "unknown" and fleet_mod.should_adopt(v["verdict"])
    v = _both_verdicts(None)
    assert v["verdict"] == "unknown" and fleet_mod.should_adopt("unknown")


def test_classify_death_unparseable_ring_is_unclean(tmp_path):
    base = str(tmp_path / "flight")
    _write_ring(base, ["{torn json", "also not json"])
    v = _both_verdicts(base)
    assert v["verdict"] == "unclean" and v["snapshots"] == 0
    assert fleet_mod.should_adopt(v["verdict"])


# ---------------------------------------------------------------------------
# Membership records and the heartbeat
# ---------------------------------------------------------------------------


def test_member_records_roundtrip_and_tolerate_garbage(tmp_path):
    from hadoop_bam_tpu_torch.utils.tracing import MetricsRegistry

    fdir = str(tmp_path / "fleet")
    fleet_mod.write_member(fdir, {"name": "a", "t_wall": time.time()})
    fleet_mod.write_member(fdir, {"name": "b", "t_wall": time.time() - 60})
    with open(os.path.join(fdir, "corrupt.json"), "w") as f:
        f.write("{half a record")
    reg = MetricsRegistry()
    recs = fleet_mod.read_members(fdir, reg)
    assert set(recs) == {"a", "b"} and reg.get("fleet.members.unreadable") == 1
    assert fleet_mod.heartbeat_age_s(recs["a"]) < 5
    assert fleet_mod.heartbeat_age_s(recs["b"]) > 30
    assert fleet_mod.heartbeat_age_s({"t_wall": "x"}) == float("inf")
    fleet_mod.remove_member(fdir, "a")
    assert set(fleet_mod.read_members(fdir)) == {"b"}
    assert fleet_mod.read_members(str(tmp_path / "nowhere")) == {}


def test_heartbeater_refreshes_and_final_beat_carries_draining(tmp_path):
    fdir = str(tmp_path / "fleet")
    state = {"draining": False}
    hb = fleet_mod.Heartbeater(fdir, lambda: {"name": "hb", "draining": state["draining"]},
                               period_s=3600)
    hb.start()
    try:
        assert fleet_mod.read_members(fdir)["hb"]["seq"] == 0  # registered at start
        hb.beat()
        rec = fleet_mod.read_members(fdir)["hb"]
        assert rec["seq"] == 1 and not rec["draining"]
    finally:
        state["draining"] = True
        hb.stop()
    rec = fleet_mod.read_members(fdir)["hb"]
    assert rec["draining"] is True and rec["seq"] == 2
    assert hb.metrics.get("fleet.heartbeats") == 3
    hb.stop(unregister=True)
    assert fleet_mod.read_members(fdir) == {}


# ---------------------------------------------------------------------------
# Client retry: jittered backoff on the request's trace
# ---------------------------------------------------------------------------

_CHILDREN = []


class _CapturingCtx(RequestContext):
    """An ambient context that keeps its children for inspection."""

    def child(self, op=""):
        c = super().child(op)
        _CHILDREN.append(c)
        return c


def test_client_retry_annotates_trace_with_jittered_backoff(monkeypatch):
    del _CHILDREN[:]
    calls = {"n": 0}

    def flaky(self, obj):
        calls["n"] += 1
        if calls["n"] <= 1:
            raise ConnectionResetError("peer restarted")
        return {"ok": True, "pong": True}

    monkeypatch.setattr(ServeClient, "_request_once", flaky)
    client = ServeClient(socket_path="/nonexistent.sock", retries=2, retry_backoff=0.001)
    amb = _CapturingCtx("ab" * 16, "cd" * 8, op="test")
    with request_scope(amb):
        assert client.ping()["pong"]
    assert calls["n"] == 2
    (rctx,) = _CHILDREN
    assert rctx.trace_id == amb.trace_id == client.last_trace_id
    hops = [h for h in rctx.hops if h["hop"] == "client.retry"]
    assert len(hops) == 1 and hops[0]["attempt"] == 1
    assert hops[0]["error"] == "ConnectionResetError" and hops[0]["pause_ms"] > 0


def test_client_retry_backoff_is_jittered(monkeypatch):
    del _CHILDREN[:]

    def always_down(self, obj):
        raise ConnectionRefusedError("down")

    monkeypatch.setattr(ServeClient, "_request_once", always_down)
    client = ServeClient(socket_path="/nonexistent.sock", retries=4, retry_backoff=0.0001)
    amb = _CapturingCtx("ef" * 16, "01" * 8, op="test")
    with request_scope(amb), pytest.raises(ServeConnectionError):
        client.ping()
    (rctx,) = _CHILDREN
    pauses = [h["pause_ms"] for h in rctx.hops if h["hop"] == "client.retry"]
    assert len(pauses) == 4
    normalized = [p / 2 ** (i + 1) for i, p in enumerate(pauses)]
    assert max(normalized) - min(normalized) > 1e-9


# ---------------------------------------------------------------------------
# Stale windows, adoption, warmth on one or two daemons
# ---------------------------------------------------------------------------


def test_stale_arena_windows_evicted_on_identity_change(sorted_bam, tmp_path, sock_dir):
    path = _copy_bam(sorted_bam, str(tmp_path / "private.bam"))
    with _daemons(sock_dir, tmp_path, ["d"]) as ds:
        d, client = ds["d"]
        first = client.view(path, REGION, level=1)
        assert client.view(path, REGION, level=1) == first
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        s0 = snapshot(d.metrics)
        assert client.view(path, REGION, level=1) == first
        assert delta(s0, registry=d.metrics)["counters"].get("serve.cache.stale_evict", 0) >= 1
        s1 = snapshot(d.metrics)
        assert client.view(path, REGION, level=1) == first
        assert delta(s1, registry=d.metrics)["counters"].get("serve.cache.stale_evict", 0) == 0
        # Only the current vintage's windows are listed as exportable.
        listed = client.warmth(path)["windows"]
        assert listed and len(client.warmth(path, export=True)["windows"]) == len(listed)


def _peer_journal(tmp_path, src, journal_cls, out) -> str:
    """A dead peer's journal: one resumable sort, one with a stale input
    (lost), one finished before the death (no action)."""
    peer = str(tmp_path / "peer.jsonl")
    j = journal_cls(peer)
    req = {"bam": [src], "output": out, "level": 1, "part_dir": str(tmp_path / "parts")}
    j.submit("job-0001", req, journal_mod.input_identity([src]))
    j.state("job-0001", "running")
    gone = {"bam": [str(tmp_path / "gone.bam")], "output": str(tmp_path / "x.bam"),
            "part_dir": str(tmp_path / "parts2")}
    j.submit("job-0002", gone, [{"path": str(tmp_path / "gone.bam"), "size": 1, "mtime_ns": 1}])
    j.state("job-0002", "running")
    j.submit("job-0003", dict(req), journal_mod.input_identity([src]))
    j.state("job-0003", "done")
    j.close()
    return peer


ADOPT_COUNTERS = {"serve.adopt.resumed": 1, "serve.adopt.lost": 1, "serve.adoptions": 1}


def test_adopt_resumes_peer_journal_byte_identical(tmp_path, sock_dir):
    src = str(tmp_path / "in.bam")
    _write_unsorted_bam(src, n=240, seed=5)
    oracle = str(tmp_path / "oracle.bam")
    sort_bam([src], oracle, device="cpu", backend="host", level=1)
    out = str(tmp_path / "adopted-out.bam")
    peer = _peer_journal(tmp_path, src, journal_mod.JobJournal, out)
    with _daemons(sock_dir, tmp_path, ["adopter"]) as ds:
        d, client = ds["adopter"]
        s0 = snapshot(d.metrics)
        r = client.adopt(peer, source="corpse")
        assert r["ok"] and r["jobs_seen"] == 3
        assert list(r["adopted"]) == ["job-0001"] and r["lost"] == ["job-0002"]
        local = r["adopted"]["job-0001"]
        jr = _wait_job(client, local)
        assert jr["status"] == "done", jr
        assert jr["adopted_from"] == {"job": "job-0001", "source": "corpse"}
        assert _counters(d.metrics, s0, "serve.adopt") == ADOPT_COUNTERS
        with pytest.raises(ServeError, match="adopt needs a journal path"):
            client._request({"op": "adopt"})
        bad = tmp_path / "bad.jsonl"
        bad.write_text("{not json}\n{}\n")
        with pytest.raises(ServeError, match="unreadable"):
            client.adopt(str(bad))
        assert d.metrics.get("serve.adopt.journal_errors") == 1
    assert open(out, "rb").read() == open(oracle, "rb").read()
    # The adopter's own journal replays the job as done.
    assert journal_mod.replay(str(tmp_path / "adopter.jsonl"))[local]["status"] == "done"


def test_warmth_windows_roundtrip_between_daemons(sorted_bam, tmp_path, sock_dir, monkeypatch):
    """Windows exported from a warm arena install into a cold peer through
    its stream's member inflate (row 1's plain version here), and the
    peer's first view is an arena hit with the same bytes."""
    calls = []
    real = flate._lanes_decode_members

    def counted(*a, **k):
        calls.append(len(a[1]))
        return real(*a, **k)

    monkeypatch.setattr(flate, "_lanes_decode_members", counted)
    with _daemons(sock_dir, tmp_path, ["w1", "w2"]) as ds:
        (d1, c1), (d2, c2) = ds["w1"], ds["w2"]
        first = c1.view(sorted_bam, REGION, level=1)
        listing = c1.warmth(sorted_bam)
        assert listing["ok"] and len(listing["windows"]) >= 1
        export = c1.warmth(sorted_bam, export=True)
        assert len(export["windows"]) == len(listing["windows"])
        assert all(w["members_b64"] for w in export["windows"])
        s0 = snapshot(d2.metrics)
        del calls[:]
        install = c2.warmth(sorted_bam, windows=export["windows"])
        assert install["installed"] == len(export["windows"])
        assert len(calls) == len(export["windows"])  # one inflate a window
        got = _counters(d2.metrics, s0, ("fleet.", "device_stream.decodes", "flate."))
        assert got == {"fleet.migrate.imported": len(export["windows"]),
                       "device_stream.decodes": len(export["windows"])}
        s1 = snapshot(d2.metrics)
        assert c2.view(sorted_bam, REGION, level=1) == first
        dlt = delta(s1, registry=d2.metrics)["counters"]
        assert dlt.get("serve.arena.hit", 0) == len(export["windows"])
        assert dlt.get("serve.arena.miss", 0) == 0
        assert c2.warmth(sorted_bam)["windows"] == listing["windows"]
        with pytest.raises(ServeError, match="warmth needs a path"):
            c2._request({"op": "warmth"})


def _bad_windows(good: dict) -> list:
    """One good window's damaged copies: an unknown kind, broken base64,
    garbage members, a wrong record count, a missing field, a bad span."""
    blob = base64.b64decode(good["members_b64"])
    flipped = bytearray(blob)
    flipped[30] ^= 0xFF
    return [
        dict(good, kind="variants"),
        dict(good, members_b64="not*base64="),
        dict(good, members_b64=base64.b64encode(b"\x1f\x8bgarbage").decode()),
        dict(good, members_b64=base64.b64encode(bytes(flipped)).decode()),
        dict(good, n_records=good["n_records"] + 1),
        {k: v for k, v in good.items() if k != "members_b64"},
        dict(good, span=["x", 1]),
    ]


def test_warmth_import_counts_data_errors_by_class(sorted_bam, tmp_path, sock_dir):
    with _daemons(sock_dir, tmp_path, ["w1", "w2"]) as ds:
        (d1, c1), (d2, c2) = ds["w1"], ds["w2"]
        c1.view(sorted_bam, REGION, level=1)
        good = c1.warmth(sorted_bam, export=True)["windows"][0]
        bad = _bad_windows(good)
        s0 = snapshot(d2.metrics)
        assert c2.warmth(sorted_bam, windows=bad + [good])["installed"] == 1
        assert _counters(d2.metrics, s0, "fleet.migrate") == {
            "fleet.migrate.import_errors": len(bad), "fleet.migrate.imported": 1}
        assert c2.warmth(str(tmp_path / "missing.bam"), windows=[good])["installed"] == 0
        assert d2.metrics.get("fleet.migrate.stale_drop") == 1
    from hadoop_bam_tpu.serve import fleet as jfleet
    from hadoop_bam_tpu.serve.arena import HbmArena as JArena
    from hadoop_bam_tpu.utils.tracing import delta as jdelta
    from hadoop_bam_tpu.utils.tracing import snapshot as jsnapshot

    j0 = jsnapshot()
    assert jfleet.unpack_windows(JArena(), sorted_bam, bad + [good]) == 1
    jc = jdelta(j0)["counters"]
    assert jc["fleet.migrate.import_errors"] == len(bad) and jc["fleet.migrate.imported"] == 1


def test_warmth_import_raises_a_kernel_failure(sorted_bam, tmp_path, sock_dir, monkeypatch):
    """A kernel that fails during an import is no data error: the reply
    carries it, and nothing is counted as an import error."""
    with _daemons(sock_dir, tmp_path, ["w1", "w2"]) as ds:
        (d1, c1), (d2, c2) = ds["w1"], ds["w2"]
        c1.view(sorted_bam, REGION, level=1)
        windows = c1.warmth(sorted_bam, export=True)["windows"]

        def broken(*a, **k):
            raise RuntimeError("CUDA error: kernel launch failed")

        monkeypatch.setattr(flate, "_lanes_decode_members", broken)
        with pytest.raises(ServeError, match="CUDA error"):
            c2.warmth(sorted_bam, windows=windows)
        assert d2.metrics.get("fleet.migrate.import_errors") == 0
        assert d2.metrics.get("serve.request_errors") == 1
        assert d2.ctx.arena.stats()["entries"] == 0
        assert c2.ping()["ok"]


# ---------------------------------------------------------------------------
# The router over in-thread daemons
# ---------------------------------------------------------------------------


def _holed_paths(router, sorted_bam, tmp_path, member, n=48, prefix="v"):
    """Copies of the BAM until one hashes to ``member``."""
    for i in range(n):
        p = _copy_bam(sorted_bam, str(tmp_path / f"{prefix}{i}.bam"))
        if router.ring.owner(fleet_mod.file_key(p)) == member:
            return p
    raise AssertionError(f"{n} identities never hashed to {member}")


def test_router_places_by_identity_and_folds_the_fleet(sorted_bam, tmp_path, sock_dir):
    fdir = str(tmp_path / "fleet")
    with _daemons(sock_dir, tmp_path, ["m-a", "m-b", "m-c"], fdir) as ds, \
            _router(sock_dir, fdir, heartbeat_timeout_ms=TIMEOUT_MS) as (router, client):
        ping = client.ping()
        assert ping["router"] is True and ping["members"] == 3
        view = client.fleet()
        assert set(view["members"]) == {"m-a", "m-b", "m-c"}
        assert abs(sum(view["ring"]["shares"].values()) - 1.0) < 1e-3
        assert view["ring"]["shares"] == {m: round(s, 4) for m, s in
                                          HashRing(("m-a", "m-b", "m-c")).shares().items()}
        s0 = snapshot(router.metrics)
        owner, oracle = None, None
        for _ in range(6):
            r = client._request({"op": "view", "path": sorted_bam, "region": REGION,
                                 "level": 1}, idempotent=True)
            owner = owner or r["member"]
            assert r["member"] == owner == router.ring.owner(fleet_mod.file_key(sorted_bam))
            blob = base64.b64decode(r["data_b64"])
            oracle = oracle or blob
            assert blob == oracle
        per_member = client.stats()["members"]
        for name, st in per_member.items():
            assert (st["arena"]["entries"] >= 1) == (name == owner)
        fs = client._request({"op": "flagstat", "path": sorted_bam}, idempotent=True)
        assert fs["member"] == owner
        assert fs["counts"] == ds[owner][1].flagstat(sorted_bam)
        got = _counters(router.metrics, s0, ("fleet.router.", "fleet.admission."))
        assert got == {"fleet.router.op.view": 6, "fleet.router.op.flagstat": 1,
                       "fleet.router.op.stats": 1, "fleet.router.routed": 7,
                       "fleet.admission.admitted": 7}
        stats = client.stats()
        assert stats["slo"]["members"] == 3 and set(stats["members"]) == set(ds)
        text = client.metrics()
        assert text.count("# fleet member:") == 3 and "# fleet router" in text
        with pytest.raises(ServeError, match="unknown op"):
            client._request({"op": "nonsense"})
        with pytest.raises(ServeError, match="not a fleet id"):
            client.job("job-0001")


def test_router_adopts_unclean_death_and_aliases_jobs(tmp_path, sock_dir):
    src = str(tmp_path / "in.bam")
    _write_unsorted_bam(src, n=240, seed=9)
    oracle = str(tmp_path / "oracle.bam")
    sort_bam([src], oracle, device="cpu", backend="host", level=1)
    fdir = str(tmp_path / "fleet")
    with _daemons(sock_dir, tmp_path, ["live-a", "live-b"], fdir) as ds, \
            _router(sock_dir, fdir, heartbeat_timeout_ms=TIMEOUT_MS) as (router, client):
        out = str(tmp_path / "ghost-out.bam")
        gj = str(tmp_path / "ghost.jsonl")
        j = journal_mod.JobJournal(gj)
        j.submit("job-0001", {"bam": [src], "output": out, "level": 1,
                              "part_dir": str(tmp_path / "ghost-parts")},
                 journal_mod.input_identity([src]))
        j.state("job-0001", "running")
        j.close()
        fbase = str(tmp_path / "ghost-flight")
        _write_ring(fbase, [_snap(0), _snap(1)])  # no final: a SIGKILL
        ghost = {"name": "ghost", "journal": gj, "flightrec": fbase,
                 "endpoint": {"socket": os.path.join(sock_dir, "ghost.sock")},
                 "t_wall": time.time(), "seq": 1, "pid": 999999}
        fleet_mod.write_member(fdir, ghost)
        router.scan_members()
        assert "ghost" in client.fleet()["members"]
        s0 = snapshot(router.metrics)
        fleet_mod.write_member(fdir, {**ghost, "t_wall": time.time() - 3600})
        router.scan_members()
        view = client.fleet()
        assert "ghost" not in view["members"]
        dead = view["dead"]["ghost"]
        assert dead["forensics"]["verdict"] == "unclean"
        assert dead["adopter"] == HashRing(("live-a", "live-b", "ghost")).successor("ghost")
        local = dead["adopted"]["job-0001"]
        assert view["job_aliases"] == {"ghost:job-0001": f"{dead['adopter']}:{local}"}
        assert _counters(router.metrics, s0, ("fleet.deaths", "fleet.adopt", "fleet.jobs")) == {
            "fleet.deaths": 1, "fleet.deaths.unclean": 1, "fleet.adoptions": 1,
            "fleet.jobs_adopted": 1}
        jr = _wait_job(client, "ghost:job-0001")
        assert jr["status"] == "done" and jr["member"] == dead["adopter"], jr
        assert jr["id"] == f"{dead['adopter']}:{local}"
        hand = [h for h in view["handoffs"] if h["member"] == "ghost"]
        assert hand and hand[-1]["lost"] == [] and hand[-1]["kind"] == "death"
        with pytest.raises(ServeError, match="gone") as ei:
            client.job("ghost:job-0002x")
        assert ei.value.code == "JOB_LOST"
    assert open(out, "rb").read() == open(oracle, "rb").read()


def test_router_retries_read_on_successor_and_drops_draining(sorted_bam, tmp_path, sock_dir):
    fdir = str(tmp_path / "fleet")
    with _daemons(sock_dir, tmp_path, ["r-a", "r-b"], fdir), \
            _router(sock_dir, fdir, heartbeat_timeout_ms=TIMEOUT_MS) as (router, client):
        hole = {"name": "r-hole", "endpoint": {"socket": os.path.join(sock_dir, "nowhere.sock")},
                "t_wall": time.time(), "seq": 1}
        fleet_mod.write_member(fdir, hole)
        router.scan_members()
        holed = _holed_paths(router, sorted_bam, tmp_path, "r-hole")
        s0 = snapshot(router.metrics)
        r = client._request({"op": "view", "path": holed, "region": REGION, "level": 1},
                            idempotent=True)
        assert r["member"] == router.ring.owners(fleet_mod.file_key(holed), n=2)[1]
        assert _counters(router.metrics, s0, ("fleet.router.retries", "fleet.eager")) == {
            "fleet.router.retries": 1}
        # A job submit to the hole is never resubmitted blind.
        with pytest.raises(ServeError, match="FileNotFoundError"):
            client._request({"op": "sort", "bam": [holed], "output": str(tmp_path / "o.bam")})
        assert router.metrics.get("fleet.router.retries") == 1
        s1 = snapshot(router.metrics)
        fleet_mod.write_member(fdir, {**hole, "t_wall": time.time(), "seq": 2, "draining": True})
        router.scan_members()
        view = client.fleet()
        assert "r-hole" not in view["members"] and "r-hole" not in view["dead"]
        leaves = [h for h in view["handoffs"] if h["member"] == "r-hole" and h["kind"] == "leave"]
        assert leaves and leaves[-1]["reason"] == "draining"
        assert _counters(router.metrics, s1, "fleet.") == {"fleet.member_leaves": 1,
                                                           "fleet.router.op.fleet": 1}
        # A member whose record goes away leaves too.
        fleet_mod.write_member(fdir, {**hole, "name": "r-tmp", "t_wall": time.time()})
        router.scan_members()
        assert "r-tmp" in client.fleet()["members"]
        fleet_mod.remove_member(fdir, "r-tmp")
        router.scan_members()
        view = client.fleet()
        assert set(view["members"]) == {"r-a", "r-b"}
        assert view["handoffs"][-1]["reason"] == "unregistered"


def test_router_eager_death_on_connection_refused(sorted_bam, tmp_path, sock_dir):
    fdir = str(tmp_path / "fleet")
    with _daemons(sock_dir, tmp_path, ["e-a", "e-b"], fdir), \
            _router(sock_dir, fdir, heartbeat_timeout_ms=TIMEOUT_MS) as (router, client):
        ghost_sock = os.path.join(sock_dir, "ghost.sock")
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(ghost_sock)
        s.listen(1)
        s.close()
        fleet_mod.write_member(fdir, {"name": "e-ghost", "endpoint": {"socket": ghost_sock},
                                      "t_wall": time.time(), "seq": 1})
        router.scan_members()
        holed = _holed_paths(router, sorted_bam, tmp_path, "e-ghost", prefix="g")
        s0 = snapshot(router.metrics)
        r = client._request({"op": "view", "path": holed, "region": REGION, "level": 1},
                            idempotent=True)
        assert r["member"] in ("e-a", "e-b")
        assert _counters(router.metrics, s0, ("fleet.eager", "fleet.deaths")) == {
            "fleet.eager_refused": 1, "fleet.deaths": 1, "fleet.deaths.unknown": 1}
        view = client.fleet()
        assert "e-ghost" in view["dead"] and "e-ghost" not in view["members"]
        s1 = snapshot(router.metrics)
        r2 = client._request({"op": "view", "path": holed, "region": REGION, "level": 1},
                             idempotent=True)
        assert r2["member"] in ("e-a", "e-b")
        assert _counters(router.metrics, s1, "fleet.eager") == {}


def test_router_migrates_warmth_from_a_draining_member(sorted_bam, tmp_path, sock_dir):
    """A planned leave with ``hadoopbam.fleet.migrate-warmth``: the leaving
    member's recently routed file's windows are exported and installed on
    its new owner, whose first views of them read nothing cold."""
    fdir = str(tmp_path / "fleet")
    conf = Configuration({"hadoopbam.fleet.migrate-warmth": "true"})
    with _daemons(sock_dir, tmp_path, ["h-a", "h-b"], fdir) as ds, \
            _router(sock_dir, fdir, conf=conf, heartbeat_timeout_ms=TIMEOUT_MS) as (router,
                                                                                      client):
        owner = router.ring.owner(fleet_mod.file_key(sorted_bam))
        other = ({"h-a", "h-b"} - {owner}).pop()
        first = client.view(sorted_bam, REGION, level=1)
        n_windows = len(ds[owner][1].warmth(sorted_bam)["windows"])
        d_new, d_old = ds[other][0], ds[owner][0]
        s0, r0 = snapshot(d_new.metrics), snapshot(router.metrics)
        # The owner drains: its record says so, its control plane answers.
        d_old._draining.set()
        d_old._heartbeater.beat()
        router.scan_members()
        assert _counters(router.metrics, r0, ("fleet.migrat", "fleet.member_leaves")) == {
            "fleet.migrations": 1, "fleet.member_leaves": 1}
        assert _counters(d_new.metrics, s0, "fleet.migrate") == {
            "fleet.migrate.imported": n_windows}
        s1 = snapshot(d_new.metrics)
        r = client._request({"op": "view", "path": sorted_bam, "region": REGION, "level": 1},
                            idempotent=True)
        assert r["member"] == other and base64.b64decode(r["data_b64"]) == first
        dlt = delta(s1, registry=d_new.metrics)["counters"]
        assert dlt.get("serve.arena.hit") == n_windows and not dlt.get("serve.arena.miss")
        assert not dlt.get("serve.batch.launches")


def test_daemon_fleet_member_record_and_final_beat(tmp_path, sock_dir):
    """A fleet member's record names what a router needs; its drained exit
    leaves a final record that says ``draining``."""
    fdir = str(tmp_path / "fleet")
    sock = os.path.join(sock_dir, "m.sock")
    fr = str(tmp_path / "m.flight")
    d = BamDaemon(conf=Configuration({FLEET_DIR: fdir, FLEET_NAME: "m",
                                      FLEET_HEARTBEAT_MS: "3600000"}),
                  socket_path=sock, warmup=False, device="cpu",
                  journal_path=str(tmp_path / "m.jsonl"), flightrec_path=fr)
    t = _serve(d)
    client = ServeClient(socket_path=sock, timeout=60)
    try:
        rec = fleet_mod.read_members(fdir)["m"]
        assert {k: rec[k] for k in ("name", "endpoint", "journal", "flightrec", "pid",
                                    "draining", "seq")} == {
            "name": "m", "endpoint": {"socket": sock}, "journal": str(tmp_path / "m.jsonl"),
            "flightrec": fr, "pid": os.getpid(), "draining": False, "seq": 0}
    finally:
        _stop(client, d, t)
    rec = fleet_mod.read_members(fdir)["m"]
    assert rec["draining"] is True and rec["seq"] == 1
    assert fleet_mod.classify_death(fr)["verdict"] == "clean"
    d2 = BamDaemon(conf=Configuration({FLEET_DIR: fdir}), socket_path=sock, warmup=False,
                   device="cpu")
    try:
        assert d2.fleet_name == f"daemon-{os.getpid()}"
    finally:
        d2.ctx.close()


# ---------------------------------------------------------------------------
# The packages crossed
# ---------------------------------------------------------------------------


def _jdaemon(name, sock, conf, journal):
    from hadoop_bam_tpu.conf import Configuration as JConf
    from hadoop_bam_tpu.serve import BamDaemon as JDaemon

    return JDaemon(conf=JConf(conf), socket_path=sock, warmup=False, journal_path=journal)


def _router_sequence(router_cls, make, files, src, tmp_path, sock_dir) -> dict:
    """Two members of ``make``'s package behind ``router_cls``: ping, the
    fleet view, views and flagstat placed by the ring, a warmth listing, a
    sort job polled to done through its fleet id, a lost id; replies without
    their pids, paths and latencies."""
    fdir = str(tmp_path / "fleet")
    out = {}
    with _daemons(sock_dir, tmp_path, ["x-a", "x-b"], fdir, make=make), \
            _router(sock_dir, fdir, cls=router_cls, heartbeat_timeout_ms=TIMEOUT_MS) as (router,
                                                                                       client):
        router.scan_members()
        ping = client.ping()
        out["ping"] = (ping["router"], ping["members"])
        view = client.fleet()
        out["fleet"] = (sorted(view["members"]), view["ring"], view["dead"])
        for k, path in enumerate(files):
            r = client._request({"op": "view", "path": path, "region": REGION, "level": 1},
                                idempotent=True)
            out[f"view{k}"] = (r["member"], base64.b64decode(r["data_b64"]))
        r = client._request({"op": "flagstat", "path": files[0]}, idempotent=True)
        out["flagstat"] = (r["member"], r["counts"])
        r = client._request({"op": "warmth", "path": files[0]}, idempotent=True)
        out["warmth"] = (r["member"], r["windows"])
        job_out = str(tmp_path / "job.bam")
        r = client._request({"op": "sort", "bam": [src], "output": job_out, "level": 1})
        out["job_id"] = r["job"]
        jr = _wait_job(client, r["job"])
        out["job"] = (jr["status"], jr["member"], jr["id"], jr.get("stats"))
        out["job_bytes"] = open(job_out, "rb").read()
        try:
            client.job("x-a:job-0099")
        except ServeError as e:
            out["lost"] = e.code
        out["stats_members"] = sorted(client.stats()["members"])
    return out


@pytest.mark.parametrize("direction", ["port_router_reference_daemons",
                                       "reference_router_port_daemons"])
def test_the_fleet_wires_crossed_give_equal_replies(sorted_bam, tmp_path, sock_dir, direction):
    """The same sequence through each package's router over the other's
    daemons gives the replies of the port's router over the port's
    daemons, request for request, and every placement is the ring's."""
    from hadoop_bam_tpu.serve import FleetRouter as JRouter

    files = [_copy_bam(sorted_bam, str(tmp_path / f"f{k}.bam")) for k in range(2)]
    src = str(tmp_path / "in.bam")
    _write_unsorted_bam(src, n=240, seed=3)
    runs = {}
    for name, router_cls, make in (
        ("port", FleetRouter, None),
        ("crossed", JRouter if direction.startswith("reference") else FleetRouter,
         None if direction.endswith("port_daemons") else _jdaemon),
    ):
        work = tmp_path / name
        work.mkdir()
        runs[name] = _router_sequence(router_cls, make, files, src, work, sock_dir)
    want, got = runs["port"], runs["crossed"]
    assert got == want
    ring = HashRing(("x-a", "x-b"))
    for k, path in enumerate(files):
        assert want[f"view{k}"][0] == ring.owner(fleet_mod.file_key(path))
    assert want["job_id"] == f"{ring.owner(fleet_mod.file_key(src))}:job-0001"
    assert want["job"][0] == "done" and want["lost"] == "JOB_LOST"


@pytest.mark.parametrize("direction", ["reference_journal_port_daemon",
                                       "port_journal_reference_daemon"])
def test_journal_adopted_across_packages(tmp_path, sock_dir, direction):
    """A dead peer's journal written by one package is adopted by the other's
    daemon: the same reply, the oracle's bytes, the reference's
    ``serve.adopt.*`` deltas."""
    from hadoop_bam_tpu.serve import journal as jjournal
    from hadoop_bam_tpu.utils.tracing import delta as jdelta
    from hadoop_bam_tpu.utils.tracing import snapshot as jsnapshot

    src = str(tmp_path / "in.bam")
    _write_unsorted_bam(src, n=240, seed=5)
    oracle = str(tmp_path / "oracle.bam")
    sort_bam([src], oracle, device="cpu", backend="host", level=1)
    out = str(tmp_path / "adopted-out.bam")
    port_daemon = direction.endswith("port_daemon")
    peer = _peer_journal(tmp_path, src, jjournal.JobJournal if port_daemon
                         else journal_mod.JobJournal, out)
    with _daemons(sock_dir, tmp_path, ["adopter"], make=None if port_daemon else _jdaemon) as ds:
        d, client = ds["adopter"]
        s0 = snapshot(d.metrics) if port_daemon else jsnapshot()
        r = client.adopt(peer, source="corpse")
        assert (r["ok"], r["jobs_seen"], r["lost"]) == (True, 3, ["job-0002"])
        assert list(r["adopted"]) == ["job-0001"]
        jr = _wait_job(client, r["adopted"]["job-0001"])
        assert jr["status"] == "done" and jr["adopted_from"] == {"job": "job-0001",
                                                                  "source": "corpse"}
        counters = (delta(s0, registry=d.metrics) if port_daemon else jdelta(s0))["counters"]
        assert {k: v for k, v in counters.items() if k.startswith("serve.adopt")} == \
            ADOPT_COUNTERS
    assert open(out, "rb").read() == open(oracle, "rb").read()


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_windows_exchanged_across_packages(sorted_bam, tmp_path, sock_dir, direction):
    """Both packages export the same windows of the same view byte for byte
    (the same ``fleet.migrate.*`` deltas); a window exported by either
    installs in the other, which then serves the view warm with the same
    bytes."""
    from hadoop_bam_tpu.utils.tracing import delta as jdelta
    from hadoop_bam_tpu.utils.tracing import snapshot as jsnapshot

    with _daemons(sock_dir, tmp_path, ["tp"]) as tds, \
            _daemons(sock_dir, tmp_path, ["jr"], make=_jdaemon) as jds:
        (td, tc), (jd, jc) = tds["tp"], jds["jr"]
        blob = tc.view(sorted_bam, REGION, level=1)
        assert jc.view(sorted_bam, REGION, level=1) == blob
        t0, j0 = snapshot(td.metrics), jsnapshot()
        t_export = tc.warmth(sorted_bam, export=True)["windows"]
        j_export = jc.warmth(sorted_bam, export=True)["windows"]
        assert t_export == j_export and t_export
        tm = _counters(td.metrics, t0, "fleet.migrate")
        jm = {k: v for k, v in jdelta(j0)["counters"].items() if k.startswith("fleet.migrate")}
        assert tm == jm == {"fleet.migrate.windows": len(t_export),
                            "fleet.migrate.bytes": sum(len(base64.b64decode(w["members_b64"]))
                                                       for w in t_export)}
    # A cold receiver of the other package.
    name, make, windows = (("jr2", _jdaemon, t_export) if direction == "port_to_reference"
                           else ("tp2", None, j_export))
    with _daemons(sock_dir, tmp_path, [name], make=make) as ds:
        d, c = ds[name]
        assert c.warmth(sorted_bam, windows=windows)["installed"] == len(windows)
        s0 = snapshot(d.metrics) if make is None else jsnapshot()
        assert c.view(sorted_bam, REGION, level=1) == blob
        dlt = (delta(s0, registry=d.metrics) if make is None else jdelta(s0))["counters"]
        assert dlt.get("serve.arena.hit") == len(windows) and not dlt.get("serve.arena.miss")


def test_fleet_conf_keys_and_defaults_equal_the_reference(tmp_path):
    """The router's and the daemon's fleet keys carry the reference's
    strings and defaults, and one conf dict configures both packages'
    routers and daemons alike."""
    from hadoop_bam_tpu import conf as jconf
    from hadoop_bam_tpu.serve import FleetRouter as JRouter
    from hadoop_bam_tpu.serve import fleet as jfleet
    from hadoop_bam_tpu.serve import router as jrouter
    from hadoop_bam_tpu_torch import conf as tconf
    from hadoop_bam_tpu_torch.serve import router as trouter

    keys = ("FLEET_DIR", "FLEET_NAME", "FLEET_HEARTBEAT_MS", "FLEET_HEARTBEAT_TIMEOUT_MS",
            "FLEET_VNODES", "FLEET_SOCKET", "FLEET_PORT", "FLEET_TOKENS", "FLEET_FILE_TOKENS",
            "FLEET_MIGRATE_WARMTH")
    for k in keys:
        assert getattr(tconf, k) == getattr(jconf, k), k
    for k in ("DEFAULT_VNODES", "DEFAULT_HEARTBEAT_MS", "DEFAULT_HEARTBEAT_TIMEOUT_MS",
              "CLEAN", "UNCLEAN", "UNKNOWN"):
        assert getattr(fleet_mod, k) == getattr(jfleet, k), k
    for k in ("DEFAULT_FLEET_TOKENS", "DEFAULT_FILE_TOKENS", "ROUTED_OPS", "_RECENT_PATHS"):
        assert getattr(trouter, k) == getattr(jrouter, k), k
    assert trouter.default_router_socket_path() == jrouter.default_router_socket_path()

    def attrs(r):
        return (r.fleet_dir, r.socket_path, r.port, r.heartbeat_timeout_ms, r.migrate_warmth,
                r.request_tracing, r.ring.vnodes, r.ledger.tokens, r.ledger.file_tokens,
                r.endpoint)

    fdir = str(tmp_path / "fleet")
    for d in ({jconf.FLEET_DIR: fdir},
              {jconf.FLEET_DIR: fdir, jconf.FLEET_PORT: "0", jconf.FLEET_SOCKET: "/x/r.sock",
               jconf.FLEET_HEARTBEAT_TIMEOUT_MS: "900", jconf.FLEET_VNODES: "9",
               jconf.FLEET_TOKENS: "5", jconf.FLEET_FILE_TOKENS: "2",
               jconf.FLEET_MIGRATE_WARMTH: "on"}):
        assert attrs(FleetRouter(conf=tconf.from_reference_conf(d))) == \
            attrs(JRouter(conf=jconf.Configuration(d)))
    for bad in (lambda: FleetRouter(), lambda: JRouter()):
        with pytest.raises(ValueError, match="fleet directory"):
            bad()
    from hadoop_bam_tpu.serve import BamDaemon as JDaemon

    for d in ({jconf.FLEET_DIR: fdir}, {jconf.FLEET_DIR: fdir, jconf.FLEET_NAME: "m-1"}):
        t = BamDaemon(conf=tconf.from_reference_conf(d), socket_path=str(tmp_path / "t.sock"),
                      warmup=False, device="cpu")
        j = JDaemon(conf=jconf.Configuration(d), socket_path=str(tmp_path / "j.sock"),
                    warmup=False)
        try:
            assert (t.fleet_dir, t.fleet_name) == (j.fleet_dir, j.fleet_name)
        finally:
            t.ctx.close()


# ---------------------------------------------------------------------------
# The real thing: daemon processes, kill -9 mid-job, adoption
# ---------------------------------------------------------------------------

_CHILD = (
    "import sys; sys.path.insert(0, {repo!r})\n"
    "from hadoop_bam_tpu_torch.conf import Configuration\n"
    "from hadoop_bam_tpu_torch.serve import BamDaemon\n"
    "d = BamDaemon(conf=Configuration({conf!r}), socket_path={sock!r}, warmup=False,\n"
    "              journal_path={journal!r}, flightrec_path={flight!r}, device='cpu')\n"
    "d.serve_forever()\n"
)


def _spawn_member(tmp_path, sock_dir, name, fdir, env):
    sock = os.path.join(sock_dir, f"{name}.sock")
    conf = {FLEET_DIR: fdir, FLEET_NAME: name, FLEET_HEARTBEAT_MS: "200",
            SERVE_FLIGHTREC_CADENCE_MS: "100"}
    code = _CHILD.format(repo=REPO, conf=conf, sock=sock, journal=str(tmp_path / f"{name}.jsonl"),
                         flight=str(tmp_path / f"{name}.flight"))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    client = ServeClient(socket_path=sock, timeout=30, retries=0)
    deadline = time.time() + 120
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"{name} exited rc={proc.returncode}")
        try:
            if client.ping()["ok"]:
                return proc
        except (OSError, ServeError):
            time.sleep(0.1)
    proc.kill()
    raise AssertionError(f"{name} never became ready")


@pytest.mark.slow
def test_kill9_mid_sort_peer_adopts_journal_byte_identical(tmp_path, sock_dir):
    """Two daemon processes behind the router; the sort's owner is killed
    -9 once its first part is written (its later parts held by the fault
    plan); the monitor finds an unclean death, the successor adopts the
    journal and the fleet id polls to done with the uninterrupted bytes."""
    src = str(tmp_path / "in.bam")
    _write_unsorted_bam(src, n=2500, seed=17)
    budget = 48 << 10
    oracle = str(tmp_path / "oracle.bam")
    sort_bam([src], oracle, device="cpu", backend="host", level=1, memory_budget=budget)
    fdir = str(tmp_path / "fleet")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("HBAM_FAULTS", None)
    procs = {}
    try:
        owner_env = dict(env, HBAM_FAULTS="exec.delay:items=1,attempts=*,ms=60000,n=*")
        with _router(sock_dir, fdir, heartbeat_timeout_ms=1200.0) as (router, client):
            names = ["fd-a", "fd-b"]
            ring = HashRing(tuple(names))
            owner = ring.owner(fleet_mod.file_key(src))
            for n in names:
                procs[n] = _spawn_member(tmp_path, sock_dir, n, fdir,
                                         owner_env if n == owner else env)
            router.scan_members()
            assert set(client.fleet()["members"]) == set(names)
            pdir = str(tmp_path / "parts")
            out = str(tmp_path / "out.bam")
            reply = client._request({"op": "sort", "bam": [src], "output": out, "level": 1,
                                     "memory_budget": budget, "part_dir": pdir})
            jid = reply["job"]
            assert reply["member"] == owner and jid.startswith(owner + ":")
            part0 = os.path.join(pdir, "part-r-00000")
            deadline = time.time() + 120
            while time.time() < deadline and not os.path.exists(part0):
                time.sleep(0.05)
            assert os.path.exists(part0), "the owner never wrote its first part"
            procs[owner].send_signal(signal.SIGKILL)
            assert procs[owner].wait(timeout=30) == -signal.SIGKILL
            jr = None
            deadline = time.time() + 300
            while time.time() < deadline:
                try:
                    jr = client._request({"op": "job", "id": jid}, idempotent=True)
                    if jr["status"] in ("done", "failed"):
                        break
                except ServeError:
                    pass  # JOB_LOST between the death and the adoption
                time.sleep(0.25)
            assert jr is not None and jr["status"] == "done", jr
            assert jr["member"] != owner
            view = client.fleet()
            dead = view["dead"][owner]
            assert dead["forensics"]["verdict"] == "unclean"
            assert jid.split(":", 1)[1] in dead["adopted"]
            hand = [h for h in view["handoffs"] if h["member"] == owner and h["kind"] == "death"]
            assert hand and hand[-1]["lost"] == []
            assert open(out, "rb").read() == open(oracle, "rb").read()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=30)


def test_serve_package_exports_the_fleet():
    for name in ("HashRing", "Heartbeater", "classify_death", "file_key", "FleetRouter",
                 "default_router_socket_path"):
        assert name in tserve.__all__ and getattr(tserve, name) is not None

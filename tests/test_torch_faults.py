"""Fault injection and salvage in the port against the reference, on the CPU.

The cases are the reference's ``tests/test_faults.py`` that need no serve
daemon or CLI (their CLI cases go through the Python entry points; the
``io.read.*`` cases go through the port's ``io/fs.py``), its ``test_variant_plane.py`` BCF quarantine and its
``test_device_stream.py`` ``salvage.splits_failed`` case.  Every case runs
the same damaged input, made from a seed, through both packages: the output
bytes are equal, and every ``salvage.*``, ``executor.*`` and
``faults.fired.*`` counter of the port's job equals the reference's
``METRICS`` delta over the same run.  The corpus is the reference's
(``test_faults._build_bam``: 1,500 records in 2 KiB members).
"""

import os
import time

import numpy as np
import pytest
import torch

from hadoop_bam_tpu import faults as jfaults
from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.io.bam import BamInputFormat as JFormat
from hadoop_bam_tpu.parallel import executor as jexecutor
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.spec import bgzf as jbgzf
from hadoop_bam_tpu.utils.tracing import delta, snapshot
from hadoop_bam_tpu_torch import faults, pipeline
from hadoop_bam_tpu_torch.conf import ERRORS_MODE, Configuration, from_reference_conf
from hadoop_bam_tpu_torch.device_stream import DeviceStream
from hadoop_bam_tpu_torch.faults import FaultPlan
from hadoop_bam_tpu_torch.io.bam import BamInputFormat
from hadoop_bam_tpu_torch.parallel import executor as texecutor
from hadoop_bam_tpu_torch.parallel.executor import (
    ElasticExecutor,
    PartFailedError,
    bgzf_part_valid,
)
from hadoop_bam_tpu_torch.spec import bam, bgzf
from hadoop_bam_tpu_torch.utils import nio
from hadoop_bam_tpu_torch.utils.tracing import Metrics
from test_faults import _build_bam, _corrupt, _record_members, _records_of, _surviving_oracle
from test_torch_sort_bam import HOST

CPU = torch.device("cpu")
#: A record member of the corpus's last split at ``split_size=6000`` (four
#: splits): a salvaged last split never spills, so the reference's reader
#: reads it (see ``test_salvage_split_reads_at_many_boundaries``).
LAST_SPLIT_RANK = 70
#: The counter families held to the reference.
FAMILIES = ("salvage.", "executor.", "faults.fired")


@pytest.fixture(autouse=True)
def _disarmed():
    """Both packages start and end each case disarmed."""
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


@pytest.fixture(scope="module")
def bam_corpus(tmp_path_factory):
    td = tmp_path_factory.mktemp("tfaults")
    clean_path = str(td / "clean.bam")
    clean, stream, hlen = _build_bam(clean_path)
    return {"dir": td, "clean_path": clean_path, "clean": clean, "stream": stream, "hlen": hlen}


def _bytes(p):
    with open(p, "rb") as f:
        return f.read()


def family(counters):
    return {k: v for k, v in counters.items() if k.startswith(FAMILIES) and v}


def same_counters(port: dict, ref: dict):
    assert family(port) == family(ref)


def arm_both(spec):
    faults.arm(spec)
    jfaults.arm(spec)


def both(job, src, tmp_path, tag="", gates=HOST, plan=None, **kw):
    """``job`` through the reference and the port (on the CPU): ``(port
    stats, port out, reference out, reference delta)``.  The outputs are the
    same bytes and the counter families are equal; ``plan`` is armed in
    both packages for their runs."""
    t_out, j_out = str(tmp_path / f"port{tag}.bam"), str(tmp_path / f"ref{tag}.bam")
    kw_t = dict(kw)
    kw_j = dict(kw)
    for k in ("part_dir",):
        if k in kw:
            kw_t[k] = kw[k] + ".port"
            kw_j[k] = kw[k] + ".ref"
    if plan:
        jfaults.arm(plan)
    before = snapshot()
    try:
        getattr(jpipeline, job)(src, j_out, conf=JConf(gates), **kw_j)
    finally:
        jfaults.disarm()
    d = delta(before)["counters"]
    if plan:
        faults.arm(plan)
    try:
        st = getattr(pipeline, job)(src, t_out, conf=from_reference_conf(gates), device="cpu",
                                    **kw_t)
    finally:
        faults.disarm()
    assert _bytes(t_out) == _bytes(j_out)
    same_counters(st.counters, d)
    return st, t_out, j_out, d


# ---------------------------------------------------------------------------
# FaultPlan mechanics
# ---------------------------------------------------------------------------


def test_fault_plan_parse_and_budget():
    spec = ("seed=42;io.read.error:n=2,path=.bam;"
            "exec.crash:items=0-2,attempts=0;serve.drop:op=job")
    for mod in (faults, jfaults):
        p = mod.FaultPlan.parse(spec)
        assert p.seed == 42 and len(p.directives) == 3
        assert p.io_read("/x/y.vcf", 0, b"AA") == b"AA"  # the path filter
        for _ in range(2):
            with pytest.raises(IOError):
                p.io_read("/x/y.bam", 0, b"AA")
        assert p.io_read("/x/y.bam", 0, b"AA") == b"AA"  # the budget is spent
        with pytest.raises(RuntimeError):
            p.exec_attempt(1, 0, "/tmp/x")  # items=0-2, attempts=0: fires once
        p2 = mod.FaultPlan.parse("exec.crash:items=1,3,attempts=*")
        with pytest.raises(RuntimeError):
            p2.exec_attempt(3, 7, "/tmp/x")
        assert p2._fire("exec.crash", item=2, attempt=0) is None
        assert p.serve_action("view") is None
        assert p.serve_action("job") == {"action": "drop"}
        assert p.fired == {"io.read.error": 2, "exec.crash": 1, "serve.drop": 1}
    m = Metrics()
    FaultPlan.parse("flate.corrupt:n=2").corrupt_payload(b"abc", m)
    assert m.counters() == {"faults.fired": 1, "faults.fired.flate.corrupt": 1}


def test_seams_of_later_modules_fire_as_the_reference(tmp_path):
    """The mesh seams' directives parse and their ``FaultPlan`` methods fire
    and count as the reference's do (``mh.corrupt`` fires in the
    multi-process sort's wire, ``test_torch_multihost.py``;
    ``mh.speculate.lose`` before a speculative copy's promotion,
    ``test_torch_multihost_skew.py``).
    The ``serve.stall``, ``serve.drop`` and ``arena.oom`` directives fire at
    the daemon's seams (the reply, the lane batcher's launch) with the
    reference's ``faults.fired.*`` counts and the same replies."""
    spec = ("seed=5;mh.corrupt:members=1-2,n=2;mh.speculate.lose:ms=1;arena.oom:n=1;"
            "serve.stall:op=view,ms=7;flate.inflate.tierdown:members=3")
    p, q = FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    m = Metrics()
    got = [p.mh_corrupt(k, m) for k in range(4)] + [p.arena_oom("x", m), p.arena_oom("x", m)]
    want = [q.mh_corrupt(k) for k in range(4)] + [q.arena_oom("x"), q.arena_oom("x")]
    assert got == want == [False, True, True, False, True, False]
    p.mh_speculate_lose(m)
    q.mh_speculate_lose()
    assert p.serve_action("view", m) == q.serve_action("view") == {"action": "stall", "ms": 7}
    assert [p.flate_tierdown("inflate", k, m) for k in range(5)] == \
        [q.flate_tierdown("inflate", k) for k in range(5)]
    assert p.fired == q.fired
    assert m.get("faults.fired") == sum(q.fired.values())
    assert isinstance(faults.InjectedResourceExhausted("x"), MemoryError)
    assert "RESOURCE_EXHAUSTED" in str(faults.InjectedResourceExhausted("x"))
    assert _daemon_seams(tmp_path, "port") == _daemon_seams(tmp_path, "reference")


def _daemon_seams(tmp_path, which):
    """A daemon of ``which`` package armed (through its conf) with a stalled
    view, a dropped flagstat and two out-of-memory launches, driven by its
    own client: the replies and the ``faults.fired.*`` counters."""
    import shutil
    import tempfile
    import threading

    from hadoop_bam_tpu.serve import BamDaemon as JDaemon
    from hadoop_bam_tpu.serve import client as jclient
    from hadoop_bam_tpu_torch.serve import BamDaemon
    from hadoop_bam_tpu_torch.serve import client as tclient
    from test_serve import _write_unsorted_bam

    work = tmp_path / which
    work.mkdir()
    src, path = str(work / "u.bam"), str(work / "s.bam")
    _write_unsorted_bam(src, n=120)
    pipeline.sort_bam(src, path, device="cpu", level=1)
    plan = {"hadoopbam.faults.plan": "seed=2;serve.stall:op=view,ms=5,n=1;"
                                     "serve.drop:op=flagstat,n=1;arena.oom:n=2"}
    sock_dir = tempfile.mkdtemp(prefix="hbf")
    sock = os.path.join(sock_dir, "d.sock")
    if which == "port":
        d, cmod = BamDaemon(conf=Configuration(plan), socket_path=sock, warmup=False,
                            device="cpu"), tclient
    else:
        d, cmod = JDaemon(conf=JConf(plan), socket_path=sock, warmup=False), jclient
    before = snapshot()
    ready = threading.Event()
    t = threading.Thread(target=d.serve_forever, args=(ready,), daemon=True)
    t.start()
    try:
        assert ready.wait(60)
        c = cmod.ServeClient(socket_path=sock, timeout=60, retry_backoff=0.01)
        out = {"view": c.view(path, "chr1:1-1000000", level=1), "flagstat": c.flagstat(path),
               "view2": c.view(path, "chr2", level=1)}
        counters = c.stats()["metrics"]["counters"] if which == "port" else \
            delta(before)["counters"]
        out["fired"] = {k: v for k, v in counters.items() if k.startswith("faults.fired")}
        out["oom"] = {k: v for k, v in counters.items() if k.startswith("serve.oom.")}
        c.shutdown()
    finally:
        faults.disarm()
        jfaults.disarm()
        if t.is_alive():
            d.stop()
        t.join(timeout=60)
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert not t.is_alive()
    assert out["fired"]["faults.fired.serve.drop"] == 1
    assert out["fired"]["faults.fired.arena.oom"] == 2
    return out


def test_offset_pinned_bitflip_is_persistent():
    """A corrupt disk byte is corrupt on every read covering it: no budget
    unless ``n`` is given (``FaultPlan.io_read``; the seam waits for
    ``io/fs.py``)."""
    for mod in (faults, jfaults):
        p = mod.FaultPlan.parse("io.read.bitflip:offset=5,bit=1")
        for _ in range(3):
            out = p.io_read("f", 0, bytes(10))
            assert out[5] == 0x02 and out.count(0) == 9
        assert p.io_read("f", 6, bytes(10)) == bytes(10)
    p = FaultPlan.parse("seed=3;io.read.bitflip:n=1;io.read.short:drop=4")
    q = jfaults.FaultPlan.parse("seed=3;io.read.bitflip:n=1;io.read.short:drop=4")
    assert p.io_read("f", 0, bytes(range(32))) == q.io_read("f", 0, bytes(range(32)))


def test_unknown_site_rejected():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan.parse("io.write.bitflip:n=1")
    with pytest.raises(ValueError, match="bad fault directive parameter"):
        FaultPlan.parse("exec.crash:oops")


def test_arming_from_conf_and_env(monkeypatch):
    assert not faults.arm_from_conf(Configuration())
    assert faults.arm_from_conf(Configuration({"hadoopbam.faults.plan": "exec.crash:n=1"}))
    assert faults.ACTIVE.directives[0].site == "exec.crash"
    faults.disarm()
    monkeypatch.setenv("HBAM_FAULTS", "exec.delay:ms=1")
    assert faults.arm_from_env() and faults.ACTIVE.directives[0].site == "exec.delay"


# ---------------------------------------------------------------------------
# Salvage reads: injected corruption against the reference
# ---------------------------------------------------------------------------


def _read_both(path, stream_gates=None):
    """Every split of ``path`` read under salvage by both packages:
    ``(port batches, reference batches, port metrics, reference delta)``."""
    jfmt = JFormat(JConf({ERRORS_MODE: "salvage"}))
    before = snapshot()
    want = [jfmt.read_split(s) for s in jfmt.get_splits([path], split_size=1 << 30)]
    d = delta(before)["counters"]
    m = Metrics()
    fmt = BamInputFormat(Configuration({ERRORS_MODE: "salvage"}), metrics=m)
    stream = None
    if stream_gates is not None:
        stream = DeviceStream(CPU, Configuration(stream_gates))
        m = stream.metrics
    got = [fmt.read_split(s, stream=stream) for s in fmt.get_splits([path], split_size=1 << 30)]
    return got, want, m, d


def test_salvage_quarantines_exactly_injected_members(bam_corpus, tmp_path):
    ranks = [3, 10, 25]
    xp = _corrupt(bam_corpus, tmp_path / "payload_flips.bam", ranks)
    strict = BamInputFormat()
    with pytest.raises((bgzf.BgzfError, bam.BamError)):
        for s in strict.get_splits([xp], split_size=1 << 30):
            strict.read_split(s)
    for gates in (None, {"hadoopbam.inflate.lanes": "true"}):
        got, want, m, d = _read_both(xp, gates)
        assert m.get("salvage.members_quarantined") == len(ranks)
        assert m.get("salvage.strict_fallbacks") == 1
        same_counters(m.counters(), d)
        assert _records_of(got) == _records_of(want)
        assert sorted(_records_of(got)) == sorted(_surviving_oracle(bam_corpus, ranks))
        assert all(b.salvaged and b.device_data is None for b in got)


def test_salvage_resyncs_past_destroyed_header(bam_corpus, tmp_path):
    xp = _corrupt(bam_corpus, tmp_path / "magic_flip.bam", [7], "magic")
    got, want, m, d = _read_both(xp)
    assert m.get("salvage.members_quarantined") == 1 and m.get("salvage.resyncs") >= 1
    same_counters(m.counters(), d)
    assert _records_of(got) == _records_of(want)
    assert sorted(_records_of(got)) == sorted(_surviving_oracle(bam_corpus, [7]))


@pytest.mark.parametrize("split_size", [4000, 6000], ids=["small_splits", "larger_splits"])
def test_salvage_split_reads_at_many_boundaries(bam_corpus, tmp_path, split_size):
    """Damage near and inside split boundaries: every split reads the
    reference's records and counters, and the splits together hold no
    record twice and none that the clean file lacks.  Standing deviation: where a salvaged split's tail
    record spills past its end, the reference's reader raises
    ``BufferError`` (its live view of the growing buffer), which its read
    drive turns into an empty split; the port completes the record, so
    those splits are held to the survivors only."""
    for ranks, where in (([2, 3, 9, 14, 15, 26], "payload"), ([5, 6, 20], "magic")):
        path = _corrupt(bam_corpus, tmp_path / f"{where}.bam", ranks, where)
        jfmt = JFormat(JConf({ERRORS_MODE: "salvage"}))
        splits = BamInputFormat().get_splits([path], split_size=split_size)
        assert len(splits) > 2
        got_all, deviations = [], 0
        for s in splits:
            m = Metrics()
            got = BamInputFormat(Configuration({ERRORS_MODE: "salvage"}), metrics=m).read_split(s)
            got_all.append(got)
            before = snapshot()
            try:
                want = jfmt.read_split(type(jfmt.get_splits([path], split_size=1 << 30)[0])(
                    s.path, s.vstart, s.vend))
            except BufferError:
                deviations += 1
                continue
            assert _records_of([got]) == _records_of([want])
            same_counters(m.counters(), delta(before)["counters"])
        got_recs = _records_of(got_all)
        assert len(set(got_recs)) == len(got_recs)  # no record read twice
        assert set(got_recs) <= set(_surviving_oracle(bam_corpus, []))
        assert deviations < len(splits)


@pytest.mark.parametrize("where", ["payload", "magic"])
def test_salvage_member_at_a_split_end(bam_corpus, tmp_path, where):
    """A damaged member that starts exactly at a split's end: the split
    scans it but leaves its count to the next split, as the reference does,
    whose guessed start lies past it; every split reads the reference's
    records and counters."""
    blocks, idx, _ = _record_members(bam_corpus)
    rank = 10
    split_size = blocks[idx[rank]].coffset  # the first split ends at the member
    path = _corrupt(bam_corpus, tmp_path / "end.bam", [rank], where)
    jfmt = JFormat(JConf({ERRORS_MODE: "salvage"}))
    jsplit = type(jfmt.get_splits([path], split_size=1 << 30)[0])
    splits = BamInputFormat().get_splits([path], split_size=split_size)
    assert splits[0].vend >> 16 == split_size
    totals = [0, 0]
    for s in splits:
        m = Metrics()
        got = BamInputFormat(Configuration({ERRORS_MODE: "salvage"}), metrics=m).read_split(s)
        before = snapshot()
        want = jfmt.read_split(jsplit(s.path, s.vstart, s.vend))
        d = delta(before)["counters"]
        assert _records_of([got]) == _records_of([want])
        same_counters(m.counters(), d)
        totals[0] += m.get("salvage.members_quarantined")
        totals[1] += d.get("salvage.members_quarantined", 0)
    assert totals[0] == totals[1]


def test_salvage_sort_end_to_end(bam_corpus, tmp_path):
    """``sort --errors salvage`` through ``sort_bam``: the reference's
    bytes and counters; the output holds exactly the survivors, sorted."""
    ranks = [4, 19]
    xp = _corrupt(bam_corpus, tmp_path / "sortme.bam", ranks)
    st, out, _, d = both("sort_bam", xp, tmp_path, level=1, errors="salvage")
    assert st.counters["salvage.members_quarantined"] == len(ranks)
    assert d["executor.attempts"] == st.counters["executor.attempts"] == st.n_splits
    _, recs = jbam.read_bam(out)
    assert sorted(r.raw for r in recs) == sorted(_surviving_oracle(bam_corpus, ranks))
    keys = [jbam.alignment_key(r) for r in recs]
    assert keys == sorted(keys)


@pytest.mark.parametrize("gates,device_parse", [
    (HOST, None), ({"hadoopbam.inflate.lanes": "true", "hadoopbam.deflate.lanes": "true",
                    "hadoopbam.write.device": "true"}, True)], ids=["host", "every_gate"])
def test_salvage_sort_through_the_plain_kernels(bam_corpus, tmp_path, gates, device_parse):
    """Salvage with every gate on: the clean splits take the inflate, chain
    and write kernels' plain versions, the salvaged ones the host keys and
    the host gather; the bytes are those of the reference's host run."""
    ranks = [LAST_SPLIT_RANK]
    xp = _corrupt(bam_corpus, tmp_path / "gates.bam", ranks)
    j_out, t_out = str(tmp_path / "ref.bam"), str(tmp_path / "port.bam")
    before = snapshot()
    jpipeline.sort_bam(xp, j_out, conf=JConf(HOST), level=1, split_size=6000,
                       errors="salvage")
    d = delta(before)["counters"]
    st = pipeline.sort_bam(xp, t_out, conf=from_reference_conf(gates), device="cpu", level=1,
                           split_size=6000, errors="salvage", device_parse=device_parse)
    assert st.n_splits > 2 and st.counters["salvage.members_quarantined"] == 1
    if gates is HOST:
        assert _bytes(t_out) == _bytes(j_out)
    else:
        assert st.backend == "device-parse"
        assert st.counters["bam.device_write_tierdown.no_residency"] == st.n_splits
        assert jbam.read_bam(t_out)[1] == jbam.read_bam(j_out)[1]
    same_counters(st.counters, d)


def test_salvage_queryname_sort(bam_corpus, tmp_path):
    ranks = [3, 17]
    xp = _corrupt(bam_corpus, tmp_path / "qn.bam", ranks)
    st, out, _, _ = both("sort_bam", xp, tmp_path, level=1, sort_order="queryname",
                         errors="salvage")
    assert st.counters["salvage.members_quarantined"] == len(ranks)
    hdr, got = jbam.read_bam(out)
    assert hdr.sort_order() == "queryname"
    assert sorted(r.raw for r in got) == sorted(_surviving_oracle(bam_corpus, ranks))


def test_salvage_fixmate(bam_corpus, tmp_path):
    """The corpus is unpaired, so fixmate passes the survivors through."""
    ranks = [5, 12]
    xp = _corrupt(bam_corpus, tmp_path / "fm.bam", ranks)
    st, out, _, _ = both("fixmate_bam", xp, tmp_path, level=1, errors="salvage")
    assert st.counters["salvage.members_quarantined"] == len(ranks)
    assert [r.raw for r in jbam.read_bam(out)[1]] == _surviving_oracle(bam_corpus, ranks)


def test_salvage_markdup(bam_corpus, tmp_path):
    ranks = [8, 30]
    xp = _corrupt(bam_corpus, tmp_path / "md.bam", ranks)
    st, _, _, _ = both("markdup_bam", xp, tmp_path, level=1, errors="salvage")
    assert st.counters["salvage.members_quarantined"] == len(ranks)


def test_salvage_on_clean_file_identical_to_strict(bam_corpus, tmp_path):
    o1 = str(tmp_path / "strict.bam")
    pipeline.sort_bam([bam_corpus["clean_path"]], o1, device="cpu", backend="host", level=1)
    st, o2, _, _ = both("sort_bam", [bam_corpus["clean_path"]], tmp_path, backend="host",
                        level=1, errors="salvage")
    assert _bytes(o1) == _bytes(o2)
    assert not st.counters.get("salvage.members_quarantined")
    assert not st.counters.get("salvage.records_dropped")


def test_disarmed_strict_clean_run_is_zero_overhead(bam_corpus, tmp_path):
    """A disarmed strict clean run counts no ``faults.*``, ``salvage.*``,
    invalid-part, missing-EOF or deadline counter."""
    st = pipeline.sort_bam([bam_corpus["clean_path"]], str(tmp_path / "o.bam"), device="cpu",
                           backend="host", level=1)
    leaked = [k for k in st.counters if k.startswith((
        "faults.", "salvage.", "executor.invalid_part", "bgzf.missing_eof",
        "serve.deadline.", "executor.deadline_exceeded"))]
    assert leaked == []
    assert st.counters["executor.attempts"] == st.n_splits
    assert st.counters["executor.retried"] == st.counters["executor.skipped_existing"] == 0


@pytest.mark.parametrize("kw", [{}, {"mark_duplicates": True}, {"sort_order": "queryname"}],
                         ids=["coordinate", "markdup", "queryname"])
def test_external_salvage_sort_matches_in_core(bam_corpus, tmp_path, kw):
    """Under a budget: the reference's bytes and counters, and, at the
    budget's split geometry, the in-core salvage's record sequence."""
    ranks = [6, 21]
    xp = _corrupt(bam_corpus, tmp_path / "ext.bam", ranks)
    budget = 64 << 10
    _, o2, _, _ = both("sort_bam", [xp], tmp_path, tag="ext", backend="host", level=1,
                       errors="salvage", memory_budget=budget, **kw)
    _, o1, _, _ = both("sort_bam", [xp], tmp_path, tag="in", backend="host", level=1,
                       errors="salvage", split_size=max(64 << 10, budget // 16), **kw)
    r1, r2 = jbam.read_bam(o1)[1], jbam.read_bam(o2)[1]
    assert [r.raw for r in r1] == [r.raw for r in r2] and len(r1) > 0


def test_external_salvage_fixmate(bam_corpus, tmp_path):
    xp = _corrupt(bam_corpus, tmp_path / "extfm.bam", [6, 21])
    st, _, _, _ = both("fixmate_bam", [xp], tmp_path, level=1, errors="salvage",
                       memory_budget=64 << 10)
    assert st.backend == "collate-fixmate[budget]"
    # Both passes read the damaged splits, as the reference's do.
    assert st.counters["salvage.members_quarantined"] == 4


# ---------------------------------------------------------------------------
# BGZF EOF marker, torn tails, the CRC gate, the codec's tier-downs
# ---------------------------------------------------------------------------


def test_missing_eof_marker_flagged(bam_corpus, tmp_path):
    clean = bam_corpus["clean"]
    p_ok = tmp_path / "with_eof.bam"
    p_ok.write_bytes(clean)
    p_trunc = tmp_path / "no_eof.bam"
    p_trunc.write_bytes(clean[: -len(bgzf.TERMINATOR)])
    m = Metrics()
    assert bgzf.BgzfReader(str(p_ok), metrics=m).truncated is False
    assert m.get("bgzf.missing_eof") == 0
    for path in (str(p_trunc),):
        before = snapshot()
        assert jbgzf.BgzfReader(path).truncated is True
        r = bgzf.BgzfReader(path, metrics=m)
        assert r.truncated is True
        assert m.get("bgzf.missing_eof") == delta(before)["counters"]["bgzf.missing_eof"] == 1
    assert bgzf.BgzfReader(clean[: 1 << 16]).truncated is None
    assert bgzf.has_eof_terminator(clean) and not bgzf.has_eof_terminator(clean[:-1])


def test_torn_tail_strict_raises_salvage_stops(bam_corpus, tmp_path):
    clean = bam_corpus["clean"]
    co, cs, us = bgzf.scan_blocks(clean)
    torn = clean[: int(co[-2] + cs[-2] // 2)]
    p = tmp_path / "torn.bam"
    p.write_bytes(torn)
    r = bgzf.BgzfReader(str(p))
    assert r.truncated is True
    r.seek_voffset(bgzf.make_voffset(int(co[-2]), 0))
    with pytest.raises(bgzf.BgzfError):
        r.read(1)
    m = Metrics()
    r2 = bgzf.BgzfReader(str(p), errors="salvage", metrics=m)
    r2.seek_voffset(bgzf.make_voffset(int(co[-3]), 0))
    got = r2.read(1 << 20)
    before = snapshot()
    j = jbgzf.BgzfReader(str(p), errors="salvage")
    j.seek_voffset(jbgzf.make_voffset(int(co[-3]), 0))
    assert got == j.read(1 << 20) and len(got) == int(us[-3])
    assert r2.at_eof
    assert m.get("salvage.torn_tail") == delta(before)["counters"]["salvage.torn_tail"] == 1
    with pytest.raises(ValueError, match="strict|salvage"):
        bgzf.BgzfReader(torn, errors="lenient")


# ---------------------------------------------------------------------------
# Byte-I/O seam: transient errors and disk bit-flips through io/fs.py
# ---------------------------------------------------------------------------


def test_transient_read_error_retried_at_fs_seam(bam_corpus):
    path = bam_corpus["clean_path"]
    jfmt = JFormat()
    fmt = BamInputFormat()
    jsplits = jfmt.get_splits([path], split_size=1 << 30)
    splits = fmt.get_splits([path], split_size=1 << 30)
    arm_both("io.read.error:n=1,path=clean.bam")
    before = snapshot()
    want = jfmt.read_split(jsplits[0])
    d = delta(before)["counters"]
    got = fmt.read_split(splits[0])
    assert got.n_records == want.n_records == 1500
    c = fmt.metrics.counters()
    assert c["io.read_retries"] == d["io.read_retries"] == 1
    assert c["faults.fired.io.read.error"] == d["faults.fired.io.read.error"] == 1
    same_counters(c, d)
    assert _records_of([got]) == _records_of([want])


def test_fs_seam_bitflip_feeds_salvage(bam_corpus):
    """The flip is in the read path (a bad disk byte), not in the file:
    salvage quarantines the member it lands in, and, the flip being
    offset-pinned and persistent, the widened re-reads see it too."""
    blocks, idx, _ = _record_members(bam_corpus)
    co = blocks[idx[9]].coffset
    arm_both(f"io.read.bitflip:offset={co + 25},path=clean.bam")
    got, want, m, d = _read_both(bam_corpus["clean_path"])
    assert m.get("salvage.members_quarantined") == d.get("salvage.members_quarantined") == 1
    assert m.get("faults.fired.io.read.bitflip") >= 1
    same_counters(m.counters(), d)
    assert _records_of(got) == _records_of(want)
    assert sorted(_records_of(got)) == sorted(_surviving_oracle(bam_corpus, [9]))


@pytest.mark.parametrize("scheme", ["", "file://"])
def test_sort_retries_every_read_of_its_input(bam_corpus, tmp_path, scheme):
    """Every read of a sort's input (the header, the split plan's whole-file
    read, the split windows) is retried on a transient error into the job's
    counters: two injected errors cost two retries and change no byte.
    Deviation: the reference retries only the split windows, so the same
    plan fails its sort at the header read."""
    src = scheme + bam_corpus["clean_path"]
    clean = str(tmp_path / "clean.bam")
    pipeline.sort_bam(bam_corpus["clean_path"], clean, conf=from_reference_conf(HOST),
                      device="cpu", split_size=6000)
    faults.arm("io.read.error:n=2,path=clean.bam")
    out = str(tmp_path / "retried.bam")
    st = pipeline.sort_bam(src, out, conf=from_reference_conf(HOST), device="cpu",
                           split_size=6000)
    assert _bytes(out) == _bytes(clean)
    assert st.counters["io.read_retries"] == 2
    assert st.counters["faults.fired.io.read.error"] == 2
    jfaults.arm("io.read.error:n=2,path=clean.bam")
    with pytest.raises(OSError):
        jpipeline.sort_bam(src, str(tmp_path / "ref.bam"), conf=JConf(HOST), backend="host")


def test_forced_tierdown_cascade_bit_exact():
    """The codec's forced member tier-downs: the deflate side's members go
    to host zlib (the reference's bytes), the inflate side's to the host,
    and both streams decode to their input."""
    from hadoop_bam_tpu.ops import flate as jflate
    from hadoop_bam_tpu_torch.ops import flate

    rng = np.random.default_rng(5)
    data = bytes(rng.integers(65, 91, 6000, dtype=np.uint8))
    clean_blob = flate.bgzf_compress_device(data, level=1, block_payload=1024, use_lanes=False,
                                            device="cpu")
    arm_both("flate.deflate.tierdown:members=1,3,n=2")
    m = Metrics()
    forced = flate.bgzf_compress_device(data, level=1, block_payload=1024, use_lanes=False,
                                        device="cpu", metrics=m)
    jforced = jflate.bgzf_compress_device(data, level=1, block_payload=1024, use_lanes=False)
    assert forced == jforced != clean_blob
    assert m.get("faults.fired.flate.deflate.tierdown") == 2
    assert jbgzf.decompress_all(forced) == data
    arm_both("flate.inflate.tierdown:members=*,n=*")
    m, st = Metrics(), flate.CodecTierStats()
    before = snapshot()
    jout = jflate.bgzf_decompress_device(forced)
    d = delta(before)["counters"]
    out = flate.bgzf_decompress_device(forced, device="cpu", metrics=m, stats=st)
    assert out == jout == data
    assert m.get("faults.fired.flate.inflate.tierdown") == \
        d["faults.fired.flate.inflate.tierdown"] >= 2
    assert st.host == jflate.LAST_INFLATE_STATS.host >= 2


def test_detected_payload_corruption_caught_at_crc_gate(bam_corpus):
    clean = bam_corpus["clean"]
    faults.arm("flate.corrupt:n=1")
    with pytest.raises(bgzf.BgzfError, match="CRC|ISIZE"):
        bgzf.inflate_block(clean, 0)
    payload, _ = bgzf.inflate_block(clean, 0)  # the budget is spent
    assert len(payload) > 0
    arm_both("flate.corrupt:n=1")
    m = Metrics()
    r = bgzf.BgzfReader(clean, errors="salvage", check_eof=False, metrics=m)
    assert r.read(10) == b""  # the first member quarantined: a clean EOF
    before = snapshot()
    assert jbgzf.BgzfReader(clean, errors="salvage", check_eof=False).read(10) == b""
    d = delta(before)["counters"]
    assert m.get("salvage.torn_tail") == d["salvage.torn_tail"] == 1
    assert m.get("faults.fired.flate.corrupt") == d["faults.fired.flate.corrupt"] == 1


# ---------------------------------------------------------------------------
# The executor: validation, torn writes, backoff, deadlines, quarantine
# ---------------------------------------------------------------------------


def _bgzf_part_writer(item, tmp):
    with open(tmp, "wb") as f:
        f.write(bgzf.compress_block(f"payload-{item}".encode()))


def _run_both(make, tmp_path, items, work, plan=None):
    """The same executor run in both packages: ``(port report, port
    metrics, reference report, reference delta)``; ``make(mod, out_dir,
    metrics)`` builds each package's executor."""
    m = Metrics()
    if plan:
        arm_both(plan)
    before = snapshot()
    jrep = make(jexecutor, str(tmp_path / "ref"), None).run(items, work)
    d = delta(before)["counters"]
    rep = make(texecutor, str(tmp_path / "port"), m).run(items, work)
    return rep, m, jrep, d


def _kw(mod, m):
    return {} if mod is jexecutor else {"metrics": m}


def test_resume_validates_existing_parts(tmp_path):
    for side in ("ref", "port"):
        out = tmp_path / side
        out.mkdir()
        (out / "part-r-00000").write_bytes(b"")  # a crashed replace's zero bytes
        (out / "part-r-00001").write_bytes(b"GARBAGE-NOT-BGZF")
        (out / "part-r-00002").write_bytes(bgzf.compress_block(b"good"))
    calls = []

    def work(item, tmp):
        calls.append(item)
        _bgzf_part_writer(item, tmp)

    rep, m, jrep, d = _run_both(
        lambda mod, out, mm: mod.ElasticExecutor(out, validate_part=mod.bgzf_part_valid,
                                                 **_kw(mod, mm)),
        tmp_path, [0, 1, 2], work)
    assert sorted(calls) == [0, 0, 1, 1]  # the torn parts redone, the valid one trusted
    assert rep.skipped_existing == jrep.skipped_existing == 1
    assert m.get("executor.invalid_part_redone") == d["executor.invalid_part_redone"] == 2
    same_counters(m.counters(), d)
    assert bgzf_part_valid(str(tmp_path / "port" / "part-r-00000"))
    # Without a validator any existing file is trusted.
    (tmp_path / "port" / "part-r-00001").write_bytes(b"")
    assert ElasticExecutor(str(tmp_path / "port")).run([0, 1, 2], work).skipped_existing == 3


def test_torn_tmp_write_retried_and_swept(tmp_path):
    rep, m, jrep, d = _run_both(
        lambda mod, out, mm: mod.ElasticExecutor(out, **_kw(mod, mm)),
        tmp_path, [0], _bgzf_part_writer, plan="exec.torn:items=0,attempts=0,n=1")
    assert rep.retried == jrep.retried == 1
    same_counters(m.counters(), d)
    assert m.get("faults.fired.exec.torn") == 1
    assert bgzf_part_valid(str(tmp_path / "port" / "part-r-00000"))
    assert not [p for p in os.listdir(tmp_path / "port") if p.startswith("_temporary")]


def test_retry_backoff_applied(tmp_path, monkeypatch):
    sleeps = {"port": [], "ref": []}
    monkeypatch.setattr(texecutor.time, "sleep", lambda s: sleeps["port"].append(s))

    def hook(i, attempt):
        if attempt < 2:
            raise IOError("transient")

    ElasticExecutor(str(tmp_path / "out"), max_attempts=3, fault_hook=hook,
                    retry_backoff=0.1).run([0], _bgzf_part_writer)
    monkeypatch.setattr(jexecutor.time, "sleep", lambda s: sleeps["ref"].append(s))
    jexecutor.ElasticExecutor(str(tmp_path / "jout"), max_attempts=3, fault_hook=hook,
                              retry_backoff=0.1).run([0], _bgzf_part_writer)
    assert len(sleeps["port"]) == 2 and sleeps["port"][1] > sleeps["port"][0]
    assert sleeps["port"] == sleeps["ref"]  # the reference's jitter


def test_attempt_deadline_counts_as_failure(tmp_path):
    def make_work():
        slow_once = {"done": False}

        def work(item, tmp):
            if not slow_once["done"]:
                slow_once["done"] = True
                time.sleep(1.0)
            _bgzf_part_writer(item, tmp)
        return work

    m = Metrics()
    before = snapshot()
    jrep = jexecutor.ElasticExecutor(str(tmp_path / "ref"), max_attempts=2,
                                     attempt_timeout=0.2).run([0], make_work())
    d = delta(before)["counters"]
    rep = ElasticExecutor(str(tmp_path / "out"), max_attempts=2, attempt_timeout=0.2,
                          metrics=m).run([0], make_work())
    assert rep.retried == jrep.retried == 1
    assert m.get("executor.attempt_timeouts") == d["executor.attempt_timeouts"] == 1
    same_counters(m.counters(), d)
    nio.check_success(tmp_path / "out")
    time.sleep(1.0)  # the abandoned attempt ends; it never renames
    assert [p.name for p in nio.list_parts(tmp_path / "out")] == ["part-r-00000"]
    assert bgzf_part_valid(str(tmp_path / "out" / "part-r-00000"))


def test_quarantine_mode_skips_dead_part(tmp_path):
    def hook(i, attempt):
        if i == 1:
            raise RuntimeError("device on fire")

    with pytest.raises(PartFailedError):
        ElasticExecutor(str(tmp_path / "strict"), max_attempts=2,
                        fault_hook=hook).run([0, 1, 2], _bgzf_part_writer)
    rep, m, jrep, d = _run_both(
        lambda mod, out, mm: mod.ElasticExecutor(out, max_attempts=2, fault_hook=hook,
                                                 quarantine=True, **_kw(mod, mm)),
        tmp_path, [0, 1, 2], _bgzf_part_writer)
    assert rep.quarantined == jrep.quarantined == [1]
    assert m.get("salvage.parts_quarantined") == 1
    same_counters(m.counters(), d)
    nio.check_success(tmp_path / "port")
    assert [p.name for p in nio.list_parts(tmp_path / "port")] == [
        "part-r-00000", "part-r-00002"]


def test_injected_crash_quarantines_exactly_its_part(bam_corpus, tmp_path):
    """``exec.crash:items=1,attempts=*`` under salvage: part 1 fails every
    attempt and is quarantined; the job completes with the reference's
    bytes (the other parts) and counters."""
    xp = _corrupt(bam_corpus, tmp_path / "crash.bam", [LAST_SPLIT_RANK])
    st, out, _, _ = both("sort_bam", xp, tmp_path, level=1, split_size=6000,
                         errors="salvage", plan="exec.crash:items=1,attempts=*,n=*",
                         max_attempts=2)
    assert st.counters["salvage.parts_quarantined"] == 1
    assert st.counters["executor.failed_parts"] == 1
    assert st.counters["faults.fired.exec.crash"] == 2
    # Strict: the same crash fails the job, and no _SUCCESS is written.
    faults.arm("exec.crash:items=1,attempts=*,n=*")
    pdir = str(tmp_path / "strict_parts")
    with pytest.raises(PartFailedError):
        pipeline.sort_bam(bam_corpus["clean_path"], str(tmp_path / "strict.bam"),
                          conf=from_reference_conf(HOST), device="cpu", level=1,
                          split_size=6000, max_attempts=1, part_dir=pdir)
    assert not os.path.exists(os.path.join(pdir, "_SUCCESS"))


# ---------------------------------------------------------------------------
# The split drive, the BCF quarantine, the standing deviation
# ---------------------------------------------------------------------------


class _FakeFmt:
    """A format whose split ``fail`` raises its ``error``."""

    def __init__(self, n, fail=(), error=None):
        self.splits = list(range(n))
        self.fail = set(fail)
        self.error = error or bgzf.BgzfError("corrupt split")

    def read_split(self, s, **kw):
        from hadoop_bam_tpu_torch.io.bam import RecordBatch

        if s in self.fail:
            raise self.error
        return RecordBatch(soa={"rec_off": np.array([4], np.int64),
                                "rec_len": np.array([0], np.int64)},
                           data=np.full(1, s, dtype=np.uint8), keys=np.array([s], np.int64))


def test_salvage_empty_batch_mid_stream_keeps_slot_and_order():
    for depth in ("1", "2"):
        stream = DeviceStream(CPU, Configuration({"hadoopbam.read.depth": depth}))
        fmt = _FakeFmt(5, fail={2})
        out = list(stream.read_splits(fmt, fmt.splits, errors="salvage"))
        assert [b.n_records for b in out] == [1, 1, 0, 1, 1]
        assert [int(b.data[0]) for i, b in enumerate(out) if i != 2] == [0, 1, 3, 4]
        assert stream.metrics.get("salvage.splits_failed") == 1
        with pytest.raises(bgzf.BgzfError):
            list(DeviceStream(CPU).read_splits(_FakeFmt(4, fail={1}), range(4), errors="strict"))


def test_salvage_does_not_swallow_a_kernel_failure(bam_corpus, tmp_path, monkeypatch):
    """The standing deviation: the split drive catches data errors by class;
    a kernel's ``RuntimeError`` raises through salvage (the reference
    catches every exception)."""
    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin

    def broken(*a, **k):
        raise RuntimeError("inflate_members: CUDA error 700 at launch")

    stream = DeviceStream(CPU)
    with pytest.raises(RuntimeError, match="CUDA error"):
        list(stream.read_splits(_FakeFmt(3, fail={1}, error=RuntimeError("CUDA error 700")),
                                range(3), errors="salvage"))
    monkeypatch.setattr(kin, "inflate_members", broken)
    xp = _corrupt(bam_corpus, tmp_path / "k.bam", [4])
    with pytest.raises(RuntimeError, match="CUDA error"):
        pipeline.sort_bam(xp, str(tmp_path / "o.bam"), device="cpu", errors="salvage",
                          conf=Configuration({"hadoopbam.inflate.lanes": "true"}))


def _bcf_corpus(tmp_path):
    from test_variant_plane import _encode_bcf, _make_variants

    vcf, variants = _make_variants()
    data = _encode_bcf(vcf, variants)
    path = str(tmp_path / "calls.bcf")
    with open(path, "wb") as f:
        f.write(data)
    return path, variants, data


def test_bcf_salvage_quarantines_exactly_one_member(tmp_path):
    from hadoop_bam_tpu.io.bcf import BcfInputFormat as JBcf
    from hadoop_bam_tpu_torch.io.bcf import BcfInputFormat
    from test_variant_plane import TestSalvage, _whole_file_split

    _, variants, data = _bcf_corpus(tmp_path)
    bad, n_members = TestSalvage._corrupt_middle_member(None, data)
    bad_path = str(tmp_path / "bad.bcf")
    with open(bad_path, "wb") as f:
        f.write(bad)
    split = _whole_file_split(bad_path)
    with pytest.raises(bgzf.BgzfError):
        BcfInputFormat().read_split(split, errors="strict")
    before = snapshot()
    want = JBcf(JConf()).read_split(split, errors="salvage")
    d = delta(before)["counters"]
    for gates in ({}, {"hadoopbam.bcf.chain": "true", "hadoopbam.inflate.lanes": "true"}):
        stream = DeviceStream(CPU, Configuration(gates))
        fmt = BcfInputFormat(Configuration(gates), metrics=stream.metrics)
        got = fmt.read_split(split, stream=stream, errors="salvage")
        assert [int(k) for k in got.keys] == [int(k) for k in want.keys]
        assert [v.format_line() for v in got.variants] == [v.format_line() for v in want.variants]
        m = stream.metrics
        assert m.get("salvage.members_quarantined") == 1 and m.get("salvage.bytes_quarantined")
        same_counters(m.counters(), d)
        assert 0 < len(variants) - got.n_records < 3 * (len(variants) // n_members + 2)


def test_bcf_salvage_window_query_equals_the_reference(tmp_path):
    """``variants_blob`` with ``hadoopbam.errors=salvage`` over a call set
    with one flipped member: the reference's blob."""
    from hadoop_bam_tpu.serve import endpoints as jend
    from hadoop_bam_tpu_torch.serve import endpoints as tend
    from test_variant_plane import TestSalvage

    path, _, data = _bcf_corpus(tmp_path)
    bad, _ = TestSalvage._corrupt_middle_member(None, data)
    bad_path = str(tmp_path / "bad.bcf")
    with open(bad_path, "wb") as f:
        f.write(bad)
    conf = {"hadoopbam.errors": "salvage"}
    ctx = jend.ServeContext.from_conf(JConf(conf), with_batcher=False)
    want = jend.variants_blob(ctx, bad_path, "chr1")
    for gates in ({}, {"hadoopbam.bcf.chain": "true", "hadoopbam.inflate.lanes": "true"}):
        tctx = tend.ServeContext.from_conf(Configuration(dict(conf, **gates)),
                                           with_batcher=False, device="cpu")
        got = tend.variants_blob(tctx, bad_path, "chr1")
        assert got == want
        assert tctx.metrics.get("salvage.members_quarantined") == 1

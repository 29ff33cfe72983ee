"""The multi-process sort's skew healing and collation ranks against the
reference's.  Case list: the reference's ``tests/test_mesh_skew.py`` less
fixmate (``test_torch_multihost_fixmate.py``) and ``mesh_report``
(``test_torch_mesh_trace.py``):

- the wide (queryname) key row: 29 bytes a routed row, read off the bytes
  that cross the processes' ``all_to_all_single`` (a one-rank gloo group),
  and the group's columns equal to the one-process mesh's;
- ``_reservoir_splitters`` on a zipfian pool: balanced cuts, and the
  reference's splitters for the same draw;
- queryname rejects ``memory_budget``;
- the queryname mesh sort against the single-process queryname sort of
  both packages, with ``mh.rank.names``;
- the zipfian repartition: one refresh, ``mh.repartition.*`` counters and
  gauges equal to the reference's, ``ratio_after < ratio_before``, and
  the single-process sort's bytes;
- ``group_representatives`` and ``global_name_ranks`` equal to the
  reference's on the same columns;
- speculation: ``_promote_part``'s first-wins race, ``_try_read_json`` on
  absent and torn markers, ``_maybe_speculate`` over markers written
  beforehand, ``_ByteFetcher(dest_pid=)``'s counters, ``_speculate_stage``
  winning and losing on a byte plane written by ``_write_byte_runs`` (the
  ``mh.speculate.lose`` seam), a row-1 failure that propagates, and the
  reference's two-process win and lose drills."""

import json
import os
import sys
import threading

import numpy as np
import pytest

from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.parallel import multihost as jm
from hadoop_bam_tpu_torch import faults as tfaults
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.device_stream import DeviceStream
from hadoop_bam_tpu_torch.ops.keys import split_keys_np
from hadoop_bam_tpu_torch.parallel import DistributedSort
from hadoop_bam_tpu_torch.parallel import multihost as tm
from hadoop_bam_tpu_torch.parallel.mesh import ProcessLayout
from hadoop_bam_tpu_torch.spec import bgzf
from hadoop_bam_tpu_torch.utils.tracing import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from bench import synth_bam  # noqa: E402
from test_mesh_skew import _synth_zipf_bam  # noqa: E402

SPLIT = 1 << 16


@pytest.fixture(scope="module")
def bam_paired(tmp_path_factory):
    """Consecutive rows share a name with FIRST/SECOND flags."""
    p = str(tmp_path_factory.mktemp("mh_skew") / "paired.bam")
    synth_bam(p, 4_000, paired=True)
    return p


def _stream(path):
    with open(path, "rb") as f:
        return bgzf.decompress_all(f.read())


def _jreport():
    from hadoop_bam_tpu.utils.tracing import METRICS

    return METRICS.report()


def _jdelta(before, after):
    return {k: v - before["counters"].get(k, 0) for k, v in after["counters"].items()
            if k.startswith("mh.") and v - before["counters"].get(k, 0)}


def test_wide_key_row_crosses_the_processes_at_29_bytes(tmp_path, monkeypatch):
    """The queryname sort's key row across processes: the bytes each
    ``all_to_all_single`` row carries are ``capacity * 29`` (key, key2,
    valid, src_dev, src_row, orig), ``ds.key_row_bytes``; through a
    one-rank gloo group every column equals the one-process mesh's."""
    ctx = tm.initialize(init_method=f"file://{tmp_path / 'rdv'}", num_processes=1, process_id=0,
                        device="cpu", shards=4, timeout_s=60)
    try:
        assert ctx.mesh.layout.transport == "gloo" and ctx.global_device_count == 4
        sent = []
        a2a = ProcessLayout.all_to_all

        def spy(self, t):
            sent.append(tuple(t.shape))
            return a2a(self, t)

        monkeypatch.setattr(ProcessLayout, "all_to_all", spy)
        rng = np.random.default_rng(3)
        rows = 64
        n = 4 * rows
        hi, lo = split_keys_np(rng.integers(0, 50, n, dtype=np.int64) << 20)
        hi2, lo2 = split_keys_np(rng.integers(0, 1 << 40, n, dtype=np.int64))
        valid = rng.random(n) < 0.9
        orig = np.arange(n, dtype=np.int32)
        ds = DistributedSort(ctx.mesh, rows, samples_per_device=8, key_words=2)
        got = ds(hi, lo, valid, orig, hi2=hi2, lo2=lo2)
        assert ds.key_row_bytes == 29
        assert sent == [(1, 4, 4, ds.capacity * ds.key_row_bytes)]
        one = DistributedSort(tm.initialize(device="cpu", shards=4).mesh, rows,
                              samples_per_device=8, key_words=2)(hi, lo, valid, orig,
                                                                  hi2=hi2, lo2=lo2)
        for f in got._fields:
            a, b = getattr(got, f).numpy(), getattr(one, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    finally:
        ctx.close()


def test_reservoir_splitters_balance_zipf_pool():
    """The rescue's splitters are the balanced quantiles of the gathered
    reservoir (and the reference's for the same draw): every slab holds
    about |pool| / D keys."""
    keys = (190_000_000 * np.random.default_rng(3).random(20_000) ** 6).astype(np.int64)
    sp, n_pool = tm._reservoir_splitters(tm.initialize(device="cpu"), keys, 4096, 8,
                                         np.random.default_rng(5))
    jsp, jn = jm._reservoir_splitters(jm.initialize(), keys, 4096, 8, np.random.default_rng(5))
    assert n_pool == jn == 4096
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(sp, jsp))
    sp_hi, sp_lo = sp
    assert len(sp_hi) == len(sp_lo) == 7
    k_hi, k_lo = split_keys_np(keys)
    ge = (k_hi[:, None] > sp_hi[None, :]) | (
        (k_hi[:, None] == sp_hi[None, :]) & (k_lo[:, None] >= sp_lo[None, :]))
    counts = np.bincount(ge.sum(axis=1), minlength=8)
    assert counts.max() / counts.mean() < 1.25, counts


def test_queryname_rejects_memory_budget():
    with pytest.raises(ValueError, match="in-core"):
        tm.sort_bam_multihost(["x.bam"], "y.bam", ctx=tm.initialize(device="cpu"),
                              memory_budget=1 << 20, sort_order="queryname", device="cpu")


def test_queryname_mesh_matches_pipeline_oracle(bam_paired, tmp_path):
    """The queryname sort through the distributed rank pass: the
    single-process queryname sort's record stream (both packages'), the
    reference's mesh bytes and counters, ``SO:queryname``, and one rank a
    distinct name (two records share each)."""
    oracle = str(tmp_path / "oracle.bam")
    port_single = str(tmp_path / "single.bam")
    out, j_out = str(tmp_path / "mesh.bam"), str(tmp_path / "jmesh.bam")
    jpipeline.sort_bam([bam_paired], oracle, sort_order="queryname", split_size=SPLIT, level=1)
    tpipeline.sort_bam(bam_paired, port_single, sort_order="queryname", split_size=SPLIT,
                       level=1, device="cpu")
    m = MetricsRegistry()
    n = tm.sort_bam_multihost(bam_paired, out, ctx=tm.initialize(device="cpu", shards=8),
                              split_size=SPLIT, level=1, sort_order="queryname",
                              device="cpu", metrics=m)
    before = _jreport()
    jm.sort_bam_multihost([bam_paired], j_out, ctx=jm.initialize(), split_size=SPLIT, level=1,
                          sort_order="queryname")
    after = _jreport()
    assert n == 4_000
    got = _stream(out)
    assert got == _stream(oracle) == _stream(port_single)
    assert b"SO:queryname" in got[: 4 << 10]
    with open(out, "rb") as f, open(j_out, "rb") as g:
        assert f.read() == g.read()
    mh = {k: v for k, v in m.counters().items() if k.startswith("mh.") and v}
    assert mh == _jdelta(before, after)
    assert mh["mh.rank.names"] == 2_000


def test_zipf_repartition_heals_skew(tmp_path):
    """A zipfian corpus under a starved election (2 samples a shard)
    routes skewed; the sort re-cuts the splitters from the reservoir
    once, and the refreshed cuts heal the round: ``ratio_after <
    ratio_before``, no capacity retry, the reference's counters and
    gauges, and the single-process sort's bytes."""
    src = str(tmp_path / "zipf.bam")
    _synth_zipf_bam(src, 6_000)
    out, j_out = str(tmp_path / "zipf.sorted.bam"), str(tmp_path / "jzipf.sorted.bam")
    m = MetricsRegistry()
    n = tm.sort_bam_multihost(src, out, ctx=tm.initialize(device="cpu", shards=8),
                              split_size=SPLIT, level=1, samples_per_device=2, device="cpu",
                              metrics=m)
    before = _jreport()
    jm.sort_bam_multihost([src], j_out, ctx=jm.initialize(), split_size=SPLIT, level=1,
                          samples_per_device=2)
    after = _jreport()
    assert n == 6_000
    c = m.counters()
    assert c["mh.repartition.triggered"] == 1 and c["mh.repartition.sample_keys"] > 0
    assert c.get("mh.shuffle.capacity_retry", 0) == 0
    assert {k: v for k, v in c.items() if k.startswith("mh.") and v} == _jdelta(before, after)
    g, jg = m.gauges(), after["gauges"]
    for k in ("mh.repartition.ratio_before", "mh.repartition.ratio_after", "mh.skew_ratio"):
        assert g[k] == jg[k], k
    assert g["mh.repartition.ratio_before"] > 1.5
    assert g["mh.repartition.ratio_after"] < g["mh.repartition.ratio_before"]
    oracle = str(tmp_path / "zipf_oracle.bam")
    tpipeline.sort_bam(src, oracle, split_size=SPLIT, level=1, device="cpu")
    assert _stream(out) == _stream(oracle)
    with open(out, "rb") as f, open(j_out, "rb") as h:
        assert f.read() == h.read()


def _name_columns(path, collate, read_split, collation_columns, **kw):
    from hadoop_bam_tpu_torch.io.bam import BamInputFormat

    fmt = BamInputFormat()
    parts = []
    for s in fmt.get_splits([path], split_size=SPLIT):
        b = read_split(fmt, s)
        parts.append(collation_columns(b.data, b.soa))
    cols = collate.concat_collation(parts)
    n = len(cols["qh1"])
    col = collate.collate_by_name(cols, candidates=np.zeros(n, np.int32), **kw)
    col, _ = collate.verify_and_repair(col, cols)
    return cols, col


@pytest.mark.parametrize("names", ["paired", "natural"])
def test_group_representatives_and_global_name_ranks(bam_paired, tmp_path, names):
    """One name a verified group, and the dense natural-order ranks of a
    union of per-process lists (names in both lists rank once), equal to
    the reference's on the same columns."""
    from hadoop_bam_tpu import collate as jcollate
    from hadoop_bam_tpu_torch import collate as tcollate
    from hadoop_bam_tpu_torch.io.bam import SORT_FIELDS

    fields = tuple(dict.fromkeys(SORT_FIELDS + ("l_read_name",)))

    def read(fmt, s):
        return fmt.read_split(s, fields=fields, with_keys=False)

    cols, col = _name_columns(bam_paired, tcollate, read, tcollate.collation_columns,
                              device="cpu")
    jcols, jcol = _name_columns(bam_paired, jcollate, read, jcollate.collation_columns)
    reps = tcollate.group_representatives(cols, col)
    assert reps == jcollate.group_representatives(jcols, jcol)
    if names == "paired":
        lists = [reps[: len(reps) // 2 + 50], reps[len(reps) // 2 :]]
    else:
        rng = np.random.default_rng(9)
        pool = [b"r%d" % i for i in range(40)] + [b"r0%d" % i for i in range(20)] + [
            b"x%d:%d" % (a, b) for a, b in rng.integers(0, 30, (60, 2))] + [b"a", b"A", b"a00"]
        lists = [list(rng.choice(pool, 50)), list(rng.choice(pool, 70)), []]
    ranks = tcollate.global_name_ranks(lists)
    assert ranks == jcollate.global_name_ranks(lists)
    assert sorted(ranks.values()) == list(range(len(set().union(*lists))))


# ---------------------------------------------------------------------------
# Speculative re-execution: one-process units.
# ---------------------------------------------------------------------------


def test_promote_part_first_wins(tmp_path):
    """Two first-wins copies of one part: the first links and wins, the
    second gets ``(False, its size)``, the part keeps the first's bytes and
    no temporary is left; without first-wins the rename replaces."""
    td = str(tmp_path)

    def writer(payload):
        return lambda f: f.write(payload)

    assert tm._promote_part(td, 0, 3, writer(b"A" * 10), first_wins=True) == (True, 10)
    assert tm._promote_part(td, 1, 3, writer(b"B" * 7), first_wins=True) == (False, 7)
    with open(tmp_path / "part-r-00003", "rb") as f:
        assert f.read() == b"A" * 10
    assert sorted(os.listdir(td)) == ["part-r-00003"]
    assert tm._promote_part(td, 1, 3, writer(b"C"), first_wins=False) == (True, 0)
    with open(tmp_path / "part-r-00003", "rb") as f:
        assert f.read() == b"C"
    assert sorted(os.listdir(td)) == ["part-r-00003"]


def test_try_read_json_absent_torn_and_whole(tmp_path):
    """The poll loop's read: an absent or torn marker reads as None (the
    reference's reader agrees), a whole one as its dict."""
    whole, torn = str(tmp_path / "whole.json"), str(tmp_path / "torn.json")
    tm._write_done_marker(str(tmp_path), 4, 1.25)
    os.replace(tm._done_marker(str(tmp_path), 4), whole)
    with open(torn, "w") as f:
        f.write('{"pid": 1, "dur')
    for p in (str(tmp_path / "absent.json"), torn, whole):
        assert tm._try_read_json(p) == jm._try_read_json(p)
    assert tm._try_read_json(whole) == {"pid": 4, "dur_s": 1.25}
    assert tm._try_read_json(torn) is None
    with open(tmp_path / "bytes.json", "wb") as f:
        f.write(b"\xff\xfe{")
    assert tm._try_read_json(str(tmp_path / "bytes.json")) is None


def _fake_ctx(pid, n_proc, shards, timeout_s=60.0):
    import torch

    from hadoop_bam_tpu_torch.parallel import Mesh, MultihostContext

    return MultihostContext(pid, n_proc, Mesh([torch.device("cpu")] * shards), timeout_s)


@pytest.mark.parametrize("who", ["speculator", "bystander"])
def test_maybe_speculate_over_prewritten_markers(tmp_path, monkeypatch, who):
    """The poll loop on markers written beforehand, with the stage itself
    stubbed: the lowest finished process re-runs the first missing one's
    stage once and returns when every marker is there, with the
    reference's block; any other process only waits."""
    td = str(tmp_path)
    calls = []

    def stub(target, write_marker):
        calls.append(target)
        write_marker(td, target, 9.0)  # the straggler ends
        return {"launched": 1, "target": target, "won_parts": 2, "wasted_bytes": 0}

    if who == "bystander":
        for p in (0, 1):
            tm._write_done_marker(td, p, 0.5)
        monkeypatch.setattr(tm, "_speculate_stage", lambda *a: calls.append(a))
        timer = threading.Timer(0.3, tm._write_done_marker, (td, 2, 5.0))
        timer.start()
        try:
            got = tm._maybe_speculate(_fake_ctx(1, 3, 1), td, [], 8, None, True, 1, None, 1.0,
                                      0.5, 1)
        finally:
            timer.join(5)
        assert not timer.is_alive()
        assert got == {} and calls == []
        return
    tm._write_done_marker(td, 0, 0.5)
    monkeypatch.setattr(tm, "_speculate_stage",
                        lambda *a: stub(a[8], tm._write_done_marker))
    got = tm._maybe_speculate(_fake_ctx(0, 2, 1), td, [], 8, None, True, 1, None, 1.5, 0.5, 1)
    assert calls == [1]
    assert got == {"launched": 1, "target": 1, "won_parts": 2, "wasted_bytes": 0}
    # The reference's loop on the same markers.
    os.remove(tm._done_marker(td, 1))
    monkeypatch.setattr(jm, "_speculate_stage", lambda *a: stub(a[8], jm._write_done_marker))
    jctx = type("Ctx", (), {"process_id": 0, "num_processes": 2})()
    assert jm._maybe_speculate(jctx, td, [], 8, True, None, 1, None, 1.5, 0.5, 1, None, None,
                               None) == got
    assert calls == [1, 1]


def test_maybe_speculate_fails_on_a_dead_peer(tmp_path, monkeypatch):
    """A done marker that never comes (a dead peer) fails the poll after
    the context's timeout, as a collective on the group would, instead of
    polling for ever; no copy runs for a process that is not the lowest
    finished one."""
    td = str(tmp_path)
    for p in (0, 1):
        tm._write_done_marker(td, p, 0.5)
    monkeypatch.setattr(tm, "_speculate_stage", lambda *a: pytest.fail("speculated"))
    with pytest.raises(TimeoutError, match=r"processes \[2\]"):
        tm._maybe_speculate(_fake_ctx(1, 3, 1, timeout_s=0.3), td, [], 8, None, True, 1, None,
                            100.0, 0.5, 1)


def _fake_plane(tmp_path, src, compress, L=2):
    """A byte plane of two processes of ``L`` shards in one directory, as
    ``_write_byte_runs`` writes it, and the route of each of process 1's
    shards: ``(td, shuffle_dir, rows, {g_dev: (src_dev, src_row, expected
    part bytes)})``."""
    import io as _io

    import torch

    from hadoop_bam_tpu_torch.io.bam import BamInputFormat, RecordBatch, gather_record_array
    from hadoop_bam_tpu_torch.io.bam import write_part_fast

    fmt = BamInputFormat()
    b = fmt.read_split(fmt.get_splits([src], split_size=SPLIT)[0])
    n = b.n_records
    rows = -(-n // L)
    td = str(tmp_path / "parts")
    shuffle_dir = os.path.join(td, "shuffle")
    os.makedirs(shuffle_dir)
    rng = np.random.default_rng(17)
    ds = DeviceStream(torch.device("cpu"), metrics=MetricsRegistry())
    refs = []  # (g_dev, src_dev, src_row, record index)
    for s in range(2):
        slots = rng.permutation(L * rows)[:n].astype(np.int64)
        dest = rng.integers(0, 2 * L, n)
        tm._write_byte_runs(shuffle_dir, _fake_ctx(s, 2, L), b, dest, slots, rows, ds,
                            compress=compress, member_bytes=2048, level=1)
        for i in range(n):
            refs.append((int(dest[i]), s * L + int(slots[i]) // rows, int(slots[i]) % rows, i))
    routes = {}
    for g in range(L, 2 * L):
        mine = [r for r in refs if r[0] == g]
        order = np.array([r[3] for r in mine], np.int64)
        part = RecordBatch(soa={"rec_off": b.soa["rec_off"][order],
                                "rec_len": b.soa["rec_len"][order]}, data=b.data,
                           keys=np.zeros(len(order), np.int64))
        sd = np.array([r[1] for r in mine], np.int64)
        sr = np.array([r[2] for r in mine], np.int64)
        tm._write_route_sidecar(td, g, sd, sr)
        buf = _io.BytesIO()
        flat = gather_record_array(part)
        offs = np.concatenate([[0], np.cumsum(part.soa["rec_len"].astype(np.int64) + 4)])
        write_part_fast(buf, RecordBatch(soa={"rec_off": offs[:-1] + 4,
                                              "rec_len": part.soa["rec_len"]},
                                         data=flat, keys=part.keys), order=None, level=1)
        routes[g] = buf.getvalue()
    return td, shuffle_dir, rows, routes


@pytest.mark.parametrize("compress", [True, False], ids=["wire", "raw"])
def test_byte_fetcher_dest_pid_counts_speculate_bytes(bam_paired, tmp_path, compress):
    """A fetch of another process's share counts its wire bytes as
    ``mh.speculate.fetch_bytes`` and touches no recv counter; a fetch of
    its own counts the recv row as before."""
    import torch

    td, shuffle_dir, rows, _ = _fake_plane(tmp_path, bam_paired, compress)
    ext = ".bgzf" if compress else ".bin"
    wire = {d: sum(os.path.getsize(os.path.join(shuffle_dir, tm._bytes_name(s, d) + ext))
                   for s in range(2)) for d in range(2)}
    for dest_pid, want in ((None, None), (1, wire[1])):
        m = MetricsRegistry()
        ds = DeviceStream(torch.device("cpu"), metrics=m)
        tm._ByteFetcher([shuffle_dir] * 2, _fake_ctx(0, 2, 2), rows, ds, compress=compress,
                        fetch_threads=2, dest_pid=dest_pid)
        c = m.counters()
        if dest_pid is None:
            assert "mh.speculate.fetch_bytes" not in c
            assert sum(c[f"mh.shuffle.recv.{s}"] for s in range(2)) == wire[0]
        else:
            assert c == {"mh.speculate.fetch_bytes": want}


def test_speculate_stage_wins_then_loses_and_fires_the_lose_seam(bam_paired, tmp_path):
    """The speculative copy of process 1's stage from the byte plane: the
    first run links both parts (the bytes of a direct write of each route)
    and wins; a second copy loses both, counted as waste, and under
    ``mh.speculate.lose`` the seam fires before each promotion."""
    import torch

    td, shuffle_dir, rows, routes = _fake_plane(tmp_path, bam_paired, True)
    m = MetricsRegistry()
    ds = DeviceStream(torch.device("cpu"), metrics=m)
    ctx = _fake_ctx(0, 2, 2)
    got = tm._speculate_stage(ctx, td, [shuffle_dir] * 2, rows, ds, True, 2, None, 1, 1)
    assert got == {"launched": 1, "target": 1, "won_parts": 2, "wasted_bytes": 0}
    for g, want in routes.items():
        with open(os.path.join(td, f"part-r-{g:05d}"), "rb") as f:
            assert f.read() == want
    tfaults.arm("mh.speculate.lose:ms=1,n=*")
    try:
        again = tm._speculate_stage(ctx, td, [shuffle_dir] * 2, rows, ds, True, 2, None, 1, 1)
    finally:
        tfaults.disarm()
    sizes = sum(len(v) for v in routes.values())
    assert again == {"launched": 1, "target": 1, "won_parts": 0, "wasted_bytes": sizes}
    c = m.counters()
    assert (c["mh.speculate.launched"], c["mh.speculate.won"],
            c["mh.speculate.wasted_bytes"]) == (2, 2, sizes)
    assert c["faults.fired.mh.speculate.lose"] == 2
    assert not [n for n in os.listdir(td) if n.startswith("_tmp-")]


@pytest.mark.parametrize("errors", [None, "salvage"], ids=["strict", "salvage"])
def test_row_1_failure_in_the_speculative_fetch_raises(bam_paired, tmp_path, monkeypatch,
                                                       errors):
    """A failure of the inflate itself (a kernel or the card) inside the
    speculative fetch propagates, under salvage too, and promotes no
    part."""
    import torch

    td, shuffle_dir, rows, _ = _fake_plane(tmp_path, bam_paired, True)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tm, "_decode_wire", broken)
    ds = DeviceStream(torch.device("cpu"), metrics=MetricsRegistry())
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tm._speculate_stage(_fake_ctx(0, 2, 2), td, [shuffle_dir] * 2, rows, ds, True, 2,
                            errors, 1, 1)
    assert not [n for n in os.listdir(td) if n.startswith("part-r-")]


# ---------------------------------------------------------------------------
# Speculative re-execution: the reference's two-process drills.
# ---------------------------------------------------------------------------

_SPEC_WORKER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
sys.modules["jax"] = None  # the port's processes never load JAX
pid, rdv, src, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
from hadoop_bam_tpu_torch import faults
from hadoop_bam_tpu_torch.conf import MESH_SPECULATE_FACTOR, Configuration
from hadoop_bam_tpu_torch.parallel import multihost
from hadoop_bam_tpu_torch.utils.tracing import MetricsRegistry
ctx = multihost.initialize(init_method="file://" + rdv, num_processes=2, process_id=pid,
                           device="cpu", shards=4, timeout_s=120)
conf = Configuration({{MESH_SPECULATE_FACTOR: "3.0"}})
for tag, plan in json.loads(sys.argv[5]):
    faults.arm(plan)
    m = MetricsRegistry()
    n = multihost.sort_bam_multihost(src, os.path.join(outdir, tag + ".bam"), ctx=ctx,
                                     conf=conf, split_size={split}, level=1, device="cpu",
                                     metrics=m)
    faults.disarm()
    c = m.counters()
    d = {{k: c.get(k, 0) for k in ("mh.speculate.launched", "mh.speculate.won",
                                   "mh.speculate.wasted_bytes", "mh.speculate.fetch_bytes",
                                   "faults.fired.mh.speculate.lose")}}
    d.update(tag=tag, pid=pid, n=n,
             recv={{k: v for k, v in c.items() if k.startswith("mh.shuffle.recv.")}},
             sent={{k: v for k, v in c.items() if k.startswith("mh.shuffle.sent.")}})
    print("LEG " + json.dumps(d), flush=True)
ctx.close()
print(f"MH_OK pid={{pid}}", flush=True)
"""

#: The reference's drills (``test_mesh_skew.py``): host 1 drags each part
#: 1.5 s and host 0's copy wins; then 0.7 s, and host 0's copy stalls 4 s
#: before each promotion and loses.
SPEC_LEGS = [
    ("win", "seed=3;exec.delay:items=1,attempts=1000-1999,ms=1500,n=*"),
    ("lose", "seed=3;exec.delay:items=1,attempts=1000-1999,ms=700,n=*;"
             "mh.speculate.lose:ms=4000,n=*"),
]


def test_two_process_speculation_win_and_lose(bam_paired, tmp_path):
    """Two gloo processes, 4 CPU shards each, speculate-factor 3.  Win:
    host 0 launches once and wins parts, host 1's late copies are the
    waste.  Lose: host 0's copy loses every race and carries the waste.
    Both outputs are the undelayed single-process sort's record stream, and
    the recv matrix (speculative bytes excluded) balances the sent one."""
    from test_torch_multihost import _legs, _run_pair

    outdir = str(tmp_path)
    worker = _SPEC_WORKER.format(repo=REPO, split=SPLIT)
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = _run_pair(lambda pid: [sys.executable, "-c", worker, str(pid),
                                  os.path.join(outdir, "rendezvous"), bam_paired, outdir,
                                  json.dumps(SPEC_LEGS)], env)
    legs = _legs(outs)
    win0, win1 = legs[("win", 0)], legs[("win", 1)]
    assert win0["mh.speculate.launched"] == 1 and win0["mh.speculate.won"] >= 1
    assert win0["mh.speculate.fetch_bytes"] > 0
    assert win1["mh.speculate.wasted_bytes"] > 0 and win1["mh.speculate.launched"] == 0
    lose0, lose1 = legs[("lose", 0)], legs[("lose", 1)]
    assert lose0["mh.speculate.launched"] == 1 and lose0["mh.speculate.won"] == 0
    assert lose0["mh.speculate.wasted_bytes"] > 0 and lose1["mh.speculate.wasted_bytes"] == 0
    assert lose0["faults.fired.mh.speculate.lose"] == 4
    oracle = str(tmp_path / "oracle.bam")
    jpipeline.sort_bam([bam_paired], oracle, split_size=SPLIT, level=1)
    want = _stream(oracle)
    for tag in ("win", "lose"):
        assert _stream(os.path.join(outdir, tag + ".bam")) == want, tag
        a, b = legs[(tag, 0)], legs[(tag, 1)]
        assert a["n"] == b["n"] == 4_000
        assert a["sent"]["mh.shuffle.sent.1"] == b["recv"]["mh.shuffle.recv.0"]
        assert b["sent"]["mh.shuffle.sent.0"] == a["recv"]["mh.shuffle.recv.1"]

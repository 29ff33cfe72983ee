"""The multi-process sort's skew healing and collation ranks against the
reference's.  Case list: the reference's ``tests/test_mesh_skew.py`` less
fixmate, speculation and ``mesh_report`` (ROADMAP A.10c):

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
  reference's on the same columns."""

import os
import sys

import numpy as np
import pytest

from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.parallel import multihost as jm
from hadoop_bam_tpu_torch import pipeline as tpipeline
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

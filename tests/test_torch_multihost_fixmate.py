"""The port's ``fixmate_bam_multihost`` against the reference's, on the CPU.
Case list: the reference's ``tests/test_mesh_skew.py`` fixmate case, in
one process on 8 shards and in two processes on 4 shards each:

- the decompressed output equals the port's single-process ``fixmate_bam``
  and the reference's ``fixmate_bam_multihost`` on the same input;
- ``FixmateStats`` (records, splits, pairs, singletons, orphans, the
  backend) and the ``mh.fixmate.*`` counters equal the reference's, in
  each process;
- with two processes the mates of the corpus's interleaved pairs fall on
  both (``mh.fixmate.half_open > 0``), and a name with three candidates
  across the processes breaks its local pair, as on one host.

The corpus is the collation tests' (mates far apart in file order, MC
tags, orphans, secondary and supplementary copies, unmapped mates) plus a
third primary candidate of one name; small members and splits put its
mates in different splits."""

import os
import sys

import numpy as np
import pytest

from hadoop_bam_tpu.parallel import multihost as jm
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.parallel import fixmate_bam_multihost
from hadoop_bam_tpu_torch.parallel import multihost as tm
from hadoop_bam_tpu_torch.spec import bgzf
from hadoop_bam_tpu_torch.utils.tracing import MetricsRegistry
from test_collate import F1, P, _collate_corpus, bam
from test_torch_markdup import REFS, write_bam
from test_torch_multihost import _free_port, _legs, _run_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = 2048
STATS = ("n_records", "n_splits", "n_pairs", "n_singletons", "n_orphans", "backend")


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    recs = _collate_corpus(np.random.default_rng(29), n_pairs=300, n_extra=60)
    # A third primary candidate of pair 1's name, at the end of the file.
    recs.append(bam.build_record("q001", 0, 777, 30, P | F1, [(40, "M")], "ACGT" * 10,
                                 bytes([30] * 40), -1, -1, 0))
    return write_bam(str(tmp_path_factory.mktemp("mh_fixmate") / "in.bam"), recs, refs=REFS,
                     block_payload=1024)


def _stream(path):
    with open(path, "rb") as f:
        return bgzf.decompress_all(f.read())


def _mh(d):
    return {k: v for k, v in d.items() if k.startswith("mh.fixmate.")}


@pytest.fixture(scope="module")
def single(src, tmp_path_factory):
    """The port's single-process ``fixmate_bam``: (stats, stream)."""
    out = str(tmp_path_factory.mktemp("mh_fixmate_single") / "single.bam")
    st = tpipeline.fixmate_bam(src, out, split_size=SPLIT, level=1, device="cpu")
    return st, _stream(out)


def test_one_process_equals_single_and_the_reference(src, single, tmp_path):
    """One process on 8 shards: the single-process fixmate's record stream
    and census, and the reference's mesh fixmate's bytes, stats and
    ``mh.fixmate.*`` counters."""
    from hadoop_bam_tpu.utils.tracing import METRICS

    out, j_out = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    m = MetricsRegistry()
    st = fixmate_bam_multihost(src, out, ctx=tm.initialize(device="cpu", shards=8),
                               split_size=SPLIT, level=1, device="cpu", metrics=m)
    before = dict(METRICS.report()["counters"])
    jst = jm.fixmate_bam_multihost([src], j_out, ctx=jm.initialize(), split_size=SPLIT, level=1)
    after = dict(METRICS.report()["counters"])
    want = {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith("mh.fixmate.") and v - before.get(k, 0)}
    assert _stream(out) == single[1] == _stream(j_out)
    assert [getattr(st, k) for k in STATS] == [getattr(jst, k) for k in STATS]
    sst = single[0]
    assert (st.n_pairs, st.n_singletons, st.n_orphans) == (sst.n_pairs, sst.n_singletons,
                                                           sst.n_orphans)
    assert st.backend == "collate-fixmate[mesh]" and st.n_splits > 4
    got = {k: v for k, v in _mh(m.counters()).items() if v}
    assert got == want and got["mh.fixmate.records"] == st.n_records
    assert "mh.fixmate.half_open" not in got  # one process: every mate is local


_WORKER = r"""
import json, os, sys
which, pid, rdv, src, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, {repo!r})
if which == "port":
    sys.modules["jax"] = None  # the port's processes never load JAX
    from hadoop_bam_tpu_torch.parallel import multihost
    from hadoop_bam_tpu_torch.utils.tracing import MetricsRegistry
    ctx = multihost.initialize(init_method="file://" + rdv, num_processes=2, process_id=pid,
                               device="cpu", shards=4, timeout_s=120)
    m = MetricsRegistry()
    st = multihost.fixmate_bam_multihost(src, out, ctx=ctx, split_size={split}, level=1,
                                         device="cpu", metrics=m)
    counters = m.counters()
    ctx.close()
else:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from hadoop_bam_tpu.parallel import multihost
    from hadoop_bam_tpu.utils.tracing import METRICS
    ctx = multihost.initialize("127.0.0.1:" + rdv, num_processes=2, process_id=pid)
    c0 = dict(METRICS.report()["counters"])
    st = multihost.fixmate_bam_multihost([src], out, ctx=ctx, split_size={split}, level=1)
    c1 = dict(METRICS.report()["counters"])
    counters = {{k: v - c0.get(k, 0) for k, v in c1.items()}}
print("LEG " + json.dumps({{"tag": which, "pid": pid,
                           "stats": [getattr(st, k) for k in {stats!r}],
                           "mh": {{k: v for k, v in counters.items()
                                  if k.startswith("mh.fixmate.") and v}}}}), flush=True)
print(f"MH_OK pid={{pid}}", flush=True)
"""


def _pair(which, src, out, rdv):
    worker = _WORKER.format(repo=REPO, split=SPLIT, stats=STATS)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    outs = _run_pair(lambda pid: [sys.executable, "-c", worker, which, str(pid), rdv, src, out],
                     env)
    return _legs(outs)


@pytest.fixture(scope="module")
def pairs(src, tmp_path_factory):
    """The port's and the reference's two-process fixmate of ``src``:
    ``{which: (output stream, {(which, pid): leg})}``."""
    d = str(tmp_path_factory.mktemp("mh_fixmate_pair"))
    got = {}
    for which, rdv in (("port", os.path.join(d, "rendezvous")), ("ref", str(_free_port()))):
        out = os.path.join(d, which + ".bam")
        legs = _pair(which, src, out, rdv)
        got[which] = (_stream(out), legs)
    return got


def test_two_processes_equal_single_and_the_reference(pairs, single):
    """Two processes, 4 CPU shards each: the single-process fixmate's
    record stream and census, and in each process the reference's stats
    and ``mh.fixmate.*`` counters; mates cross the processes."""
    (t_stream, t_legs), (j_stream, j_legs) = pairs["port"], pairs["ref"]
    assert t_stream == single[1] == j_stream
    sst = single[0]
    for pid in range(2):
        t, j = t_legs[("port", pid)], j_legs[("ref", pid)]
        assert t["stats"] == j["stats"], pid
        assert t["stats"][2:5] == [sst.n_pairs, sst.n_singletons, sst.n_orphans]
        assert t["stats"][5] == "collate-fixmate[mesh]"
        assert t["mh"] == j["mh"], pid
        assert t["mh"]["mh.fixmate.half_open"] > 0
        assert t["mh"]["mh.fixmate.virtual_mates"] > 0
        assert t["mh"]["mh.fixmate.records"] == sst.n_records

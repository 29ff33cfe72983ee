"""The port's part executor against the reference's, on the CPU: the Hadoop
task-retry, part-restart and ``_SUCCESS`` contract.  The cases are the
reference's ``tests/test_executor.py`` (all eight); the two that sort run
the JAX package on the same input, and the bytes and the ``executor.*``
counters are equal."""

import io
import os

import numpy as np
import pytest

from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.parallel import executor as jexecutor
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.utils.tracing import delta, snapshot
from hadoop_bam_tpu_torch import pipeline
from hadoop_bam_tpu_torch.parallel import executor as texecutor
from hadoop_bam_tpu_torch.parallel.executor import ElasticExecutor, PartFailedError
from hadoop_bam_tpu_torch.utils import nio
from hadoop_bam_tpu_torch.utils.tracing import Metrics


def _write(item, tmp):
    with open(tmp, "w") as f:
        f.write(f"payload-{item}")


def _executor_counters(counters):
    return {k: v for k, v in counters.items() if k.startswith("executor.") and v}


def test_success_path(tmp_path):
    m = Metrics()
    rep = ElasticExecutor(str(tmp_path / "out"), metrics=m).run([10, 20, 30], _write)
    assert [open(p).read() for p in rep.parts] == ["payload-10", "payload-20", "payload-30"]
    nio.check_success(tmp_path / "out")
    assert rep.attempts == 3 and rep.retried == 0
    assert _executor_counters(m.counters()) == {"executor.attempts": 3}


def test_transient_fault_retried(tmp_path):
    def hook(i, attempt):
        if attempt == 0:
            raise IOError(f"transient {i}")

    m = Metrics()
    rep = ElasticExecutor(str(tmp_path / "out"), fault_hook=hook, metrics=m).run([1, 2], _write)
    jrep = jexecutor.ElasticExecutor(str(tmp_path / "ref"), fault_hook=hook).run([1, 2], _write)
    assert (rep.retried, rep.attempts) == (jrep.retried, jrep.attempts) == (2, 4)
    assert m.get("executor.retried") == 2
    nio.check_success(tmp_path / "out")


def test_permanent_fault_raises_and_no_success(tmp_path):
    def hook(i, attempt):
        if i == 1:
            raise RuntimeError("device on fire")

    m = Metrics()
    ex = ElasticExecutor(str(tmp_path / "out"), max_attempts=2, fault_hook=hook, metrics=m)
    with pytest.raises(PartFailedError) as ei:
        ex.run([0, 1, 2], _write)
    assert 1 in ei.value.failures and len(ei.value.failures[1]) == 2
    assert not os.path.exists(tmp_path / "out" / "_SUCCESS")
    assert (tmp_path / "out" / "part-r-00000").exists()  # the restart units
    assert not [p for p in os.listdir(tmp_path / "out") if p.startswith("_temporary")]
    assert nio.list_parts(tmp_path / "out") == [
        tmp_path / "out" / "part-r-00000", tmp_path / "out" / "part-r-00002"]
    assert m.get("executor.failed_parts") == 1
    with pytest.raises(jexecutor.PartFailedError) as jei:
        jexecutor.ElasticExecutor(str(tmp_path / "ref"), max_attempts=2,
                                  fault_hook=hook).run([0, 1, 2], _write)
    assert str(ei.value) == str(jei.value)


def test_resume_skips_existing(tmp_path):
    out = tmp_path / "out"
    ElasticExecutor(str(out)).run([1, 2, 3], _write)
    calls = []

    def count_writes(item, tmp):
        calls.append(item)
        _write(item, tmp)

    os.remove(out / "part-r-00001")
    m = Metrics()
    rep = ElasticExecutor(str(out), metrics=m).run([1, 2, 3], count_writes)
    assert calls == [2]
    assert rep.skipped_existing == m.get("executor.skipped_existing") == 2


def test_failed_attempt_sweeps_side_files(tmp_path):
    def messy(item, tmp):
        with open(tmp + ".sb", "w") as f:
            f.write("index")
        raise IOError("boom")

    with pytest.raises(PartFailedError):
        ElasticExecutor(str(tmp_path / "out"), max_attempts=2).run([0], messy)
    assert not [p for p in os.listdir(tmp_path / "out") if p.startswith("_temporary")]


def test_max_attempts_validation(tmp_path):
    with pytest.raises(ValueError) as got:
        ElasticExecutor(str(tmp_path), max_attempts=0)
    with pytest.raises(ValueError) as want:
        jexecutor.ElasticExecutor(str(tmp_path), max_attempts=0)
    assert str(got.value) == str(want.value)


def _bam(path, n, seed, pos_of):
    rng = np.random.default_rng(seed)
    hdr = jbam.BamHeader("@HD\tVN:1.6\n@SQ\tSN:c\tLN:9999999", [("c", 9999999)])
    recs = [jbam.build_record(f"r{i}", 0, pos_of(i, rng), 60, 0, [(100, "M")],
                              "".join("ACGT"[b] for b in rng.integers(0, 4, 100)),
                              bytes(rng.integers(2, 40, 100).astype(np.uint8)))
            for i in range(n)]
    buf = io.BytesIO()
    jbam.write_bam(buf, hdr, iter(recs))
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def _patched_run(mod, wrap):
    """``mod.ElasticExecutor.run`` with each job's ``work_fn`` wrapped by
    ``wrap(items, work_fn)``; returns the original."""
    real = mod.ElasticExecutor.run

    def run(self, items, work_fn, **kw):
        return real(self, items, wrap(items, work_fn), **kw)

    mod.ElasticExecutor.run = run
    return real


def test_sort_resume_from_part_dir(tmp_path):
    """A permanent failure of the last part with ``max_attempts=1``, then a
    rerun on the same ``part_dir``: the finished parts are skipped, and the
    bytes and ``executor.*`` counters are the reference's."""
    src = str(tmp_path / "in.bam")
    _bam(src, 1000, 5, lambda i, rng: int(rng.integers(0, 9000000)))

    def crash_last(items, work_fn):
        def work(item, tmp):
            if item == len(items) - 1:
                raise RuntimeError("simulated crash")
            work_fn(item, tmp)
        return work

    outs = {}
    counters = {}
    for side, mod, job, kw in (("ref", jexecutor, jpipeline.sort_bam, {}),
                               ("port", texecutor, pipeline.sort_bam, {"device": "cpu"})):
        pdir, out = str(tmp_path / f"parts.{side}"), str(tmp_path / f"out.{side}.bam")
        real = _patched_run(mod, crash_last)
        try:
            with pytest.raises(mod.PartFailedError):
                job(src, out, split_size=30_000, part_dir=pdir, max_attempts=1, **kw)
        finally:
            mod.ElasticExecutor.run = real
        assert not os.path.exists(os.path.join(pdir, "_SUCCESS"))
        before = snapshot()
        st = job(src, out, split_size=30_000, part_dir=pdir, **kw)
        counters[side] = _executor_counters(st.counters if side == "port"
                                            else delta(before)["counters"])
        with open(out, "rb") as f:
            outs[side] = f.read()
    assert outs["port"] == outs["ref"]
    assert counters["port"] == counters["ref"]
    assert counters["port"]["executor.skipped_existing"] > 0
    _, got = jbam.read_bam(str(tmp_path / "out.port.bam"))
    keys = [jbam.alignment_key(r) for r in got]
    assert len(got) == 1000 and keys == sorted(keys)


def test_sort_survives_transient_part_failures(tmp_path):
    """Every part's first attempt fails: the output is complete and sorted,
    the bytes and ``executor.*`` counters are the reference's."""
    src = str(tmp_path / "in.bam")
    _bam(src, 1000, 0, lambda i, rng: (31 * i) % 90000)

    def flaky(items, work_fn):
        failed = set()

        def work(item, tmp):
            if item not in failed:
                failed.add(item)
                raise IOError("synthetic first-attempt failure")
            work_fn(item, tmp)
        return work

    outs, counters = {}, {}
    for side, mod, job, kw in (("ref", jexecutor, jpipeline.sort_bam, {}),
                               ("port", texecutor, pipeline.sort_bam, {"device": "cpu"})):
        out = str(tmp_path / f"out.{side}.bam")
        real = _patched_run(mod, flaky)
        try:
            before = snapshot()
            st = job(src, out, split_size=30_000, **kw)
        finally:
            mod.ElasticExecutor.run = real
        counters[side] = _executor_counters(st.counters if side == "port"
                                            else delta(before)["counters"])
        with open(out, "rb") as f:
            outs[side] = f.read()
    assert outs["port"] == outs["ref"]
    assert counters["port"] == counters["ref"]
    assert counters["port"]["executor.retried"] == counters["port"]["executor.attempts"] // 2 > 1
    _, got = jbam.read_bam(str(tmp_path / "out.port.bam"))
    keys = [jbam.alignment_key(r) for r in got]
    assert len(got) == 1000 and keys == sorted(keys)

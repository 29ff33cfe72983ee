"""``sort_bam``'s arguments against the reference's: the domains of
``errors``, ``sort_order`` and ``backend`` raise the reference's
``ValueError`` (class and message) before anything else, also when the
value comes through the configuration; ``backend="host"`` and
``max_attempts`` are taken and write the reference's bytes; the queryname
order raises the reference's ``ValueError`` (class and message) with
``mark_duplicates``, a mesh and ``device_parse``, before any other check,
and so does ``memory_budget`` with a mesh or ``device_parse``; the
out-of-core forms write the reference's bytes; the serve job's
``resource_cache`` and ``deadline`` write the reference's bytes and raise
the reference's ``DeadlineExceeded`` at the same seam."""

import os

import pytest
import torch

from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.conf import from_reference_conf
from test_torch_sort_bam import HOST, LANES, _read, _write_bam


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("sort_args") / "in.bam")
    _write_bam(p, n=60, seed=3)
    return p


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e), str(e)
    return None


BAD = [
    ({"errors": "bogus"}, {}),
    ({"sort_order": "bogus"}, {}),
    ({"errors": ""}, {}),
    ({}, {"hadoopbam.errors": "bogus"}),
    ({}, {"hadoopbam.bam.sort-order": "bogus"}),
    ({"backend": "tpu"}, {}),
    ({"backend": "host", "errors": "lenient"}, {}),
]


@pytest.mark.parametrize("kwargs,conf", BAD, ids=[
    "errors", "sort_order", "errors_empty", "conf_errors", "conf_sort_order", "backend",
    "host_backend_errors"])
def test_bad_values_raise_the_reference_error(src, tmp_path, kwargs, conf):
    want = _raised(lambda: jpipeline.sort_bam(src, str(tmp_path / "ref.bam"), conf=JConf(conf),
                                              **kwargs))
    got = _raised(lambda: tpipeline.sort_bam(src, str(tmp_path / "port.bam"),
                                             conf=from_reference_conf(conf), device="cpu",
                                             **kwargs))
    assert want is not None and want[0] is ValueError
    assert got == want
    assert not os.path.exists(tmp_path / "port.bam")


@pytest.mark.parametrize("kwargs", [{"errors": "bogus"}, {"sort_order": "bogus"},
                                    {"backend": "bogus"}], ids=["errors", "sort_order", "backend"])
def test_domain_is_checked_before_the_device(tmp_path, monkeypatch, kwargs):
    """With no card and no ``device``, a bad value still raises its
    ``ValueError``, not the missing card's ``RuntimeError``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="must be"):
        tpipeline.sort_bam(str(tmp_path / "in.bam"), str(tmp_path / "out.bam"), **kwargs)


SERVE_JOB = [
    ("resource_cache", {}),
    ("deadline", {}),
    ("expired_deadline", {}),
    ("expired_deadline", {"memory_budget": 1 << 16}),
]


@pytest.mark.parametrize("what,kwargs", SERVE_JOB, ids=[
    "resource_cache", "live_deadline", "expired_deadline", "expired_deadline_out_of_core"])
def test_serve_job_arguments_match_the_reference(src, tmp_path, what, kwargs):
    """The serve job's ``resource_cache`` (the header from the daemon's
    cache: one header miss in each package's cache, the reference's bytes)
    and ``deadline`` (a live one: the reference's bytes; an expired one:
    the reference's ``DeadlineExceeded`` at the same seam, counted the
    same)."""
    from hadoop_bam_tpu.serve.cache import ResourceCache as JCache
    from hadoop_bam_tpu.utils.deadline import Deadline as JDeadline
    from hadoop_bam_tpu.utils.deadline import DeadlineExceeded as JDeadlineExceeded
    from hadoop_bam_tpu.utils.tracing import delta, snapshot
    from hadoop_bam_tpu_torch.serve.cache import ResourceCache
    from hadoop_bam_tpu_torch.utils.deadline import Deadline, DeadlineExceeded
    from hadoop_bam_tpu_torch.utils.tracing import MetricsRegistry

    reg = MetricsRegistry()
    if what == "resource_cache":
        jkw, tkw = {"resource_cache": JCache()}, {"resource_cache": ResourceCache(metrics=reg)}
    elif what == "deadline":
        jkw = {"deadline": JDeadline.after_ms(600_000)}
        tkw = {"deadline": Deadline.after_ms(600_000, metrics=reg)}
    else:
        jkw, tkw = {"deadline": JDeadline.after_ms(0)}, {"deadline": Deadline.after_ms(0, metrics=reg)}
    j_out, t_out = str(tmp_path / "ref.bam"), str(tmp_path / "port.bam")
    before = snapshot()
    if what == "expired_deadline":
        with pytest.raises(JDeadlineExceeded) as je:
            jpipeline.sort_bam(src, j_out, level=1, split_size=1024, **kwargs, **jkw)
        with pytest.raises(DeadlineExceeded) as te:
            tpipeline.sort_bam(src, t_out, device="cpu", level=1, split_size=1024, **kwargs,
                               **tkw)
        assert te.value.seam == je.value.seam
        assert str(te.value).split(" (")[0] == str(je.value).split(" (")[0]
    else:
        jpipeline.sort_bam(src, j_out, level=1, split_size=1024, **kwargs, **jkw)
        tpipeline.sort_bam(src, t_out, device="cpu", level=1, split_size=1024, **kwargs, **tkw)
        assert _read(t_out) == _read(j_out)
    want = {k: v for k, v in delta(before)["counters"].items()
            if k.startswith(("serve.cache.", "serve.deadline."))}
    assert reg.counters() == want
    if what == "resource_cache":
        assert want == {"serve.cache.miss": 1, "serve.cache.miss.header": 1}


@pytest.mark.parametrize("gates,device_parse", [(HOST, None), (LANES, True)],
                         ids=["host_gates", "lanes_device_parse"])
def test_host_backend_writes_the_reference_bytes(src, tmp_path, gates, device_parse):
    """``backend="host"``: keys built and sorted on the host (an explicit
    ``device_parse`` is overridden, as in the reference), the reference's
    bytes, and the same bytes as the device backend."""
    t_out, j_out, d_out = (str(tmp_path / f) for f in ("port.bam", "ref.bam", "dev.bam"))
    st = tpipeline.sort_bam(src, t_out, conf=from_reference_conf(gates), device="cpu",
                            device_parse=device_parse, level=1, split_size=1024, backend="host")
    jst = jpipeline.sort_bam(src, j_out, conf=JConf(gates), device_parse=device_parse, level=1,
                             split_size=1024, backend="host")
    tpipeline.sort_bam(src, d_out, conf=from_reference_conf(gates), device="cpu", level=1,
                       split_size=1024)
    assert st.backend == jst.backend == "host"
    assert st.n_records == jst.n_records == 60
    assert _read(t_out) == _read(j_out) == _read(d_out)


def test_max_attempts_is_taken(src, tmp_path):
    """``max_attempts`` bounds each part's attempts (the executor, A.2): one
    attempt writes the default's bytes, and 0 raises the reference's
    ``ValueError`` when the write phase starts, leaving no output."""
    a, b = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    for out, kw in ((a, {"max_attempts": 1}), (b, {})):
        st = tpipeline.sort_bam(src, out, conf=from_reference_conf(HOST), device="cpu",
                                level=1, **kw)
        assert st.counters["executor.attempts"] == st.n_splits
    assert _read(a) == _read(b)
    want = _raised(lambda: jpipeline.sort_bam(src, str(tmp_path / "ref.bam"), conf=JConf(HOST),
                                              max_attempts=0))
    got = _raised(lambda: tpipeline.sort_bam(src, str(tmp_path / "port.bam"),
                                             conf=from_reference_conf(HOST), device="cpu",
                                             max_attempts=0))
    assert want is not None and want[0] is ValueError and got == want
    assert not os.path.exists(tmp_path / "port.bam")


QUERYNAME_BAD = [
    ({"mark_duplicates": True}, {}),
    ({}, {"hadoopbam.bam.mark-duplicates": "true"}),
    ({"mesh": object()}, {}),
    ({"distributed": object()}, {}),
    ({"device_parse": True}, {}),
    ({"device_parse": True, "backend": "host"}, {}),
    ({"mesh": object(), "mark_duplicates": True, "device_parse": True}, {}),
    ({"mark_duplicates": True, "memory_budget": 1 << 20}, {}),
    ({"device_parse": True, "resource_cache": object(), "errors": "salvage"}, {}),
]


@pytest.mark.parametrize("kwargs,conf", QUERYNAME_BAD, ids=[
    "mark_duplicates", "conf_mark_duplicates", "mesh", "distributed", "device_parse",
    "device_parse_host_backend", "mesh_first", "before_memory_budget", "before_unported"])
@pytest.mark.parametrize("how", ["argument", "conf"])
def test_queryname_combinations_raise_the_reference_error(src, tmp_path, kwargs, conf, how):
    """Queryname with ``mark_duplicates``, a mesh or ``device_parse``: the
    reference's ``ValueError``, in its order, before the checks of what the
    port has not ported yet; the order comes as the argument or the conf
    key."""
    conf = dict(conf)
    kw = dict(kwargs)
    if how == "argument":
        kw["sort_order"] = "queryname"
    else:
        conf["hadoopbam.bam.sort-order"] = "queryname"
    ref_kw = {k: v for k, v in kw.items() if k != "resource_cache"}
    want = _raised(lambda: jpipeline.sort_bam(src, str(tmp_path / "ref.bam"), conf=JConf(conf),
                                              **ref_kw))
    got = _raised(lambda: tpipeline.sort_bam(src, str(tmp_path / "port.bam"),
                                             conf=from_reference_conf(conf), device="cpu", **kw))
    assert want is not None and want[0] is ValueError
    assert got == want
    assert not os.path.exists(tmp_path / "port.bam")


def test_queryname_checks_come_before_the_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="mark_duplicates needs the coordinate stream"):
        tpipeline.sort_bam(str(tmp_path / "in.bam"), str(tmp_path / "out.bam"),
                           sort_order="queryname", mark_duplicates=True)


@pytest.mark.parametrize("kwargs", [{"mark_duplicates": True}, {"sort_order": "queryname"}],
                         ids=["mark_duplicates", "queryname"])
def test_out_of_core_forms_cite_a4(src, tmp_path, kwargs):
    """``memory_budget`` with duplicate marking or the queryname order (A.4,
    ported): the out-of-core forms write the reference's bytes, through
    ``sort_bam`` and, for duplicate marking, ``markdup_bam``."""
    jobs = [("sort_bam", kwargs)]
    if "mark_duplicates" in kwargs:
        jobs.append(("markdup_bam", {}))
    for job, kw in jobs:
        t_out, j_out = str(tmp_path / f"{job}.port.bam"), str(tmp_path / f"{job}.ref.bam")
        st = getattr(tpipeline, job)(src, t_out, conf=from_reference_conf(HOST), device="cpu",
                                     level=1, memory_budget=64 << 10, **kw)
        jst = getattr(jpipeline, job)(src, j_out, conf=JConf(HOST), level=1,
                                      memory_budget=64 << 10, **kw)
        assert st.backend == jst.backend == "external[device]"
        assert (st.n_records, st.n_runs, st.n_ranges, st.n_duplicates) == \
            (jst.n_records, jst.n_runs, jst.n_ranges, jst.n_duplicates)
        assert _read(t_out) == _read(j_out)


BUDGET_BAD = [
    ({"mesh": object()}, {}),
    ({"distributed": object()}, {}),
    ({"device_parse": True}, {}),
    ({"device_parse": True, "backend": "host"}, {}),
    ({"mesh": object(), "device_parse": True}, {}),
    ({"mesh": object(), "mark_duplicates": True}, {}),
    ({"device_parse": True}, {"hadoopbam.bam.mark-duplicates": "true"}),
    ({"device_parse": True, "resource_cache": object(), "errors": "salvage"}, {}),
]


@pytest.mark.parametrize("kwargs,conf", BUDGET_BAD, ids=[
    "mesh", "distributed", "device_parse", "device_parse_host_backend", "mesh_first",
    "mesh_markdup", "device_parse_conf_markdup", "before_unported"])
def test_memory_budget_combinations_raise_the_reference_error(src, tmp_path, kwargs, conf):
    """``memory_budget`` with a mesh or a true ``device_parse``: the
    reference's ``ValueError`` (class and message), in its order (the mesh
    first), before the mesh's A.10 and the other checks of what is not
    ported yet."""
    ref_kw = {k: v for k, v in kwargs.items() if k != "resource_cache"}
    want = _raised(lambda: jpipeline.sort_bam(src, str(tmp_path / "ref.bam"), conf=JConf(conf),
                                              memory_budget=1 << 20, **ref_kw))
    got = _raised(lambda: tpipeline.sort_bam(src, str(tmp_path / "port.bam"),
                                             conf=from_reference_conf(conf), device="cpu",
                                             memory_budget=1 << 20, **kwargs))
    assert want is not None and want[0] is ValueError
    assert got == want
    assert not os.path.exists(tmp_path / "port.bam")


def test_memory_budget_checks_come_before_the_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="memory_budget is single-host"):
        tpipeline.sort_bam(str(tmp_path / "in.bam"), str(tmp_path / "out.bam"),
                           memory_budget=1 << 20, mesh=object())


def test_mesh_still_cites_a10_for_the_coordinate_order(tmp_path):
    for kw in ({"mesh": object()}, {"distributed": object(), "mark_duplicates": True}):
        with pytest.raises(NotImplementedError, match=r"\(ROADMAP A\.10\)$"):
            tpipeline.sort_bam(str(tmp_path / "in.bam"), str(tmp_path / "out.bam"),
                               device="cpu", **kw)

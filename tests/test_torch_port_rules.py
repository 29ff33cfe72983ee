"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, it runs on the card unless told otherwise, it carries the same
constant tables, what it has ported runs on the CPU through the plain
versions, and what it has not ported yet raises."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, ``chip_smoke.py``, ``tools/write_pair.py``,
    ``tools/chain_pair.py``, ``tools/region_pair.py`` and
    ``tools/inflate_probe_pair.py`` (and the run each hands a tree) and
    ``tools/inflate_probe_chain.py`` load with ``jax`` blocked and pull in no
    module of the JAX package."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now fails
import hadoop_bam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import importlib.util
for tool in ("write_pair", "chain_pair", "region_pair", "inflate_probe_pair",
             "inflate_probe_chain"):
    spec = importlib.util.spec_from_file_location(tool, f"tools/{tool}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if tool.endswith("_pair"):
        assert "jax" not in mod.ONE_RUN and "hadoop_bam_tpu." not in mod.ONE_RUN, tool
bad = [m for m in sys.modules if m == "hadoop_bam_tpu" or m.startswith("hadoop_bam_tpu.")]
assert not bad, bad
assert len(names) >= 57, names
print("ok", len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


SERVE_MODULES = ("server", "client", "admission", "batching", "arena", "cache", "journal",
                 "flightrec", "exemplars", "slo", "endpoints", "warmup", "fleet", "router")


@pytest.mark.parametrize("name", SERVE_MODULES)
def test_serve_modules_import_neither_jax_nor_the_jax_package(name):
    """Each module of the port's serve layer, read as source: no import of
    ``jax`` or of the JAX package anywhere in it, lazy imports inside
    functions included (the import test above sees only what loading runs)."""
    import ast

    tree = ast.parse((REPO / "hadoop_bam_tpu_torch" / "serve" / f"{name}.py").read_text())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append(node.module)
    bad = [m for m in found if m.split(".")[0] in ("jax", "jaxlib", "hadoop_bam_tpu")]
    assert not bad, bad


def test_smoke_and_tools_import_only_names_the_port_has():
    """Every ``from hadoop_bam_tpu_torch... import name`` in ``chip_smoke.py``
    and ``tools/*.py``, inside functions and in the pair tools' ``ONE_RUN``
    too, names something the port has: such imports run only on the card."""
    import ast
    import importlib

    missing = []
    for path in [REPO / "chip_smoke.py", *sorted((REPO / "tools").glob("*.py"))]:
        tree = ast.parse(path.read_text())
        trees = [tree] + [ast.parse(node.value.value) for node in ast.walk(tree)
                          if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                          and any(getattr(t, "id", "") == "ONE_RUN" for t in node.targets)]
        for t in trees:
            for node in ast.walk(t):
                if not (isinstance(node, ast.ImportFrom) and node.module
                        and node.module.startswith("hadoop_bam_tpu_torch")):
                    continue
                mod = importlib.import_module(node.module)
                for alias in node.names:
                    if not hasattr(mod, alias.name):
                        try:
                            importlib.import_module(f"{node.module}.{alias.name}")
                        except ImportError:
                            missing.append((path.name, node.module, alias.name))
    assert not missing, missing


def test_sort_bam_without_device_raises_when_no_card(tmp_path, monkeypatch):
    from hadoop_bam_tpu_torch import pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.sort_bam(str(tmp_path / "in.bam"), str(tmp_path / "out.bam"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.sort_bam(str(tmp_path / "in.bam"), str(tmp_path / "out.bam"), device="cuda")


def test_constant_tables_equal_the_reference():
    from hadoop_bam_tpu.ops import flate as jflate
    from hadoop_bam_tpu.ops.pallas.crc32 import CRC_TABLES
    from hadoop_bam_tpu.utils import murmur3 as jm
    from hadoop_bam_tpu_torch.ops import flate as tflate
    from hadoop_bam_tpu_torch.utils import murmur3 as tm

    # The inflate kernel computes these by formula; the compiled core is held
    # to the same tables in test_torch_inflate_core.py.
    for py in ("LEN_BASE", "LEN_EXTRA", "DIST_BASE", "DIST_EXTRA", "CLC_ORDER"):
        assert np.array_equal(getattr(tflate, py), getattr(jflate, py)), py
    for py in ("LITLEN_TABLE", "DIST_TABLE", "FIXED_LITLEN_LENS", "FIXED_DIST_LENS", "REV8"):
        assert np.array_equal(getattr(tflate, py), getattr(jflate, py)), py
    assert np.array_equal(tflate.CRC32_TABLE, CRC_TABLES[0])
    assert (tm.C1, tm.C2) == (jm._C1, jm._C2)


def test_reference_conf_dict_drives_both_packages():
    from hadoop_bam_tpu import conf as jconf
    from hadoop_bam_tpu_torch import conf as tconf

    d = {jconf.INFLATE_LANES: "on", jconf.BAM_WRITE_SPLITTING_BAI: "yes",
         jconf.READ_DEPTH: "3", jconf.DEFLATE_LANES: "off"}
    a, b = jconf.Configuration(d), tconf.from_reference_conf(d)
    for key in ("INFLATE_LANES", "BAM_WRITE_SPLITTING_BAI", "DEFLATE_LANES",
                "WRITE_DEVICE", "READ_DEPTH", "BAM_MARK_DUPLICATES", "BAM_SORT_ORDER",
                "ERRORS_MODE", "BAM_BOUNDED_TRAVERSAL", "BAM_ENABLE_BAI_SPLITTER"):
        k = getattr(tconf, key)
        assert k == getattr(jconf, key)
        assert a.get_boolean(k) == b.get_boolean(k)
        assert a.get_int(k, -1) == b.get_int(k, -1)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"memory_budget": 1 << 20},
        {"mesh": object()},
        {"distributed": object()},
        {"errors": "salvage"},
        {"conf": {"hadoopbam.errors": "salvage"}},
    ],
    ids=["memory_budget", "mesh", "distributed", "salvage", "conf_salvage"],
)
def test_options_outside_the_slice_raise(tmp_path, kwargs):
    """What is not ported yet raises, citing ROADMAP; ``memory_budget`` is
    ported (the out-of-core sort) and writes the reference's bytes, and so
    is salvage, as the argument or the conf key: the reference's bytes and
    counters on a damaged file."""
    from hadoop_bam_tpu_torch import pipeline
    from hadoop_bam_tpu_torch.conf import Configuration

    kw = dict(kwargs)
    if "memory_budget" in kw:
        assert _budget_sort_matches_the_reference(tmp_path, kw).n_runs > 1
        return
    if kw.get("errors") == "salvage" or "conf" in kw:
        st = _salvage_sort_matches_the_reference(tmp_path, kw)
        assert st.counters["salvage.members_quarantined"] == 2
        return
    if "conf" in kw:
        kw["conf"] = Configuration(kw["conf"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipeline.sort_bam(str(tmp_path / "in.bam"), str(tmp_path / "out.bam"),
                          device="cpu", **kw)


def _budget_sort_matches_the_reference(tmp_path, kw):
    """``sort_bam`` with ``kw`` (a ``memory_budget``) through both packages
    on the CPU: the same bytes; returns the port's stats."""
    from hadoop_bam_tpu import pipeline as jpipeline
    from hadoop_bam_tpu_torch import pipeline
    from test_torch_sort_bam import _write_bam

    src, t_out, j_out = (str(tmp_path / f) for f in ("in.bam", "port.bam", "ref.bam"))
    _write_bam(src, n=30_000, seed=5)
    st = pipeline.sort_bam(src, t_out, device="cpu", level=1, **kw)
    jpipeline.sort_bam(src, j_out, level=1, **kw)
    with open(t_out, "rb") as f, open(j_out, "rb") as g:
        assert f.read() == g.read()
    assert st.backend == "external[device]"
    return st


def _salvage_sort_matches_the_reference(tmp_path, kw):
    """``sort_bam`` with ``kw`` (salvage, as the argument or the conf key)
    through both packages on the CPU over a file with two corrupt members:
    the same bytes and ``salvage.*`` / ``executor.*`` counters; returns the
    port's stats."""
    from hadoop_bam_tpu import pipeline as jpipeline
    from hadoop_bam_tpu.conf import Configuration as JConf
    from hadoop_bam_tpu.utils.tracing import delta, snapshot
    from hadoop_bam_tpu_torch import pipeline
    from hadoop_bam_tpu_torch.conf import Configuration
    from test_faults import _build_bam, _corrupt

    clean = str(tmp_path / "clean.bam")
    data, stream, hlen = _build_bam(clean)
    src = _corrupt({"clean": data, "hlen": hlen}, tmp_path / "in.bam", [4, 19])
    t_out, j_out = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    conf = kw.get("conf", {})
    args = {k: v for k, v in kw.items() if k != "conf"}
    before = snapshot()
    jpipeline.sort_bam(src, j_out, conf=JConf(conf), level=1, **args)
    want = {k: v for k, v in delta(before)["counters"].items()
            if k.startswith(("salvage.", "executor.")) and v}
    st = pipeline.sort_bam(src, t_out, conf=Configuration(conf), device="cpu", level=1, **args)
    with open(t_out, "rb") as f, open(j_out, "rb") as g:
        assert f.read() == g.read()
    assert {k: v for k, v in st.counters.items()
            if k.startswith(("salvage.", "executor.")) and v} == want
    return st


@pytest.mark.parametrize(
    "kwargs,item",
    [({"memory_budget": 1 << 20}, "A.4"), ({"mesh": object()}, "A.10"),
     ({"distributed": object()}, "A.10"), ({"errors": "salvage"}, "A.7")],
    ids=["memory_budget", "mesh", "distributed", "salvage"],
)
def test_options_outside_the_slice_cite_their_roadmap_item(tmp_path, kwargs, item):
    """Each option not ported yet cites its ROADMAP item; A.4's
    ``memory_budget`` and A.7's salvage are ported and cite nothing: they
    sort, with the reference's bytes."""
    from hadoop_bam_tpu_torch import pipeline

    if item == "A.4":
        _budget_sort_matches_the_reference(tmp_path, kwargs)
        return
    if item == "A.7":
        assert _salvage_sort_matches_the_reference(tmp_path, kwargs).n_records > 0
        return
    with pytest.raises(NotImplementedError, match=rf"\(ROADMAP {re.escape(item)}\)$"):
        pipeline.sort_bam(str(tmp_path / "in.bam"), str(tmp_path / "out.bam"), device="cpu",
                          **kwargs)


def test_threaded_decodes_count_every_member(tmp_path, monkeypatch):
    """``read_splits`` decodes two splits at once: the tier stats of the
    concurrent calls all reach ``DeviceStream.inflate_stats``.  The wrapped
    inflate makes its stats update the read-modify-write race it is in the
    real function, with both threads between the read and the write."""
    import threading

    from hadoop_bam_tpu_torch.conf import INFLATE_LANES, Configuration
    from hadoop_bam_tpu_torch.device_stream import DeviceStream
    from hadoop_bam_tpu_torch.ops import flate
    from hadoop_bam_tpu_torch.spec import bgzf

    real = flate.inflate_blocks_device
    barrier = threading.Barrier(2, timeout=10)

    def racy(*args, stats=None, **kw):
        mine = flate.CodecTierStats()
        res = real(*args, stats=mine, **kw)
        seen = stats.lanes
        barrier.wait()
        stats.lanes = seen + mine.lanes
        return res

    monkeypatch.setattr(flate, "inflate_blocks_device", racy)
    data = bgzf.deflate_blocks(bytes(range(256)) * 40, level=1, block_payload=1000)[0]
    co, cs, us = bgzf.scan_blocks(data)
    stream = DeviceStream(torch.device("cpu"), Configuration({INFLATE_LANES: "true"}))
    threads = [threading.Thread(target=stream.decode_members, args=(data, co, cs, us))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert stream.inflate_stats.lanes == 2 * len(co)
    assert stream.inflate_stats.host == 0


@pytest.mark.parametrize(
    "conf",
    [{"hadoopbam.deflate.lanes": "true"}, {"hadoopbam.write.device": "true"}],
    ids=["conf_deflate_lanes", "conf_device_write"],
)
def test_write_gates_sort_on_the_cpu(tmp_path, conf):
    """Each write-side gate sorts on the CPU through the plain versions, to
    the same records as the host write."""
    from test_torch_sort_bam import _write_bam

    from hadoop_bam_tpu_torch import pipeline
    from hadoop_bam_tpu_torch.conf import INFLATE_LANES, Configuration
    from hadoop_bam_tpu_torch.spec import bgzf

    src = str(tmp_path / "in.bam")
    _write_bam(src, n=30)
    outs = []
    for c in (dict(conf, **{INFLATE_LANES: "true"}), {}):
        out = str(tmp_path / f"out{len(outs)}.bam")
        st = pipeline.sort_bam(src, out, conf=Configuration(c), device="cpu", level=1,
                               split_size=1 << 20)
        assert st.n_records == 30
        with open(out, "rb") as f:
            data = f.read()
        outs.append(bgzf.inflate_blocks(data, *bgzf.scan_blocks(data))[0].tobytes())
    assert outs[0] == outs[1]


def test_stream_policy_gates(monkeypatch):
    from hadoop_bam_tpu_torch.conf import (BCF_CHAIN, CRAM_RANS_LANES, DEFLATE_LANES,
                                            INFLATE_LANES, WRITE_DEVICE, Configuration)
    from hadoop_bam_tpu_torch.device_stream import StreamPolicy

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for env in ("HBAM_INFLATE_LANES", "HBAM_DEFLATE_LANES", "HBAM_DEVICE_WRITE",
                "HBAM_BCF_CHAIN", "HBAM_RANS_LANES"):
        monkeypatch.delenv(env, raising=False)
    for gate, key, env in (("inflate_lanes", INFLATE_LANES, "HBAM_INFLATE_LANES"),
                           ("deflate_lanes", DEFLATE_LANES, "HBAM_DEFLATE_LANES"),
                           ("device_write", WRITE_DEVICE, "HBAM_DEVICE_WRITE"),
                           ("use_bcf_chain", BCF_CHAIN, "HBAM_BCF_CHAIN"),
                           ("use_rans_lanes", CRAM_RANS_LANES, "HBAM_RANS_LANES")):
        assert getattr(StreamPolicy.resolve(None, cuda), gate)  # the auto rule on a card
        assert not getattr(StreamPolicy.resolve(None, cpu), gate)
        assert getattr(StreamPolicy.resolve(Configuration({key: "true"}), cpu), gate)
        assert not getattr(StreamPolicy.resolve(Configuration({key: "false"}), cuda), gate)
        monkeypatch.setenv(env, "0")
        assert not getattr(StreamPolicy.resolve(Configuration({key: "true"}), cuda), gate)
        monkeypatch.setenv(env, "1")
        assert getattr(StreamPolicy.resolve(Configuration({key: "false"}), cpu), gate)
        monkeypatch.delenv(env)
    assert StreamPolicy.resolve(None, cuda).depth == 2
    monkeypatch.setenv("HBAM_READ_DEPTH", "5")
    assert StreamPolicy.resolve(None, cpu).depth == 5


def test_plain_versions_do_not_count_launches():
    from hadoop_bam_tpu_torch.ops.kernels import bcf_chain as kbcf
    from hadoop_bam_tpu_torch.ops.kernels import chain as kch
    from hadoop_bam_tpu_torch.ops.kernels import crc32 as kcrc
    from hadoop_bam_tpu_torch.ops.kernels import deflate as kd
    from hadoop_bam_tpu_torch.ops.kernels import gather as kg
    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin
    from hadoop_bam_tpu_torch.ops.kernels import rans as kr
    from hadoop_bam_tpu_torch.spec import cram_codecs as cc

    counters = (kin.LAUNCHES, kch.WALK_LAUNCHES, kch.KEYS_LAUNCHES, kd.LAUNCHES, kg.LAUNCHES,
                kcrc.LAUNCHES, kbcf.LAUNCHES, kr.LAUNCHES)
    before = [c.value for c in counters]
    s = torch.zeros(0, dtype=torch.uint8)
    offs, meta = kch.record_chain(s, 0)
    kch.stream_keys(s, 0, offs, meta, 0)
    data = torch.arange(200, dtype=torch.int64).to(torch.uint8)
    kcrc.crc32_device(data, [0, 10], [100, 50])
    kg.gather_stream_device(data, [0, 100], [50, 60], dup_mask=[True, False])
    kd.deflate_lanes_stream(data, [120, 80])
    kbcf.walk_chain(data.to(torch.uint8), 0, 200)
    assert kr.rans_lanes([cc.rans_encode(b"ACGT" * 50, 1)], torch.device("cpu"))[0] == [
        b"ACGT" * 50]
    assert [c.value for c in counters] == before


def test_a_kernel_that_cannot_build_raises(tmp_path, monkeypatch):
    """No fallback hides the card: without a compiler the build raises."""
    from hadoop_bam_tpu_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    for name in ("deflate", "write"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)


def test_mixed_devices_raise():
    from hadoop_bam_tpu_torch.ops.kernels import use_plain

    with pytest.raises(ValueError):
        use_plain(torch.zeros(1), torch.zeros(1, device="meta"))


def test_ingest_fastq_without_device_raises_when_no_card(tmp_path, monkeypatch):
    from hadoop_bam_tpu_torch import ingest

    p = tmp_path / "r.fastq"
    p.write_bytes(b"@r0\nACGT\n+\nIIII\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest.ingest_fastq(str(p), str(tmp_path / "out.bam"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest.ingest_fastq(str(p), str(tmp_path / "out.bam"), device="cuda")


@pytest.mark.parametrize("what", ["live_deadline", "resource_cache", "expired_deadline"])
def test_ingest_serve_options_match_the_reference(tmp_path, what):
    """The serve ingest job's ``deadline`` and ``resource_cache`` are taken
    as the reference takes them: the reference's bytes and stats.  The
    reference's ingest reaches none of the stream's deadline seams, so an
    expired deadline raises in neither package."""
    import dataclasses

    from hadoop_bam_tpu import ingest as jing
    from hadoop_bam_tpu.serve.cache import ResourceCache as JCache
    from hadoop_bam_tpu.utils.deadline import Deadline as JDeadline
    from hadoop_bam_tpu_torch import ingest
    from hadoop_bam_tpu_torch.serve.cache import ResourceCache
    from hadoop_bam_tpu_torch.utils.deadline import Deadline
    from test_ingest import _gz_members, make_fastq

    paths = []
    for k in (1, 2):
        p = tmp_path / f"r{k}.fastq.gz"
        p.write_bytes(_gz_members(make_fastq(30, seed=k, qual_at_every=5, name="q")))
        paths.append(str(p))
    ms = {"live_deadline": 600_000, "expired_deadline": 0}.get(what)
    if what == "resource_cache":
        jkw, tkw = {"resource_cache": JCache()}, {"resource_cache": ResourceCache()}
    else:
        jkw, tkw = {"deadline": JDeadline.after_ms(ms)}, {"deadline": Deadline.after_ms(ms)}
    sj = jing.ingest_fastq(paths, str(tmp_path / "want.bam"), level=4, **jkw)
    st = ingest.ingest_fastq(paths, str(tmp_path / "got.bam"), level=4, device="cpu", **tkw)
    assert (tmp_path / "got.bam").read_bytes() == (tmp_path / "want.bam").read_bytes()
    assert st.counts() == dataclasses.asdict(sj) and st.n_records == 60


def test_record_scan_that_cannot_build_raises(tmp_path, monkeypatch):
    from hadoop_bam_tpu_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    assert "hbt_record_scan" in _build.SIGNATURES["record_scan"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("record_scan")


@pytest.mark.parametrize("conf", [{}, {"hadoopbam.ingest.device-scan": "true"}],
                         ids=["default_scan", "device_scan"])
def test_salvage_does_not_swallow_a_kernel_failure(tmp_path, monkeypatch, conf):
    """A kernel that fails raises through ingest salvage; only corrupt data is
    quarantined."""
    import gzip

    from hadoop_bam_tpu_torch import ingest
    from hadoop_bam_tpu_torch.conf import Configuration
    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin
    from hadoop_bam_tpu_torch.ops.kernels import record_scan as krs

    p = tmp_path / "r.fastq.gz"
    p.write_bytes(gzip.compress(b"".join(b"@r%d\nACGT\n+\nIIII\n" % i for i in range(20))))

    def broken(*a, **k):
        raise RuntimeError("inflate_members: CUDA error 700 at launch")

    monkeypatch.setattr(kin, "inflate_members", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ingest.ingest_fastq(str(p), str(tmp_path / "o.bam"), device="cpu", errors="salvage",
                            conf=Configuration(conf))
    monkeypatch.undo()
    if conf:
        monkeypatch.setattr(krs, "scan_windows", broken)
        with pytest.raises(RuntimeError, match="CUDA error"):
            ingest.ingest_fastq(str(p), str(tmp_path / "o.bam"), device="cpu",
                                errors="salvage", conf=Configuration(conf))


def test_reference_conf_dict_drives_the_ingest_keys():
    from hadoop_bam_tpu import conf as jconf
    from hadoop_bam_tpu_torch import conf as tconf

    keys = ("FASTQ_BASE_QUALITY_ENCODING", "FASTQ_FILTER_FAILED_QC",
            "INPUT_BASE_QUALITY_ENCODING", "INPUT_FILTER_FAILED_QC", "INGEST_CHUNK_BYTES",
            "INGEST_SCAN_OVERLAP", "INGEST_DEVICE_SCAN")
    d = {getattr(jconf, k): v for k, v in zip(keys, ("illumina", "true", "sanger", "no", "4096",
                                                      "512", "false"))}
    a, b = jconf.Configuration(d), tconf.from_reference_conf(d)
    for key in keys:
        k = getattr(tconf, key)
        assert k == getattr(jconf, key)
        assert a.get(k) == b.get(k) and a.get_int(k, -1) == b.get_int(k, -1)
        assert a.get_boolean(k) == b.get_boolean(k)


def test_reference_conf_dict_drives_the_variant_keys():
    from hadoop_bam_tpu import conf as jconf
    from hadoop_bam_tpu_torch import conf as tconf

    keys = ("VCF_INTERVALS", "VCFRECORDREADER_VALIDATION_STRINGENCY", "BCF_CHAIN")
    d = {getattr(jconf, k): v for k, v in zip(keys, ("chr1:1-5,chr2", "lenient", "on"))}
    a, b = jconf.Configuration(d), tconf.from_reference_conf(d)
    for key in keys:
        k = getattr(tconf, key)
        assert k == getattr(jconf, key)
        assert a.get(k) == b.get(k) and a.get_boolean(k) == b.get_boolean(k)


def test_reference_conf_dict_drives_the_fastq_qseq_keys():
    """The reader and writer keys of FASTQ and QSEQ keep the reference's
    strings, and one dict read by both packages' formats picks the same
    encodings and filters."""
    from hadoop_bam_tpu import conf as jconf
    from hadoop_bam_tpu.io import fastq as jfastq
    from hadoop_bam_tpu.io import qseq as jqseq
    from hadoop_bam_tpu_torch import conf as tconf
    from hadoop_bam_tpu_torch.io import fastq, qseq

    keys = ("FASTQ_OUTPUT_BASE_QUALITY_ENCODING", "QSEQ_BASE_QUALITY_ENCODING",
            "QSEQ_FILTER_FAILED_QC", "QSEQ_OUTPUT_BASE_QUALITY_ENCODING")
    d = {getattr(jconf, k): v for k, v in zip(keys, ("illumina", "sanger", "yes", "sanger"))}
    a, b = jconf.Configuration(d), tconf.from_reference_conf(d)
    for key in keys:
        k = getattr(tconf, key)
        assert k == getattr(jconf, key)
        assert a.get(k) == b.get(k) and a.get_boolean(k) == b.get_boolean(k)
    assert fastq.FastqOutputFormat(b).encoding == jfastq.FastqOutputFormat(a).encoding
    assert qseq.QseqOutputFormat(b).encoding == jqseq.QseqOutputFormat(a).encoding
    assert qseq.QseqInputFormat(b)._encoding() == jqseq.QseqInputFormat(a)._encoding()
    assert qseq.QseqInputFormat(b)._filter_failed() == jqseq.QseqInputFormat(a)._filter_failed()


def test_variant_and_collate_entry_points_raise_when_no_card(tmp_path, monkeypatch):
    """``variants_blob``, ``collate_by_name`` and ``queryname_perm`` run on
    the card unless the caller asks for the CPU."""
    from hadoop_bam_tpu_torch.collate import device as cdev
    from hadoop_bam_tpu_torch.collate import host as chost
    from hadoop_bam_tpu_torch.serve.endpoints import ServeContext, variants_blob

    cols = {k: np.arange(4, dtype=np.int32) for k in ("qh1", "qh2", "flag", "pos")}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: variants_blob(ServeContext.from_conf(), str(tmp_path / "x.bcf"),
                                       "chr1:1-10"),
                 lambda: variants_blob(ServeContext.from_conf(device="cuda"),
                                       str(tmp_path / "x.bcf"), "chr1"),
                 lambda: cdev.collate_by_name(cols),
                 lambda: chost.queryname_perm(cols)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_overlap_entry_points_raise_when_no_card(monkeypatch):
    """The ragged join runs on the card when the caller gives host columns
    and no device, as the reference's does on its default device."""
    from hadoop_bam_tpu_torch.ops import overlap as tov

    a = np.arange(4, dtype=np.int64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tov.join_mask_device(a, a + 1, a, a + 2),
                 lambda: tov.ragged_overlap_mask(a, a, a + 1, a, a, a + 2, use_device=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    t = torch.from_numpy(a)
    assert tov.join_mask_device(t, t + 1, a, a + 2).device.type == "cpu"


def test_sort_bam_on_cram_raises_when_no_card(tmp_path, monkeypatch):
    from hadoop_bam_tpu_torch import pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipeline.sort_bam(str(tmp_path / "in.cram"), str(tmp_path / "out.bam"), **kw)


def test_rans_kernel_that_cannot_build_raises(tmp_path, monkeypatch):
    """The rANS tier raises when its kernel cannot build: no host fallback
    hides it."""
    from hadoop_bam_tpu_torch import _build
    from hadoop_bam_tpu_torch.ops.kernels import rans as kr
    from hadoop_bam_tpu_torch.spec import cram_codecs as cc

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    assert "hbt_rans_decode" in _build.SIGNATURES["rans"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("rans")

    def on_card(*args):
        raise RuntimeError("rans: CUDA error 700 at launch")

    monkeypatch.setattr(kr, "rans_decode_device", on_card)
    blocks = [(cc.METHOD_RANS, cc.rans_encode(b"ACGT" * 40, 0), 160)]

    from hadoop_bam_tpu_torch.conf import CRAM_RANS_LANES, Configuration
    from hadoop_bam_tpu_torch.device_stream import DeviceStream

    stream = DeviceStream(torch.device("cpu"), Configuration({CRAM_RANS_LANES: "true"}))
    with pytest.raises(RuntimeError, match="CUDA error"):
        cc.decompress_batch(blocks, stream=stream)


def test_reference_conf_dict_drives_the_cram_keys():
    from hadoop_bam_tpu import conf as jconf
    from hadoop_bam_tpu_torch import conf as tconf

    keys = ("CRAM_REFERENCE_SOURCE_PATH", "CRAM_RANS_LANES", "ANYSAM_TRUST_EXTS")
    d = {getattr(jconf, k): v for k, v in zip(keys, ("/x/ref.fa", "on", "false"))}
    a, b = jconf.Configuration(d), tconf.from_reference_conf(d)
    for key in keys:
        k = getattr(tconf, key)
        assert k == getattr(jconf, key)
        assert a.get(k) == b.get(k) and a.get_boolean(k, True) == b.get_boolean(k, True)


def test_reference_conf_dict_drives_the_interval_keys():
    from hadoop_bam_tpu import conf as jconf
    from hadoop_bam_tpu_torch import conf as tconf

    keys = ("BAM_BOUNDED_TRAVERSAL", "BAM_INTERVALS", "BAM_TRAVERSE_UNPLACED_UNMAPPED")
    d = {getattr(jconf, k): v for k, v in zip(keys, ("true", "chr1:1-5,chr2", "on"))}
    a, b = jconf.Configuration(d), tconf.from_reference_conf(d)
    for key in keys:
        k = getattr(tconf, key)
        assert k == getattr(jconf, key)
        assert a.get(k) == b.get(k) and a.get_boolean(k) == b.get_boolean(k)


def test_bcf_chain_that_cannot_build_raises(tmp_path, monkeypatch):
    from hadoop_bam_tpu_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    assert "hbt_bcf_chain_walk" in _build.SIGNATURES["bcf_chain"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("bcf_chain")


@pytest.mark.parametrize("name,entry", [("inflate_fixed", "hbt_inflate_fixed_literal"),
                                        ("inflate_probe", "hbt_inflate_probe_walk")])
def test_codec_kernels_that_cannot_build_raise(tmp_path, monkeypatch, name, entry):
    """Rows 10 and 11 raise when their source cannot build; the literal-only
    tier of bgzf_decompress_device has no try around row 10."""
    from hadoop_bam_tpu_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    assert entry in _build.SIGNATURES[name]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load(name)
    src = (REPO / "hadoop_bam_tpu_torch" / "ops" / "flate.py").read_text()
    body = src[src.index("def bgzf_decompress_device("):]
    assert "except" not in body


def test_codec_plain_versions_do_not_count_launches():
    from hadoop_bam_tpu_torch.ops import flate as tflate
    from hadoop_bam_tpu_torch.ops.kernels import inflate_fixed as kfix
    from hadoop_bam_tpu_torch.ops.kernels import inflate_probe as kip

    before = (kfix.LAUNCHES.value, kip.LAUNCHES.value)
    blob = tflate.bgzf_compress_device(b"literal" * 50, use_lanes=False, device="cpu")
    assert tflate.bgzf_decompress_device(blob, device="cpu") == b"literal" * 50
    comp, clens = tflate.deflate_fixed(torch.zeros((2, 8), dtype=torch.uint8),
                                       torch.tensor([8, 3], dtype=torch.int32), 16)
    kfix.inflate_fixed_literal(comp, clens, torch.tensor([8, 3], dtype=torch.int32))
    kip.make_walk(64, 4, "cpu")(torch.zeros((64, kip.LANES), dtype=torch.int32),
                               torch.zeros((1, kip.LANES), dtype=torch.int32))
    assert (kfix.LAUNCHES.value, kip.LAUNCHES.value) == before

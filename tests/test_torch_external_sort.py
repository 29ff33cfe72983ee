"""The out-of-core sort in the port (``io.runs``; ``sort_bam`` /
``markdup_bam`` / ``fixmate_bam`` with ``memory_budget``) against the
reference's, exactly: output files, ``.splitting-bai`` files, the spill
directory (runs, sidebands, ``dupmask.npy``, ``manifest.json``), the range
cuts, ``SortStats`` and counters.  The cases are the reference's
``tests/test_external_sort.py`` (all six), the out-of-core cases of
``test_collate.py`` (queryname, fixmate), ``test_dedup.py`` (markdup),
``test_device_write.py`` (``no_residency`` under a budget),
``test_rans_lanes.py`` (a ``.cram`` and its BAM twin) and ``test_faults.py``
(kill -9 in phase 2 and resume; a stale manifest), plus the spill directory
itself and a header-only input."""

import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.io import runs as jruns
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.utils.tracing import delta, snapshot
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.conf import from_reference_conf
from hadoop_bam_tpu_torch.io import runs as truns
from hadoop_bam_tpu_torch.io.bam import BamInputFormat, read_header
from hadoop_bam_tpu_torch.spec import indices
from test_torch_sort_bam import HOST

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from bench import synth_bam  # noqa: E402

#: The counters both packages count into a budget job.
JOB_COUNTERS = ("sort_bam.records", "sort_bam.splits", "sort_bam.runs", "sort_bam.ranges",
                "sort_bam.duplicates", "sort_bam.resume_spill_reused")


def _bytes(p):
    with open(p, "rb") as f:
        return f.read()


def _read_all(path, split_size=1 << 20):
    """Keys and record bodies of a BAM, by the port's reader."""
    fmt = BamInputFormat()
    batches = [fmt.read_split(s) for s in fmt.get_splits([path], split_size=split_size)]
    keys = np.concatenate([b.keys for b in batches]) if batches else np.empty(0)
    raws = []
    for b in batches:
        for off, ln in zip(b.soa["rec_off"].tolist(), b.soa["rec_len"].tolist()):
            raws.append(b.data[off : off + ln].tobytes())
    return keys, raws


def both(src, tmp_path, job="sort_bam", tag="", gates=HOST, **kw):
    """The job through the reference and the port (on the CPU) with the
    same arguments: ``(port stats, reference stats, port out, reference
    out, reference counters)``; the two outputs must be the same bytes."""
    t_out, j_out = str(tmp_path / f"port{tag}.bam"), str(tmp_path / f"ref{tag}.bam")
    before = snapshot()
    jst = getattr(jpipeline, job)(src, j_out, conf=JConf(gates), **kw)
    jc = delta(before)["counters"]
    st = getattr(tpipeline, job)(src, t_out, conf=from_reference_conf(gates), device="cpu", **kw)
    assert _bytes(t_out) == _bytes(j_out)
    for k in ("n_records", "n_splits", "backend", "n_runs", "n_ranges", "peak_bytes",
              "n_duplicates", "n_pairs", "n_singletons", "n_orphans"):
        if hasattr(jst, k):
            assert getattr(st, k) == getattr(jst, k), k
    if job != "fixmate_bam":
        assert {k: st.counters.get(k, 0) for k in JOB_COUNTERS} == \
            {k: jc.get(k, 0) for k in JOB_COUNTERS}
    return st, jst, t_out, j_out, jc


@pytest.fixture(scope="module")
def bam_60k(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("ext") / "in.bam")
    synth_bam(p, 60_000)
    return p


def test_external_matches_in_memory_oracle(bam_60k, tmp_path):
    budget = 1 << 20  # ~8x smaller than the uncompressed stream
    st, _, out_ext, _, _ = both(bam_60k, tmp_path, level=1, backend="host",
                                memory_budget=budget)
    assert st.backend == "external[host]"
    assert st.n_records == 60_000
    assert st.n_runs > 1, "budget did not force multiple spill runs"
    assert st.n_ranges > 1, "budget did not force multiple merge ranges"
    assert st.peak_bytes <= budget
    assert set(st.seconds) == {"spill", "plan", "merge"}
    out_mem = str(tmp_path / "mem.bam")
    tpipeline.sort_bam([bam_60k], out_mem, conf=from_reference_conf(HOST), device="cpu",
                       level=1, backend="host")
    k_ext, r_ext = _read_all(out_ext)
    k_mem, r_mem = _read_all(out_mem)
    assert np.array_equal(k_ext, k_mem)
    assert r_ext == r_mem  # the same records in the same stable order
    assert read_header(out_ext).text.split("\n")[0].endswith("SO:coordinate")


def test_external_device_backend(bam_60k, tmp_path):
    st, _, out, _, _ = both(bam_60k, tmp_path, level=1, backend="device",
                            memory_budget=2 << 20)
    assert st.backend == "external[device]"
    keys, _ = _read_all(out)
    assert len(keys) == 60_000 and np.all(keys[:-1] <= keys[1:])


def test_external_tie_heavy_stability(tmp_path):
    """Records with only 4 distinct keys: ties span every run and range;
    the order must still be the stable in-memory sort's."""
    src = str(tmp_path / "ties.bam")
    refs = [("chr1", 1_000_000)]
    hdr = jbam.BamHeader("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000000", refs)
    rng = np.random.default_rng(11)
    recs = [jbam.build_record(name=f"read{i:06d}", refid=0, pos=(i % 4) * 100, mapq=60, flag=0,
                              cigar=[(50, "M")],
                              seq="".join("ACGT"[j] for j in rng.integers(0, 4, 50)),
                              qual=bytes([30] * 50))
            for i in range(20_000)]
    with open(src, "wb") as f:
        jbam.write_bam(f, hdr, recs, level=1)
    for backend in ("host", "device"):
        st, _, out_ext, _, _ = both(src, tmp_path, tag=backend, level=1, backend=backend,
                                    memory_budget=256 << 10)
        assert st.n_runs > 1 and st.n_ranges > 1
        out_mem = str(tmp_path / f"mem{backend}.bam")
        tpipeline.sort_bam([src], out_mem, conf=from_reference_conf(HOST), device="cpu",
                           level=1, backend=backend)
        assert _read_all(out_ext)[1] == _read_all(out_mem)[1]


def test_external_with_splitting_bai(bam_60k, tmp_path):
    _, _, out, j_out, _ = both(bam_60k, tmp_path, level=1, backend="host",
                               memory_budget=1 << 20, write_splitting_bai=True)
    ext = indices.SPLITTING_BAI_EXT
    assert _bytes(out + ext) == _bytes(j_out + ext)
    idx = indices.SplittingBai.load(out + ext)
    assert idx.bam_size() == os.path.getsize(out)
    keys, _ = _read_all(out)
    assert len(keys) == 60_000


def test_plan_ranges_exact_cover(tmp_path):
    """plan_ranges: ranges are disjoint, ordered, cover all records, and
    respect the byte budget; the port's runs are the reference's files and
    its cuts the reference's cuts."""

    class _B:
        def __init__(self, data, keys, off, ln):
            self.data = data
            self.keys = keys
            self.soa = {"rec_off": off, "rec_len": ln}

    rng = np.random.default_rng(3)
    runs, jr = [], []
    d, jd = str(tmp_path / "port"), str(tmp_path / "ref")
    os.makedirs(d)
    os.makedirs(jd)
    for ri in range(3):
        n = 500
        ln = np.full(n, 32, dtype=np.int64)
        body = rng.integers(0, 255, n * 36, dtype=np.uint8).astype(np.uint8)
        off = np.arange(n, dtype=np.int64) * 36 + 4
        keys = np.sort(rng.integers(0, 1000, n).astype(np.int64))
        perm = np.arange(n)
        orig = np.arange(n, dtype=np.int64) + 1000 * ri
        truns.write_run(d, ri, _B(body, keys, off, ln), perm, orig_idx=orig)
        jruns.write_run(jd, ri, _B(body, keys, off, ln), perm, orig_idx=orig)
        for a, b in zip(truns.run_paths(d, ri), jruns.run_paths(jd, ri)):
            assert os.path.basename(a) == os.path.basename(b)
            assert _bytes(a) == _bytes(b)
        runs.append(truns.Run.open(d, ri))
        jr.append(jruns.Run.open(jd, ri))
        assert runs[-1].slice_stream(10, 20).tobytes() == jr[-1].slice_stream(10, 20).tobytes()
    budget = 5000
    ranges = truns.plan_ranges(runs, budget)
    assert ranges == jruns.plan_ranges(jr, budget)
    seen = [0, 0, 0]
    prev_max = -(1 << 62)
    for cuts in ranges:
        total = 0
        lo_k = 1 << 62
        hi_k = -(1 << 62)
        for r, (i0, i1) in enumerate(cuts):
            assert i0 == seen[r], "ranges must be contiguous per run"
            seen[r] = i1
            total += runs[r].bytes_between(i0, i1)
            if i1 > i0:
                lo_k = min(lo_k, int(runs[r].keys[i0]))
                hi_k = max(hi_k, int(runs[r].keys[i1 - 1]))
        assert total <= budget
        if hi_k >= lo_k:
            assert lo_k >= prev_max  # ranges ascend (ties may touch)
            prev_max = hi_k
    assert seen == [r.n for r in runs], "every record covered exactly once"
    for budget in (1, 36, 37, 100, 1 << 30):  # one record a range, ties cut in run order
        assert truns.plan_ranges(runs, budget) == jruns.plan_ranges(jr, budget)


def test_flat_rss_subprocess(tmp_path):
    """Physical memory, as the reference measures it: sort a stream many
    times the budget in a child process (with a time limit of its own) and
    require the child's maxrss growth during the sort to stay well under
    the uncompressed stream (flat peak, not O(file))."""
    n = 1_200_000  # ~229 MB of record stream
    budget = 16 << 20
    code = f"""
import os, resource, sys
sys.path.insert(0, {REPO!r})
os.chdir({REPO!r})
from bench import synth_bam
from hadoop_bam_tpu_torch.pipeline import sort_bam
src = {str(tmp_path)!r} + "/big.bam"
synth_bam(src, {n})
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KB on linux
st = sort_bam([src], {str(tmp_path)!r} + "/sorted.bam", level=1, backend="host",
              memory_budget={budget}, device="cpu")
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
assert st.peak_bytes <= {budget}, st.peak_bytes
assert st.n_records == {n} and st.n_runs >= 10 and st.n_ranges >= 10, st
print("RSS_DELTA_KB=%d" % (peak - base))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    delta_kb = int([x for x in res.stdout.splitlines() if x.startswith("RSS_DELTA_KB")][0]
                   .split("=")[1])
    # The stream is ~229 MB; a sort that is not out of core would grow RSS
    # by at least that.
    assert delta_kb < 100 * 1024, f"RSS grew {delta_kb} KB: not flat"


# ---------------------------------------------------------------------------
# The collation family under a budget
# ---------------------------------------------------------------------------


def test_queryname_out_of_core_matches_in_core(tmp_path):
    from test_collate import _collate_corpus, _write_bam

    rng = np.random.default_rng(6)
    recs = _collate_corpus(rng, n_pairs=220, n_extra=150)
    src = str(tmp_path / "in.bam")
    _write_bam(src, recs, level=0, block_payload=2048)
    st, _, o2, _, _ = both(src, tmp_path, sort_order="queryname", memory_budget=32 << 10)
    assert st.backend.startswith("external") and st.n_runs >= 2
    assert set(st.seconds) == {"prepass", "spill", "plan", "merge"}
    o1 = str(tmp_path / "mem.bam")
    tpipeline.sort_bam(src, o1, conf=from_reference_conf(HOST), device="cpu",
                       split_size=8 << 10, sort_order="queryname")
    assert _read_all(o1)[1] == _read_all(o2)[1]
    assert read_header(o2).text.split("\n")[0].endswith("SO:queryname")


def test_fixmate_out_of_core_matches_in_core(tmp_path):
    from test_collate import _collate_corpus, _write_bam

    rng = np.random.default_rng(5)
    recs = _collate_corpus(rng, n_pairs=150, n_extra=80)
    src = str(tmp_path / "in.bam")
    _write_bam(src, recs, level=0, block_payload=2048)
    s2, _, o2, _, _ = both(src, tmp_path, job="fixmate_bam", memory_budget=96 << 10)
    assert s2.backend == "collate-fixmate[budget]"
    o1 = str(tmp_path / "mem.bam")
    s1 = tpipeline.fixmate_bam(src, o1, conf=from_reference_conf(HOST), device="cpu",
                               split_size=8 << 10)
    assert (s1.n_pairs, s1.n_orphans) == (s2.n_pairs, s2.n_orphans)
    assert _read_all(o1)[1] == _read_all(o2)[1]


def test_markdup_out_of_core_matches_in_core(tmp_path):
    from test_dedup import _family_corpus, _ident, _write_bam

    from hadoop_bam_tpu.dedup import mark_duplicates_oracle

    rng = np.random.default_rng(4)
    # Level-0 blocks: the 64 KiB split floor gives several splits and the
    # budget at least two spill runs.
    recs = _family_corpus(rng, n_families=150, n_single=600)
    src = str(tmp_path / "in.bam")
    _write_bam(src, recs, level=0)
    s2, _, o2, _, _ = both(src, tmp_path, job="markdup_bam", memory_budget=96 << 10)
    assert s2.backend.startswith("external") and s2.n_runs >= 2
    assert set(s2.seconds) == {"spill", "markdup", "plan", "merge"}
    o1 = str(tmp_path / "mem.bam")
    s1 = tpipeline.sort_bam(src, o1, conf=from_reference_conf(HOST), device="cpu",
                            split_size=8 << 10, mark_duplicates=True)
    assert s1.n_duplicates == s2.n_duplicates > 0
    assert _read_all(o1)[1] == _read_all(o2)[1]
    expect = {_ident(r): bool(d) for r, d in zip(recs, mark_duplicates_oracle(recs))}
    for r in jbam.read_bam(o2)[1]:
        assert bool(r.flag & jbam.FLAG_DUPLICATE) == expect[_ident(r)]


def test_external_sort_records_no_residency(tmp_path, monkeypatch):
    """Range parts are rebuilt from disk and carry no window: with the
    device write gate forced on (the plain kernels on the CPU), every range
    counts ``no_residency`` and takes the host gather."""
    from hadoop_bam_tpu_torch.spec import bam as tbam
    from hadoop_bam_tpu_torch.spec import bgzf as tbgzf

    for k, v in (("HBAM_DEVICE_WRITE", "1"), ("HBAM_DEFLATE_LANES", "0"),
                 ("HBAM_INFLATE_LANES", "0")):
        monkeypatch.setenv(k, v)
    hdr = tbam.BamHeader("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:100000", [("chr1", 100000)])
    rng = np.random.default_rng(14)
    recs = [tbam.build_record(f"q{i:04d}", 0, int(rng.integers(0, 1000)), 60, 0, [(10, "M")],
                              "ACGTACGTAC", bytes([30] * 10)) for i in range(3000)]
    src = str(tmp_path / "in.bam")
    with open(src, "wb") as f:
        f.write(tbgzf.deflate_blocks(hdr.encode(), level=1)[0])
        f.write(tbgzf.deflate_blocks(b"".join(recs), level=1, block_payload=4096)[0])
        f.write(tbgzf.TERMINATOR)
    st, _, _, _, jc = both(src, tmp_path, gates={}, level=1, backend="host",
                           memory_budget=64 << 10)
    assert st.n_records == 3000 and st.n_ranges > 1
    assert st.counters["bam.device_write_tierdown.no_residency"] == st.n_ranges == \
        jc["bam.device_write_tierdown.no_residency"]
    assert st.counters.get("bam.device_write_parts", 0) == 0


def test_cram_and_bam_twin_under_budget(tmp_path):
    """A ``.cram`` and its BAM twin under a budget write the same bytes,
    which are also the in-core bytes and the reference's."""
    from test_rans_lanes import _write_twins

    pb, pc = _write_twins(str(tmp_path), n=480, per_container=120)
    outs = {}
    for name, src, kw in (("b", pb, {}), ("c", pc, {}), ("b2", pb, {"memory_budget": 256 << 10}),
                          ("c2", pc, {"memory_budget": 256 << 10})):
        outs[name] = str(tmp_path / f"o{name}.bam")
        st = tpipeline.sort_bam(src, outs[name], conf=from_reference_conf(HOST), device="cpu",
                                split_size=64 << 10, **kw)
        if kw:
            assert st.backend == "external[device]"
    j_out = str(tmp_path / "ref_c2.bam")
    jpipeline.sort_bam(pc, j_out, conf=JConf(HOST), split_size=64 << 10,
                       memory_budget=256 << 10)
    assert _bytes(outs["c2"]) == _bytes(outs["b2"]) == _bytes(outs["b"]) == _bytes(outs["c"]) \
        == _bytes(j_out)


def test_header_only_input_writes_one_empty_part(tmp_path):
    from hadoop_bam_tpu_torch.spec import bam as tbam
    from hadoop_bam_tpu_torch.spec import bgzf as tbgzf

    src = str(tmp_path / "empty.bam")
    hdr = tbam.BamHeader("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000", [("chr1", 1000)])
    with open(src, "wb") as f:
        f.write(tbgzf.deflate_blocks(hdr.encode(), level=1)[0])
        f.write(tbgzf.TERMINATOR)
    for i, (job, kw) in enumerate((("sort_bam", {}), ("markdup_bam", {}),
                                   ("sort_bam", {"sort_order": "queryname"}))):
        st, _, _, _, _ = both(src, tmp_path, job=job, tag=str(i), memory_budget=1 << 20, **kw)
        # The header-only split spills one empty run (as in the reference)
        # and plans no range.
        assert (st.n_records, st.n_runs, st.n_ranges) == (0, 1, 0)
        pdir = tmp_path / f"parts{i}"
        getattr(tpipeline, job)(src, str(tmp_path / "o.bam"), device="cpu",
                                memory_budget=1 << 20, part_dir=str(pdir), **kw)
        assert sorted(p.name for p in pdir.iterdir()) == ["_SUCCESS", "part-r-00000", "spill"]
        assert os.path.getsize(pdir / "part-r-00000") == 0
        assert _bytes(tmp_path / "o.bam") == _bytes(tmp_path / f"port{i}.bam")


# ---------------------------------------------------------------------------
# The spill directory and crash-resume
# ---------------------------------------------------------------------------


def _build_faults_bam(path, n, seed):
    from test_faults import _build_bam

    _build_bam(path, n=n, seed=seed)


@pytest.mark.parametrize("kw", [{}, {"mark_duplicates": True}, {"sort_order": "queryname"}],
                         ids=["coordinate", "markdup", "queryname"])
def test_spill_directory_matches_the_reference(tmp_path, kw):
    """With a persistent ``part_dir`` both packages leave the same files
    under ``spill/``, byte for byte: every run and sideband, ``dupmask.npy``
    and ``manifest.json`` (the same input paths)."""
    src = str(tmp_path / "in.bam")
    _build_faults_bam(src, 20_000, 17)
    t_dir, j_dir = tmp_path / "tparts", tmp_path / "jparts"
    budget = 256 << 10
    tpipeline.sort_bam([src], str(tmp_path / "t.bam"), conf=from_reference_conf(HOST),
                       device="cpu", level=1, memory_budget=budget, part_dir=str(t_dir), **kw)
    jpipeline.sort_bam([src], str(tmp_path / "j.bam"), conf=JConf(HOST), level=1,
                       memory_budget=budget, part_dir=str(j_dir), **kw)
    names = sorted(os.listdir(j_dir / "spill"))
    assert sorted(os.listdir(t_dir / "spill")) == names
    assert "manifest.json" in names and sum(x.endswith(".run") for x in names) >= 3
    assert ("dupmask.npy" in names) == bool(kw.get("mark_duplicates"))
    for x in names:
        assert _bytes(t_dir / "spill" / x) == _bytes(j_dir / "spill" / x), x
    assert _bytes(tmp_path / "t.bam") == _bytes(tmp_path / "j.bam")


def test_kill9_mid_external_sort_then_resume(tmp_path):
    src = str(tmp_path / "in.bam")
    _build_faults_bam(src, 4000, 11)
    budget = 96 << 10
    out_clean = str(tmp_path / "uninterrupted.bam")
    j_clean = str(tmp_path / "reference.bam")
    tpipeline.sort_bam([src], out_clean, device="cpu", backend="host", level=1,
                       memory_budget=budget)
    jpipeline.sort_bam([src], j_clean, backend="host", level=1, memory_budget=budget)

    out = str(tmp_path / "resumed.bam")
    pdir = str(tmp_path / "parts")
    child = (
        "import sys; sys.path.insert(0, {repo!r})\n"
        "from hadoop_bam_tpu_torch import pipeline\n"
        "pipeline.sort_bam([{src!r}], {out!r}, device='cpu', backend='host', level=1, "
        "memory_budget={budget}, part_dir={pdir!r})\n"
    ).format(repo=REPO, src=src, out=out, budget=budget, pdir=pdir)
    # The child holds itself mid-phase 2 (the second range's every attempt
    # stalls), so the parent's SIGKILL lands between checkpoints.
    env = dict(os.environ, HBAM_FAULTS="exec.delay:items=1,attempts=*,ms=60000,n=*")
    proc = subprocess.Popen([sys.executable, "-c", child], env=env)
    part0 = os.path.join(pdir, "part-r-00000")
    deadline = time.time() + 120
    while time.time() < deadline and not os.path.exists(part0):
        if proc.poll() is not None:
            pytest.fail(f"child exited early rc={proc.returncode}")
        time.sleep(0.05)
    assert os.path.exists(part0), "child never reached phase 2"
    time.sleep(0.2)
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    assert not os.path.exists(out)
    assert os.path.exists(os.path.join(pdir, "spill", "manifest.json"))

    # The rerun, no faults: the spill runs and the finished parts are the
    # checkpoints; its peak is the reference's resumed run's.
    jpdir = str(tmp_path / "jparts")
    shutil.copytree(pdir, jpdir)
    before = snapshot()
    jst = jpipeline.sort_bam([src], str(tmp_path / "jresumed.bam"), backend="host", level=1,
                             memory_budget=budget, part_dir=jpdir)
    jc = delta(before)["counters"]
    st = tpipeline.sort_bam([src], out, device="cpu", backend="host", level=1,
                            memory_budget=budget, part_dir=pdir)
    assert st.counters["sort_bam.resume_spill_reused"] == 1
    assert st.counters["executor.skipped_existing"] >= 1
    assert st.counters["executor.skipped_existing"] == jc["executor.skipped_existing"]
    assert st.peak_bytes == jst.peak_bytes
    assert st.n_records == 4000 and st.n_ranges > 2
    assert "spill" in st.seconds  # phase 1 was skipped: loading the manifest
    assert _bytes(out) == _bytes(out_clean) == _bytes(j_clean) == \
        _bytes(tmp_path / "jresumed.bam")


def test_stale_manifest_redoes_spill(tmp_path):
    src = str(tmp_path / "in.bam")
    _build_faults_bam(src, 1200, 13)
    out = str(tmp_path / "o.bam")
    pdir = str(tmp_path / "parts")
    budget = 64 << 10
    kw = dict(device="cpu", backend="host", level=1, memory_budget=budget, part_dir=pdir)
    first = tpipeline.sort_bam([src], out, **kw)
    assert "sort_bam.resume_spill_reused" not in first.counters
    again = tpipeline.sort_bam([src], out, **kw)
    assert again.counters["sort_bam.resume_spill_reused"] == 1
    want = _bytes(out)
    # Touch the input: its identity changes, the checkpoint is refused.
    os.utime(src, ns=(1, 1))
    for p in os.listdir(pdir):
        if p.startswith("part-"):
            os.remove(os.path.join(pdir, p))
    os.remove(os.path.join(pdir, "_SUCCESS"))
    st = tpipeline.sort_bam([src], out, **kw)
    assert "sort_bam.resume_spill_reused" not in st.counters
    assert st.n_runs == first.n_runs and _bytes(out) == want
    # Another budget, order or duplicate marking refuses it too.
    for other in ({"memory_budget": budget * 2}, {"sort_order": "queryname"},
                  {"mark_duplicates": True}):
        tpipeline.sort_bam([src], out, **kw)  # the manifest is this job's again
        st = tpipeline.sort_bam([src], str(tmp_path / "x.bam"), **dict(kw, **other))
        assert "sort_bam.resume_spill_reused" not in st.counters, other

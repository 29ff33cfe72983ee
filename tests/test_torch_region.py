"""The port's region plane against the JAX reference, on the CPU.

The ``.bai`` (``build_bai`` bytes, queries, ``reg2bins``), the ``.bai``
split planner and the interval filter of bounded traversal (with and
without the unplaced-unmapped pass, a stale and a missing index), a
bounded-traversal ``sort_bam``, the CIGAR ops, the pileup ops, and the
``view_blob``, ``flagstat`` and ``depth_stat`` endpoints on BAM (with and
without a companion ``.bai``) and on a no-ref CRAM.  Every comparison is
exact.  The corpus is a few thousand records made from a numpy seed,
sorted by the reference's host sort and re-blocked into members of at most
2,500 payload bytes, so records straddle members.
"""

import gc
import io
import os
import shutil
import weakref

import numpy as np
import pytest
import torch

from hadoop_bam_tpu import native
from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.io import bam as jio
from hadoop_bam_tpu.ops import cigar as jcigar
from hadoop_bam_tpu.ops import pileup as jpileup
from hadoop_bam_tpu.serve import endpoints as jend
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.spec import bgzf as jbgzf
from hadoop_bam_tpu.spec import cram as jcram
from hadoop_bam_tpu.spec import indices as jidx
from hadoop_bam_tpu.utils import intervals as jiv
from hadoop_bam_tpu.utils.tracing import delta, snapshot
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.conf import Configuration, from_reference_conf
from hadoop_bam_tpu_torch.io import bam as tio
from hadoop_bam_tpu_torch.ops import cigar as tcigar
from hadoop_bam_tpu_torch.ops import pileup as tpileup
from hadoop_bam_tpu_torch.serve import endpoints as tend
from hadoop_bam_tpu_torch.spec import indices as tidx
from hadoop_bam_tpu_torch.utils import intervals as tiv
from hadoop_bam_tpu_torch.utils.tracing import Metrics

CPU = torch.device("cpu")
REFS = [("chr1", 3_000_000), ("chr2", 500_000), ("chr3", 200_000)]
LANES = {"hadoopbam.inflate.lanes": "true"}
CIGARS = [
    [(50, "M")],
    [(5, "S"), (30, "M"), (2, "D"), (13, "M"), (2, "S")],
    [(3, "H"), (20, "M"), (400, "N"), (27, "M"), (3, "H")],
    [(25, "M"), (2, "I"), (23, "M")],
    [(50, "S")],  # all clip: spans one base
    [],  # mapped with an empty CIGAR
    [(10, "M"), (20000, "D"), (40, "M")],  # crosses 16 KiB windows
]


def _records(n: int, seed: int):
    """Reference records: mapped reads with the CIGARs above over chr1/chr2
    (a cluster across 2**20 on chr1), placed and unplaced unmapped reads,
    and every flag bit flagstat reads."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        flag = int(rng.choice([0, 16])) | int(rng.integers(0, 0x1000)) & 0xFCB
        kind = i % 23
        refid = int(rng.integers(0, 2))
        pos = int(rng.integers(0, REFS[refid][1] - 30_000))
        if i % 9 == 0:
            refid, pos = 0, int(rng.integers((1 << 20) - 3000, (1 << 20) + 3000))
        cig = CIGARS[i % len(CIGARS)]
        if kind == 0:  # unplaced unmapped
            refid = pos = -1
            flag |= 0x4
            cig = []
        elif kind == 1:  # placed unmapped
            flag |= 0x4
            cig = []
        else:
            flag &= ~0x4
        l_seq = sum(k for k, op in cig if op in "MIS=X") or 50
        seq = "".join(rng.choice(list("ACGT"), l_seq))
        recs.append(jbam.build_record(
            name=f"r{i:05d}", refid=refid, pos=pos, mapq=int(rng.integers(0, 61)), flag=flag,
            cigar=cig, seq=seq, qual=rng.integers(2, 41, l_seq, dtype=np.uint8).tobytes(),
            next_refid=refid, next_pos=max(pos, 0) + 200, tlen=250))
    return recs


def _header():
    text = "@HD\tVN:1.6\tSO:unsorted\n" + "".join(f"@SQ\tSN:{c}\tLN:{n}\n" for c, n in REFS)
    return jbam.BamHeader(text, list(REFS))


def _reblock(src: str, dst: str, payload: int = 2500, empty_member_at=None) -> None:
    """Rewrite a BAM with header and records in members of ``payload``
    bytes (an empty member after member ``empty_member_at``)."""
    raw = open(src, "rb").read()
    r = jbgzf.BgzfReader(raw)
    hdr = jbam.read_header_stream(r)
    rest = bytearray()
    while True:
        b = r.read(1 << 20)
        if not b:
            break
        rest += b
    head = hdr.encode()
    body = native.deflate_blocks(np.frombuffer(bytes(rest), np.uint8), level=1,
                                 block_payload=payload)
    if empty_member_at is not None:
        cut = jbgzf.scan_blocks(body)[empty_member_at].coffset
        body = body[:cut] + jbgzf.compress_block(b"", 1) + body[cut:]
    with open(dst, "wb") as f:
        f.write(native.deflate_blocks(np.frombuffer(head, np.uint8), level=1, block_payload=900))
        f.write(body)
        f.write(jbgzf.TERMINATOR)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    td = tmp_path_factory.mktemp("region")
    src = str(td / "unsorted.bam")
    buf = io.BytesIO()
    jbam.write_bam(buf, _header(), iter(_records(2400, 5)), level=1)
    open(src, "wb").write(buf.getvalue())
    srt = str(td / "sorted.host.bam")
    jpipeline.sort_bam([src], srt, backend="host", level=1)
    paths = {"bai": str(td / "sorted.bam"), "nobai": str(td / "nobai.bam"),
             "empty": str(td / "empty_member.bam")}
    _reblock(srt, paths["bai"])
    shutil.copy(paths["bai"], paths["nobai"])
    _reblock(srt, paths["empty"], empty_member_at=7)
    with open(paths["bai"] + ".bai", "wb") as f:
        jidx.build_bai(paths["bai"]).save(f)
    hdr, recs = jbam.read_bam(paths["bai"])
    paths["cram"] = str(td / "sorted.cram")
    with open(paths["cram"], "wb") as f:
        jcram.write_cram(f, hdr, recs, records_per_container=300, codec="gzip")
    paths["records"] = recs
    return paths


# ---------------------------------------------------------------------------
# The .bai
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beg,end", [(0, 1), (0, 0), (5, 3), (16383, 16385), (1 << 20, 3 << 20),
                                     (123_456, 9_876_543), (0, 1 << 29)])
def test_reg2bins_equals_the_reference(beg, end):
    assert tidx.reg2bins(beg, end) == jidx.reg2bins(beg, end)


def _save(bai) -> bytes:
    b = io.BytesIO()
    bai.save(b)
    return b.getvalue()


@pytest.mark.parametrize("which", ["bai", "empty"])
def test_build_bai_writes_the_reference_bytes(corpus, which):
    path = corpus[which]
    got = _save(tidx.build_bai(path))
    assert got == _save(jidx.build_bai(path))
    assert _save(tidx.Bai.load(got)) == got
    with open(path, "rb") as f:
        assert _save(tidx.build_bai(f.read())) == got


def test_baibuilder_walk_equals_the_columnar_build(corpus):
    """The per-record builder fed the reference's walk gives the same bytes."""
    raw = open(corpus["empty"], "rb").read()
    reader = jbgzf.BgzfReader(raw)
    hdr = jbam.read_header_stream(reader)
    b = tidx.BaiBuilder(hdr.n_refs)
    while not reader.at_eof:
        vstart = reader.tell_voffset()
        size = reader.read(4)
        if len(size) < 4:
            break
        body = reader.read_fully(int.from_bytes(size, "little"))
        rec, _ = jbam.decode_record(size + body, 0)
        b.add(rec.refid, rec.pos, rec.pos + max(1, rec.reference_length()), rec.bin, vstart,
              reader.tell_voffset())
    assert _save(b.build()) == _save(tidx.build_bai(raw))


def test_bai_queries_equal_the_reference(corpus):
    t = tidx.Bai.load(corpus["bai"] + ".bai")
    j = jidx.Bai.load(corpus["bai"] + ".bai")
    rng = np.random.default_rng(3)
    regions = [(r, b, b + w) for r in (-1, 0, 1, 2, 3)
               for b, w in [(0, 1), (0, 1 << 29), ((1 << 20) - 100, 200), (2_999_000, 5000)]]
    regions += [(int(rng.integers(0, 2)), int(b), int(b) + int(w))
                for b, w in zip(rng.integers(0, 600_000, 40), rng.integers(1, 80_000, 40))]
    for rid, beg, end in regions:
        assert [(c.beg, c.end) for c in t.query(rid, beg, end)] == \
            [(c.beg, c.end) for c in j.query(rid, beg, end)], (rid, beg, end)
    assert t.first_offset() == j.first_offset()
    assert t.unmapped_span_start() == j.unmapped_span_start()
    assert t.n_no_coor == j.n_no_coor
    assert [t.linear_index(i) for i in range(3)] == [j.linear_index(i) for i in range(3)]


# ---------------------------------------------------------------------------
# Split planning and bounded traversal
# ---------------------------------------------------------------------------


def _splits(fmt, paths, split_size):
    return [(s.path, s.vstart, s.vend, s.interval_chunks)
            for s in fmt.get_splits(paths, split_size=split_size)]


def _split_records(fmt, path, split_size):
    out = []
    for s in fmt.get_splits([path], split_size=split_size):
        b = fmt.read_split(s)
        out += [bytes(b.data[o - 4 : o + n]) for o, n in zip(b.soa["rec_off"], b.soa["rec_len"])]
    return out


@pytest.mark.parametrize("which,split_size", [("bai", 20_000), ("bai", 57_000),
                                               ("bai", 10 << 20), ("nobai", 20_000)])
def test_bai_splits_equal_the_reference(corpus, which, split_size):
    conf = {"hadoopbam.bam.enable-bai-splitter": "true"}
    path = corpus[which]
    t = _splits(tio.BamInputFormat(Configuration(conf)), [path], split_size)
    j = _splits(jio.BamInputFormat(JConf(conf)), [path], split_size)
    assert t == j
    recs = _split_records(tio.BamInputFormat(Configuration(conf)), path, split_size)
    assert recs == [r.encode() for r in corpus["records"]]


def test_stale_bai_plans_with_the_guesser_like_the_reference(corpus, tmp_path):
    path = str(tmp_path / "stale.bam")
    shutil.copy(corpus["bai"], path)
    bai = jidx.Bai.load(corpus["bai"] + ".bai")
    for ref in bai.refs:
        ref.linear = [v + (10**9 << 16) for v in ref.linear if v]
        ref.bins = {b: [jidx.Chunk(c.beg + (10**9 << 16), c.end + (10**9 << 16)) for c in cs]
                    for b, cs in ref.bins.items()}
    with open(path + ".bai", "wb") as f:
        bai.save(f)
    conf = {"hadoopbam.bam.enable-bai-splitter": "true"}
    t = _splits(tio.BamInputFormat(Configuration(conf)), [path], 30_000)
    assert t == _splits(jio.BamInputFormat(JConf(conf)), [path], 30_000)
    assert t == _splits(tio.BamInputFormat(), [path], 30_000)


@pytest.mark.parametrize("which", ["bai", "nobai"])
@pytest.mark.parametrize("intervals,unmapped", [
    ("chr1:100000-400000", False),
    ("chr1:100000-400000,chr2:1-50000,chrZ:1-5", True),
    ("chr2", False),
    ("chr1:1048000-1049000", True),
    (None, True),
    ("chr3:1-1000", False),
])
def test_interval_filter_equals_the_reference(corpus, which, intervals, unmapped):
    conf = {"hadoopbam.bam.bounded-traversal": "true"}
    if intervals is not None:
        conf["hadoopbam.bam.intervals"] = intervals
    if unmapped:
        conf["hadoopbam.bam.traverse-unplaced-unmapped"] = "true"
    path = corpus[which]
    tf, jf = tio.BamInputFormat(Configuration(conf)), jio.BamInputFormat(JConf(conf))
    t = _splits(tf, [path], 40_000)
    assert t == _splits(jf, [path], 40_000)
    assert _split_records(tf, path, 40_000) == _split_records(jf, path, 40_000)


@pytest.mark.parametrize("unmapped", [False, True])
def test_bounded_traversal_sort_writes_the_reference_bytes(corpus, tmp_path, unmapped):
    conf = {"hadoopbam.bam.bounded-traversal": "true",
            "hadoopbam.bam.intervals": "chr1:200000-900000,chr2:10000-60000",
            "hadoopbam.inflate.lanes": "false"}
    if unmapped:
        conf["hadoopbam.bam.traverse-unplaced-unmapped"] = "true"
    t_out, j_out = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    st = tpipeline.sort_bam(corpus["bai"], t_out, conf=from_reference_conf(conf), device="cpu",
                            level=1, split_size=40_000)
    jst = jpipeline.sort_bam(corpus["bai"], j_out, conf=JConf(conf), level=1, split_size=40_000)
    assert st.n_records == jst.n_records > 0
    assert open(t_out, "rb").read() == open(j_out, "rb").read()


def test_bounded_traversal_through_the_inflate_gate(corpus, tmp_path):
    """The plain inflate kernel and the records-kept count."""
    conf = {"hadoopbam.bam.bounded-traversal": "true",
            "hadoopbam.bam.intervals": "chr1:1000000-1100000", **LANES}
    t_out, j_out = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    st = tpipeline.sort_bam(corpus["nobai"], t_out, conf=from_reference_conf(conf), device="cpu",
                            level=1, split_size=30_000)
    conf.pop("hadoopbam.inflate.lanes")  # the reference's host inflate: the same bytes
    jpipeline.sort_bam(corpus["nobai"], j_out, conf=JConf(conf), level=1, split_size=30_000)
    assert open(t_out, "rb").read() == open(j_out, "rb").read()
    assert st.counters["bam.records_kept"] == st.n_records > 0
    assert st.counters["flate.inflate.lanes"] > 0


# ---------------------------------------------------------------------------
# CIGAR and pileup ops
# ---------------------------------------------------------------------------


def _soa(corpus):
    from hadoop_bam_tpu_torch.spec import bam as tbam

    data = np.frombuffer(b"".join(r.encode() for r in corpus["records"]), np.uint8)
    return data, tbam.soa_decode(data, tbam.record_offsets(data))


def test_cigar_np_ops_equal_the_reference(corpus):
    data, soa = _soa(corpus)
    for fn in ("reference_lengths_np", "unclipped_start_np", "unclipped_end_np"):
        assert np.array_equal(getattr(tcigar, fn)(data, soa), getattr(jcigar, fn)(data, soa)), fn
    for a, b in zip(tcigar.clip_spans_np(data, soa), jcigar.clip_spans_np(data, soa)):
        assert np.array_equal(a, b)
    assert np.array_equal(tcigar.pack_cigars_padded(data, soa, 5),
                          jcigar.pack_cigars_padded(data, soa, 5))
    with pytest.raises(ValueError, match="max_ops"):
        tcigar.pack_cigars_padded(data, soa, 2)
    empty = {k: v[:0] for k, v in soa.items()}
    assert len(tcigar.reference_lengths_np(data, empty)) == 0


def test_cigar_padded_ops_equal_the_reference(corpus):
    data, soa = _soa(corpus)
    packed = jcigar.pack_cigars_padded(data, soa, 5)
    n_ops = soa["n_cigar_op"].astype(np.int32)
    pos = soa["pos"].astype(np.int32)
    pos[:3] = [2**31 - 1, -1, 2**31 - 60]  # int32 wrap
    t = torch.from_numpy(packed.astype(np.int64))
    assert np.array_equal(tcigar.reference_lengths_padded(t).numpy(),
                          np.asarray(jcigar.reference_lengths_padded(packed)))
    for fn in ("unclipped_start_padded", "unclipped_end_padded"):
        got = getattr(tcigar, fn)(t, torch.from_numpy(n_ops), torch.from_numpy(pos)).numpy()
        assert np.array_equal(got, np.asarray(getattr(jcigar, fn)(packed, n_ops, pos))), fn


@pytest.mark.parametrize("k", [0, 1, 5])
def test_cigar_overlap_mask_equals_the_reference(k):
    rng = np.random.default_rng(k)
    n = 3000
    refid = rng.integers(-1, 3, n).astype(np.int32)
    pos = rng.integers(-5, 200_000, n).astype(np.int32)
    ln = rng.integers(-3, 500, n).astype(np.int32)
    pos[:4] = [2**31 - 1, 2**31 - 10, -1, 0]
    ln[:4] = [0, 50, 10, 0]
    ivr = rng.integers(-1, 3, k).astype(np.int32)
    ivb = rng.integers(-10, 150_000, k).astype(np.int32)
    ive = (ivb + rng.integers(0, 60_000, k)).astype(np.int32)
    if k:
        ivr[0], ivb[0], ive[0] = 0, 2**31 - 100, 2**31 - 1
    got = tcigar.overlap_mask(*[torch.from_numpy(a) for a in (refid, pos, ln, ivr, ivb, ive)])
    want = np.asarray(jcigar.overlap_mask(refid, pos, ln, ivr, ivb, ive)) if k else np.zeros(n, bool)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def test_depth_ops_across_a_chunk_boundary_equal_the_reference():
    rng = np.random.default_rng(9)
    beg = 50_000
    end = beg + tpileup.CHUNK_BASES + 30_000  # two chunks, the cut at beg + CHUNK_BASES
    starts = rng.integers(end - 70_000, end + 1000, 3000)
    ends = starts + rng.integers(1, 400, 3000)
    want = jpileup.depth_profile(starts, ends, beg, end)
    for dev in (False, True):
        m = Metrics()
        got = tpileup.depth_profile(starts, ends, beg, end, use_device=dev, device=CPU, metrics=m)
        assert np.array_equal(got, want)
        assert m.get("pileup.device_chunks") == (2 if dev else 0)
    assert np.array_equal(want, jpileup.depth_profile(starts, ends, beg, end, use_device=True))
    for bin_size in (1, 777, 4096, 1 << 21):
        for dev in (False, True):
            got = tpileup.depth_summary(starts, ends, beg, end, bin_size=bin_size,
                                        use_device=dev, device=CPU)
            assert got == jpileup.depth_summary(starts, ends, beg, end, bin_size=bin_size,
                                                use_device=dev), (bin_size, dev)
    assert tpileup.depth_summary([], [], 5, 5) == jpileup.depth_summary([], [], 5, 5)
    keys = (rng.integers(0, 3, 500).astype(np.int64) << 32) | rng.integers(0, 10_000, 500)
    lens = rng.integers(1, 300, 500)
    for a, b in zip(tpileup.spans_from_keys(keys, lens, 1, 100, 5000),
                    jpileup.spans_from_keys(keys, lens, 1, 100, 5000)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The endpoints
# ---------------------------------------------------------------------------

VIEW_REGIONS = ["chr1:100,001-300,000", "chr1:1048000-1049500", "chr2", "chr1:2000000",
                "chr1:2999000-3000000", "chr3:1-200000", "chr2:499990-600000"]


def _jctx():
    return jend.ServeContext.from_conf(JConf(), with_batcher=False)


def _tctx(conf=None):
    """The port's one-shot context on the CPU (cold cache and arena)."""
    return tend.ServeContext.from_conf(conf, with_batcher=False, device="cpu")


@pytest.mark.parametrize("which", ["bai", "nobai"])
def test_view_blob_writes_the_reference_bytes(corpus, which):
    path = corpus[which]
    ctx = _jctx()
    for region in VIEW_REGIONS:
        tctx = _tctx()
        t = {}
        got = tend.view_blob(tctx, path, region, level=1, timings=t)
        before = snapshot()
        want = jend.view_blob(ctx, path, region, level=1)
        d = delta(before)["counters"]
        assert got == want, region
        c = tctx.metrics.counters()
        for k in ("serve.view.requests", "serve.view.records", "serve.view.overlap_device"):
            assert c.get(k, 0) == d.get(k, 0), (region, k)
        assert set(t) == {"index", "read", "overlap", "encode"}
    for bad in ("chrZ:1-10", "chr1:0-5"):
        with pytest.raises(jiv.FormatError):
            jend.view_blob(ctx, path, bad)
        with pytest.raises(tiv.FormatError):
            tend.view_blob(_tctx(), path, bad)


@pytest.mark.parametrize("region", ["chr1:1000000-1100000", "chr2", "chr1"])
def test_a_view_across_many_chunk_spans_is_one_cut(corpus, region):
    """A view whose ``.bai`` query crosses at least four chunk spans (members
    of at most 2,500 payload bytes): every span is read first and the view is
    cut once, and ``view_blob`` and ``depth_stat`` still give the
    reference's bytes and dict with its ``serve.view.*`` counters, one
    ``overlap_device`` a non-empty span as the reference counts them."""
    path = corpus["bai"]
    iv = tiv.parse_interval(region)
    rid = tio.read_header_voffset(path)[0].ref_index(iv.contig)
    chunks = tidx.Bai.load(path + ".bai").query(rid, iv.start - 1, min(iv.end, tiv.MAX_END))
    assert len(chunks) >= 4
    tctx = _tctx()
    t = {}
    got = tend.view_blob(tctx, path, region, level=1, timings=t)
    before = snapshot()
    want = jend.view_blob(_jctx(), path, region, level=1)
    d = delta(before)["counters"]
    assert got == want
    c = tctx.metrics.counters()
    for k in ("serve.view.requests", "serve.view.records", "serve.view.overlap_device"):
        assert c.get(k, 0) == d.get(k, 0), k
    assert c["serve.view.overlap_device"] >= 4
    assert set(t) == {"index", "read", "overlap", "encode"}
    tctx = _tctx()
    got = tend.depth_stat(tctx, path, region, bin_size=1000)
    before = snapshot()
    want = jend.depth_stat(_jctx(), path, region, bin_size=1000)
    d = delta(before)["counters"]
    assert got == want and got["n_records"] > 0
    c = tctx.metrics.counters()
    for k in ("serve.view.overlap_device", "serve.depth.requests"):
        assert c.get(k, 0) == d.get(k, 0), k


@pytest.mark.parametrize("budget", [1, 100_000])
def test_a_many_split_cram_view_drops_each_batch_without_a_hit(corpus, monkeypatch, budget):
    """A CRAM view reads every split (here eight, one container each) and
    cuts its held batches each time they reach ``VIEW_CUT_BYTES``: at each
    cut every batch of the earlier cuts without a hit is gone, the held
    batches but the last stay under the budget, and the bytes and dict are
    the reference's.  The context's arena keeps what its budget allows (a
    1-byte budget: the newest window, and windows of no bytes), so a
    dropped batch must be gone or held by the arena: the view holds none."""
    from hadoop_bam_tpu_torch.io import anysam as tany

    splits = tany.AnySamInputFormat.get_splits
    monkeypatch.setattr(tany.AnySamInputFormat, "get_splits",
                        lambda self, paths, split_size=0: splits(self, paths, 4096))
    monkeypatch.setattr(tend, "VIEW_CUT_BYTES", budget)
    cut, dropped, sizes, ctxs = tend._cut_view, [], [], []

    def one_window_ctx():
        ctxs.append(_tctx(Configuration({"hadoopbam.serve.arena-bytes": "1"})))
        return ctxs[-1]

    def watch(batches, *args):
        gc.collect()
        kept = [e[1] for c in ctxs for e in c.arena._entries.values()]
        assert all(r() is None or any(r() is b for b in kept) for r in dropped)
        assert sum(b.data.nbytes for b in batches[:-1]) < budget
        sizes.append(len(batches))
        rows = cut(batches, *args)
        dropped.extend(weakref.ref(b) for b, r in zip(batches, rows) if not len(r))
        return rows

    monkeypatch.setattr(tend, "_cut_view", watch)
    ctx = _jctx()
    for region in ("chr3", "chr1:100,001-300,000"):
        sizes.clear()
        dropped.clear()
        tctx = one_window_ctx()
        assert tend.view_blob(tctx, corpus["cram"], region) == \
            jend.view_blob(ctx, corpus["cram"], region), region
        assert sum(sizes) == 8 and len(sizes) == (8 if budget == 1 else 3), sizes
        assert tctx.metrics.counters()["serve.view.overlap_device"] == 8
        assert len(dropped) >= 5
        assert tend.depth_stat(one_window_ctx(), corpus["cram"], region, bin_size=1000) == \
            jend.depth_stat(ctx, corpus["cram"], region, bin_size=1000), region


def test_view_blob_through_the_inflate_gate(corpus):
    conf = Configuration(LANES)
    for region in VIEW_REGIONS[:3]:
        tctx = _tctx(conf)
        got = tend.view_blob(tctx, corpus["bai"], region, level=1)
        assert got == jend.view_blob(_jctx(), corpus["bai"], region, level=1)
        assert tctx.stream.inflate_stats.lanes > 0


def test_view_blob_of_a_cram_writes_the_reference_bytes(corpus):
    ctx = _jctx()
    for region in ("chr1:100,001-300,000", "chr2", "chr3"):
        assert tend.view_blob(_tctx(), corpus["cram"], region) == \
            jend.view_blob(ctx, corpus["cram"], region), region
    with pytest.raises(tiv.FormatError):
        tend.view_blob(_tctx(), corpus["cram"], "chrZ")


@pytest.mark.parametrize("which", ["bai", "cram"])
def test_flagstat_equals_the_reference(corpus, which):
    tctx = _tctx()
    t = {}
    got = tend.flagstat(tctx, corpus[which], timings=t)
    before = snapshot()
    want = jend.flagstat(_jctx(), corpus[which])
    assert got == want and got["total"] == 2400
    assert tctx.metrics.get("serve.flagstat.requests") == delta(before)["counters"]["serve.flagstat.requests"]
    assert set(t) == {"index", "read"}


@pytest.mark.parametrize("which", ["bai", "nobai", "cram"])
def test_depth_stat_equals_the_reference(corpus, which):
    path = corpus[which]
    ctx = _jctx()
    cases = [("chr1:1047001-1049000", 100, True), ("chr1", 4096, False),
             ("chr2:1-20000", 1000, True), ("chr1:2999001-3100000", 64, True)]
    for region, bin_size, per_base in cases:
        for gate in ("false", "true"):
            tctx = _tctx(Configuration({"hadoopbam.bcf.chain": gate}))
            got = tend.depth_stat(tctx, path, region, bin_size=bin_size, per_base=per_base)
            before = snapshot()
            want = jend.depth_stat(jend.ServeContext.from_conf(JConf({"hadoopbam.bcf.chain": gate}),
                                                               with_batcher=False),
                                   path, region, bin_size=bin_size, per_base=per_base)
            d = delta(before)["counters"]
            assert got == want, (region, gate)
            for k in ("serve.depth.requests", "pileup.device_chunks"):
                assert tctx.metrics.get(k) == d.get(k, 0), (region, gate, k)
    for region, kw in (("chr1", {"per_base": True}), ("chr3:300000-400000", {})):
        with pytest.raises(jiv.FormatError):
            jend.depth_stat(ctx, path, region, **kw)
        with pytest.raises(tiv.FormatError):
            tend.depth_stat(_tctx(), path, region, **kw)


def test_region_entry_points_raise_when_no_card(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tend.view_blob(tend.ServeContext.from_conf(), corpus["bai"], "chr1"),
                 lambda: tend.flagstat(tend.ServeContext.from_conf(with_batcher=False),
                                       corpus["bai"]),
                 lambda: tend.depth_stat(tend.ServeContext.from_conf(device="cuda"),
                                         corpus["bai"], "chr1:1-100")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# The reference-named ``*_auto`` entry points of rows 6, 8 and 9


@pytest.mark.parametrize("as_bool", [False, True], ids=["int_valid", "bool_valid"])
def test_quality_histogram_auto_equals_the_reference(as_bool):
    from hadoop_bam_tpu.ops.pallas import quality_histogram_auto as jauto
    from hadoop_bam_tpu_torch.ops.kernels import quality_histogram_auto
    from test_torch_region_kernels import _hist_case

    values, valid = _hist_case(37, 32, 256)
    got = quality_histogram_auto(values, valid.astype(bool) if as_bool else valid, nbins=256,
                                 device="cpu")
    want = np.asarray(jauto(values, valid, nbins=256))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
def test_unpack_nibbles_auto_equals_the_reference(dtype):
    from hadoop_bam_tpu.ops.pallas import unpack_nibbles_auto as jauto
    from hadoop_bam_tpu_torch.ops.kernels import unpack_nibbles_auto

    packed = np.random.default_rng(4).integers(0, 256, (19, 11)).astype(dtype)
    got = unpack_nibbles_auto(packed, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jauto(packed)))
    np.testing.assert_array_equal(unpack_nibbles_auto(torch.from_numpy(packed)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("k", [0, 3, 40])
def test_overlap_mask_auto_equals_the_reference(k):
    from hadoop_bam_tpu.ops.pallas import overlap_mask_auto as jauto
    from hadoop_bam_tpu_torch.ops.kernels import overlap_mask_auto
    from test_torch_region_kernels import _overlap_case

    iv, refid, start, end = _overlap_case(k, n=600)
    got = overlap_mask_auto(iv, refid, start, end, device="cpu")
    assert got.dtype == torch.bool
    want = np.asarray(jauto(iv.reshape(-1, 3), refid, start, end)) if k else np.zeros(600, bool)
    np.testing.assert_array_equal(got.numpy(), want)


def test_auto_entry_points_raise_without_a_card_unless_told(monkeypatch):
    from hadoop_bam_tpu_torch.ops import kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    one = np.ones((1, 4), np.int32)
    for call in (lambda: kernels.quality_histogram_auto(one, one),
                 lambda: kernels.unpack_nibbles_auto(one),
                 lambda: kernels.overlap_mask_auto(np.array([[0, 1, 2]]), [0], [1], [2])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert kernels.unpack_nibbles_auto(one, device="cpu").shape == (1, 8)

"""Fixmate in the port (``collate.fixmate``: the edit plan, the tag walk, the
record rewrite; ``pipeline.fixmate_bam``) against the reference's, exactly:
collation columns, ``FixmateEdits`` field by field, rebuilt streams, output
files, ``FixmateStats`` and counters.  The cases are the reference's
``tests/test_collate.py`` fixmate, rebuild and collision cases (mates that
straddle splits, stale MC tags, idempotence), without the CLI and the
out-of-core job, plus a ``.cram`` input, the deflate lanes, an empty input
and the argument checks."""

import os

import numpy as np
import pytest
import torch

from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.collate import collate_by_name as jcollate
from hadoop_bam_tpu.collate import collation_columns as jcolumns
from hadoop_bam_tpu.collate import compute_fixmate_edits as jedits
from hadoop_bam_tpu.collate import fixmate as jfixmate
from hadoop_bam_tpu.collate import signature as jsig
from hadoop_bam_tpu.collate import verify_and_repair as jverify
from hadoop_bam_tpu.conf import DEFLATE_LANES
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.io.bam import rebuild_record_stream as jrebuild
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.utils.tracing import delta, snapshot
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.collate import (
    FIXMATE_FIELDS,
    apply_fixmate,
    collate_by_name,
    collation_columns,
    compute_fixmate_edits,
    concat_collation,
    fixmate_oracle,
    mc_tag_of,
    verify_and_repair,
)
from hadoop_bam_tpu_torch.collate import fixmate as tfixmate
from hadoop_bam_tpu_torch.collate import signature as tsig
from hadoop_bam_tpu_torch.conf import from_reference_conf
from hadoop_bam_tpu_torch.io.bam import RecordBatch, rebuild_record_stream
from hadoop_bam_tpu_torch.spec import bam as tbam
from hadoop_bam_tpu_torch.spec import bgzf as tbgzf
from hadoop_bam_tpu_torch.utils.tracing import Metrics
from test_collate import _collate_corpus
from test_torch_markdup import HOST, port_records, read, write_bam

REFS = [("c1", 1 << 24), ("c2", 1 << 24)]


def soa_of(recs):
    data = np.frombuffer(b"".join(r.encode() for r in recs), np.uint8)
    return data, tbam.soa_decode(data, tbam.record_offsets(data, 0), FIXMATE_FIELDS)


def same_edits(a, b):
    for k in ("mask", "place", "flag", "refid", "pos", "bin", "next_refid", "next_pos", "tlen",
              "mc", "mc_off", "mc_len"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.counts == b.counts


def both_fixmates(src, tmp_path, gates=HOST, **kw):
    t_out, j_out = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    st = tpipeline.fixmate_bam(src, t_out, conf=from_reference_conf(gates), device="cpu", **kw)
    jst = jpipeline.fixmate_bam(src, j_out, conf=JConf(gates), **kw)
    assert read(t_out) == read(j_out)
    assert (st.n_records, st.n_splits, st.n_pairs, st.n_singletons, st.n_orphans, st.backend) \
        == (jst.n_records, jst.n_splits, jst.n_pairs, jst.n_singletons, jst.n_orphans,
            jst.backend)
    return st, t_out


def check_fields(path, recs):
    """The output's fields against the port's per-record oracle."""
    got = jbam.read_bam(path)[1]
    exp = fixmate_oracle(port_records(recs))
    assert len(got) == len(exp)
    for r, e in zip(got, exp):
        ctx = (r.read_name, hex(r.flag))
        assert (r.flag, r.refid, r.pos, r.next_refid, r.next_pos, r.tlen) == (
            e["flag"], e["refid"], e["pos"], e["next_refid"], e["next_pos"], e["tlen"]), ctx
        if e["mc"] is not None:
            assert mc_tag_of(tbam.decode_record(r.encode())[0]) == e["mc"], ctx


@pytest.mark.parametrize("seed,interleave", [(0, True), (1, False), (2, True)])
def test_edit_plan_matches_the_reference(seed, interleave):
    recs = _collate_corpus(np.random.default_rng(seed), interleave=interleave)
    data, soa = soa_of(recs)
    cols = collation_columns(data, soa, with_cigars=True)
    want_cols = jcolumns(data, dict(soa), with_cigars=True)
    assert list(cols) == list(want_cols)
    for k in want_cols:
        assert cols[k].dtype == want_cols[k].dtype, k
        np.testing.assert_array_equal(cols[k], want_cols[k], err_msg=k)
    m = Metrics()
    col, n_coll = verify_and_repair(collate_by_name(cols, device="cpu"), cols, m)
    jcol, j_coll = jverify(jcollate(want_cols), want_cols)
    assert n_coll == j_coll == 0
    np.testing.assert_array_equal(col.mate, jcol.mate)
    before = snapshot()
    want = jedits(want_cols, jcol)
    jc = delta(before)["counters"]
    got = compute_fixmate_edits(cols, col, m)
    same_edits(got, want)
    for k in ("collate.pairs", "collate.singletons", "collate.orphans", "fixmate.records_updated",
              "fixmate.placed_unmapped", "fixmate.mc_tags"):
        assert m.get(k) == jc.get(k, 0), k
    assert got.place.any() and got.mc_len.any()


@pytest.mark.parametrize("seed", [3, 4])
def test_apply_fixmate_matches_the_reference(seed):
    """One split's rewrite against the reference's, from a row base inside
    the plan."""
    recs = _collate_corpus(np.random.default_rng(seed))
    data, soa = soa_of(recs)
    cols = collation_columns(data, soa, with_cigars=True)
    col, _ = verify_and_repair(collate_by_name(cols, device="cpu"), cols)
    edits = compute_fixmate_edits(cols, col)
    a, b = 40, 95
    sub = {k: v[a:b] for k, v in soa.items()}
    got = apply_fixmate(RecordBatch(soa=sub, data=data, keys=np.empty(0, np.int64)), edits, a)
    from hadoop_bam_tpu.io.bam import RecordBatch as JBatch

    want = jfixmate.apply_fixmate(JBatch(soa=dict(sub), data=data, keys=np.empty(0, np.int64)),
                                  edits, a)
    np.testing.assert_array_equal(got.data, want.data)
    for k in ("rec_off", "rec_len"):
        np.testing.assert_array_equal(got.soa[k], want.soa[k])


def test_rebuild_record_stream_matches_the_reference():
    recs = [jbam.build_record(f"r{i}", 0, 10 * i, 60, 0, [(4, "M")], "ACGT", bytes([30] * 4),
                              tags=b"NMC\x05") for i in range(3)]
    blob = b"".join(r.encode() for r in recs)
    data = np.frombuffer(blob, np.uint8)
    soa = tbam.soa_decode(data, tbam.record_offsets(data, 0), ("rec_off", "rec_len"))
    rec_off, rec_len = soa["rec_off"], soa["rec_len"]
    noop = (data, rec_off, rec_len, rec_len.copy(), np.zeros(3, np.int64), np.empty(0, np.uint8),
            np.zeros(3, np.int64), np.zeros(3, np.int64))
    out, no, nl = rebuild_record_stream(*noop)
    assert out.tobytes() == blob
    np.testing.assert_array_equal(no, rec_off)
    cut_off = rec_len.copy()
    cut_off[1] = rec_len[1] - 4
    app = np.frombuffer(b"MCZ4M\x00", np.uint8)
    args = (data, rec_off, rec_len, cut_off, np.array([0, 4, 0], np.int64), app,
            np.zeros(3, np.int64), np.array([0, len(app), 0], np.int64))
    for got, want in zip(rebuild_record_stream(*args), jrebuild(*args)):
        np.testing.assert_array_equal(got, want)
    got = list(tbam.iter_records(rebuild_record_stream(*args)[0].tobytes()))
    assert got[1].tags_raw == b"MCZ4M\x00" and got[0].raw == recs[0].raw


TAG_BLOCKS = [
    b"NMC\x05MCZ9M\x00",
    b"MCZ3S37M\x00NMC\x05",
    b"XAAxXBcxXCCxXDs\x01\x00XES\x01\x00XFi\x01\x00\x00\x00XGI\x00\x00\x00\x00XHf\x00\x00\x00\x00",
    b"BQBc\x03\x00\x00\x00\x01\x02\x03MCZ5M\x00",
    b"BQBf\x01\x00\x00\x00\x00\x00\x00\x00XHH0A0B\x00MCZ1M\x00",
    b"BQBq\x01\x00\x00\x00\x00",  # an unknown element type stops the walk
    b"XXq\x00MCZ1M\x00",  # an unknown tag type stops the walk
    b"MCZ4M",  # no NUL: the value runs past the end
    b"BQBc\xff\x00\x00\x00",  # a count past the end
    b"",
]


@pytest.mark.parametrize("tags", TAG_BLOCKS)
def test_find_tag_span_matches_the_reference(tags):
    body = np.frombuffer(b"\x00" * 7 + tags, np.uint8)
    for tag in (b"MC", b"NM", b"XH", b"ZZ"):
        want = jfixmate.find_tag_span(body, 7, tag)
        assert tfixmate.find_tag_span(body, 7, tag) == want
        assert tfixmate.find_tag_span(body.tobytes(), 7, tag) == want


def test_find_tag_spans_walks_as_find_tag_span():
    """The lockstep walk of many tag blocks of one stream against the
    per-record walk: the cases above, then a fuzz of blocks built from valid
    and broken entries of every type."""
    rng = np.random.default_rng(13)
    entries = [b"MCZ%dM\x00" % int(rng.integers(1, 200)), b"NMC\x05", b"XSs\x01\x00",
               b"XIi\x01\x00\x00\x00", b"XFf\x00\x00\x80\x3f", b"XAAq", b"RGZgrp\x00",
               b"XHH0AFF\x00", b"BCBc\x02\x00\x00\x00\x01\x02", b"BIBI\x01\x00\x00\x00abcd",
               b"BSBS\x02\x00\x00\x00abcd", b"MCZ", b"MCZ5", b"BQBq\x01\x00\x00\x00\x00",
               b"XXq\x00", b"BCBc\xff\xff\x00\x00", b"MC"]
    blocks = list(TAG_BLOCKS)
    for _ in range(400):
        k = int(rng.integers(0, 5))
        blocks.append(b"".join(entries[int(i)] for i in rng.integers(0, len(entries), k)))
    pad = [int(rng.integers(0, 9)) for _ in blocks]
    stream = b"".join(b"\x07" * a + b for a, b in zip(pad, blocks))
    data = np.frombuffer(stream, np.uint8)
    ends = np.cumsum([a + len(b) for a, b in zip(pad, blocks)])
    starts = ends - np.asarray([len(b) for b in blocks])
    for tag in (b"MC", b"NM", b"BC", b"ZZ"):
        off, ln = tfixmate.find_tag_spans(data, starts, ends, tag)
        for i, b in enumerate(blocks):
            want = jfixmate.find_tag_span(np.frombuffer(b, np.uint8), 0, tag)
            got = None if off[i] < 0 else (int(off[i] - starts[i]), int(ln[i]))
            assert got == want, (b, tag)
    assert (tfixmate.find_tag_spans(data, starts, ends, b"MC")[0] >= 0).sum() > 50


@pytest.fixture(scope="module")
def straddling(tmp_path_factory):
    """The reference's interleaved corpus (mates far apart in file order)
    in level-0 members of 2,048 bytes, so that mates straddle splits."""
    recs = _collate_corpus(np.random.default_rng(0))
    path = write_bam(str(tmp_path_factory.mktemp("fixmate") / "in.bam"), recs, refs=REFS,
                     level=0)
    return recs, path


@pytest.mark.parametrize("split_size", [4 << 10, 16 << 10, 1 << 20])
def test_fixmate_bam_writes_the_reference_bytes(straddling, tmp_path, split_size):
    recs, src = straddling
    st, out = both_fixmates(src, tmp_path, split_size=split_size, level=1,
                            write_splitting_bai=True)
    assert read(out + ".splitting-bai") == read(str(tmp_path / "ref.bam") + ".splitting-bai")
    if split_size == 4 << 10:
        assert st.n_splits > 1
    assert st.n_pairs > 0 and st.n_orphans > 0 and st.n_singletons > 0
    assert st.counters["fixmate.records"] == st.n_records == len(recs)
    assert st.counters["collate.pairs"] == st.n_pairs
    assert set(st.seconds) == {"read", "collate", "write"}
    assert jbam.read_bam(out)[0].sort_order() == "unsorted"  # the header is the input's
    check_fields(out, recs)


def test_fixmate_counters_match_the_reference(straddling, tmp_path):
    recs, src = straddling
    before = snapshot()
    jpipeline.fixmate_bam(src, str(tmp_path / "j.bam"), conf=JConf(HOST), split_size=4096)
    jc = delta(before)["counters"]
    st = tpipeline.fixmate_bam(src, str(tmp_path / "t.bam"), conf=from_reference_conf(HOST),
                               device="cpu", split_size=4096)
    for k in ("fixmate.records", "fixmate.records_updated", "fixmate.placed_unmapped",
              "fixmate.mc_tags", "collate.pairs", "collate.singletons", "collate.orphans"):
        assert st.counters.get(k, 0) == jc.get(k, 0), k
    assert st.counters["fixmate.mc_tags"] > 0


def test_stale_mc_is_replaced_not_duplicated(tmp_path):
    recs = _collate_corpus(np.random.default_rng(1), n_pairs=9, n_extra=0)
    src = write_bam(str(tmp_path / "in.bam"), recs, refs=REFS)
    _, out = both_fixmates(src, tmp_path, split_size=1 << 20)
    got = jbam.read_bam(out)[1]
    assert all(r.tags_raw.count(b"MCZ") <= 1 for r in got)
    assert any(r.tags_raw.count(b"MCZ") == 1 for r in got)


@pytest.mark.parametrize("interleave", [True, False])
def test_fixmate_is_idempotent(tmp_path, interleave):
    recs = _collate_corpus(np.random.default_rng(3), interleave=interleave)
    src = write_bam(str(tmp_path / "in.bam"), recs, refs=REFS)
    _, once = both_fixmates(src, tmp_path, split_size=4 << 10, level=1)
    again = tmp_path / "again"
    again.mkdir()
    _, twice = both_fixmates(once, again, split_size=4 << 10, level=1)
    assert read(once) == read(twice)


def test_fixmate_survives_hash_collisions(tmp_path, monkeypatch):
    """Every name hashes to one bucket in both packages: the exact names
    repair the pairing, and both write the same bytes."""
    def constant_hash(data, soa):
        n = len(soa["rec_off"])
        return np.zeros(n, np.int32), np.zeros(n, np.int32)

    monkeypatch.setattr(tsig, "name_hash_pair", constant_hash)
    monkeypatch.setattr(jsig, "name_hash_pair", constant_hash)
    recs = _collate_corpus(np.random.default_rng(11), n_pairs=15, n_extra=10)
    src = write_bam(str(tmp_path / "in.bam"), recs, refs=REFS)
    st, out = both_fixmates(src, tmp_path, split_size=4 << 10)
    assert st.counters["collate.hash_collisions"] > 0
    check_fields(out, recs)


def test_fixmate_with_the_deflate_lanes(tmp_path):
    recs = _collate_corpus(np.random.default_rng(5), n_pairs=12, n_extra=6)
    src = write_bam(str(tmp_path / "in.bam"), recs, refs=REFS)
    gates = dict(HOST, **{DEFLATE_LANES: "true"})
    st, out = both_fixmates(src, tmp_path, gates=gates, split_size=4 << 10, level=1)
    assert st.counters["flate.deflate.lanes"] > 0
    check_fields(out, recs)


def test_fixmate_of_cram_input(tmp_path):
    from hadoop_bam_tpu_torch.spec import cram as tcram

    recs = _collate_corpus(np.random.default_rng(6), n_pairs=20, n_extra=10)
    path = str(tmp_path / "in.cram")
    header = tbam.header_from_text("@HD\tVN:1.6\tSO:unsorted\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in REFS))
    with open(path, "wb") as f:
        tcram.write_cram(f, header, port_records(recs), records_per_container=25, codec="rans")
    gates = dict(HOST, **{"hadoopbam.cram.rans-lanes": "true"})
    st, _ = both_fixmates(path, tmp_path, gates=gates, split_size=2048, level=1)
    assert st.n_splits > 1 and st.counters["cram.rans.lanes_slices"] > 0


def test_fixmate_of_no_record(tmp_path):
    src = write_bam(str(tmp_path / "in.bam"), [], refs=REFS)
    st, _ = both_fixmates(src, tmp_path)
    assert st.n_records == st.n_pairs == 0


def test_concat_collation_matches_the_reference():
    recs = _collate_corpus(np.random.default_rng(8))
    parts = [collation_columns(*soa_of(recs[a:b]), with_cigars=True)
             for a, b in ((0, 30), (30, 31), (31, None))]
    from hadoop_bam_tpu.collate import concat_collation as jconcat

    got, want = concat_collation(parts), jconcat(parts)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    whole = collation_columns(*soa_of(recs), with_cigars=True)
    for k in whole:
        np.testing.assert_array_equal(got[k], whole[k], err_msg=k)
    empty, jempty = concat_collation([]), jconcat([])
    assert {k: v.dtype for k, v in empty.items()} == {k: v.dtype for k, v in jempty.items()}


@pytest.mark.parametrize("kwargs", [{"errors": "bogus"}, {"errors": ""}, {"memory_budget": 1 << 20},
                                    {"errors": "salvage"}],
                         ids=["errors", "errors_empty", "memory_budget", "salvage"])
def test_fixmate_arguments(straddling, tmp_path, kwargs):
    """The reference's ``ValueError`` outside the domain of ``errors``;
    salvage and the out-of-core form write the reference's bytes, stats and
    counters (``tests/test_torch_external_sort.py`` holds the out-of-core
    form to the in-core one); salvage over a file with a corrupt member."""
    _, src = straddling
    out = str(tmp_path / "o.bam")
    if "memory_budget" in kwargs:
        st, out = both_fixmates(src, tmp_path, **kwargs)
        assert st.backend == "collate-fixmate[budget]"
        assert st.counters["fixmate.records"] == st.n_records > 0
        return
    if kwargs.get("errors") in ("bogus", ""):
        with pytest.raises(ValueError) as got:
            tpipeline.fixmate_bam(src, out, device="cpu", **kwargs)
        with pytest.raises(ValueError) as want:
            jpipeline.fixmate_bam(src, str(tmp_path / "j.bam"), **kwargs)
        assert str(got.value) == str(want.value)
    else:
        data = bytearray(read(src))
        co, cs, _ = tbgzf.scan_blocks(bytes(data))
        k = len(co) // 2  # a record member in the middle
        data[int(co[k]) + 25] ^= 0x01  # a payload bit: the CRC gate catches it
        bad = str(tmp_path / "bad.bam")
        with open(bad, "wb") as f:
            f.write(bytes(data))
        before = snapshot()
        st, _ = both_fixmates(bad, tmp_path, **kwargs)
        fam = ("salvage.", "executor.")
        want = {k: v for k, v in delta(before)["counters"].items() if k.startswith(fam) and v}
        assert {k: v for k, v in st.counters.items() if k.startswith(fam) and v} == want
        assert st.counters["salvage.members_quarantined"] == 1
        return
    assert not os.path.exists(out)


def test_fixmate_raises_when_no_card(straddling, tmp_path, monkeypatch):
    _, src = straddling
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipeline.fixmate_bam(src, str(tmp_path / "o.bam"), **kw)

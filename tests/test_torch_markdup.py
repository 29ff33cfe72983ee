"""Duplicate marking in the port (``dedup``: signature columns, the decision
on the device, the per-record oracle; ``sort_bam(mark_duplicates=True)`` and
``markdup_bam``) against the reference's, exactly: columns, masks, output
files, ``SortStats.n_duplicates`` and counters.  The cases are the
reference's ``tests/test_dedup.py`` (its family corpus, the pair-beats-
fragment case, the fused sort, idempotence, the device parse, the conf key)
and its markdup-on-unsorted case, plus negative unclipped 5' ends, name
hashes of both signs in one family, int32 extremes, ``backend="host"``, the
device write with a real mask and a ``.cram`` input."""

import os

import numpy as np
import pytest
import torch

from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.conf import DEFLATE_LANES, INFLATE_LANES, WRITE_DEVICE
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.dedup import mark_duplicates_device as jmark
from hadoop_bam_tpu.dedup import mark_duplicates_oracle as joracle
from hadoop_bam_tpu.dedup import signature_columns as jsig
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.utils.murmur3 import murmurhash3_int32 as jmurmur
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.conf import from_reference_conf
from hadoop_bam_tpu_torch.dedup import (
    DEDUP_EXTRA_FIELDS,
    concat_columns,
    mark_duplicates_device,
    mark_duplicates_oracle,
    signature_columns,
)
from hadoop_bam_tpu_torch.spec import bam as tbam
from hadoop_bam_tpu_torch.spec import bgzf as tbgzf
from hadoop_bam_tpu_torch.utils.tracing import Metrics

P, R = jbam.FLAG_PAIRED, jbam.FLAG_REVERSE
F1, F2 = jbam.FLAG_FIRST_OF_PAIR, jbam.FLAG_SECOND_OF_PAIR
DUP = jbam.FLAG_DUPLICATE

LANES = {INFLATE_LANES: "true", DEFLATE_LANES: "false", WRITE_DEVICE: "false"}
HOST = {INFLATE_LANES: "false", DEFLATE_LANES: "false", WRITE_DEVICE: "false"}
ALL_ON = {INFLATE_LANES: "true", DEFLATE_LANES: "true", WRITE_DEVICE: "true"}
REFS = [("c1", 1 << 24), ("c2", 1 << 24), ("c3", 1 << 24)]
FIELDS = ("rec_off", "rec_len", "refid", "pos", "flag") + DEDUP_EXTRA_FIELDS


def family_corpus(rng, n_families=8, n_single=30, near_start=False):
    """The reference's family corpus (``tests/test_dedup.py``): clip-shifted
    duplicate pairs, fragments shadowing a pair's end, exempt secondary
    copies, unmapped reads, demoted mates and fragments, shuffled.  With
    ``near_start`` the families sit at the start of their contig with longer
    soft clips, so their unclipped 5' ends are negative."""
    recs = []

    def add(name, refid, pos, flag, cigar, qual, nr=-1, npos=-1):
        seq = "ACGT" * (len(qual) // 4 + 1)
        recs.append(jbam.build_record(name, refid, pos, 30, flag, cigar, seq[: len(qual)],
                                      bytes(qual), nr, npos))

    for f in range(n_families):
        p1 = int(rng.integers(0, 4)) if near_start else int(rng.integers(1000, 1 << 20))
        p2 = int(rng.integers(1000, 1 << 20))
        refid = int(rng.integers(0, 2))
        for k in range(int(rng.integers(2, 4))):
            c = k + 6 * near_start  # the start shifts by c, the clip restores it
            q = [int(rng.integers(15, 40))] * 40
            add(f"d{f}_{k}", refid, p1 + c, P | F1, ([(c, "S")] if c else []) + [(40 - c, "M")],
                q, refid, p2)
            add(f"d{f}_{k}", refid, p2, P | F2 | R, [(40 - c, "M")] + ([(c, "S")] if c else []),
                q, refid, p1 + c)
        if f % 2 == 0:  # a fragment shadowing the pair's forward end
            add(f"s{f}", refid, p1 + 6 * near_start,
                0, [(6, "S"), (34, "M")] if near_start else [(40, "M")], [41] * 40)
        if f % 3 == 0:  # an exempt secondary copy at the same place
            add(f"d{f}_0", refid, p1, P | F1 | jbam.FLAG_SECONDARY, [(40, "M")], [30] * 40,
                refid, p2)
    for i in range(n_single):
        if i % 7 == 0:
            add(f"u{i}", -1, -1, jbam.FLAG_UNMAPPED, [], [20] * 12)
        elif i % 5 == 0:  # a paired candidate whose mate is absent
            add(f"w{i}", 1, int(rng.integers(0, 1 << 20)), P | F1, [(30, "M")], [30] * 30, 1,
                12345)
        else:
            add(f"f{i}", int(rng.integers(0, 2)), int(rng.integers(0, 1 << 20)), 0, [(36, "M")],
                list(rng.integers(10, 40, 36)))
    return [recs[i] for i in rng.permutation(len(recs))]


def soa_of(recs):
    data = np.frombuffer(b"".join(r.encode() for r in recs), np.uint8)
    return data, tbam.soa_decode(data, tbam.record_offsets(data, 0), FIELDS)


def port_records(recs):
    return [tbam.decode_record(r.encode())[0] for r in recs]


def write_bam(path, recs, refs=REFS, block_payload=2048, level=1):
    """An unsorted BAM of ``recs`` in members of ``block_payload`` bytes."""
    header = tbam.BamHeader("@HD\tVN:1.6\tSO:unsorted\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in refs), list(refs))
    with open(path, "wb") as f:
        f.write(tbgzf.deflate_blocks(header.encode(), level=level)[0])
        f.write(tbgzf.deflate_blocks(b"".join(r.encode() for r in recs), level=level,
                                     block_payload=block_payload)[0])
        f.write(tbgzf.TERMINATOR)
    return path


def read(path):
    with open(path, "rb") as f:
        return f.read()


def both_sorts(src, tmp_path, gates=HOST, port_fn=None, ref_fn=None, **kw):
    """The port's and the reference's job on ``src`` (``sort_bam`` unless
    given): their stats and output paths."""
    t_out, j_out = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    st = (port_fn or tpipeline.sort_bam)(src, t_out, conf=from_reference_conf(gates),
                                         device="cpu", **kw)
    jst = (ref_fn or jpipeline.sort_bam)(src, j_out, conf=JConf(gates), **kw)
    return st, jst, t_out, j_out


def assert_same_marking(st, jst, t_out, j_out):
    assert read(t_out) == read(j_out)
    assert st.n_duplicates == jst.n_duplicates > 0
    assert st.counters["sort_bam.duplicates"] == st.n_duplicates
    assert st.backend == jst.backend
    assert "markdup" in st.seconds
    _, got = jbam.read_bam(t_out)
    assert sum(bool(r.flag & DUP) for r in got) == st.n_duplicates


# ---------------------------------------------------------------------------
# Columns and the decision
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,near_start", [(0, False), (1, False), (2, True), (3, True)])
def test_signature_columns_match_the_reference(seed, near_start):
    recs = family_corpus(np.random.default_rng(seed), near_start=near_start)
    data, soa = soa_of(recs)
    got, want = signature_columns(data, soa), jsig(data, dict(soa))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if near_start:
        assert (got["pos5"] < 0).any()


@pytest.mark.parametrize("seed,near_start", [(0, False), (1, False), (2, False), (5, False),
                                             (6, True), (7, True)])
def test_decision_matches_the_reference_and_the_oracles(seed, near_start):
    recs = family_corpus(np.random.default_rng(seed), near_start=near_start)
    data, soa = soa_of(recs)
    cols = signature_columns(data, soa)
    m = Metrics()
    got = mark_duplicates_device(cols, device="cpu", metrics=m)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, jmark(jsig(data, dict(soa))))
    np.testing.assert_array_equal(got, mark_duplicates_oracle(port_records(recs)))
    np.testing.assert_array_equal(got, joracle(recs))
    assert got.any() and not got.all()
    assert not m.counters()  # the CPU moves nothing between host and device


def _signed_names(n_each):
    """Names whose first name hash is negative, and names whose is positive."""
    neg, pos = [], []
    i = 0
    while len(neg) < n_each or len(pos) < n_each:
        nm = f"fam:{i}"
        (neg if jmurmur(nm.encode(), 0) < 0 else pos).append(nm)
        i += 1
    return neg[:n_each], pos[:n_each]


@pytest.mark.parametrize("best", ["negative_hash", "positive_hash"])
def test_one_family_with_negative_pos5_and_signed_hashes(best):
    """Four copies of one pair at the start of a contig: every forward mate
    has a negative unclipped 5' end, the names' hashes have both signs, and
    the scores tie, so the election falls to the hash; plus fragments at the
    same negative end, which lose to the pairs."""
    neg, pos = _signed_names(2)
    recs = []
    q = bytes([30] * 40)
    for k, nm in enumerate(neg + pos):
        clip = 8 + k  # pos 1 + k + 1, clip 8 + k: unclipped start -7
        recs.append(jbam.build_record(nm, 0, 2 + k - 1, 30, P | F1, [(clip, "S"), (40 - clip, "M")],
                                      "A" * 40, q, 0, 500))
        recs.append(jbam.build_record(nm, 0, 500, 30, P | F2 | R, [(40, "M")], "A" * 40, q, 0,
                                      1 + k))
    recs.append(jbam.build_record("frag", 0, 3, 30, 0, [(10, "S"), (30, "M")], "A" * 40,
                                  bytes([41] * 40)))
    if best == "positive_hash":  # give a positive-hash pair the top score instead
        recs[-2] = jbam.build_record(pos[-1], 0, 500, 30, P | F2 | R, [(40, "M")], "A" * 40,
                                     bytes([31] * 40), 0, 4)
    data, soa = soa_of(recs)
    cols = signature_columns(data, soa)
    fwd = cols["rev"] == 0
    assert (cols["pos5"][fwd] == -7).all()
    assert (cols["qh1"][:8] < 0).any() and (cols["qh1"][:8] > 0).any()
    got = mark_duplicates_device(cols, device="cpu")
    np.testing.assert_array_equal(got, jmark(jsig(data, dict(soa))))
    np.testing.assert_array_equal(got, mark_duplicates_oracle(port_records(recs)))
    assert got.sum() == 7  # three pairs and the fragment


def test_strand_separates_families():
    """A forward and a reverse read whose 5' ends fall on one base are two
    families, for fragments and for pairs alike: nothing is marked."""
    seq, q = "ACGT" * 10, bytes([30] * 40)
    mk = jbam.build_record
    recs = [
        mk("f", 0, 100, 30, 0, [(40, "M")], seq, q),  # 5' end 100, forward
        mk("r", 0, 61, 30, R, [(40, "M")], seq, q),  # 5' end 61 + 39 = 100, reverse
        mk("a", 0, 200, 30, P | F1, [(40, "M")], seq, q, 0, 400),
        mk("a", 0, 400, 30, P | F2 | R, [(40, "M")], seq, q, 0, 200),
        mk("b", 0, 161, 30, P | F1 | R, [(40, "M")], seq, q, 0, 439),  # 5' end 200, reverse
        mk("b", 0, 439, 30, P | F2, [(40, "M")], seq, q, 0, 161),  # 5' end 439, forward
    ]
    data, soa = soa_of(recs)
    got = mark_duplicates_device(signature_columns(data, soa), device="cpu")
    np.testing.assert_array_equal(got, jmark(jsig(data, dict(soa))))
    np.testing.assert_array_equal(got, mark_duplicates_oracle(port_records(recs)))
    assert not got.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decision_on_int32_extremes_matches_the_reference(seed):
    """Raw columns at the int32 ends: refids, 5' ends and hashes from a
    small pool of extremes (so rows share them), scores up to the cap (pair
    sums that wrap as the reference's do) and below 0 (where the election's
    baseline of 0 decides), flags and candidates at random."""
    rng = np.random.default_rng(seed)
    n = 300
    lo, hi = -2**31, 2**31 - 1
    ext = np.asarray([lo, lo + 1, -7, -1, 0, 1, hi - 1, hi], np.int64)
    cols = {
        "refid": rng.choice(ext[2:6], n), "pos5": rng.choice(ext, n),
        "rev": rng.integers(0, 2, n), "exempt": (rng.random(n) < 0.1),
        "cand": rng.integers(0, 2, n), "score": rng.choice([0, 1, 1 << 30, (1 << 30) - 1, -1, lo], n),
        "qh1": rng.choice(ext, n), "qh2": rng.choice(ext[[0, 4, 7]], n),
        "flag": rng.choice([0, 1, 0x41, 0x8091, hi], n),
    }
    cols = {k: np.asarray(v).astype(np.int32) for k, v in cols.items()}
    got = mark_duplicates_device(cols, device="cpu")
    np.testing.assert_array_equal(got, jmark(cols))
    assert got.any()


def test_quality_sums_with_empty_and_missing_sequences():
    """The capped score's quality sums: records without a sequence (first,
    inside and last), qualities absent (0xFF), at and around the threshold."""
    from hadoop_bam_tpu.ops.quality import sum_base_qualities_np as jsum
    from hadoop_bam_tpu_torch.ops.quality import sum_base_qualities_np

    rng = np.random.default_rng(4)
    recs = []
    for i in range(40):
        n = 0 if i % 9 == 0 or i == 39 else int(rng.integers(1, 30))
        qual = b"*" if i % 7 == 3 else rng.integers(13, 18, n, dtype=np.uint8).tobytes()
        recs.append(jbam.build_record(f"z{i}", 0, i, 30, 0, [(max(n, 1), "M")],
                                      "A" * n if n else "*", qual if n else b""))
    data, soa = soa_of(recs)
    got = sum_base_qualities_np(data, soa)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jsum(data, dict(soa)))
    assert (got == 0).sum() >= 5 and got.max() > 0


def test_empty_and_tiny():
    empty = signature_columns(np.empty(0, np.uint8), {k: np.empty(0, np.int64) for k in FIELDS})
    assert len(mark_duplicates_device(empty, device="cpu")) == 0
    assert {k: v.dtype for k, v in concat_columns([]).items()} == {
        k: np.dtype(np.int32) for k in empty}
    recs = [jbam.build_record("x", 0, 5, 60, 0, [(4, "M")], "ACGT", bytes([30] * 4))]
    data, soa = soa_of(recs)
    assert not mark_duplicates_device(signature_columns(data, soa), device="cpu").any()


def test_pair_beats_fragment_and_best_pair_wins():
    seq = "ACGT" * 10
    mk = jbam.build_record
    recs = [
        mk("lo", 0, 100, 30, P | F1, [(40, "M")], seq, bytes([20] * 40), 0, 300),
        mk("lo", 0, 300, 30, P | F2 | R, [(40, "M")], seq, bytes([20] * 40), 0, 100),
        mk("hi", 0, 100, 30, P | F1, [(40, "M")], seq, bytes([40] * 40), 0, 300),
        mk("hi", 0, 300, 30, P | F2 | R, [(40, "M")], seq, bytes([40] * 40), 0, 100),
        mk("fr", 0, 100, 30, 0, [(40, "M")], seq, bytes([41] * 40)),
    ]
    data, soa = soa_of(recs)
    got = mark_duplicates_device(signature_columns(data, soa), device="cpu")
    assert list(got) == [True, True, False, False, True]
    np.testing.assert_array_equal(got, mark_duplicates_oracle(port_records(recs)))


def test_concat_columns_is_the_reference_concatenation():
    recs = family_corpus(np.random.default_rng(9))
    parts = [signature_columns(*soa_of(recs[a:b])) for a, b in ((0, 20), (20, 21), (21, None))]
    whole = signature_columns(*soa_of(recs))
    got = concat_columns(parts)
    for k in whole:
        np.testing.assert_array_equal(got[k], whole[k], err_msg=k)
    assert concat_columns(parts[:1]) is parts[0]


# ---------------------------------------------------------------------------
# The jobs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    td = tmp_path_factory.mktemp("markdup")
    recs = family_corpus(np.random.default_rng(3), near_start=True)
    return {"recs": recs, "bam": write_bam(str(td / "in.bam"), recs)}


@pytest.mark.parametrize("backend,split_size", [("device", 4096), ("device", 1 << 20),
                                                ("host", 4096)])
def test_sort_with_mark_duplicates_writes_the_reference_bytes(corpus, tmp_path, backend,
                                                              split_size):
    st, jst, t_out, j_out = both_sorts(corpus["bam"], tmp_path, mark_duplicates=True, level=1,
                                       split_size=split_size, backend=backend,
                                       write_splitting_bai=True)
    assert_same_marking(st, jst, t_out, j_out)
    assert read(t_out + ".splitting-bai") == read(j_out + ".splitting-bai")
    assert st.n_duplicates == int(joracle(corpus["recs"]).sum())
    hdr, _ = jbam.read_bam(t_out)
    assert hdr.sort_order() == "coordinate"


def test_device_parse_marks_the_reference_bytes(corpus, tmp_path):
    """The device parse reads the union of fields and takes the signature
    before the SoA is trimmed (the reference's
    ``test_device_parse_mode_marks_identically``): the reference's bytes,
    which equal the host-key sort's."""
    st, jst, t_out, j_out = both_sorts(corpus["bam"], tmp_path, gates=LANES, device_parse=True,
                                       mark_duplicates=True, level=1, split_size=8192)
    assert st.backend == jst.backend == "device-parse"
    assert_same_marking(st, jst, t_out, j_out)
    h_out = str(tmp_path / "host.bam")
    tpipeline.sort_bam(corpus["bam"], h_out, conf=from_reference_conf(LANES), device="cpu",
                       backend="host", mark_duplicates=True, level=1, split_size=8192)
    assert read(h_out) == read(t_out)


def test_device_write_patches_the_reference_flags(corpus, tmp_path):
    """Every write gate on and one split: the part is gathered with the
    duplicate mask by the gather kernel's plain version."""
    st, jst, t_out, j_out = both_sorts(corpus["bam"], tmp_path, gates=ALL_ON, device_parse=True,
                                       mark_duplicates=True, level=1, split_size=1 << 20)
    assert_same_marking(st, jst, t_out, j_out)
    assert st.counters["bam.device_write_parts"] == 1


def test_markdup_bam_writes_the_reference_bytes(corpus, tmp_path):
    st, jst, t_out, j_out = both_sorts(corpus["bam"], tmp_path, port_fn=tpipeline.markdup_bam,
                                       ref_fn=jpipeline.markdup_bam, split_size=4096, level=1)
    assert_same_marking(st, jst, t_out, j_out)


def test_markdup_is_idempotent(corpus, tmp_path):
    """Marked flags do not enter the signature: marking the output again
    gives the same records, and the reference's bytes each time."""
    st, jst, t_out, j_out = both_sorts(corpus["bam"], tmp_path, port_fn=tpipeline.markdup_bam,
                                       ref_fn=jpipeline.markdup_bam, split_size=4096, level=1)
    again = tmp_path / "again"
    again.mkdir()
    st2, jst2, t2, j2 = both_sorts(t_out, again, port_fn=tpipeline.markdup_bam,
                                   ref_fn=jpipeline.markdup_bam, split_size=4096, level=1)
    assert read(t2) == read(j2)
    assert st.n_duplicates == st2.n_duplicates == jst2.n_duplicates
    assert [r.raw for r in jbam.read_bam(t_out)[1]] == [r.raw for r in jbam.read_bam(t2)[1]]


@pytest.mark.parametrize("variant", ["shuffled", "grouped"])
def test_shuffled_and_grouped_inputs(corpus, tmp_path, variant):
    """Markdup of a shuffled and of a queryname-grouped copy of the input:
    the reference's bytes, the same records as the original's, each marked
    as the oracle marks it."""
    from hadoop_bam_tpu.collate import queryname_sort_oracle

    recs = corpus["recs"]
    rng = np.random.default_rng(12)
    order = (rng.permutation(len(recs)) if variant == "shuffled"
             else queryname_sort_oracle(recs))
    src = write_bam(str(tmp_path / "in.bam"), [recs[i] for i in order])
    st, jst, t_out, j_out = both_sorts(src, tmp_path, port_fn=tpipeline.markdup_bam,
                                       ref_fn=jpipeline.markdup_bam, split_size=4096, level=1)
    assert_same_marking(st, jst, t_out, j_out)
    orig = str(tmp_path / "orig.bam")
    tpipeline.markdup_bam(corpus["bam"], orig, device="cpu", split_size=4096, level=1)
    assert sorted(r.raw for r in jbam.read_bam(t_out)[1]) == \
        sorted(r.raw for r in jbam.read_bam(orig)[1])
    ident = lambda r: (r.read_name, r.flag & ~DUP, r.pos, r.refid)  # noqa: E731
    expect = {ident(r): bool(d) for r, d in zip(recs, joracle(recs))}
    for r in jbam.read_bam(t_out)[1]:
        assert bool(r.flag & DUP) == expect[ident(r)], r.read_name


def test_conf_key_marks_duplicates(corpus, tmp_path):
    gates = dict(HOST, **{"hadoopbam.bam.mark-duplicates": "true"})
    st, jst, t_out, j_out = both_sorts(corpus["bam"], tmp_path, gates=gates, split_size=4096)
    assert_same_marking(st, jst, t_out, j_out)


def test_plain_sort_marks_nothing(corpus, tmp_path):
    st, jst, t_out, j_out = both_sorts(corpus["bam"], tmp_path, split_size=4096, level=1)
    assert read(t_out) == read(j_out)
    assert st.n_duplicates == jst.n_duplicates == 0
    assert "markdup" not in st.seconds and "sort_bam.duplicates" not in st.counters
    assert not any(r.flag & DUP for r in jbam.read_bam(t_out)[1])


def test_markdup_of_cram_input(corpus, tmp_path):
    """A ``.cram`` input (rANS, no reference) through the plain rANS kernel:
    the reference's bytes and marks."""
    from hadoop_bam_tpu_torch.spec import cram as tcram

    path = str(tmp_path / "in.cram")
    header = tbam.header_from_text("@HD\tVN:1.6\tSO:unsorted\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in REFS))
    with open(path, "wb") as f:
        tcram.write_cram(f, header, port_records(corpus["recs"]), records_per_container=40,
                         codec="rans")
    gates = dict(HOST, **{"hadoopbam.cram.rans-lanes": "true"})
    st, jst, t_out, j_out = both_sorts(path, tmp_path, gates=gates, port_fn=tpipeline.markdup_bam,
                                       ref_fn=jpipeline.markdup_bam, split_size=2048, level=1)
    assert st.n_splits > 1 and st.counters["cram.rans.lanes_slices"] > 0
    assert_same_marking(st, jst, t_out, j_out)


def test_empty_input_marks_nothing(tmp_path):
    src = write_bam(str(tmp_path / "empty.bam"), [])
    st, jst, t_out, j_out = both_sorts(src, tmp_path, mark_duplicates=True, level=1)
    assert read(t_out) == read(j_out)
    assert st.n_records == st.n_duplicates == jst.n_duplicates == 0


def test_decision_raises_when_no_card(monkeypatch, corpus, tmp_path):
    data, soa = soa_of(corpus["recs"])
    cols = signature_columns(data, soa)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mark_duplicates_device(cols),
                 lambda: mark_duplicates_device(cols, device="cuda"),
                 lambda: tpipeline.markdup_bam(corpus["bam"], str(tmp_path / "o.bam"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(tmp_path / "o.bam")

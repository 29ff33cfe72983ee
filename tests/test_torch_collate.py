"""The port's name-collation core (``collate/device.py``, torch ops) and its
host passes (``collate/host.py``) against the reference's, exactly: seeded
names with digit runs, leading zeros, duplicates, pairs and orphans."""

import numpy as np
import pytest

from hadoop_bam_tpu.collate import device as jdev
from hadoop_bam_tpu.collate import host as jhost
from hadoop_bam_tpu.collate.signature import QNAME_SEED2 as J_SEED2
from hadoop_bam_tpu.utils.murmur3 import murmurhash3_int32_batch as jmurmur
from hadoop_bam_tpu_torch.collate import device as tdev
from hadoop_bam_tpu_torch.collate import host as thost
from hadoop_bam_tpu_torch.collate.signature import QNAME_SEED2
from hadoop_bam_tpu_torch.utils.tracing import Metrics


def _random_name(rng) -> bytes:
    parts = []
    for _ in range(int(rng.integers(1, 5))):
        if rng.random() < 0.5:
            zeros = "0" * int(rng.integers(0, 3))
            parts.append(zeros + str(int(rng.integers(0, 300))))
        else:
            parts.append("".join(rng.choice(list("abAB:_-"), int(rng.integers(1, 3)))))
    return "".join(parts).encode()


def _cols(names, flags):
    """The ingest's collation columns over ``names`` (bytes) and flags."""
    n = len(names)
    blob = np.frombuffer(b"".join(names), np.uint8)
    name_len = np.asarray([len(b) for b in names], np.int32)
    name_off = np.zeros(n, np.int64)
    if n:
        np.cumsum(name_len[:-1], out=name_off[1:])
    flag = np.asarray(flags, np.int32)
    return {
        "qh1": jmurmur(blob, name_off, name_len.astype(np.int64), 0),
        "qh2": jmurmur(blob, name_off, name_len.astype(np.int64), J_SEED2),
        "flag": flag,
        "pos": np.full(n, -1, np.int32),
        "cand": ((flag & 0x1) != 0).astype(np.int32),
        "name_len": name_len,
        "name_off": name_off,
        "names": blob,
    }


def _corpus(seed: int, n_names: int = 60):
    """Pairs (flags 0x4D/0x8D), orphans (one mate), singletons (0x4) and
    triples of one name, in a shuffled order."""
    rng = np.random.default_rng(seed)
    names, flags = [], []
    for _ in range(n_names):
        nm = _random_name(rng)
        kind = rng.integers(0, 4)
        if kind == 0:
            names += [nm, nm]
            flags += [0x4D, 0x8D]
        elif kind == 1:
            names.append(nm)
            flags.append(0x4D)
        elif kind == 2:
            names.append(nm)
            flags.append(0x4)
        else:
            names += [nm, nm, nm]
            flags += [0x4D, 0x8D, 0x4D]
    perm = rng.permutation(len(names))
    return [names[i] for i in perm], [flags[i] for i in perm]


def _same_collation(a, b):
    np.testing.assert_array_equal(a.order, b.order)
    np.testing.assert_array_equal(a.group, b.group)
    np.testing.assert_array_equal(a.mate, b.mate)
    assert (a.n_groups, a.n_pairs) == (b.n_groups, b.n_pairs)


def test_seed_matches_the_reference():
    assert QNAME_SEED2 == J_SEED2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collate_by_name_matches_the_reference(seed):
    names, flags = _corpus(seed)
    cols = _cols(names, flags)
    _same_collation(tdev.collate_by_name(cols, device="cpu"), jdev.collate_by_name(cols))
    n = len(names)
    active = (np.arange(n) % 5 != 0).astype(np.int32)
    _same_collation(tdev.collate_by_name(cols, active=active, device="cpu"),
                    jdev.collate_by_name(cols, active=active))
    zeros = np.zeros(n, np.int32)
    _same_collation(tdev.collate_by_name(cols, candidates=zeros, device="cpu"),
                    jdev.collate_by_name(cols, candidates=zeros))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9])
def test_collate_padding_edges(n):
    names, flags = _corpus(5, n_names=10)
    cols = _cols(names[:n], flags[:n])
    _same_collation(tdev.collate_by_name(cols, device="cpu"), jdev.collate_by_name(cols))


def test_collate_core_with_extreme_tie_keys():
    """Signed int32 keys at both ends, ties through every key."""
    rng = np.random.default_rng(4)
    n = 64
    lo, hi = -2**31, 2**31 - 1
    act = rng.integers(0, 2, n).astype(np.int32)
    qh1 = rng.choice([lo, -1, 0, 5, hi], n).astype(np.int32)
    qh2 = rng.choice([lo, 0, hi], n).astype(np.int32)
    cand = rng.integers(0, 2, n).astype(np.int32)
    tie1 = rng.choice([lo, -3, 0, hi], n).astype(np.int32)
    tie2 = rng.choice([lo, -1, 0, hi], n).astype(np.int32)
    import jax.numpy as jnp
    import torch

    want = [np.asarray(x) for x in jdev._collate_padded(*map(jnp.asarray, (act, qh1, qh2, cand,
                                                                            tie1, tie2)))]
    got = [x.numpy() for x in tdev.collate_core(*map(torch.from_numpy, (act, qh1, qh2, cand,
                                                                         tie1, tie2)))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


@pytest.mark.parametrize("seed", [0, 3])
def test_queryname_perm_and_counts_match_the_reference(seed):
    names, flags = _corpus(seed)
    cols = _cols(names, flags)
    m = Metrics()
    perm, st = thost.queryname_perm(cols, device="cpu", metrics=m)
    jperm, jst = jhost.queryname_perm(cols)
    np.testing.assert_array_equal(perm, jperm)
    assert (st.n_records, st.n_groups, st.n_collisions) == (
        jst.n_records, jst.n_groups, jst.n_collisions)
    assert m.get("collate.groups") == st.n_groups
    got = thost.collation_counts(cols, tdev.collate_by_name(cols, device="cpu"), m)
    want = jhost.collation_counts(cols, jdev.collate_by_name(cols))
    assert got == want
    assert got["pairs"] > 0 and got["orphans"] > 0 and got["singletons"] > 0
    assert m.get("collate.pairs") == got["pairs"]


def test_natural_compare_matches_the_reference():
    rng = np.random.default_rng(11)
    pool = [_random_name(rng) for _ in range(300)] + [b"", b"0", b"00", b"a0", b"a00", b"a01",
                                                      b"a1", b"a001b", b"a1b", b"9", b"10"]
    for _ in range(600):
        a, b = (pool[int(i)] for i in rng.integers(0, len(pool), 2))
        assert thost.natural_compare(a, b) == jhost.natural_compare(a, b), (a, b)
    for a in pool[-11:]:
        for b in pool[-11:]:
            assert thost.natural_compare(a, b) == jhost.natural_compare(a, b), (a, b)
    assert sorted(pool, key=thost.natural_sort_key) == sorted(pool, key=jhost.natural_sort_key)


def test_forced_hash_collision_is_repaired_like_the_reference():
    """Three distinct names forced into one hash bucket (two of them a pair):
    the exact regroup and re-pairing equal the reference's."""
    names, flags = _corpus(7, n_names=20)
    names += [b"zz10", b"zz10", b"zz9", b"zz011"]
    flags += [0x4D, 0x8D, 0x4D, 0x4]
    cols = _cols(names, flags)
    for r in range(len(names) - 4, len(names)):
        cols["qh1"][r], cols["qh2"][r] = 12345, -6789
    m = Metrics()
    got, n_coll = thost.verify_and_repair(tdev.collate_by_name(cols, device="cpu"), cols, m)
    want, j_coll = jhost.verify_and_repair(jdev.collate_by_name(cols), cols)
    assert n_coll == j_coll == 1
    assert m.get("collate.hash_collisions") == 1
    _same_collation(got, want)
    perm, st = thost.queryname_perm(cols, device="cpu")
    jperm, jst = jhost.queryname_perm(cols)
    np.testing.assert_array_equal(perm, jperm)
    assert st.n_collisions == jst.n_collisions == 1


# ---------------------------------------------------------------------------
# The queryname sort (``sort_bam(sort_order="queryname")``), its columns and
# oracles, against the reference's (its ``tests/test_collate.py`` cases)
# ---------------------------------------------------------------------------

from hadoop_bam_tpu import collate as jcollate  # noqa: E402
from hadoop_bam_tpu import pipeline as jpipeline  # noqa: E402
from hadoop_bam_tpu.collate import signature as jsig  # noqa: E402
from hadoop_bam_tpu.conf import Configuration as JConf  # noqa: E402
from hadoop_bam_tpu.spec import bam as jbam  # noqa: E402
from hadoop_bam_tpu_torch import collate as tcollate  # noqa: E402
from hadoop_bam_tpu_torch import pipeline as tpipeline  # noqa: E402
from hadoop_bam_tpu_torch.collate import signature as tsig  # noqa: E402
from hadoop_bam_tpu_torch.conf import from_reference_conf  # noqa: E402
from test_collate import _collate_corpus  # noqa: E402
from test_torch_markdup import HOST, LANES, port_records, read, write_bam  # noqa: E402

REFS = [("c1", 1 << 24), ("c2", 1 << 24)]


def test_exports_are_the_reference_s():
    """All of the reference's exports but the mesh's two (ROADMAP A.10)."""
    mesh = {"global_name_ranks", "group_representatives"}
    assert tcollate.__all__ == [k for k in jcollate.__all__ if k not in mesh]
    assert tcollate.COLLATE_EXTRA_FIELDS == jcollate.COLLATE_EXTRA_FIELDS
    assert tcollate.FIXMATE_FIELDS == jcollate.FIXMATE_FIELDS
    assert tsig._BLOB_COLS == jsig._BLOB_COLS


@pytest.mark.parametrize("with_cigars", [False, True])
def test_collation_columns_match_the_reference(with_cigars):
    from hadoop_bam_tpu_torch.spec import bam as tbam

    recs = _collate_corpus(np.random.default_rng(2))
    data = np.frombuffer(b"".join(r.encode() for r in recs), np.uint8)
    soa = tbam.soa_decode(data, tbam.record_offsets(data, 0), tcollate.FIXMATE_FIELDS)
    got = tcollate.collation_columns(data, soa, with_cigars=with_cigars)
    want = jcollate.collation_columns(data, dict(soa), with_cigars=with_cigars)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    qh = tsig.name_hash_pair(data, soa)
    for a, b in zip(qh, jsig.name_hash_pair(data, dict(soa))):
        np.testing.assert_array_equal(a, b)
    blob, offs = tsig.ragged_slice(data, soa["rec_off"] + 32, soa["l_read_name"] - 1)
    jblob, joffs = jsig.ragged_slice(data, soa["rec_off"] + 32, soa["l_read_name"] - 1)
    np.testing.assert_array_equal(blob, jblob)
    np.testing.assert_array_equal(offs, joffs)


@pytest.mark.parametrize("seed", [0, 1])
def test_oracles_match_the_reference(seed):
    recs = _collate_corpus(np.random.default_rng(seed))
    trecs = port_records(recs)
    assert tcollate.collate_oracle(trecs) == jcollate.collate_oracle(recs)
    assert tcollate.queryname_sort_oracle(trecs) == jcollate.queryname_sort_oracle(recs)
    assert tcollate.fixmate_oracle(trecs) == jcollate.fixmate_oracle(recs)
    assert [tcollate.mc_tag_of(r) for r in trecs] == [jcollate.mc_tag_of(r) for r in recs]


def test_natural_keys_order_names_as_natural_compare():
    rng = np.random.default_rng(17)
    alphabet = np.frombuffer(b"0123456789:aZ_.\x00\xff", np.uint8)
    pool = [rng.choice(alphabet, int(rng.integers(0, 9))).tobytes() for _ in range(600)]
    pool += [b"x" + p for p in pool[:100]] + [p + b"00" for p in pool[:100]]
    pool += [b"", b"00x", b"0", b"0x", b"01a", b"1", b"a01z", b"a1a", b"r07", b"r7", b"r10"]
    keys = thost.natural_keys(pool)
    for _ in range(20000):
        i, j = (int(k) for k in rng.integers(0, len(pool), 2))
        c = jhost.natural_compare(pool[i], pool[j])
        assert (keys[i] > keys[j]) - (keys[i] < keys[j]) == (c > 0) - (c < 0), (pool[i], pool[j])


@pytest.fixture(scope="module")
def qcorpus(tmp_path_factory):
    recs = _collate_corpus(np.random.default_rng(4))
    return recs, write_bam(str(tmp_path_factory.mktemp("qname") / "in.bam"), recs, refs=REFS)


def _both_queryname(src, tmp_path, gates=HOST, **kw):
    t_out, j_out = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    st = tpipeline.sort_bam(src, t_out, conf=from_reference_conf(gates), device="cpu", **kw)
    jst = jpipeline.sort_bam(src, j_out, conf=JConf(gates), **kw)
    assert read(t_out) == read(j_out)
    assert (st.n_records, st.n_splits, st.backend) == (jst.n_records, jst.n_splits, jst.backend)
    return st, t_out


@pytest.mark.parametrize("split_size,backend,gates", [
    (4 << 10, "device", HOST), (1 << 20, "device", HOST), (4 << 10, "host", HOST),
    (8 << 10, "device", LANES)], ids=["splits", "one_split", "host_backend", "inflate_lanes"])
def test_queryname_sort_writes_the_reference_bytes(qcorpus, tmp_path, split_size, backend,
                                                   gates):
    recs, src = qcorpus
    st, out = _both_queryname(src, tmp_path, gates=gates, sort_order="queryname",
                              split_size=split_size, backend=backend, level=1,
                              write_splitting_bai=True)
    assert read(out + ".splitting-bai") == read(str(tmp_path / "ref.bam") + ".splitting-bai")
    assert st.backend == "collate-queryname" and st.n_duplicates == 0
    hdr, got = jbam.read_bam(out)
    assert hdr.sort_order() == "queryname"
    order = jcollate.queryname_sort_oracle(recs)
    assert [r.raw for r in got] == [recs[i].raw for i in order]
    assert st.counters["collate.groups"] == len({r.read_name for r in recs})
    assert out.endswith(".bam") and read(out).endswith(jbam_terminator())


def jbam_terminator():
    from hadoop_bam_tpu.spec import bgzf as jbgzf

    return jbgzf.TERMINATOR


@pytest.mark.parametrize("variant", ["shuffled", "sorted"])
def test_queryname_sort_of_shuffled_and_sorted_input(qcorpus, tmp_path, variant):
    """A shuffled copy, and a copy already in queryname order: the reference's
    bytes, and the same records in the same order as the original's sort."""
    recs, src = qcorpus
    rng = np.random.default_rng(5)
    order = (rng.permutation(len(recs)) if variant == "shuffled"
             else jcollate.queryname_sort_oracle(recs))
    other = write_bam(str(tmp_path / "in.bam"), [recs[i] for i in order], refs=REFS)
    _, out = _both_queryname(other, tmp_path, sort_order="queryname", split_size=4 << 10)
    base = str(tmp_path / "base.bam")
    tpipeline.sort_bam(src, base, device="cpu", sort_order="queryname", split_size=4 << 10)
    assert [r.raw for r in jbam.read_bam(out)[1]] == [r.raw for r in jbam.read_bam(base)[1]]


def test_queryname_conf_key(qcorpus, tmp_path):
    _, src = qcorpus
    st, out = _both_queryname(src, tmp_path, gates=dict(HOST, **{
        "hadoopbam.bam.sort-order": "queryname"}), split_size=4 << 10)
    assert st.backend == "collate-queryname"
    assert jbam.read_bam(out)[0].sort_order() == "queryname"


def test_queryname_sort_survives_hash_collisions(qcorpus, tmp_path, monkeypatch):
    def constant_hash(data, soa):
        n = len(soa["rec_off"])
        return np.zeros(n, np.int32), np.zeros(n, np.int32)

    monkeypatch.setattr(tsig, "name_hash_pair", constant_hash)
    monkeypatch.setattr(jsig, "name_hash_pair", constant_hash)
    recs, src = qcorpus
    st, out = _both_queryname(src, tmp_path, sort_order="queryname", split_size=4 << 10)
    assert st.counters["collate.hash_collisions"] > 0
    order = jcollate.queryname_sort_oracle(recs)
    assert [r.raw for r in jbam.read_bam(out)[1]] == [recs[i].raw for i in order]


def test_coordinate_sort_still_claims_coordinate(qcorpus, tmp_path):
    _, src = qcorpus
    _, out = _both_queryname(src, tmp_path, split_size=4 << 10)
    assert jbam.read_bam(out)[0].sort_order() == "coordinate"


def test_queryname_sort_of_no_record(tmp_path):
    src = write_bam(str(tmp_path / "in.bam"), [], refs=REFS)
    st, out = _both_queryname(src, tmp_path, sort_order="queryname")
    assert st.n_records == 0


def test_queryname_entry_points_raise_when_no_card(qcorpus, tmp_path, monkeypatch):
    import torch

    _, src = qcorpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipeline.sort_bam(src, str(tmp_path / "o.bam"), sort_order="queryname", **kw)

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

"""The port's device parse (``ops/decode.py``: ``parse_stream_device``,
``soa_decode_device``, ``pad_offsets``; ``ops/sort.apply_permutation``;
``ops/keys`` ``pack_hash64_np``/``split_hash64_np``; the kernel's
reference-named ``record_chain_device``) on the CPU, through the plain
walk, against the reference's with its Pallas chain kernel in interpret
mode.  Tolerance 0: the ``[:count]`` SoA columns (values and dtypes), the
key halves of the valid rows, ``ok`` and the count are equal.  The port
pads to ``offsets_capacity(n)`` rows, the reference to its chunk capacity
(ROADMAP C), so only the live rows are compared."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hadoop_bam_tpu.ops import decode as jdecode
from hadoop_bam_tpu.ops import keys as jkeys
from hadoop_bam_tpu.ops import sort as jsort
from hadoop_bam_tpu.ops.pallas import chain as jchain
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu_torch.ops import decode as tdecode
from hadoop_bam_tpu_torch.ops import keys as tkeys
from hadoop_bam_tpu_torch.ops import sort as tsort
from hadoop_bam_tpu_torch.ops.kernels import chain as kch
from hadoop_bam_tpu_torch.spec import bam as tbam
from test_torch_chain_keys import _stream

CPU = torch.device("cpu")


def _unmapped_only(n, seed):
    rng = np.random.default_rng(seed)
    recs = [jbam.build_record(f"u{i}", -1, -1, 0, 4, [], "ACGT"[: 1 + i % 4], b"")
            if i % 2 else jbam.build_record(f"q{i}", int(rng.integers(0, 3)),
                                            int(rng.integers(0, 999)), 0, 4, [], "AC", b"")
            for i in range(n)]
    return np.frombuffer(b"".join(r.encode() for r in recs), np.uint8).copy()


def _cases():
    many = _stream(3000, seed=5)
    one = _stream(1, seed=6)
    offs = jbam.record_offsets(many, 0)
    return {
        "empty": np.empty(0, np.uint8),
        "under_36_bytes": one[:20].copy(),
        "one_record": one,
        "unmapped_rows": _unmapped_only(60, seed=7),
        "truncated_tail": many[: int(offs[41]) + 30].copy(),
        "thousands": many,
    }


CASES = _cases()


def _reference(a):
    soa, hi, lo, valid, ok = jdecode.parse_stream_device(jnp.asarray(a), interpret=True)
    return ({k: np.asarray(v) for k, v in soa.items()}, np.asarray(hi), np.asarray(lo),
            np.asarray(valid), bool(ok))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("as_tensor", [False, True], ids=["host_input", "cpu_tensor"])
def test_parse_stream_matches_the_reference(case, as_tensor):
    a = CASES[case]
    jsoa, jhi, jlo, jvalid, jok = _reference(a)
    data = torch.from_numpy(a.copy()) if as_tensor else a
    soa, hi, lo, valid, ok = tdecode.parse_stream_device(data, device=None if as_tensor else "cpu")
    n = int(valid.sum())
    assert n == int(jvalid.sum()) and bool(ok) == jok
    assert valid.numel() == kch.offsets_capacity(len(a)) and bool(valid[:n].all())
    assert set(soa) == set(jsoa) == set(tbam.SOA_FIELDS)
    for k, v in soa.items():
        assert v.device == CPU and v.numel() == valid.numel(), k
        got = v[:n].numpy()
        assert got.dtype == jsoa[k].dtype, k
        np.testing.assert_array_equal(got, jsoa[k][:n], err_msg=k)
    assert hi.dtype == torch.int32 and lo.dtype == torch.uint32
    np.testing.assert_array_equal(hi[:n].numpy(), jhi[:n])
    np.testing.assert_array_equal(lo[:n].numpy(), jlo[:n])
    if case in ("thousands", "one_record", "unmapped_rows"):
        assert jok and n == len(jbam.record_offsets(a, 0))
    if case == "truncated_tail":
        assert not jok


def test_parse_stream_n_bytes_cuts_the_stream():
    a = CASES["thousands"]
    cut = int(jbam.record_offsets(a, 0)[100])
    soa, _, _, valid, ok = tdecode.parse_stream_device(a, n_bytes=cut, device="cpu")
    jsoa, _, _, jvalid, jok = _reference(a[:cut])
    n = int(valid.sum())
    assert n == int(jvalid.sum()) == 100 and bool(ok) and jok
    for k in soa:
        np.testing.assert_array_equal(soa[k][:n].numpy(), jsoa[k][:n], err_msg=k)


def test_parse_stream_keys_equal_the_host_keys_of_mapped_rows():
    a = CASES["thousands"]
    soa, hi, lo, valid, ok = tdecode.parse_stream_device(a, device="cpu")
    n = int(valid.sum())
    offs = jbam.record_offsets(a, 0)
    host = tbam.soa_decode(a, offs)
    keys = tkeys.pack_keys_np(hi[:n].numpy(), lo[:n].numpy())
    mapped = tkeys.unmapped_mask(torch.from_numpy(host["refid"]), torch.from_numpy(host["pos"]),
                                 torch.from_numpy(host["flag"])).numpy() == 0
    np.testing.assert_array_equal(keys[mapped], tbam.soa_keys(host, a)[mapped])


def test_parse_stream_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdecode.parse_stream_device(CASES["one_record"])


def test_record_chain_device_matches_the_reference():
    for name, a in CASES.items():
        offs, count, ok = kch.record_chain_device(torch.from_numpy(a.copy()))
        jo, jc, jok = jchain.record_chain_device(jnp.asarray(a), interpret=True)
        n = int(jc)
        assert (int(count), bool(ok)) == (n, bool(jok)), name
        np.testing.assert_array_equal(offs[:n].numpy(), np.asarray(jo)[:n], err_msg=name)


def test_soa_decode_matches_the_reference_and_the_host():
    a = CASES["thousands"]
    offs = jbam.record_offsets(a, 0)
    got = tdecode.soa_decode_device(torch.from_numpy(a.copy()), torch.from_numpy(offs))
    want = jdecode.soa_decode_device(jnp.asarray(a), jnp.asarray(offs.astype(np.int32)))
    host = tbam.soa_decode(a, offs)
    for k in tbam.SOA_FIELDS:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      host[k].astype(np.int64), err_msg=k)


def test_pad_offsets_as_the_reference():
    for offs, batch in ((np.array([0, 100, 200]), 8), (np.array([], np.int64), 4),
                        (np.arange(5), 5)):
        p, v = tdecode.pad_offsets(offs, batch)
        jp, jv = jdecode.pad_offsets(offs, batch)
        assert p.dtype == jp.dtype and v.dtype == jv.dtype
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(v, jv)
    with pytest.raises(ValueError, match="batch 8 < record count 9"):
        tdecode.pad_offsets(np.arange(9), 8)
    with pytest.raises(ValueError):
        jdecode.pad_offsets(np.arange(9), 8)


def test_apply_permutation_as_the_reference():
    rng = np.random.default_rng(9)
    cols = {"a": rng.integers(-5, 5, 40).astype(np.int32),
            "b": rng.integers(0, 2**32, 40, dtype=np.uint64).astype(np.uint32),
            "c": torch.from_numpy(rng.integers(0, 9, 40).astype(np.int64))}
    perm = rng.permutation(40)
    got = tsort.apply_permutation(cols, torch.from_numpy(perm))
    want = jsort.apply_permutation({k: jnp.asarray(np.asarray(v)) for k, v in cols.items()},
                                   jnp.asarray(perm.astype(np.int32)))
    for k in cols:
        assert got[k].device == CPU
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_hash64_pack_and_split_as_the_reference():
    rng = np.random.default_rng(10)
    q1 = rng.integers(-2**31, 2**31, 500).astype(np.int32)
    q2 = rng.integers(-2**31, 2**31, 500).astype(np.int32)
    h = tkeys.pack_hash64_np(q1, q2)
    np.testing.assert_array_equal(h, jkeys.pack_hash64_np(q1, q2))
    a, b = tkeys.split_hash64_np(h)
    ja, jb = jkeys.split_hash64_np(h)
    assert a.dtype == ja.dtype and b.dtype == jb.dtype
    np.testing.assert_array_equal(a, q1)
    np.testing.assert_array_equal(b, q2)
    np.testing.assert_array_equal(b, jb)
    # signed int64 order is the (qh1, qh2 as uint32) pair's order
    order = np.lexsort((q2.view(np.uint32), q1))
    np.testing.assert_array_equal(np.argsort(h, kind="stable"), order)


@pytest.mark.cuda
def test_parse_stream_on_card_equals_the_plain_parse():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for name, a in CASES.items():
        soa, hi, lo, valid, ok = tdecode.parse_stream_device(a)
        psoa, phi, plo, pvalid, pok = tdecode.parse_stream_device(a, device="cpu")
        assert bool(ok) == bool(pok) and torch.equal(valid.cpu(), pvalid), name
        n = int(pvalid.sum())
        for k in soa:
            assert torch.equal(soa[k][:n].cpu(), psoa[k][:n]), (name, k)
        assert torch.equal(hi[:n].cpu(), phi[:n]) and torch.equal(lo[:n].cpu(), plo[:n])

"""The port's record chain and key gather (plain versions on the CPU)
against the reference's Pallas chain kernel in interpret mode, its key
gather + unmapped patch, and its sort.  Tolerance 0: offsets, count, ok,
packed keys and the stable permutation must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hadoop_bam_tpu.ops import decode as jdecode
from hadoop_bam_tpu.ops.keys import pack_keys_np
from hadoop_bam_tpu.ops.pallas import chain as jchain
from hadoop_bam_tpu.ops.sort import sort_keys as jsort_keys
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.utils.murmur3 import murmurhash3_int32_batch as jmurmur
from hadoop_bam_tpu_torch.ops import decode as tdecode
from hadoop_bam_tpu_torch.ops.kernels import chain as kch
from hadoop_bam_tpu_torch.ops.sort import sort_keys as tsort_keys
from hadoop_bam_tpu_torch.utils.murmur3 import murmurhash3_int32_batch as tmurmur


def _stream(n, seed):
    """Records with refid -1, pos -1 on mapped rows (a negative key), the
    unmapped flag, placed unmapped reads and pos = INT_MAX."""
    rng = np.random.default_rng(seed)
    blob = bytearray()
    for i in range(n):
        k = i % 9
        if k == 0:
            r = jbam.build_record(f"u{i}", -1, -1, 0, 4, [], "ACGTA", b"")
        elif k == 1:
            r = jbam.build_record(f"p{i}", 1, int(rng.integers(0, 1000)), 0, 4, [], "AC", b"")
        elif k == 2:
            r = jbam.build_record(f"n{i}", 2, -1, 60, 0, [], "ACG", b"")
        elif k == 3:
            r = jbam.build_record(f"x{i}", 0, 2**31 - 1, 60, 0, [(3, "M")], "ACG", b"")
        else:
            r = jbam.build_record(
                f"r{i:05d}", int(rng.integers(0, 3)), int(rng.integers(0, 2000)), 60,
                16 * int(rng.integers(0, 2)), [(int(rng.integers(3, 30)), "M")],
                "ACGT" * 3, bytes([30] * 12),
            )
        blob += r.encode()
    return np.frombuffer(bytes(blob), np.uint8).copy()


def _cases():
    s = _stream(240, seed=1)
    offs = jbam.record_offsets(s, 0)
    small = s.copy()
    small[offs[50] : offs[50] + 4] = [7, 0, 0, 0]  # size word < 32
    huge = s.copy()
    huge[offs[80] : offs[80] + 4] = [1, 0, 0, 0x20]  # size word > 2^28
    return {
        "clean": s,
        "truncated": s[:-5].copy(),
        "small_size_word": small,
        "huge_size_word": huge,
        "three_trailing_bytes": np.concatenate([s, [9, 9, 9]]).astype(np.uint8),
        "empty": np.empty(0, np.uint8),
    }


CASES = _cases()


@pytest.fixture
def small_chunks(monkeypatch):
    # Tiny chunks: records straddle chunk boundaries, so the reference
    # kernel's carried cursor is exercised (tests/test_chain_kernel.py).
    monkeypatch.setattr(jchain, "CHUNK", 4096)
    monkeypatch.setattr(jchain, "MAX_REC_PER_CHUNK", 256)


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_reference_kernel(case):
    """One reference chunk (the default 4 MiB): offsets, count and ok equal."""
    s = CASES[case]
    j_offs, j_count, j_ok = jchain.record_chain_device(s, interpret=True)
    t_offs, t_meta = kch.record_chain(torch.from_numpy(s), len(s))
    count = int(j_count)
    assert int(t_meta[0]) == count
    assert bool(t_meta[1]) == bool(j_ok) == (case in ("clean", "empty"))
    assert np.array_equal(t_offs[:count].numpy(), np.asarray(j_offs)[:count])


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_reference_across_chunks(small_chunks, case):
    """Records straddle the reference's chunks.  After a bad size word the
    reference resumes at the next chunk boundary, so its count past the
    error means nothing; ok and the offsets up to the error must agree."""
    s = CASES[case]
    j_offs, j_count, j_ok = jchain.record_chain_device(s, interpret=True)
    t_offs, t_meta = kch.record_chain(torch.from_numpy(s), len(s))
    count = int(t_meta[0])
    assert bool(t_meta[1]) == bool(j_ok)
    if j_ok:
        assert count == int(j_count)
    assert np.array_equal(t_offs[:count].numpy(), np.asarray(j_offs)[:count])


def test_walk_of_view_ignores_bytes_past_n_bytes():
    """A resident window is longer than the stream the walk is given:
    bytes past ``n_bytes`` read as 0, as the reference's zero padding."""
    s = CASES["truncated"]
    padded = torch.from_numpy(np.concatenate([s, [0xFF] * 64]).astype(np.uint8))
    a = kch.record_chain(torch.from_numpy(s), len(s))
    b = kch.record_chain(padded, len(s))
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def _reference_keys(s):
    """Reference device-parse keys: chain kernel → _stream_keys → host
    murmur3 → patch_unmapped_keys, packed to int64."""
    j_offs, count, ok = jchain.record_chain_device(s, interpret=True)
    hi, lo, unm = jdecode._stream_keys(jnp.asarray(s), j_offs, count)
    n = int(count)
    unm_np = np.asarray(unm)[:n]
    offs_np = np.asarray(j_offs)[:n].astype(np.int64)
    soa = jbam.soa_decode(s, offs_np, fields=("rec_off", "rec_len"))
    h = np.zeros(n, np.int32)
    rows = np.nonzero(unm_np)[0]
    h[rows] = jmurmur(s, soa["rec_off"][rows] + 32, soa["rec_len"][rows] - 32, 0)
    hi, lo = jdecode.patch_unmapped_keys(hi[:n], lo[:n], unm[:n], jnp.asarray(h))
    return pack_keys_np(np.asarray(hi), np.asarray(lo)), unm_np, h


def test_keys_match_reference(small_chunks):
    s = CASES["clean"]
    want, want_unm, h = _reference_keys(s)
    t = torch.from_numpy(s)
    keys, unm, meta = tdecode.keys_from_stream_device(t, len(s), len(want))
    assert np.array_equal(unm.numpy(), want_unm)
    got = tdecode.patch_unmapped_keys(keys, unm, torch.from_numpy(h)).numpy()
    assert np.array_equal(got, want)
    assert (want < 0).any() and (h < 0).any() and want_unm.any()


def test_stable_permutation_matches_reference_sort():
    rng = np.random.default_rng(5)
    keys = rng.integers(-3, 4, 500).astype(np.int64) << 32 | rng.integers(0, 3, 500)
    keys[::7] = -1
    hi = (keys >> 32).astype(np.int32)
    lo = (keys & 0xFFFFFFFF).astype(np.uint32)
    _, _, j_perm = jsort_keys(jnp.asarray(hi), jnp.asarray(lo))
    _, t_perm = tsort_keys(torch.from_numpy(keys))
    assert np.array_equal(t_perm.numpy(), np.asarray(j_perm))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_murmur3_batch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 5000, dtype=np.uint8)
    offs = rng.integers(0, 4000, 200)
    lens = rng.integers(0, 1000, 200)
    assert np.array_equal(tmurmur(data, offs, lens, 0), jmurmur(data, offs, lens, 0))


def test_rows_past_the_walk_are_zero():
    s = CASES["small_size_word"]
    t = torch.from_numpy(s)
    offs, meta = kch.record_chain(t, len(s))
    keys, unm = kch.stream_keys(t, len(s), offs, meta, int(meta[0]) + 5)
    assert not keys[int(meta[0]):].any() and not unm[int(meta[0]):].any()


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run chip_smoke.py on the H100)")
    for case, s in CASES.items():
        n_rows = len(jbam.record_offsets(CASES["clean"], 0))
        res = []
        for dev in ("cuda", "cpu"):
            t = torch.from_numpy(s).to(dev)
            offs, meta = kch.record_chain(t, len(s))
            keys, unm = kch.stream_keys(t, len(s), offs, meta, n_rows)
            res.append([x.cpu() for x in (offs, meta, keys, unm)])
        (ko, km, kk, ku), (po, pm, pk, pu) = res
        cnt = int(pm[0])
        assert torch.equal(km, pm), case
        assert torch.equal(ko[:cnt], po[:cnt]), case
        assert torch.equal(kk, pk) and torch.equal(ku, pu), case

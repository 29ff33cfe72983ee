"""Kernel row 11, the lockstep-walk probe (hadoop_bam_tpu_torch, plain
version on the CPU), against the reference's Pallas probe in interpret mode
and its NumPy oracle ``reference_walk``.  Tolerance 0: cursors and
checksums equal as int32 (the oracle's int64 values mod 2**32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_bam_tpu.ops.pallas import inflate_probe as jip
from hadoop_bam_tpu_torch.ops.kernels import inflate_probe as kip


def _streams(R: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 31), 1 << 31, (R, kip.LANES), dtype=np.int32)


def _port(streams, cursors, T, device="cpu"):
    walk = kip.make_walk(streams.shape[0], T, device)
    cur, acc = walk(torch.from_numpy(streams).to(device), torch.from_numpy(cursors).to(device))
    return cur.cpu().numpy(), acc.cpu().numpy()


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("cursor_kind", ["in_range", "negative_and_past_the_end"])
def test_walk_equals_the_reference_kernel_and_oracle(cursor_kind):
    R, T = 256, 64
    streams = _streams(R, 3)
    rng = np.random.default_rng(4)
    if cursor_kind == "in_range":
        cursors = rng.integers(0, 64, (1, kip.LANES), dtype=np.int32)
    else:  # words outside [0, R) read as 0, and >> 5 is arithmetic
        cursors = rng.integers(-4096, R * 32 + 4096, (1, kip.LANES), dtype=np.int32)
        cursors[0, :4] = [-1, -33, R * 32 - 1, R * 32]
    cur, acc = _port(streams, cursors, T)
    j_cur, j_acc = jip.make_walk(R, T, interpret=True)(jnp.asarray(streams), jnp.asarray(cursors))
    c_ref, a_ref = jip.reference_walk(streams, cursors, T)
    assert cur.dtype == np.int32 and cur.shape == (1, kip.LANES)
    assert np.array_equal(cur, np.asarray(j_cur)) and np.array_equal(acc, np.asarray(j_acc))
    assert np.array_equal(_u32(cur), c_ref & 0xFFFFFFFF)
    assert np.array_equal(_u32(acc), a_ref)


def test_reference_walk_is_the_reference_oracle():
    streams = _streams(128, 8)
    cursors = np.arange(kip.LANES, dtype=np.int32)[None, :] * 7 - 100
    for got, want in zip(kip.reference_walk(streams, cursors, 40),
                         jip.reference_walk(streams, cursors, 40)):
        assert np.array_equal(got, want)


def test_shapes_and_devices_are_checked(monkeypatch):
    walk = kip.make_walk(64, 4, "cpu")
    with pytest.raises(ValueError, match=r"\[64, 128\]"):
        walk(torch.zeros((32, kip.LANES), dtype=torch.int32),
             torch.zeros((1, kip.LANES), dtype=torch.int32))
    with pytest.raises(TypeError):
        walk(torch.zeros((64, kip.LANES), dtype=torch.int64),
             torch.zeros((1, kip.LANES), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kip.bench_marginal(R=64, t_small=8, t_big=16, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kip.make_walk(64, 4)


def test_plain_version_does_not_count_launches():
    before = kip.LAUNCHES.value
    _port(_streams(64, 1), np.zeros((1, kip.LANES), np.int32), 8)
    assert kip.LAUNCHES.value == before


@pytest.mark.cuda
def test_kernel_matches_plain_and_oracle_on_card():
    """On a card: the CUDA kernel against its plain version and the oracle,
    and bench_marginal's keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run chip_smoke.py on the H100)")
    streams = _streams(256, 3)
    cursors = np.random.default_rng(5).integers(-4096, 12288, (1, kip.LANES), dtype=np.int32)
    before = kip.LAUNCHES.value
    k = _port(streams, cursors, 64, "cuda")
    assert kip.LAUNCHES.value == before + 1
    p = _port(streams, cursors, 64)
    assert np.array_equal(k[0], p[0]) and np.array_equal(k[1], p[1])
    c_ref, a_ref = kip.reference_walk(streams, cursors, 64)
    assert np.array_equal(_u32(k[0]), c_ref & 0xFFFFFFFF) and np.array_equal(_u32(k[1]), a_ref)
    r = kip.bench_marginal(R=256, t_small=64, t_big=256)
    assert set(r) == {"fixed_ms", "ns_per_wave", "tokens_per_s", "projected_mb_s",
                      "t_small_ms", "t_big_ms"}

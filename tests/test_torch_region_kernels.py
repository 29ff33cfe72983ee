"""Kernel rows 6, 8 and 9 of the port (the overlap cut, the quality
histogram, the nibble unpack) against the reference's Pallas kernels in
interpret mode and their XLA twins, on the CPU through the plain versions;
on a card, each kernel against its plain version.  Every comparison is
exact."""

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.ops import quality as jq
from hadoop_bam_tpu.ops.pallas import histogram as jhist
from hadoop_bam_tpu.ops.pallas import overlap as jov
from hadoop_bam_tpu.ops.pallas import unpack as junpack
from hadoop_bam_tpu_torch import _build
from hadoop_bam_tpu_torch.ops import quality as tq
from hadoop_bam_tpu_torch.ops.kernels import histogram as khist
from hadoop_bam_tpu_torch.ops.kernels import overlap as kov
from hadoop_bam_tpu_torch.ops.kernels import unpack as kunpack


def _overlap_case(k: int, n: int = 1500, seed: int = 0):
    """Records with refid -1/-2 rows, pos < 0 starts and a record at
    2**31 - 1 whose end wrapped; K intervals of mixed contigs."""
    rng = np.random.default_rng(seed + k)
    refid = rng.integers(-2, 3, n).astype(np.int32)
    start = rng.integers(-50, 100_000, n).astype(np.int32)
    end = (start + rng.integers(1, 300, n)).astype(np.int32)
    start[:3], end[:3] = [2**31 - 1, -5, 0], [-(2**31), 3, 1]
    refid[:3] = [0, -2, -1]
    iv = np.stack([rng.integers(-1, 3, k), rng.integers(-10, 90_000, k),
                   np.zeros(k, np.int64)], axis=1).astype(np.int32)
    iv[:, 2] = iv[:, 1] + rng.integers(0, 20_000, k)
    if k:
        iv[0] = [0, 2**31 - 2, 2**31 - 1]
    return iv, refid, start, end


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("k", [0, 1, 5, 64])
def test_overlap_plain_equals_the_pallas_kernel(k):
    iv, refid, start, end = _overlap_case(k)
    got = kov.overlap_mask(*_t(iv, refid, start, end))
    want = np.asarray(jov.overlap_mask(iv.reshape(-1, 3), refid, start, end, interpret=True))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert kov.overlap_mask(*_t(iv, refid[:0], start[:0], end[:0])).numel() == 0


def test_overlap_rejects_bad_shapes():
    iv, refid, start, end = _overlap_case(2)
    with pytest.raises(ValueError):
        kov.overlap_mask(*_t(iv[:, :2].copy(), refid, start, end))
    with pytest.raises(TypeError):
        kov.overlap_mask(*_t(iv, refid.astype(np.int64), start, end))


def _hist_case(b: int, length: int, nbins: int, seed: int = 1):
    rng = np.random.default_rng(seed + b)
    values = rng.integers(-5, nbins + 20, (b, length)).astype(np.int32)
    values[:, :3] = rng.integers(2, 42, (b, min(3, length)))  # the quality cluster
    valid = (rng.random((b, length)) < 0.8).astype(np.int32)
    return values, valid


@pytest.mark.parametrize("b,length,nbins", [(1, 1, 128), (37, 32, 128), (130, 17, 256),
                                            (64, 8, 128), (0, 5, 128)])
def test_quality_histogram_plain_equals_the_pallas_kernel(b, length, nbins):
    values, valid = _hist_case(b, length, nbins)
    got = khist.quality_histogram(*_t(values, valid), nbins=nbins)
    assert got.dtype == torch.int32 and got.shape == (nbins,)
    if b:
        want = np.asarray(jhist.quality_histogram(values, valid, nbins=nbins, interpret=True))
        assert np.array_equal(got.numpy(), want)
    twin = np.asarray(jq.histogram_u8(values, valid.astype(bool), nbins=nbins))
    assert np.array_equal(got.numpy(), twin)
    assert np.array_equal(tq.histogram_u8(*_t(values, valid.astype(bool)), nbins=nbins).numpy(),
                          twin)
    with pytest.raises(ValueError, match="multiple of 128"):
        khist.quality_histogram(*_t(values, valid), nbins=100)


@pytest.mark.parametrize("b,w,dtype", [(3, 5, np.uint8), (257, 75, np.uint8), (1, 0, np.uint8),
                                       (9, 4, np.int32), (0, 3, np.uint8)])
def test_unpack_plain_equals_the_pallas_kernel(b, w, dtype):
    rng = np.random.default_rng(b * 7 + w)
    packed = rng.integers(0, 256, (b, w)).astype(dtype)
    if dtype == np.int32 and packed.size:
        packed[0, 0] = -1  # bits past the byte are dropped, as the reference's shifts do
    got = kunpack.unpack_nibbles(*_t(packed))
    assert got.dtype == torch.int32 and got.shape == (b, 2 * w)
    if b:
        want = np.asarray(junpack.unpack_nibbles(packed, interpret=True))
        assert np.array_equal(got.numpy(), want)
    if dtype == np.uint8:
        hi, lo = jq.unpack_seq_nibbles(packed)
        thi, tlo = tq.unpack_seq_nibbles(*_t(packed))
        assert np.array_equal(thi.numpy(), np.asarray(hi)) and np.array_equal(
            tlo.numpy(), np.asarray(lo))
        assert np.array_equal(got.numpy()[:, 0::2], np.asarray(hi))
        assert np.array_equal(got.numpy()[:, 1::2], np.asarray(lo))


def test_quality_ops_equal_the_reference():
    rng = np.random.default_rng(4)
    qual = rng.integers(20, 130, (33, 21)).astype(np.uint8)
    valid = rng.random((33, 21)) < 0.9
    qt, vt = _t(qual, valid)
    for fn in ("verify_quality_sanger", "verify_quality_illumina"):
        assert np.array_equal(getattr(tq, fn)(qt, vt).numpy(), np.asarray(getattr(jq, fn)(qual, valid)))
    for fn in ("illumina_to_sanger", "sanger_to_illumina"):
        assert np.array_equal(getattr(tq, fn)(qt).numpy(), np.asarray(getattr(jq, fn)(qual)))
    codes = rng.integers(0, 18, (33, 21)).astype(np.int32)
    assert np.array_equal(tq.base_counts(*_t(codes, valid)).numpy(),
                          np.asarray(jq.base_counts(codes, valid)))
    q = qual.copy()
    q[0, :4] = 0xFF
    assert np.array_equal(tq.sum_base_qualities(*_t(q, valid)).numpy(),
                          np.asarray(jq.sum_base_qualities(q, valid)))
    assert tq.MARKDUP_MIN_QUALITY == jq.MARKDUP_MIN_QUALITY


def test_sum_base_qualities_np_equals_the_reference():
    from hadoop_bam_tpu_torch.spec import bam as tbam

    rng = np.random.default_rng(5)
    recs = [tbam.build_record(f"q{i}", 0, 10 * i, 60, 0, [(n, "M")], "A" * n,
                              rng.integers(0, 45, n, dtype=np.uint8).tobytes() if i % 4 else b"")
            for i, n in enumerate(rng.integers(1, 40, 50))]
    data = np.frombuffer(b"".join(recs), np.uint8)
    soa = tbam.soa_decode(data, tbam.record_offsets(data))
    assert np.array_equal(tq.sum_base_qualities_np(data, soa), jq.sum_base_qualities_np(data, soa))


def test_region_kernels_that_cannot_build_raise(tmp_path, monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    assert set(_build.SIGNATURES["region"]) == {
        "hbt_overlap_mask", "hbt_overlap_rows", "hbt_quality_histogram",
        "hbt_unpack_nibbles_u8", "hbt_unpack_nibbles_i32"}
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("region")


def test_plain_versions_do_not_count_launches():
    before = [c.value for c in (kov.LAUNCHES, khist.LAUNCHES, kunpack.LAUNCHES)]
    iv, refid, start, end = _overlap_case(3)
    kov.overlap_mask(*_t(iv, refid, start, end))
    khist.quality_histogram(*_t(*_hist_case(10, 4, 128)))
    kunpack.unpack_nibbles(torch.zeros((2, 3), dtype=torch.uint8))
    assert [c.value for c in (kov.LAUNCHES, khist.LAUNCHES, kunpack.LAUNCHES)] == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the region kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 8, 1500])
def test_overlap_kernel_matches_plain_on_card(k):
    dev = _card()
    iv, refid, start, end = _overlap_case(k, n=100_000)
    host = _t(iv, refid, start, end)
    got = kov.overlap_mask(*[a.to(dev) for a in host])
    assert torch.equal(got.cpu(), kov.overlap_mask(*host))


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,nbins", [(1, 1, 128), (1000, 150, 128), (77, 31, 512)])
def test_histogram_kernel_matches_plain_on_card(b, length, nbins):
    dev = _card()
    host = _t(*_hist_case(b, length, nbins))
    got = khist.quality_histogram(*[a.to(dev) for a in host], nbins=nbins)
    assert torch.equal(got.cpu(), khist.quality_histogram(*host, nbins=nbins))


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,dtype", [(1, 0, torch.uint8), (1001, 75, torch.uint8),
                                       (5, 7, torch.int32)])
def test_unpack_kernel_matches_plain_on_card(b, w, dtype):
    dev = _card()
    packed = torch.randint(0, 256, (b, w), dtype=torch.int64).to(dtype)
    got = kunpack.unpack_nibbles(packed.to(dev))
    assert torch.equal(got.cpu(), kunpack.unpack_nibbles(packed))

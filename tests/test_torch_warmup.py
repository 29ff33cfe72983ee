"""The serve warm-up (hadoop_bam_tpu_torch.serve.warmup) on the CPU against
the reference's ``warm_kernels``: the same families and counts, a warm
second call loads no kernel, unknown kinds raise, and a family whose
kernel cannot build raises instead of being recorded and skipped."""

import ctypes

import pytest
import torch

from hadoop_bam_tpu.serve import warmup as jwarm
from hadoop_bam_tpu_torch import _build
from hadoop_bam_tpu_torch.serve import warm_kernels
from hadoop_bam_tpu_torch.serve import warmup as twarm


def test_warmed_counts_equal_the_reference():
    rep = warm_kernels(device="cpu")
    ref = jwarm.warm_kernels()
    assert rep["warmed"] == ref["warmed"] == {"overlap": 4, "keys": 4, "codec": 1}
    assert rep["kinds"] == ref["kinds"] and rep["row_buckets"] == ref["row_buckets"]
    assert rep["codec_buckets"] == ref["codec_buckets"] == list(twarm.CPU_CODEC_BUCKETS)
    assert twarm.CUDA_CODEC_BUCKETS == jwarm.TPU_CODEC_BUCKETS
    assert (twarm.ALL_KINDS, twarm.OVERLAP_PAD_MIN, twarm.DEFAULT_ROW_BUCKETS) == (
        jwarm.ALL_KINDS, jwarm.OVERLAP_PAD_MIN, jwarm.DEFAULT_ROW_BUCKETS)
    assert [twarm.pow2_at_least(n) for n in (0, 64, 65, 3000)] == [
        jwarm.pow2_at_least(n) for n in (0, 64, 65, 3000)]


def test_second_call_compiles_nothing():
    rep = warm_kernels(kinds=("overlap", "keys"), row_buckets=(64, 256), device="cpu")
    assert rep["warmed"] == {"overlap": 2, "keys": 2}
    rep2 = warm_kernels(kinds=("overlap", "keys"), row_buckets=(64, 256), device="cpu")
    assert rep2["compiles"] == 0
    assert twarm.ensure_compile_watcher().metrics.get("serve.warmup_runs") >= 2


def test_unknown_kinds_raise():
    with pytest.raises(ValueError, match="unknown warm-up kinds"):
        warm_kernels(kinds=("overlap", "bogus"), device="cpu")
    with pytest.raises(ValueError, match="unknown warm-up kinds"):
        jwarm.warm_kernels(kinds=("overlap", "bogus"))


def test_first_library_load_counts_as_a_compile(tmp_path, monkeypatch):
    """A library loaded for the first time in the process is one compile
    (``serve.jit_compiles``); loading it again is none."""

    class FakeLib:
        def __getattr__(self, name):
            return ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    watcher = twarm.ensure_compile_watcher()
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda names: {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    c0, m0 = twarm.compile_count(), watcher.metrics.get("serve.jit_compiles")
    _build.load("inflate_fixed")
    _build.load("inflate_fixed")
    assert twarm.compile_count() == c0 + 1
    assert watcher.metrics.get("serve.jit_compiles") == m0 + 1


def test_a_family_whose_kernel_cannot_build_raises(tmp_path, monkeypatch):
    """No catch-all: kernel row 6 that cannot build fails the warm-up."""
    from hadoop_bam_tpu_torch.ops.kernels import overlap as koverlap

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(koverlap, "use_plain", lambda *t: False)  # take the kernel's path
    with pytest.raises(RuntimeError, match="nvcc not found"):
        warm_kernels(kinds=("overlap",), device="cpu")


def test_warm_kernels_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm_kernels()

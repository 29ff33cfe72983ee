"""The port's deflate lanes (hadoop_bam_tpu_torch, plain version on the
CPU) against the reference's lockstep-lane encoder in interpret mode, on
the corpus of tests/test_deflate_lanes.py.  Tolerance 0: compressed bytes,
clens and ok verdicts must be equal, and every row must inflate to its
payload through zlib."""

import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.ops import flate as jflate
from hadoop_bam_tpu.ops.pallas import deflate_lanes as jdl
from hadoop_bam_tpu_torch.ops.kernels import deflate as kd

REPO = Path(__file__).resolve().parents[1]


def _rows(payloads):
    P = max(max((len(p) for p in payloads), default=1), 1)
    mat = np.zeros((len(payloads), P), np.uint8)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
    return mat, np.array([len(p) for p in payloads], np.int32)


def _both(payloads, **kw):
    mat, lens = _rows(payloads)
    ref = jdl.deflate_lanes(mat, lens, interpret=True, **kw)
    port = [t.numpy() for t in kd.deflate_lanes(torch.from_numpy(mat), lens, **kw)]
    return ref, port


def _assert_same(ref, port, payloads):
    (jc, jl, jo), (tc, tl, to) = ref, port
    assert tc.shape == jc.shape
    assert np.array_equal(tl, jl), (tl, jl)
    assert np.array_equal(to, jo), (to, jo)
    for i in range(len(payloads)):
        assert tc[i, : tl[i]].tobytes() == jc[i, : jl[i]].tobytes(), f"member {i}"
        assert not tc[i, tl[i] :].any(), f"member {i} not zero past clen"
        if to[i]:
            d = zlib.decompressobj(-15)
            assert d.decompress(tc[i, : tl[i]].tobytes()) == payloads[i] and d.eof


def _bam_rec():
    return (struct.pack("<I", 44)
            + struct.pack("<iiBBHHHiiii", 0, 1000, 5, 60, 4681, 1, 0, -1, -1, 0, 0)
            + b"r01\x00" + bytes(8))


def _corpus():
    rng = np.random.default_rng(0)
    return {
        "bam_like": (_bam_rec() * 12)[:500],
        "random": bytes(rng.integers(0, 256, 400, dtype=np.uint8)),
        "zero_run": b"\x00" * 480,
        "empty": b"",
        "below_min_match": b"ACG",
        "two_symbols": bytes(rng.integers(0, 4, 450, dtype=np.uint8)),
        "period_2": b"ab" * 200,
        "long_match_258": b"Q" + b"xyz" * 300,
    }


@pytest.fixture(scope="module")
def oracle_batch():
    c = _corpus()
    payloads = list(c.values())
    return list(c), payloads, _both(payloads)


@pytest.mark.parametrize("name", list(_corpus()))
def test_member_matches_reference(oracle_batch, name):
    names, payloads, (ref, port) = oracle_batch
    i = names.index(name)
    pick = lambda t: tuple(x[i : i + 1] for x in t)  # noqa: E731
    _assert_same(pick(ref), pick(port), [payloads[i]])


def test_batch_matches_reference_and_compresses(oracle_batch):
    names, payloads, (ref, port) = oracle_batch
    _assert_same(ref, port, payloads)
    tl = port[1]
    assert tl[names.index("bam_like")] < len(payloads[0]) // 2  # matches found
    assert tl[names.index("zero_run")] < 16  # overlapping copies
    assert tl[names.index("empty")] == 2  # the empty fixed block


def test_fuzz_shapes_and_kinds_match_reference():
    """The reference's fuzz corpus (random sizes; random bytes, a period-8
    motif, 2-bit alphabets, single-byte runs) in one batch."""
    rng = np.random.default_rng(7)
    payloads = []
    for t in range(24):
        n = int(rng.integers(1, 500))
        kind = t % 4
        if kind == 0:
            p = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        elif kind == 1:
            p = (b"GATTACA-" * (n // 8 + 1))[:n]
        elif kind == 2:
            p = bytes(rng.integers(0, 4, n, dtype=np.uint8))
        else:
            p = bytes([int(rng.integers(0, 256))]) * n
        payloads.append(p)
    _assert_same(*_both(payloads), payloads)


def test_member_at_payload_cap_boundary():
    pat = b"0123456789ABCDEF" * 16
    payloads = [pat * 2, (pat * 2)[:500]]
    _assert_same(*_both(payloads), payloads)


def test_output_overflow_tiers_down_ok0():
    rng = np.random.default_rng(1)
    payloads = [bytes(rng.integers(0, 256, 300, dtype=np.uint8)), b"easy " * 60]
    ref, port = _both(payloads, max_clen=100)
    _assert_same(ref, port, payloads)
    assert not port[2][0] and port[2][1]


def test_member_past_the_cap_declines_like_the_reference():
    n = kd.MAX_MEMBER + 8
    mat = np.zeros((1, n), np.uint8)
    jc, jl, jo = jdl.deflate_lanes(mat, np.array([n], np.int32), interpret=True)
    tc, tl, to = kd.deflate_lanes(torch.from_numpy(mat), np.array([n]))
    assert tc.shape == jc.shape and not to[0] and not jo[0] and tl[0] == jl[0] == 0


def test_chunk_512_uses_the_reference_hash_width():
    """chunk_bytes=512 gives H = 512 or 1024 hash slots for short batches,
    which changes which candidates survive; the bytes must still agree."""
    rng = np.random.default_rng(5)
    rec = _bam_rec()
    payloads = [(rec * 40)[:1500], bytes(rng.integers(0, 3, 700, dtype=np.uint8)), b"x" * 90]
    ref, port = _both(payloads, chunk_bytes=512)
    _assert_same(ref, port, payloads)
    assert kd.hash_bits(1536) == 10 and kd.hash_bits(512) == 9


@pytest.mark.parametrize("max_plen,chunk", [
    (0, 4096), (1, 4096), (4096, 4096), (57088, 4096), (1 << 16, 4096), ((1 << 16) + 1, 4096),
    (2000, 512), (1 << 16, 65536),
])
def test_accepts_matches_reference(max_plen, chunk):
    assert kd.accepts(max_plen, chunk) == jdl.accepts(max_plen, chunk)
    assert kd.vmem_bytes(kd.round_up(max(max_plen, 1), chunk), chunk) == jdl._vmem_bytes(
        kd.round_up(max(max_plen, 1), chunk), chunk)
    assert kd.out_bytes(max(max_plen, 1)) == jdl._out_bytes(max(max_plen, 1))


def test_vmem_rule_declines_before_launch(monkeypatch):
    monkeypatch.setattr(kd, "VMEM_BUDGET_BYTES", 1 << 10)
    tc, tl, to = kd.deflate_lanes(torch.zeros((1, 2048), dtype=torch.uint8), [2048])
    assert not to.any() and not tc.any()
    assert kd.accepts(2048) == (False, "vmem")


def test_stream_form_reads_windows_in_place():
    """deflate_lanes_stream over windows of one stream (the device write's
    form) equals deflate_lanes over the same payloads as rows."""
    rng = np.random.default_rng(6)
    stream = np.frombuffer((_bam_rec() * 90)[:3000] + bytes(rng.integers(0, 256, 1000, dtype=np.uint8)),
                           np.uint8).copy()
    offs, lens = np.array([0, 1024, 2048, 3072]), np.array([1024, 1024, 1024, 928])
    a = kd.deflate_lanes_stream(torch.from_numpy(stream), lens, offs=offs)
    rows = np.zeros(4096, np.uint8)
    rows[:4000] = stream
    b = kd.deflate_lanes(torch.from_numpy(rows.reshape(4, 1024)), lens)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = kd.deflate_lanes_stream(torch.from_numpy(stream), lens)  # offs default: back to back
    assert all(torch.equal(x, y) for x, y in zip(a, c))


def test_small_chunks_are_refused():
    with pytest.raises(ValueError):
        kd.deflate_lanes(torch.zeros((1, 10), dtype=torch.uint8), [10], chunk_bytes=128)


def _cu_table(src: str, name: str) -> list:
    m = re.search(name + r"\[\d+\] = \{([^}]*)\}", src)
    return [int(x) for x in m.group(1).replace("\n", " ").split(",") if x.strip()]


def test_kernel_constants_equal_the_reference():
    # The kernel's walk and its tables live in deflate_core.cuh, whose
    # static_assert holds the formulas the walk uses to these tables.
    cu = (REPO / "hadoop_bam_tpu_torch" / "csrc" / "deflate_core.cuh").read_text()
    for py, c in (("LEN_BASE", "kLenBase"), ("LEN_EXTRA", "kLenExtra"),
                  ("DIST_BASE", "kDistBase"), ("DIST_EXTRA", "kDistExtra")):
        ref = [int(x) for x in getattr(jflate, py)]
        assert _cu_table(cu, c) == ref, c
        assert getattr(kd, "_" + py).tolist() == ref, py
    assert (kd.MAX_MEMBER, kd.HASH_ROWS, kd.VMEM_BUDGET_BYTES, kd.DEFAULT_CHUNK) == (
        jdl._MAX_MEMBER, jdl._HASH_ROWS, jdl._VMEM_BUDGET_BYTES, jdl._DEFAULT_CHUNK)
    assert "0x9E3779B1u" in cu and "kMaxDist = 1 << 15" in cu


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    payloads = list(_corpus().values())
    mat, lens = _rows(payloads)
    k = [t.cpu() for t in kd.deflate_lanes(torch.from_numpy(mat).cuda(), lens)]
    p = kd.deflate_lanes(torch.from_numpy(mat), lens)
    for x, y in zip(k, p):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n_members,member", [(4, 1024), (3, 4096)])
def test_bench_deflate_ratio_equals_the_reference(n_members, member):
    """The reference's bench probe of the coding ratio: the same corpus and
    the same compressed sizes, so every field is equal."""
    np.testing.assert_array_equal(kd._bam_like_corpus(n_members, member),
                                  jdl._bam_like_corpus(n_members, member))
    got = kd.bench_deflate_ratio(n_members, member, device="cpu")
    want = jdl.bench_deflate_ratio(n_members, member, interpret=True)
    assert got == want and got["n_ok"] == n_members


def test_bench_marginals_time_only_the_card():
    from hadoop_bam_tpu_torch.ops.kernels import gather as kg

    for bench in (kd.bench_deflate_marginal, kg.bench_write_marginal):
        with pytest.raises(ValueError, match="times the card"):
            bench(device="cpu")


@pytest.mark.cuda
def test_bench_marginals_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from hadoop_bam_tpu_torch.ops.kernels import gather as kg

    d = kd.bench_deflate_marginal()
    w = kg.bench_write_marginal()
    for r in (d, w):
        assert r["t_big_ms"] > 0 and r["t_small_ms"] > 0 and r["projected_mb_s"] > 0

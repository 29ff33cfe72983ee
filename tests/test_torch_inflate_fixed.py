"""Kernel row 10, the literal-only fixed-Huffman inflate
(hadoop_bam_tpu_torch, plain version on the CPU), against the reference's
Pallas kernel in interpret mode, on the cases of tests/test_pallas_kernels.py.
Tolerance 0: the ok verdicts are equal, and each ok row holds exactly the
member's payload (the reference leaves the bytes past ISIZE unset; the
port zeroes them)."""

import gzip

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.ops import flate as jflate
from hadoop_bam_tpu.ops.pallas.inflate_fixed import inflate_fixed_literal as jlit
from hadoop_bam_tpu_torch.ops import flate as tflate
from hadoop_bam_tpu_torch.ops.kernels import inflate_fixed as kfix
from hadoop_bam_tpu_torch.spec import bgzf as tbgzf


def _rows(comps, C=None):
    C = C or max(len(c) for c in comps)
    comp = np.zeros((len(comps), C), np.uint8)
    for i, c in enumerate(comps):
        comp[i, : len(c)] = np.frombuffer(c, np.uint8)
    return comp


def _lit(payloads):
    comps = [tflate.encode_tokens_fixed([("lit", b) for b in p]) for p in payloads]
    clens = np.array([len(c) for c in comps], np.int32)
    isz = np.array([len(p) for p in payloads], np.int32)
    return _rows(comps), clens, isz


def _port(comp, clens, isz, device="cpu"):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out, ok = kfix.inflate_fixed_literal(t(comp), t(clens), t(isz))
    return out.cpu().numpy(), ok.cpu().numpy()


def _check_both(comp, clens, isz):
    """Port == reference; returns the port's (out, ok)."""
    ref_out, ref_ok = jlit(comp, clens, isz, interpret=True)
    out, ok = _port(comp, clens, isz)
    assert np.array_equal(ok, ref_ok)
    assert out.shape == (len(isz), int(isz.max()))
    for i in range(len(isz)):
        if ok[i]:
            assert np.array_equal(out[i, : isz[i]], ref_out[i, : isz[i]])
            assert not out[i, isz[i]:].any()
        else:
            assert not out[i].any() and not ref_out[i].any()
    return out, ok


def test_byte_equal_to_the_reference_and_zlib():
    rng = np.random.default_rng(7)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (1, 2, 37, 144, 255, 300)] + [bytes([200] * 50), bytes(range(256))]
    out, ok = _check_both(*_lit(payloads))
    assert ok.all()
    for i, p in enumerate(payloads):
        assert out[i, : len(p)].tobytes() == p


@pytest.mark.parametrize("case", ["lz77_copy", "truncated", "btype_10", "isize_short",
                                  "isize_long", "empty_payload"])
def test_contract_verdicts_equal_the_reference(case):
    body = [("lit", b) for b in b"ABCDEFGH" * 8]
    if case == "lz77_copy":
        c = tflate.encode_tokens_fixed([("lit", 65)] * 8 + [("copy", 5, 3)])
        args = (_rows([c]), np.array([len(c)], np.int32), np.array([13], np.int32))
    elif case == "truncated":
        full = tflate.encode_tokens_fixed(body)
        half = full[: len(full) // 2]
        args = (_rows([half]), np.array([len(half)], np.int32), np.array([64], np.int32))
    elif case == "btype_10":
        comp = np.zeros((1, 8), np.uint8)
        comp[0, 0] = 0b101
        args = (comp, np.array([8], np.int32), np.array([4], np.int32))
    elif case in ("isize_short", "isize_long"):
        c = tflate.encode_tokens_fixed(body)
        args = (_rows([c]), np.array([len(c)], np.int32),
                np.array([63 if case == "isize_short" else 65], np.int32))
    else:
        c = tflate.encode_tokens_fixed([])
        args = (_rows([c, c]), np.array([len(c)] * 2, np.int32), np.array([0, 1], np.int32))
    _, ok = _check_both(*args)
    assert ok.tolist() == ([True, False] if case == "empty_payload" else [False])


@pytest.mark.parametrize("tail", ["zero_padded", "bytes_past_clens"],
                         ids=["zero_padded", "bytes_past_clens"])
def test_truncated_member_then_valid_member(tail):
    """A truncated member beside a valid one: the truncated one fails (its
    EOB would end past clens * 8, or never comes) whether its row holds
    zeros or the rest of its stream past clens; the valid one decodes."""
    rng = np.random.default_rng(3)
    good = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
    cut = rng.integers(0, 256, 900, dtype=np.uint8).tobytes()
    c_cut = tflate.encode_tokens_fixed([("lit", b) for b in cut])
    c_good = tflate.encode_tokens_fixed([("lit", b) for b in good])
    keep = len(c_cut) - 40
    comp = _rows([c_cut if tail == "bytes_past_clens" else c_cut[:keep], c_good])
    out, ok = _check_both(comp, np.array([keep, len(c_good)], np.int32),
                          np.array([900, 700], np.int32))
    assert ok.tolist() == [False, True]
    assert out[1, :700].tobytes() == good


def test_device_deflated_bgzf_members():
    """The port's literal-only bgzf_compress_device members decode through
    row 10 as through the reference's kernel, and gzip reads the blob."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
    blob = tflate.bgzf_compress_device(data, block_payload=256, use_lanes=False, device="cpu")
    assert gzip.decompress(blob) == data
    raw = np.frombuffer(blob, np.uint8)
    co, cs, us = tbgzf.scan_blocks(raw)
    keep = [i for i in range(len(co)) if us[i] > 0]
    comps = [raw[co[i] + 18 : co[i] + cs[i] - 8].tobytes() for i in keep]
    out, ok = _check_both(_rows(comps), np.array([len(c) for c in comps], np.int32),
                          us[keep].astype(np.int32))
    assert ok.all()
    assert b"".join(out[k, : us[i]].tobytes() for k, i in enumerate(keep)) == data


def test_member_past_the_reference_vmem_budget_decodes():
    """A 57,088-byte member (the part writer's full blocking): the
    reference declines it for its VMEM budget; the card has none, so the
    port decodes it."""
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, tflate.DEV_MAX_PAYLOAD, dtype=np.uint8).tobytes()
    comp, clens, isz = _lit([payload])
    _, ref_ok = jlit(comp, clens, isz, interpret=True)
    assert not ref_ok[0]
    out, ok = _port(comp, clens, isz)
    assert ok[0] and out[0].tobytes() == payload


def test_unaligned_width_and_empty_batch():
    comp, clens, isz = _lit([b"hello", b"BGZF"])
    _check_both(np.ascontiguousarray(np.pad(comp, ((0, 0), (0, 3)))), clens, isz)
    out, ok = _port(np.zeros((0, 8), np.uint8), np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert out.shape == (0, 0) and ok.shape == (0,)


def _negative_isize_batches():
    """The batch that once failed the fuzz (one empty-payload member,
    ``03 00``, clen 2, ISIZE -1) and a mixed batch (ISIZE 5 and -1)."""
    empty = bytes([0x03, 0x00])
    five = tflate.encode_tokens_fixed([("lit", b) for b in b"hello"])
    lone = (_rows([empty]), np.array([2], np.int32), np.array([-1], np.int32))
    mixed = (_rows([five, empty]), np.array([len(five), 2], np.int32),
             np.array([5, -1], np.int32))
    return lone, mixed


def test_every_isize_below_zero_raises_as_the_reference():
    """A batch whose every ISIZE is below 0: the reference's output would
    have a negative width and numpy refuses it with ``ValueError``; the
    port's wrapper raises the same before either route runs."""
    (comp, clens, isz), _ = _negative_isize_batches()
    with pytest.raises(ValueError):
        jlit(comp, clens, isz, interpret=True)
    with pytest.raises(ValueError):
        _port(comp, clens, isz)


def test_a_negative_isize_beside_a_valid_member_equals_the_reference():
    """ISIZE 5 and -1 in one batch: the bytes and the verdicts are the
    reference's (the -1 member is rejected with a zero row)."""
    _, mixed = _negative_isize_batches()
    out, ok = _check_both(*mixed)
    assert ok.tolist() == [True, False]
    assert out[0].tobytes() == b"hello" and not out[1].any()


def test_the_codec_refuses_an_isize_past_the_bgzf_bound_as_the_reference():
    """A member trailer's ISIZE of 2**32 - 1 never reaches row 10 as a
    negative int32: both codecs refuse the block while scanning, with the
    same exception class."""
    from hadoop_bam_tpu.spec.bgzf import BgzfError as JBgzfError

    blob = bytearray(tbgzf.deflate_blocks(b"hello")[0])
    blob[-4:] = (2**32 - 1).to_bytes(4, "little")
    with pytest.raises(tbgzf.BgzfError):
        tflate.bgzf_decompress_device(bytes(blob), device="cpu")
    with pytest.raises(JBgzfError):
        jflate.bgzf_decompress_device(bytes(blob))


def test_plain_version_does_not_count_launches():
    before = kfix.LAUNCHES.value
    _port(*_lit([b"abc"]))
    assert kfix.LAUNCHES.value == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On a card: the CUDA kernel against its plain version, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run chip_smoke.py on the H100)")
    rng = np.random.default_rng(9)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (0, 1, 15, 16, 17, 144, 1000, 24000)]
    comp, clens, isz = _lit(payloads)
    comp[2, 1] ^= 0x40
    isz[3] += 1
    for args in ((comp, clens, isz), _lit([payloads[-1]] * 3)):
        before = kfix.LAUNCHES.value
        ko, kk = _port(*args, device="cuda")
        assert kfix.LAUNCHES.value == before + 1
        po, pk = _port(*args)
        assert np.array_equal(kk, pk) and np.array_equal(ko, po)

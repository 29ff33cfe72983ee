"""The port's device codec tiers (hadoop_bam_tpu_torch.ops.flate, torch ops
and plain versions on the CPU) against the reference's on the cases of
tests/test_flate.py: the token encoder, ``deflate_fixed`` and its chunked
rows, the literal-only ``bgzf_compress_device`` tier, the three inflate
programs and ``bgzf_decompress_device`` (bytes and every CodecTierStats
field).  Tolerance 0: equal bytes, equal ok verdicts; the programs' output
rows are compared in full where the reference defines them (every row of
``inflate_stored`` and ``inflate_fixed``, the ok rows of
``inflate_dynamic``)."""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.ops import flate as jflate
from hadoop_bam_tpu.spec import bgzf as jbgzf
from hadoop_bam_tpu_torch.conf import DEFLATE_LANES, INFLATE_LANES, Configuration
from hadoop_bam_tpu_torch.ops import flate as tflate
from hadoop_bam_tpu_torch.spec import bgzf as tbgzf
from hadoop_bam_tpu_torch.utils.tracing import Metrics

CPU = torch.device("cpu")
REF_STATS = ("lanes", "xla", "host", "tierdown_size", "tierdown_vmem", "tierdown_ok0")


def _raw(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def _flushed(parts, level=6) -> bytes:
    """One raw DEFLATE stream with a full flush (a block boundary) after
    every part but the last."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    out = b""
    for k, p in enumerate(parts):
        out += co.compress(p) + co.flush(zlib.Z_FULL_FLUSH if k < len(parts) - 1 else zlib.Z_FINISH)
    return out


def _frame(comp: bytes, payload: bytes) -> bytes:
    """A raw DEFLATE stream as one BGZF member."""
    return (b"\x1f\x8b\x08\x04" + b"\0" * 6 + struct.pack("<H", 6) + b"BC"
            + struct.pack("<HH", 2, 12 + 6 + len(comp) + 8 - 1) + comp
            + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload)))


class _BitWriter:
    """LSB-first bit packer for hand-built DEFLATE headers."""

    def __init__(self):
        self.bits = []

    def w(self, val, n):
        self.bits.extend((val >> k) & 1 for k in range(n))

    def code(self, c, length):
        self.bits.extend((c >> k) & 1 for k in range(length - 1, -1, -1))

    def bytes(self):
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (i & 7)
        return bytes(out)


def _oversubscribed_ll() -> bytes:
    bw = _BitWriter()
    bw.w(1, 1), bw.w(2, 2), bw.w(0, 5), bw.w(0, 5), bw.w(14, 4)
    for pos in range(18):
        bw.w(1 if pos in (2, 17) else 0, 3)
    for _ in range(3):
        bw.code(0, 1)
    bw.code(1, 1), bw.w(138 - 11, 7), bw.code(1, 1), bw.w(116 - 11, 7), bw.code(0, 1)
    return bw.bytes() + b"\0" * 8


def _incomplete_clc() -> bytes:
    bw = _BitWriter()
    bw.w(1, 1), bw.w(2, 2), bw.w(0, 5), bw.w(0, 5), bw.w(0, 4)
    for pos in range(4):
        bw.w(1 if pos == 3 else 0, 3)
    return bw.bytes() + b"\0" * 16


def _lone_distance_code() -> bytes:
    """A dynamic block with a single length-1 distance code: "AAAAA"."""
    bw = _BitWriter()
    bw.w(1, 1), bw.w(2, 2), bw.w(2, 5), bw.w(0, 5), bw.w(14, 4)
    for pos in range(18):
        bw.w(2 if pos in (3, 17, 15, 2) else 0, 3)
    zero, one, two, rep18 = (0, 2), (1, 2), (2, 2), (3, 2)
    bw.code(*rep18), bw.w(65 - 11, 7), bw.code(*one), bw.code(*rep18), bw.w(138 - 11, 7)
    bw.code(*rep18), bw.w(52 - 11, 7), bw.code(*two), bw.code(*zero), bw.code(*two)
    bw.code(*one)
    bw.code(0, 1), bw.code(3, 2), bw.code(0, 1), bw.code(2, 2)
    return bw.bytes()


def _both(name: str, raws, isizes, out_cap: int, *extra, ok_rows_only: bool = False):
    """Run program ``name`` of both packages on the same padded rows."""
    C = max(512, 1 << (max(max(len(r) for r in raws) - 1, 1)).bit_length())
    comp = np.zeros((len(raws), C), np.uint8)
    for i, r in enumerate(raws):
        comp[i, : len(r)] = np.frombuffer(r, np.uint8)
    clens = np.array([len(r) for r in raws], np.int32)
    isz = np.array(isizes, np.int32)
    j_out, j_ok = getattr(jflate, name)(jnp.asarray(comp), jnp.asarray(clens), jnp.asarray(isz),
                                        out_cap, *extra)
    t_out, t_ok = getattr(tflate, name)(torch.from_numpy(comp), torch.from_numpy(clens),
                                        torch.from_numpy(isz), out_cap, *extra)
    j_out, j_ok = np.asarray(j_out), np.asarray(j_ok)
    t_out, t_ok = t_out.numpy(), t_ok.numpy()
    assert t_out.dtype == np.uint8 and t_out.shape == j_out.shape
    assert np.array_equal(t_ok, j_ok)
    rows = j_ok if ok_rows_only else slice(None)
    assert np.array_equal(t_out[rows], j_out[rows])
    return t_out, t_ok


# --------------------------------------------------------------------------
# Tables and the writing side
# --------------------------------------------------------------------------


def test_fixed_code_tables_equal_the_reference():
    for name in ("LITLEN_TABLE", "DIST_TABLE", "FIXED_LITLEN_LENS", "FIXED_DIST_LENS", "REV8"):
        assert np.array_equal(getattr(tflate, name), getattr(jflate, name)), name
    for sym in range(288):
        assert tflate._fixed_code(sym) == jflate._fixed_code(sym)
    assert [tflate._bit_reverse(v, 9) for v in range(512)] == [
        jflate._bit_reverse(v, 9) for v in range(512)]


@pytest.mark.parametrize("toks", [
    [("lit", b) for b in range(256)],
    [("lit", 65), ("lit", 66), ("lit", 67), ("copy", 30, 3), ("copy", 258, 1), ("copy", 3, 33)],
    [("lit", 1), ("block",), ("lit", 2), ("block",), ("lit", 3)],
    [("lit", 9)] + [("copy", n, 1) for n in (3, 10, 11, 18, 130, 257, 258)],
    [("lit", i % 256) for i in range(400)] + [("copy", 5, d) for d in (5, 24, 100, 398)],
], ids=["literals", "copies", "multiblock", "length_codes", "distance_codes"])
def test_token_encoder_writes_the_reference_bytes(toks):
    for final in (True, False):
        assert tflate.encode_tokens_fixed(toks, final) == jflate.encode_tokens_fixed(toks, final)
    want = jflate.encode_tokens_fixed(toks)
    assert zlib.decompressobj(-15).decompress(tflate.encode_tokens_fixed(toks)) == \
        zlib.decompressobj(-15).decompress(want)


@pytest.mark.parametrize("n", [0, 1, 255, 4096])
def test_deflate_fixed_equals_the_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    mat = data[None, :].copy() if n else np.zeros((1, 1), np.uint8)
    lens = np.asarray([n], np.int32)
    ob = (3 + 9 * max(n, 1) + 7 + 7) // 8 + 1
    jc, jl = jflate.deflate_fixed(jnp.asarray(mat), jnp.asarray(lens), ob)
    tc, tl = tflate.deflate_fixed(torch.from_numpy(mat), torch.from_numpy(lens), ob)
    assert np.array_equal(tc.numpy(), np.asarray(jc)) and np.array_equal(tl.numpy(), np.asarray(jl))
    assert zlib.decompress(tc.numpy()[0, : tl[0]].tobytes(), -15) == data.tobytes()


def test_deflate_fixed_nine_bit_codes_and_independent_rows():
    data = np.arange(256, dtype=np.uint8).repeat(3)
    rng = np.random.default_rng(7)
    mat = np.concatenate([data[None, :], rng.integers(0, 256, (4, 768), dtype=np.uint8)])
    lens = np.asarray([768, 767, 1, 0, 500], np.int32)
    ob = (3 + 9 * 768 + 14) // 8 + 1
    jc, jl = jflate.deflate_fixed(jnp.asarray(mat), jnp.asarray(lens), ob)
    tc, tl = tflate.deflate_fixed(torch.from_numpy(mat), torch.from_numpy(lens), ob)
    assert np.array_equal(tc.numpy(), np.asarray(jc)) and np.array_equal(tl.numpy(), np.asarray(jl))


def test_deflate_fixed_rows_chunk_to_the_reference_bytes(monkeypatch):
    rng = np.random.default_rng(2)
    mat = rng.integers(0, 256, (9, 700), dtype=np.uint8)
    lens = np.array([700, 3, 0, 699, 350, 1, 700, 2, 10], np.int32)
    jc, jl = jflate._deflate_fixed_rows(mat, lens)
    monkeypatch.setattr(tflate, "_MAX_LAUNCH_ELEMS", 2 * 700)  # chunks of two rows
    tc, tl = tflate._deflate_fixed_rows(torch.from_numpy(mat), torch.from_numpy(lens))
    assert np.array_equal(tc.numpy(), jc) and np.array_equal(tl.numpy(), jl)


@pytest.mark.parametrize("n", [0, 1, 300, 24005])
def test_literal_only_compress_writes_the_reference_blob(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    st, m = tflate.CodecTierStats(), Metrics()
    blob = tflate.bgzf_compress_device(data, level=1, use_lanes=False, device=CPU, stats=st,
                                       metrics=m)
    assert blob == jflate.bgzf_compress_device(data, level=1, use_lanes=False)
    assert {k: getattr(st, k) for k in REF_STATS} == jflate.LAST_DEFLATE_STATS.as_dict()
    assert st.xla == max(1, -(-n // tflate.DEV_DEFAULT_PAYLOAD))
    assert m.get("flate.deflate.xla") == st.xla
    assert tbgzf.inflate_blocks(blob, *tbgzf.scan_blocks(blob))[0].tobytes() == data


def test_literal_only_part_surface_and_device_input_spill():
    data = np.random.default_rng(4).integers(0, 64, 2500, dtype=np.uint8)
    blob, sizes = tflate.deflate_blocks_device(data, level=6, block_payload=1000, use_lanes=False,
                                               device=CPU)
    assert blob == jflate.deflate_blocks_device(data, level=6, block_payload=1000, use_lanes=False)
    assert sizes.tolist() == tbgzf.scan_blocks(blob)[1].tolist()
    m = Metrics()
    blob2, _ = tflate.deflate_blocks_device(None, level=6, block_payload=1000, use_lanes=False,
                                            device_input=torch.from_numpy(data), metrics=m)
    assert blob2 == blob
    assert m.get("flate.deflate.device_input_spill") == 1
    assert jflate.bgzf_compress_device(None, block_payload=1000, append_terminator=False,
                                       level=6, use_lanes=False,
                                       device_input=jnp.asarray(data)) == blob


@pytest.mark.parametrize("how", ["conf_off", "env_off", "conf_on"])
def test_use_lanes_none_resolves_through_the_deflate_gate(how, monkeypatch):
    monkeypatch.delenv("HBAM_DEFLATE_LANES", raising=False)
    data = np.random.default_rng(6).integers(0, 16, 3000, dtype=np.uint8).tobytes()
    d = {DEFLATE_LANES: "true" if how == "conf_on" else "false"} if how != "env_off" else {}
    if how == "env_off":
        monkeypatch.setenv("HBAM_DEFLATE_LANES", "0")
    st = tflate.CodecTierStats()
    blob = tflate.bgzf_compress_device(data, use_lanes=None, conf=Configuration(d), device=CPU,
                                       stats=st, block_payload=1000)
    assert blob == jflate.bgzf_compress_device(data, use_lanes=None, conf=JConf(d),
                                               block_payload=1000)
    assert (st.lanes, st.xla) == ((3, 0) if how == "conf_on" else (0, 3))


@pytest.mark.parametrize("level,use_lanes", [(0, True), (1, False)],
                         ids=["stored_with_lanes", "literal_only"])
def test_default_blocking_follows_use_lanes(level, use_lanes):
    """The default member size is DEV_LZ_PAYLOAD when the lanes tier is
    asked for and DEV_DEFAULT_PAYLOAD otherwise, whatever the level."""
    data = np.random.default_rng(1).integers(0, 256, 30000, dtype=np.uint8).tobytes()
    blob = tflate.bgzf_compress_device(data, level=level, use_lanes=use_lanes, device=CPU)
    assert blob == jflate.bgzf_compress_device(data, level=level, use_lanes=use_lanes)
    want = tflate.DEV_LZ_PAYLOAD if use_lanes else tflate.DEV_DEFAULT_PAYLOAD
    assert tbgzf.scan_blocks(blob)[2][0] == min(want, 30000)


# --------------------------------------------------------------------------
# The inflate programs
# --------------------------------------------------------------------------


_TOKEN_CASES = [
    [("lit", 65)] * 4 + [("copy", 30, 2)],  # overlap: distance < length
    [("lit", 9)] + [("copy", 258, 1)],  # max length, distance 1
    [("lit", i % 256) for i in range(400)] + [("copy", 5, 398)],
    [("lit", 200), ("block",), ("lit", 250), ("copy", 7, 2)],  # two fixed blocks
    [("lit", b) for b in bytes(range(200)) * 3],  # literals, 9-bit codes
]


def test_inflate_fixed_equals_the_reference():
    raws = [tflate.encode_tokens_fixed(t) for t in _TOKEN_CASES]
    isz = [len(zlib.decompress(r, -15)) for r in raws]
    lit = tflate.encode_tokens_fixed([("lit", b) for b in range(100)])
    raws += [raws[0], tflate.encode_tokens_fixed([("lit", 1), ("copy", 4, 30)]), lit[:-6],
             _raw(b"the quick brown fox jumps over the lazy dog. " * 60, 6)]
    assert raws[-1][0] & 7 in (4, 5), "premise: zlib wrote a dynamic block"
    isz += [isz[0] + 1, 5, 100, 2700]  # wrong isize, distance before the start, truncated, dynamic
    out, ok = _both("inflate_fixed", raws, isz, 1024)
    assert ok.tolist() == [True] * 5 + [False] * 4
    for k in range(5):
        assert out[k, : isz[k]].tobytes() == zlib.decompress(raws[k], -15)
    _both("inflate_fixed", raws, isz, 1024, 4096)  # the caller's max_cbits


def test_inflate_stored_equals_the_reference():
    rng = np.random.default_rng(3)
    rnd = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
    text = bytes(range(256)) * 4
    chain = _flushed([rnd[:300], rnd[300:700], rnd[700:]], level=0)
    bad = bytearray(_raw(text, 0))
    bad[1] ^= 0xFF  # LEN no longer matches NLEN
    raws = [_raw(text, 0), chain, bytes(bad), _raw(text, 6), _raw(b"", 0)]
    out, ok = _both("inflate_stored", raws, [1024, 1500, 1024, 1024, 0], 2048)
    assert ok.tolist() == [True, True, False, False, True]
    assert out[1, :1500].tobytes() == rnd


def test_inflate_dynamic_equals_the_reference():
    rng = np.random.default_rng(11)
    text = (b"@SQ\tSN:chr7\tLN:10000\n") * 100
    tables = [bytes(rng.integers(65, 65 + k + 2, 400, dtype=np.uint8)) * 2 for k in range(3)]
    a = b"ACGTACGT" * 40
    b_ = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    c = rng.integers(65, 91, 300, dtype=np.uint8).tobytes()
    p1 = b"HELLO_WORLD_" * 40
    raws = ([_raw(text, lv) for lv in (1, 6, 9)] + [_raw(t, 6) for t in tables]
            + [_flushed([a, b_, c]), _flushed([p1, p1], level=9), _raw(b_, 0),
               tflate.encode_tokens_fixed(_TOKEN_CASES[3]), _lone_distance_code(),
               _oversubscribed_ll(), _incomplete_clc(), _raw(text, 6)[:-20]])
    isz = ([len(text)] * 3 + [800] * 3 + [len(a + b_ + c), 2 * len(p1), 300, 9, 5, 1, 1,
                                          len(text)])
    out, ok = _both("inflate_dynamic", raws, isz, 4096, ok_rows_only=True)
    assert ok.tolist() == [True] * 11 + [False] * 3
    assert out[10, :5].tobytes() == b"AAAAA"
    assert out[6, : len(a + b_ + c)].tobytes() == a + b_ + c


def test_inflate_dynamic_block_bound():
    """More blocks than ``max_blocks``: the member fails, as in the
    reference."""
    parts = [bytes([65 + k]) * 50 for k in range(6)]
    raw = _flushed(parts)
    _, ok = _both("inflate_dynamic", [raw, raw], [300, 300], 1024, 4, ok_rows_only=True)
    assert not ok.any()
    _, ok = _both("inflate_dynamic", [raw], [300], 1024, 16, ok_rows_only=True)
    assert ok.all()


# --------------------------------------------------------------------------
# Whole streams
# --------------------------------------------------------------------------


def _decompress_both(blob: bytes, conf=None, **kw):
    st, m = tflate.CodecTierStats(), Metrics()
    got = tflate.bgzf_decompress_device(blob, device=CPU, stats=st, metrics=m,
                                        conf=Configuration(conf or {}), **kw)
    want = jflate.bgzf_decompress_device(blob, conf=JConf(conf or {}), **kw)
    assert got == want
    assert {k: getattr(st, k) for k in REF_STATS} == jflate.LAST_INFLATE_STATS.as_dict()
    assert st.tierdown_crc == 0
    for k in REF_STATS:
        assert m.get(f"flate.inflate.{k}") == getattr(st, k)
    return got, st


def _many_blocks_member() -> bytes:
    """A member of 20 flushed blocks: past the dynamic program's bound of 8,
    so only the host decodes it."""
    parts = [bytes([65 + k]) * 40 for k in range(10)]
    return _frame(_flushed(parts), b"".join(parts))


def test_literal_only_round_trip():
    data = np.random.default_rng(0).integers(0, 256, 3000, dtype=np.uint8).tobytes()
    blob = tflate.bgzf_compress_device(data, block_payload=1000, use_lanes=False, device=CPU)
    got, st = _decompress_both(blob)
    assert got == data and (st.xla, st.lanes, st.host) == (3, 0, 0)
    got, st = _decompress_both(blob, _force_no_host=True)
    assert got == data


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_zlib_members_decode_on_the_device_tiers(level):
    text = b"".join(b"read%d\tchr1\t%d\t60\t100M\n" % (i, 1000 + 7 * i) for i in range(60))
    blob = b"".join(tbgzf.compress_block(text[k : k + 1000], level)
                    for k in range(0, len(text), 1000)) + tbgzf.TERMINATOR
    got, st = _decompress_both(blob, _force_no_host=True)
    assert got == text and st.xla == -(-len(text) // 1000) and st.host == 0


def test_mixed_member_kinds_and_an_empty_stream():
    rng = np.random.default_rng(5)
    d1 = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    d2 = bytes(range(100)) * 10
    d3 = rng.integers(0, 4, 2500, dtype=np.uint8).tobytes()
    blob = (tflate.bgzf_compress_device(d1, block_payload=900, append_terminator=False,
                                        use_lanes=False, device=CPU)
            + tbgzf.compress_block(d2, level=0) + tbgzf.compress_block(d3, level=6)
            + _frame(_flushed([d2[:500], d3[:300]]), d2[:500] + d3[:300])
            + tbgzf.TERMINATOR)
    got, st = _decompress_both(blob)
    assert got == d1 + d2 + d3 + d2[:500] + d3[:300]
    assert (st.xla, st.host) == (6, 0)
    assert _decompress_both(tbgzf.TERMINATOR)[0] == b""


def test_a_member_past_the_device_bound_tiers_down_to_the_host():
    member = _many_blocks_member()
    blob = tbgzf.compress_block(b"x" * 100, 6) + member + tbgzf.TERMINATOR
    got, st = _decompress_both(blob)
    assert got == b"x" * 100 + zlib.decompress(member[18:-8], -15)
    assert (st.xla, st.host) == (1, 1)
    with pytest.raises(tbgzf.BgzfError):
        tflate.bgzf_decompress_device(blob, _force_no_host=True, device=CPU)
    with pytest.raises(jbgzf.BgzfError):
        jflate.bgzf_decompress_device(blob, _force_no_host=True)


@pytest.mark.parametrize("what", ["payload", "crc"])
def test_corruption_raises(what):
    data = np.random.default_rng(1).integers(0, 256, 2000, dtype=np.uint8).tobytes()
    blob = bytearray(tflate.bgzf_compress_device(data, use_lanes=False, device=CPU))
    blob[100 if what == "payload" else len(blob) - 28 - 8] ^= 0xFF
    for force in (False, True):
        with pytest.raises(tbgzf.BgzfError):
            tflate.bgzf_decompress_device(bytes(blob), device=CPU, _force_no_host=force)
        with pytest.raises(jbgzf.BgzfError):
            jflate.bgzf_decompress_device(bytes(blob), _force_no_host=force)
    if what == "crc":
        assert tflate.bgzf_decompress_device(bytes(blob), device=CPU, check_crc=False) == data


def test_the_inflate_gate_sends_every_member_through_the_kernel_first():
    """With ``hadoopbam.inflate.lanes`` on, every member goes through the
    inflate kernel's plain version first (the reference's lanes tier in
    interpret mode); one it declines continues to the programs."""
    rng = np.random.default_rng(8)
    d1 = rng.integers(0, 8, 400, dtype=np.uint8).tobytes()
    d2 = bytes(range(50)) * 6
    blob = (tflate.bgzf_compress_device(d1, block_payload=200, append_terminator=False,
                                        use_lanes=False, device=CPU)
            + tbgzf.compress_block(d2, 6) + tbgzf.compress_block(d2, 0) + tbgzf.TERMINATOR)
    got, st = _decompress_both(blob, {INFLATE_LANES: "true"})
    assert got == d1 + d2 + d2 and (st.lanes, st.xla, st.host) == (4, 0, 0)


def test_entry_points_run_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tflate.bgzf_decompress_device(tbgzf.TERMINATOR),
                 lambda: tflate.bgzf_compress_device(b"abc", use_lanes=False),
                 lambda: tflate.bgzf_compress_device(b"abc", use_lanes=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

"""The port's BGZF inflate (hadoop_bam_tpu_torch, plain version on the CPU)
against the reference's lockstep-lane kernel in interpret mode, on the
corpus of tests/test_inflate_lanes.py.  Tolerance 0: bytes and ok verdicts
must be equal."""

import zlib

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.ops import flate as jflate
from hadoop_bam_tpu.ops.pallas.inflate_lanes import inflate_lanes
from hadoop_bam_tpu.spec import bgzf as jbgzf
from hadoop_bam_tpu_torch.ops import flate as tflate
from hadoop_bam_tpu_torch.ops.kernels import inflate as kin
from hadoop_bam_tpu_torch.spec import bgzf as tbgzf
from hadoop_bam_tpu_torch.utils.tracing import Metrics


def _raw_deflate(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(payload) + co.flush()


class _BitWriter:
    def __init__(self):
        self.bits = []

    def w(self, val, n):
        self.bits.extend((val >> k) & 1 for k in range(n))

    def code(self, c, length):
        self.bits.extend((c >> k) & 1 for k in range(length - 1, -1, -1))

    def pad_to_byte(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def bytes(self):
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (i & 7)
        return bytes(out)


def _dynamic_block_rle(bw: _BitWriter, final: bool) -> bytes:
    """Dynamic block using code-length RLE codes 16, 17 and 18; decodes to
    b"ABCDEFG" (the hand-built block of tests/test_inflate_lanes.py)."""
    bw.w(1 if final else 0, 1)
    bw.w(2, 2)
    bw.w(0, 5)
    bw.w(0, 5)
    bw.w(10, 4)
    clc_lens = {0: 3, 1: 3, 2: 2, 3: 2, 13: 2}
    for pos in range(14):
        bw.w(clc_lens.get(pos, 0), 3)
    zero, three, r18, r16, r17 = (0, 2), (1, 2), (2, 2), (6, 3), (7, 3)
    for code, extra in ((r18, (54, 7)), (three, None), (r16, (0, 2)), (r16, (0, 2)),
                        (r18, (127, 7)), (r18, (25, 7)), (r17, (7, 3)), (three, None),
                        (zero, None)):
        bw.code(*code)
        if extra:
            bw.w(*extra)
    for k in range(8):
        bw.code(k, 3)
    return bytes(range(65, 72))


def _corpus():
    """name -> (comp, isize, expected payload or None for a rejected member)."""
    rng = np.random.default_rng(3)
    c = {}
    for name, p, lvl in (
        ("level1", b"@SQ\tSN:chr7\tLN:10000\n" * 20, 1),
        ("level6", bytes(range(256)) * 2, 6),
        ("level9", (b"motif-x" * 60)[:400], 9),
        ("stored500", bytes(rng.integers(0, 256, 500, dtype=np.uint8)), 0),
        ("stored1", bytes(rng.integers(0, 256, 1, dtype=np.uint8)), 0),
    ):
        c[name] = (_raw_deflate(p, lvl), len(p), p)
    rng = np.random.default_rng(4)
    a = b"ACGTACGT" * 30
    b_ = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    cc = bytes(rng.integers(65, 91, 250, dtype=np.uint8))
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = (co.compress(a) + co.flush(zlib.Z_FULL_FLUSH) + co.compress(b_)
            + co.flush(zlib.Z_FULL_FLUSH) + co.compress(cc) + co.flush())
    c["flush_chain"] = (comp, len(a + b_ + cc), a + b_ + cc)
    bw = _BitWriter()
    p = _dynamic_block_rle(bw, final=True)
    c["rle_16_17_18"] = (bw.bytes(), len(p), p)
    bw = _BitWriter()
    p1 = _dynamic_block_rle(bw, final=False)
    p2 = bytes(np.random.default_rng(5).integers(0, 256, 90, dtype=np.uint8))
    bw.w(0, 1)
    bw.w(0, 2)
    bw.pad_to_byte()
    bw.w(len(p2), 16)
    bw.w(len(p2) ^ 0xFFFF, 16)
    for x in p2:
        bw.w(x, 8)
    p3 = b"tail-fixed-block"
    comp = bw.bytes() + jflate.encode_tokens_fixed([("lit", x) for x in p3])
    c["dynamic_stored_fixed"] = (comp, len(p1 + p2 + p3), p1 + p2 + p3)
    c["eof_member"] = (b"\x03\x00", 0, b"")
    good = b"good data here " * 25
    c["bad_btype"] = (bytes([0b111]) + _raw_deflate(good, 6)[1:], len(good), None)
    trunc = b"truncate me please " * 30
    cut = _raw_deflate(trunc, 6)
    c["truncated"] = (cut[: len(cut) // 2], len(trunc), None)
    c["wrong_isize"] = (_raw_deflate(b"x" * 50, 6), 49, None)
    bw = _BitWriter()
    bw.w(1, 1)
    bw.w(2, 2)
    bw.w(0, 5)
    bw.w(0, 5)
    bw.w(14, 4)
    for pos in range(18):
        bw.w(1 if pos in (2, 17) else 0, 3)
    for code, extra in (((0, 1), None), ((0, 1), None), ((0, 1), None),
                        ((1, 1), (127, 7)), ((1, 1), (105, 7)), ((0, 1), None)):
        bw.code(*code)
        if extra:
            bw.w(*extra)
    c["oversubscribed"] = (bw.bytes() + b"\0" * 8, 1, None)
    return c


CORPUS = _corpus()
NAMES = sorted(CORPUS)


def _pack(names):
    comps = [CORPUS[n][0] for n in names]
    isz = np.asarray([CORPUS[n][1] for n in names], np.int32)
    clens = np.asarray([len(x) for x in comps], np.int32)
    return comps, clens, isz


def _rows(names):
    comps, clens, isz = _pack(names)
    mat = np.zeros((len(comps), int(clens.max())), np.uint8)
    for i, x in enumerate(comps):
        mat[i, : len(x)] = np.frombuffer(x, np.uint8)
    return mat, clens, isz


@pytest.fixture(scope="module")
def both():
    """One reference launch (interpret mode) and one port call over the
    whole corpus."""
    comps = [CORPUS[n][0] for n in NAMES]
    mat, clens, isz = _rows(NAMES)
    j_out, j_ok = inflate_lanes(mat, clens, isz, interpret=True)

    comp_off = np.concatenate([[0], np.cumsum(clens[:-1])]).astype(np.int64)
    out_off = np.concatenate([[0], np.cumsum(isz[:-1])]).astype(np.int64)
    blob = np.frombuffer(b"".join(comps) + b"\0" * kin.COMP_PAD, np.uint8).copy()
    out = torch.zeros(int(isz.sum()), dtype=torch.uint8)
    meta = kin.inflate_members(
        torch.from_numpy(blob), torch.from_numpy(comp_off), torch.from_numpy(clens),
        torch.from_numpy(out_off), torch.from_numpy(isz), out, int(clens.max()),
    )
    return j_out, j_ok, out.numpy(), meta.numpy(), out_off


@pytest.mark.parametrize("name", NAMES)
def test_member_matches_reference_kernel(both, name):
    j_out, j_ok, t_out, t_meta, out_off = both
    i = NAMES.index(name)
    _, isize, want = CORPUS[name]
    assert bool(t_meta[i, 1]) == bool(j_ok[i]) == (want is not None)
    if want is not None:
        o = int(out_off[i])
        assert t_meta[i, 0] == isize
        assert t_out[o : o + isize].tobytes() == j_out[i, :isize].tobytes() == want


def _bgzf_blob(payloads, level=6):
    return b"".join(jbgzf.compress_block(p, level) for p in payloads)


def test_inflate_blocks_device_matches_reference_wrapper():
    """The split-read surface: the port's inflate_blocks_device on the CPU
    against the reference's (lanes tier, interpret mode), with an empty
    member in the middle; the port also returns the resident window."""
    rng = np.random.default_rng(7)
    payloads = [bytes(rng.integers(0, 256, 900, dtype=np.uint8)), b"",
                b"@HD\tVN:1.6\n" * 60, bytes(rng.integers(65, 70, 700, dtype=np.uint8))]
    blob = _bgzf_blob(payloads) + jbgzf.TERMINATOR
    co, cs, us = tbgzf.scan_blocks(blob)
    j_out, j_offs = jflate.inflate_blocks_device(blob, co, cs, us)
    m = Metrics()
    t_out, t_offs, dev = tflate.inflate_blocks_device(blob, co, cs, us, torch.device("cpu"), m)
    assert np.array_equal(j_offs, t_offs)
    assert t_out.tobytes() == j_out.tobytes() == b"".join(payloads)
    assert dev is not None and dev.numpy().tobytes() == t_out.tobytes()
    assert m.get("flate.lanes_tierdown") == 0


def test_member_tierdown_is_per_member(monkeypatch):
    """A member the kernel declines is re-decoded by host zlib and counted;
    the others keep the kernel's bytes; the window is then not resident."""
    payloads = [b"alpha " * 100, b"beta " * 120, b"gamma " * 90]
    blob = _bgzf_blob(payloads)
    co, cs, us = tbgzf.scan_blocks(blob)
    real = kin.inflate_members_plain

    def decline_second(*a):
        meta = real(*a)
        meta[1, 1] = 0
        return meta

    monkeypatch.setattr(kin, "inflate_members_plain", decline_second)
    m = Metrics()
    stats = tflate.CodecTierStats()
    out, _, dev = tflate.inflate_blocks_device(
        blob, co, cs, us, torch.device("cpu"), m, stats=stats
    )
    assert out.tobytes() == b"".join(payloads)
    assert dev is None
    assert m.get("flate.lanes_tierdown") == 1
    assert stats.as_dict() == {"lanes": 2, "xla": 0, "host": 1, "tierdown_size": 0,
                               "tierdown_vmem": 0, "tierdown_ok0": 1, "tierdown_crc": 0}


def test_crc_mismatch_tiers_down_and_raises():
    """Content corruption that keeps the DEFLATE structure valid: the CRC
    gate re-decodes on the host, which raises — as the reference does."""
    blob = bytearray(_bgzf_blob([b"good data here " * 40]))
    blob[28] ^= 0xFF
    co, cs, us = tbgzf.scan_blocks(bytes(blob))
    with pytest.raises(tbgzf.BgzfError):
        tflate.inflate_blocks_device(bytes(blob), co, cs, us, torch.device("cpu"), Metrics())
    with pytest.raises(jbgzf.BgzfError):
        jflate.inflate_blocks_device(bytes(blob), co, cs, us)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On a card: the CUDA kernel against its plain version, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run chip_smoke.py on the H100)")
    comps, clens, isz = _pack(NAMES)
    comp_off = np.concatenate([[0], np.cumsum(clens[:-1])]).astype(np.int64)
    out_off = np.concatenate([[0], np.cumsum(isz[:-1])]).astype(np.int64)
    blob = np.frombuffer(b"".join(comps) + b"\0" * kin.COMP_PAD, np.uint8).copy()
    res = []
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.from_numpy(a).to(dev)
        out = torch.zeros(int(isz.sum()), dtype=torch.uint8, device=dev)
        meta = kin.inflate_members(t(blob), t(comp_off), t(clens), t(out_off), t(isz),
                                   out, int(clens.max()))
        res.append((out.cpu().numpy(), meta.cpu().numpy()))
    (ko, km), (po, pm) = res
    assert np.array_equal(km[:, 1], pm[:, 1])
    for i in np.nonzero(pm[:, 1])[0]:
        o = int(out_off[i])
        assert np.array_equal(ko[o : o + isz[i]], po[o : o + isz[i]])


def test_inflate_lanes_entry_point_equals_the_reference(both):
    """The reference-named ``inflate_lanes`` over padded rows, host input
    on the CPU: the same ``ok`` and the same bytes of every ok member."""
    j_out, j_ok = both[:2]
    mat, clens, isz = _rows(NAMES)
    out, ok = kin.inflate_lanes(mat, clens, isz, device="cpu")
    assert out.shape == (len(NAMES), int(isz.max())) and out.dtype == np.uint8
    np.testing.assert_array_equal(ok, j_ok)
    for i in np.flatnonzero(ok):
        assert out[i, : isz[i]].tobytes() == j_out[i, : isz[i]].tobytes(), NAMES[i]


def test_inflate_lanes_ex_keeps_device_rows_only_when_every_member_is_ok():
    good = [n for n in NAMES if CORPUS[n][2] is not None]
    bad = [n for n in NAMES if CORPUS[n][2] is None]
    assert good and bad
    mat, clens, isz = _rows(good)
    out, ok, dev = kin.inflate_lanes_ex(torch.from_numpy(mat), clens, isz, keep_device=True)
    assert ok.all() and dev is not None and dev.device.type == "cpu"
    assert np.array_equal(dev.numpy(), out)
    for i, n in enumerate(good):
        assert out[i, : isz[i]].tobytes() == CORPUS[n][2]
    assert kin.inflate_lanes_ex(torch.from_numpy(mat), clens, isz)[2] is None
    mat, clens, isz = _rows(good + bad)
    out, ok, dev = kin.inflate_lanes_ex(mat, clens, isz, device="cpu", keep_device=True)
    assert dev is None and not ok.all()

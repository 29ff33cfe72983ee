"""The port's device write side (hadoop_bam_tpu_torch, plain versions on the
CPU) against the reference: CRC32 and the sorted gather against
``crc32_device``/``gather_stream_device`` (XLA on the CPU), the BGZF
compress tiers, ``write_part_fast`` and ``sort_bam`` with every write gate
on against the reference's bytes (its deflate lanes in interpret mode).
Tolerance 0 everywhere: equal bytes."""

import io
import os
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.conf import DEFLATE_LANES, INFLATE_LANES, WRITE_DEVICE
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.io import bam as jbam
from hadoop_bam_tpu.ops import flate as jflate
from hadoop_bam_tpu.ops.pallas import deflate_lanes as jdl
from hadoop_bam_tpu.ops.pallas.crc32 import crc32_device as jcrc32
from hadoop_bam_tpu.ops.pallas.gather_stream import gather_stream_device as jgather
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.conf import from_reference_conf
from hadoop_bam_tpu_torch.device_stream import DeviceStream
from hadoop_bam_tpu_torch.io import bam as tbam
from hadoop_bam_tpu_torch.ops import flate as tflate
from hadoop_bam_tpu_torch.ops.kernels import OutsideInt32Domain
from hadoop_bam_tpu_torch.ops.kernels import crc32 as kcrc
from hadoop_bam_tpu_torch.ops.kernels import deflate as kd
from hadoop_bam_tpu_torch.ops.kernels import gather as kg
from hadoop_bam_tpu_torch.spec import bgzf

CPU = torch.device("cpu")
ALL_ON = {INFLATE_LANES: "true", DEFLATE_LANES: "true", WRITE_DEVICE: "true"}


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


# --------------------------------------------------------------------------
# CRC32
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["fuzz", "blocking", "unaligned"])
def test_crc32_matches_reference_and_zlib(case):
    rng = np.random.default_rng(0)
    stream = rng.integers(0, 256, 3000, dtype=np.uint8)
    if case == "fuzz":  # empty, 1 byte, word boundary, odd tails, whole stream
        offs = np.array([0, 0, 10, 64, 100, 17, 2995, 0])
        lens = np.array([0, 1, 4, 256, 123, 33, 5, 3000])
    elif case == "blocking":  # the part writer's cuts with a short last member
        offs = np.arange(0, 3000, 1024)
        lens = np.minimum(1024, 3000 - offs)
    else:
        offs = np.array([1, 2, 3, 5, 7, 1001])
        lens = np.array([7, 15, 16, 17, 1999, 1])
    got = _u32(kcrc.crc32_device(torch.from_numpy(stream), offs, lens))
    ref = np.asarray(jcrc32(jnp.asarray(stream), offs, lens))
    want = [zlib.crc32(stream[o : o + n].tobytes()) for o, n in zip(offs, lens)]
    assert np.array_equal(got, ref)
    assert got.tolist() == want


def test_crc32_empty_stream_and_domain():
    empty = kcrc.crc32_device(torch.zeros(0, dtype=torch.uint8), [0], [0])
    assert _u32(empty).tolist() == [0]
    s = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(OutsideInt32Domain):
        kcrc.crc32_device(s, [2**31], [8])
    with pytest.raises(ValueError):
        jcrc32(jnp.zeros(16, jnp.uint8), np.array([2**31]), np.array([8]))


# --------------------------------------------------------------------------
# Sorted gather + flag patch
# --------------------------------------------------------------------------


def _toy_stream(n, seed):
    """Records with real size words and random bodies: ``(data, rec_off,
    rec_len)``."""
    rng = np.random.default_rng(seed)
    parts, offs, lens = [], [], []
    p = 0
    for _ in range(n):
        body = rng.integers(0, 256, int(rng.integers(40, 90)), dtype=np.uint8)
        parts.append(np.concatenate([np.frombuffer(len(body).to_bytes(4, "little"), np.uint8),
                                     body]))
        offs.append(p + 4)
        lens.append(len(body))
        p += 4 + len(body)
    return np.concatenate(parts), np.array(offs, np.int64), np.array(lens, np.int64)


def _toy_batch(n, seed, resident=True):
    data, off, ln = _toy_stream(n, seed)
    return tbam.RecordBatch(soa={"rec_off": off, "rec_len": ln}, data=data,
                            keys=np.arange(n, dtype=np.int64),
                            device_data=torch.from_numpy(data.copy()) if resident else None)


@pytest.mark.parametrize("with_dup", [False, True])
def test_gather_matches_reference(with_dup):
    rng = np.random.default_rng(3)
    data, off, ln = _toy_stream(24, 2)
    order = rng.permutation(len(off))
    dup = (rng.random(len(off)) < 0.4)[order] if with_dup else None
    src, lens = (off - 4)[order], (ln + 4)[order]
    got, total = kg.gather_stream_device(torch.from_numpy(data), src, lens, dup_mask=dup)
    ref, rtotal = jgather(jnp.asarray(data), src, lens, dup_mask=dup)
    assert total == rtotal and np.array_equal(got.numpy(), np.asarray(ref))
    host = tbam.gather_record_array(
        tbam.RecordBatch(soa={"rec_off": off, "rec_len": ln}, data=data, keys=off), order).copy()
    if with_dup:
        tbam.patch_flags(host, (np.cumsum(lens) - lens)[dup])
        assert not np.array_equal(host, np.asarray(jgather(jnp.asarray(data), src, lens)[0]))
    assert np.array_equal(got.numpy(), host)


def test_gather_int32_domain_declines_like_the_reference():
    data, _, _ = _toy_stream(4, 9)
    with pytest.raises(OutsideInt32Domain):
        kg.gather_stream_device(torch.from_numpy(data), [2**31], [100])
    with pytest.raises(ValueError):
        jgather(jnp.asarray(data), np.array([2**31]), np.array([100]))


def test_chunked_records_flat_residency():
    rng = np.random.default_rng(4)
    b1, b2 = _toy_batch(10, 5), _toy_batch(12, 6)
    ck = tbam.ChunkedRecords.from_batches([b1, b2], keep_device=True)
    assert ck.device_flat is not None and ck.chunk_base.tolist() == [0, len(b1.data)]
    order = rng.permutation(ck.n_records)
    src = (ck.chunk_base[ck.chunk_id] + ck.soa["rec_off"] - 4)[order]
    got, _ = kg.gather_stream_device(ck.device_flat, src, (ck.soa["rec_len"] + 4)[order])
    assert np.array_equal(got.numpy(), tbam.gather_record_array(ck, order))
    ck.release_device()
    assert ck.device_flat is None and ck.chunk_base is None


def test_partial_residency_keeps_nothing():
    b1, b2 = _toy_batch(6, 7), _toy_batch(6, 8, resident=False)
    assert tbam.ChunkedRecords.from_batches([b1, b2], keep_device=True).device_flat is None
    assert tbam.ChunkedRecords.from_batches([b1], keep_device=False).device_flat is None


# --------------------------------------------------------------------------
# BGZF compress tiers
# --------------------------------------------------------------------------


def _mixed_data():
    rng = np.random.default_rng(12)
    return ((b"@CO\tdevice-resident-writes\n" * 60)[:1400]
            + bytes(rng.integers(0, 256, 1100, dtype=np.uint8)))


def test_deflate_blocks_device_host_and_device_input_match_reference():
    data = _mixed_data()
    ref = jflate.bgzf_compress_device(data, level=1, block_payload=1024, use_lanes=True,
                                      append_terminator=False)
    st = tflate.CodecTierStats()
    host, sizes = tflate.deflate_blocks_device(data, level=1, block_payload=1024, use_lanes=True,
                                               device=CPU, stats=st)
    dev, dsizes = tflate.deflate_blocks_device(
        None, level=1, block_payload=1024, use_lanes=True,
        device_input=torch.from_numpy(np.frombuffer(data, np.uint8).copy()))
    assert host == ref and dev == ref
    assert sizes.tolist() == dsizes.tolist() == bgzf.scan_blocks(ref)[1].tolist()
    assert st.lanes == 3 and st.host == 0
    assert bgzf.inflate_blocks(ref, *bgzf.scan_blocks(ref))[0].tobytes() == data


@pytest.mark.parametrize("data", [b"", bytes(range(256)) * 20], ids=["empty", "5120_bytes"])
def test_level0_stored_members_match_reference(data):
    ref = jflate.bgzf_compress_device(data, level=0, block_payload=2048)
    assert tflate.bgzf_compress_device(data, level=0, block_payload=2048) == ref
    assert tflate.bgzf_compress_device(data, level=0) == jflate.bgzf_compress_device(data, level=0)


def test_level0_device_input_spills_to_stored_members():
    data = bytes(range(256)) * 20
    m = tflate.Metrics()
    got = tflate.bgzf_compress_device(
        level=0, block_payload=2048, device_input=torch.from_numpy(np.frombuffer(data, np.uint8).copy()),
        metrics=m)
    assert got == jflate.bgzf_compress_device(data, level=0, block_payload=2048)
    assert m.get("flate.deflate.device_input_spill") == 1


def test_lanes_tier_with_terminator_matches_reference():
    data = (b"@SQ\tSN:chr1\tLN:12345\n" * 150)[:3000]
    ref = jflate.bgzf_compress_device(data, level=6, use_lanes=True)
    assert tflate.bgzf_compress_device(data, level=6, use_lanes=True, device=CPU) == ref


def test_geometry_tierdown_goes_to_host_zlib_like_the_reference(monkeypatch):
    data = b"tier down please " * 300
    monkeypatch.setattr(jdl, "_VMEM_BUDGET_BYTES", 1 << 10)
    monkeypatch.setattr(kd, "VMEM_BUDGET_BYTES", 1 << 10)
    ref = jflate.bgzf_compress_device(data, level=1, block_payload=24000, use_lanes=True)
    st, m = tflate.CodecTierStats(), tflate.Metrics()
    got = tflate.bgzf_compress_device(data, level=1, block_payload=24000, use_lanes=True,
                                      device=CPU, stats=st, metrics=m)
    assert got == ref
    assert st.tierdown_vmem == 1 and st.lanes == 0 and st.host == 1
    assert m.get("flate.deflate_lanes_tierdown") == 1 and m.get("flate.deflate.tierdown_vmem") == 1


def test_literal_only_tier_is_not_ported():
    """The literal-only tier (``use_lanes=False`` at a level above 0)
    writes the reference's blob: deflate_fixed on the device, the default
    24,000-byte blocking."""
    data = np.random.default_rng(12).integers(0, 256, 30000, dtype=np.uint8).tobytes()
    blob = tflate.bgzf_compress_device(data, level=1, use_lanes=False, device=CPU)
    assert blob == jflate.bgzf_compress_device(data, level=1, use_lanes=False)
    assert tflate.deflate_lanes_accepts(57088) == jflate.deflate_lanes_accepts(57088)


# --------------------------------------------------------------------------
# Part writes
# --------------------------------------------------------------------------


def _ref_batch(b):
    return jbam.RecordBatch(soa=dict(b.soa), data=b.data, keys=b.keys,
                            device_data=jnp.asarray(b.data))


def test_write_part_device_matches_reference_and_host_lanes():
    """Sorted, duplicate-marked part with an inline .splitting-bai: the
    port's device path equals the reference's device path and the port's
    own host gather + lanes path, blob and index."""
    rng = np.random.default_rng(10)
    b = _toy_batch(30, 11)
    order = rng.permutation(b.n_records)
    dup = rng.random(b.n_records) < 0.3
    outs = {}
    for name, kw in (("device", dict(device_write=True)),
                     ("host_lanes", dict(device_write=False, device_deflate=True))):
        stream = DeviceStream(CPU)
        f, sb = io.BytesIO(), io.BytesIO()
        tbam.write_part_fast(f, b, order=order, level=1, dup_mask=dup, splitting_bai_stream=sb,
                             device_stream=stream, **kw)
        outs[name] = (f.getvalue(), sb.getvalue(), stream.metrics)
    jf, jsb = io.BytesIO(), io.BytesIO()
    jbam.write_part_fast(jf, _ref_batch(b), order=order, level=1, device_write=True,
                         dup_mask=dup, splitting_bai_stream=jsb)
    assert outs["device"][:2] == outs["host_lanes"][:2] == (jf.getvalue(), jsb.getvalue())
    m = outs["device"][2]
    assert m.get("bam.device_write_parts") == 1
    assert m.get("bam.duplicate_flags_patched") == int(dup.sum())
    assert outs["host_lanes"][2].get("bam.device_write_parts") == 0


def test_write_part_without_residency_tiers_down_with_reason():
    b = _toy_batch(8, 13, resident=False)
    stream = DeviceStream(CPU)
    out = io.BytesIO()
    tbam.write_part_fast(out, b, level=1, device_write=True, device_deflate=False,
                         device_stream=stream)
    assert stream.metrics.get("bam.device_write_tierdown.no_residency") == 1
    f = io.BytesIO()
    tbam.write_part_fast(f, b, level=1)
    assert out.getvalue() == f.getvalue()  # the host zlib part


def test_write_part_past_int32_domain_tiers_down_size(monkeypatch):
    from hadoop_bam_tpu_torch import device_stream as ds

    def refuse(*a, **k):
        raise OutsideInt32Domain("gather geometry outside the int32 domain")

    monkeypatch.setattr(ds, "gather_stream_device", refuse)
    b = _toy_batch(8, 14)
    stream = DeviceStream(CPU)
    a, h = io.BytesIO(), io.BytesIO()
    tbam.write_part_fast(a, b, level=1, device_write=True, device_deflate=True,
                         device_stream=stream)
    tbam.write_part_fast(h, b, level=1, device_write=False, device_deflate=True,
                         device_stream=DeviceStream(CPU))
    assert stream.metrics.get("bam.device_write_tierdown.size") == 1
    assert a.getvalue() == h.getvalue()


# --------------------------------------------------------------------------
# sort_bam with every write gate on
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_bam(tmp_path_factory):
    from test_torch_sort_bam import _write_bam

    p = str(tmp_path_factory.mktemp("dw") / "in.bam")
    _write_bam(p, n=40, block_payload=256, seed=16)
    return p


@pytest.mark.parametrize("split_size", [1 << 20, 1024], ids=["one_split", "two_splits"])
def test_sort_bam_all_write_gates_match_reference(small_bam, tmp_path, split_size):
    t_out, j_out = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    st = tpipeline.sort_bam(small_bam, t_out, conf=from_reference_conf(ALL_ON), device="cpu",
                            device_parse=True, level=1, split_size=split_size,
                            write_splitting_bai=True)
    jpipeline.sort_bam(small_bam, j_out, conf=JConf(ALL_ON), device_parse=True, level=1,
                       split_size=split_size, write_splitting_bai=True)
    for suffix in ("", ".splitting-bai"):
        with open(t_out + suffix, "rb") as a, open(j_out + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    c = st.counters
    assert st.n_records == 40 and c["flate.deflate.lanes"] > 0
    if st.n_splits == 1:
        assert c["bam.device_write_parts"] == 1
    else:
        assert c["bam.device_write_tierdown.no_residency"] == st.n_splits
    assert not os.path.exists(t_out + ".tmp")


@pytest.mark.cuda
def test_write_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rng = np.random.default_rng(20)
    data, off, ln = _toy_stream(200, 21)
    order = rng.permutation(len(off))
    dup = rng.random(len(off)) < 0.3
    src, lens = (off - 4)[order], (ln + 4)[order]
    g, _ = kg.gather_stream_device(torch.from_numpy(data).cuda(), src, lens, dup_mask=dup)
    p, _ = kg.gather_stream_device(torch.from_numpy(data), src, lens, dup_mask=dup)
    assert torch.equal(g.cpu(), p)
    offs = np.arange(0, len(p), 1000)
    cl = np.minimum(1000, len(p) - offs)
    assert np.array_equal(_u32(kcrc.crc32_device(g, offs, cl).cpu()),
                          _u32(kcrc.crc32_device(p, offs, cl)))


# --------------------------------------------------------------------------
# A.15: the port keeps a split's window past 128 members (ROADMAP C)
# --------------------------------------------------------------------------


def test_one_split_past_128_members_writes_from_residency_where_the_reference_gathers(tmp_path):
    """A one-split sort of a BAM of more than 128 members and no spill, every
    gate on, through both packages: the same bytes; the reference drops the
    window (one 128-lane launch cannot hold the split) and gathers on the
    host, the port writes the part from the resident window (row 1 has no
    lane cap).  The pin of the standing deviation."""
    from hadoop_bam_tpu.utils.tracing import delta, snapshot
    from test_torch_sort_bam import _write_bam

    src = str(tmp_path / "in.bam")
    _write_bam(src, n=140, block_payload=32, seed=17)
    with open(src, "rb") as f:
        members = len(bgzf.scan_block_infos(f.read()))
    assert members > 129  # the header's member and the EOF besides
    t_out, j_out = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    st = tpipeline.sort_bam(src, t_out, conf=from_reference_conf(ALL_ON), device="cpu",
                            device_parse=True, level=1, split_size=1 << 24,
                            write_splitting_bai=True)
    before = snapshot()
    jpipeline.sort_bam(src, j_out, conf=JConf(ALL_ON), device_parse=True, level=1,
                       split_size=1 << 24, write_splitting_bai=True)
    jc = delta(before)["counters"]
    for suffix in ("", ".splitting-bai"):
        with open(t_out + suffix, "rb") as a, open(j_out + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    assert st.n_splits == 1 and st.n_records == 140
    assert jc.get("bam.device_write_tierdown.no_residency", 0) == 1
    assert jc.get("bam.device_write_parts", 0) == 0
    assert st.counters.get("bam.device_write_parts", 0) == 1
    assert st.counters.get("bam.device_write_tierdown.no_residency", 0) == 0

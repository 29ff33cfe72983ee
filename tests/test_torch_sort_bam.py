"""The port's in-core coordinate sort on the CPU against the reference's
``sort_bam`` with the inflate lanes and the device parse on (interpret
mode) and the write side's device tiers off.  Output BAMs and
``.splitting-bai`` files must be byte-identical."""

import os

import numpy as np
import pytest

from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.conf import DEFLATE_LANES, INFLATE_LANES, WRITE_DEVICE
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.conf import from_reference_conf
from hadoop_bam_tpu_torch.spec import bam, bgzf

LANES = {INFLATE_LANES: "true", DEFLATE_LANES: "false", WRITE_DEVICE: "false"}
HOST = {INFLATE_LANES: "false", DEFLATE_LANES: "false", WRITE_DEVICE: "false"}


def _write_bam(path, n=150, block_payload=256, seed=11):
    """Unsorted BAM of small records in small members: mapped reads, placed
    and unplaced unmapped reads, mapped reads at pos -1."""
    rng = np.random.default_rng(seed)
    header = bam.BamHeader(
        "@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:c1\tLN:1048576\n@SQ\tSN:c2\tLN:1048576",
        [("c1", 1 << 20), ("c2", 1 << 20)],
    )
    recs = []
    for i in range(n):
        k = i % 10
        if k == 0:
            recs.append(bam.build_record(f"u{i}", -1, -1, 0, 4, [], "ACGT", bytes([20] * 4)))
        elif k == 1:
            recs.append(bam.build_record(
                f"p{i}", 1, int(rng.integers(0, 900)), 0, 4, [], "ACGT", bytes([20] * 4)))
        elif k == 2:
            recs.append(bam.build_record(f"n{i}", 0, -1, 60, 0, [], "ACG", bytes([20] * 3)))
        else:
            recs.append(bam.build_record(
                f"m{i}", int(rng.integers(0, 2)), int(rng.integers(0, 900)), 60,
                16 * (i % 2), [(6, "M")], "ACGTAC", bytes([30] * 6)))
    with open(path, "wb") as f:
        f.write(bgzf.deflate_blocks(header.encode(), level=1)[0])
        f.write(bgzf.deflate_blocks(b"".join(recs), level=1, block_payload=block_payload)[0])
        f.write(bgzf.TERMINATOR)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("sort") / "in.bam")
    _write_bam(p)
    return p


def _both(src, out_dir, conf, device_parse, **kw):
    t_out = os.path.join(out_dir, "port.bam")
    j_out = os.path.join(out_dir, "ref.bam")
    st = tpipeline.sort_bam(src, t_out, conf=from_reference_conf(conf), device="cpu",
                            device_parse=device_parse, level=1, **kw)
    jst = jpipeline.sort_bam(src, j_out, conf=JConf(conf), device_parse=device_parse,
                             level=1, **kw)
    return st, jst, t_out, j_out


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.mark.parametrize(
    "split_size,splitting_bai",
    [(1024, False), (1024, True), (1 << 20, False), (700, True)],
)
def test_device_path_matches_reference(src, tmp_path, split_size, splitting_bai):
    st, jst, t_out, j_out = _both(src, str(tmp_path), LANES, True,
                                  split_size=split_size, write_splitting_bai=splitting_bai)
    assert st.n_records == jst.n_records == 150
    assert st.n_splits == jst.n_splits
    assert st.backend == jst.backend == "device-parse"
    assert _read(t_out) == _read(j_out)
    if splitting_bai:
        assert _read(t_out + ".splitting-bai") == _read(j_out + ".splitting-bai")
    assert st.counters.get("flate.lanes_tierdown", 0) == 0
    assert st.counters["flate.inflate.lanes"] > 0


def test_host_path_matches_reference(src, tmp_path):
    st, jst, t_out, j_out = _both(src, str(tmp_path), HOST, False, split_size=1024)
    assert st.backend == "single-device"
    assert _read(t_out) == _read(j_out)


def test_resort_with_splitting_bai_input(src, tmp_path):
    """Sorting a BAM that has a .splitting-bai plans splits from the index."""
    sorted_in = str(tmp_path / "sorted.bam")
    tpipeline.sort_bam(src, sorted_in, conf=from_reference_conf(LANES), device="cpu",
                       device_parse=True, level=1, split_size=1024,
                       write_splitting_bai=True)
    assert os.path.exists(sorted_in + ".splitting-bai")
    out = str(tmp_path / "again")
    os.makedirs(out)
    st, jst, t_out, j_out = _both(sorted_in, out, LANES, True, split_size=900,
                                  write_splitting_bai=True)
    assert st.n_splits == jst.n_splits > 1
    assert _read(t_out) == _read(j_out)
    assert _read(t_out + ".splitting-bai") == _read(j_out + ".splitting-bai")


def test_output_is_sorted_and_complete(src, tmp_path):
    from hadoop_bam_tpu_torch.io.bam import SORT_FIELDS, read_header_voffset, read_virtual_range

    out = str(tmp_path / "o.bam")
    tpipeline.sort_bam(src, out, conf=from_reference_conf(LANES), device="cpu",
                       device_parse=True, level=1, split_size=1024)
    res = []
    for p in (src, out):
        hdr, v0 = read_header_voffset(p)
        data = bytearray(_read(p))
        b = read_virtual_range(data, v0, (len(data) << 16) | 0xFFFF, fields=SORT_FIELDS)
        recs = sorted(
            bytes(b.data[o - 4 : o + n]) for o, n in zip(b.soa["rec_off"], b.soa["rec_len"])
        )
        res.append((hdr, b.keys, recs))
    assert res[1][0].text.startswith("@HD\tVN:1.6\tSO:coordinate")
    assert np.all(np.diff(res[1][1]) >= 0)
    assert res[0][2] == res[1][2]


def test_device_count_mismatch_raises(src, tmp_path, monkeypatch):
    """A device walk that disagrees with the host walk raises instead of
    falling back to host keys."""
    from hadoop_bam_tpu_torch.ops.kernels import chain as kch

    real = kch.record_chain_plain

    def short_walk(stream, n_bytes):
        offs, meta = real(stream, n_bytes)
        meta[0] -= 1
        return offs, meta

    monkeypatch.setattr(kch, "record_chain_plain", short_walk)
    with pytest.raises(RuntimeError, match="disagrees with the host walk"):
        tpipeline.sort_bam(src, str(tmp_path / "x.bam"), conf=from_reference_conf(LANES),
                           device="cpu", device_parse=True, split_size=1024)

"""The port's ``ingest_fastq`` on the CPU against the reference's, byte for
byte and with equal ``IngestStats``, on corpora under 3 KiB (the oversized
member case excepted); and the port's ``ingest_oracle`` against the
reference's oracle."""

import dataclasses
import gzip
import random

import numpy as np
import pytest
from test_ingest import _gz_members, make_fastq

from hadoop_bam_tpu import ingest as jing
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.spec.fragment import FormatException as JFormatException
from hadoop_bam_tpu_torch import ingest as ting
from hadoop_bam_tpu_torch.conf import (DEFLATE_LANES, FASTQ_BASE_QUALITY_ENCODING,
                                        FASTQ_FILTER_FAILED_QC, INGEST_CHUNK_BYTES,
                                        INGEST_DEVICE_SCAN, INGEST_SCAN_OVERLAP, Configuration)
from hadoop_bam_tpu_torch.device_stream import DeviceStream
from hadoop_bam_tpu_torch.spec import bgzf
from hadoop_bam_tpu_torch.spec.fragment import FormatException

SMALL_SCAN = {INGEST_CHUNK_BYTES: "256", INGEST_SCAN_OVERLAP: "256", INGEST_DEVICE_SCAN: "true"}


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(tmp_path, inputs, conf=None, **kw):
    """Run the reference and the port on the same inputs and conf; assert
    equal bytes and equal stats; return the port's stats."""
    conf = conf or {}
    want, got = tmp_path / "want.bam", tmp_path / "got.bam"
    sj = jing.ingest_fastq(inputs, str(want), conf=JConf(conf), level=4, **kw)
    st = ting.ingest_fastq(inputs, str(got), conf=Configuration(conf), level=4, device="cpu", **kw)
    assert _read(got) == _read(want)
    assert st.counts() == dataclasses.asdict(sj)
    assert set(st.seconds) == {"decode", "scan", "collate", "write"}
    return st


def _pe(tmp_path, n=40, seed=0):
    r1 = make_fastq(n, seed=seed, qual_at_every=5, name="q")
    r2 = make_fastq(n, seed=seed + 1, qual_at_every=7, name="q")
    return [_write(tmp_path / "r1.fastq.gz", _gz_members(r1)),
            _write(tmp_path / "r2.fastq.gz", _gz_members(r2))]


def test_paired_multi_member_gzip(tmp_path):
    st = _both(tmp_path, _pe(tmp_path))
    assert st.n_records == 80 and st.n_pairs == 40 and st.n_repacked == st.n_members > 2
    assert st.counters["ingest.inflate.repacked"] == st.n_repacked
    assert st.counters["collate.pairs"] == 40


def test_bgzf_input(tmp_path):
    text = make_fastq(30, seed=3, qual_at_every=4)
    blob, _ = bgzf.deflate_blocks(text, level=5, block_payload=700)
    p = _write(tmp_path / "r.fastq.bgz", blob + bgzf.TERMINATOR)
    st = _both(tmp_path, p)
    assert st.n_records == 30 and st.n_repacked == 0 and st.n_members == len(text) // 700 + 2


def test_oversized_gzip_member_inflates_on_the_host(tmp_path):
    big = (b"@r0\n" + b"A" * 40000 + b"\n+\n" + b"I" * 40000 + b"\n") * 2
    p = _write(tmp_path / "big.fastq.gz", gzip.compress(big, 1) + _gz_members(make_fastq(5)))
    st = _both(tmp_path, p)
    assert st.n_host_members == 1 and st.n_repacked >= 1
    assert st.counters["ingest.inflate.host_members"] == 1


def test_uncompressed_single_end(tmp_path):
    st = _both(tmp_path, _write(tmp_path / "plain.fastq", make_fastq(15, seed=21)))
    assert st.n_records == 15 and st.n_singletons == 15 and st.n_members == 0


def test_illumina_qualities(tmp_path):
    rng = random.Random(5)
    recs = []
    for i in range(10):
        ln = rng.randrange(6, 20)
        seq = "".join(rng.choice("ACGT") for _ in range(ln))
        qual = "".join(chr(rng.randrange(64, 104)) for _ in range(ln))
        recs.append(f"@i{i}\n{seq}\n+\n{qual}\n")
    p = _write(tmp_path / "ill.fastq", "".join(recs).encode())
    _both(tmp_path, p, conf={FASTQ_BASE_QUALITY_ENCODING: "illumina"})
    illumina = _read(tmp_path / "got.bam")
    _both(tmp_path, p)  # read as Sanger: other qualities, other bytes
    assert _read(tmp_path / "got.bam") != illumina


def test_casava_ids_with_filter_failed_qc(tmp_path):
    rng = random.Random(8)
    texts = []
    for mate in (1, 2):
        recs = []
        for i in range(16):
            seq = "".join(rng.choice("ACGT") for _ in range(12))
            filt = "Y" if i % 5 == 0 else "N"
            recs.append(f"@M1:7:FC{i % 2}:1:{1101 + i % 3}:{1000 + 37 * (15 - i)}:{200 + i} "
                        f"{mate}:{filt}:0:ACGT\n{seq}\n+\n{'I' * 12}\n")
        texts.append("".join(recs).encode())
    paths = [_write(tmp_path / "c1.fastq.gz", _gz_members(texts[0], 300)),
             _write(tmp_path / "c2.fastq.gz", _gz_members(texts[1], 300))]
    st = _both(tmp_path, paths, conf={FASTQ_FILTER_FAILED_QC: "true"})
    assert st.n_filtered == 8 and st.n_records == 24 and st.n_pairs == 12
    _both(tmp_path, paths)


def test_small_chunk_conf_runs_the_scan_tiers(tmp_path):
    """256-byte claims with the device scan on, on both sides: the plain
    version of the kernel against the reference's interpret-mode kernel,
    counters included."""
    text = make_fastq(30, seed=13, qual_at_every=4)
    p = _write(tmp_path / "t.fastq.gz", gzip.compress(text, 5))
    st = _both(tmp_path, p, conf=SMALL_SCAN)
    assert st.scan_chunks > 1 and st.scan_lanes > 0 and st.scan_serial == 0
    assert st.counters["fastq.scan.lanes"] == st.scan_lanes
    assert st.counters["ingest.scan.resident_runs"] == 1  # one run: the inflate output in place


def test_memory_budget_spill(tmp_path):
    paths = _pe(tmp_path, seed=3)
    st = _both(tmp_path, paths, memory_budget=256, part_dir=str(tmp_path / "spill"))
    incore = tmp_path / "incore.bam"
    ting.ingest_fastq(paths, str(incore), level=4, device="cpu")
    assert _read(incore) == _read(tmp_path / "got.bam") and st.n_records == 80


def _corrupt(tmp_path):
    text = make_fastq(40, seed=9)
    members = [gzip.compress(text[k: k + 500], 5) for k in range(0, len(text), 500)]
    bad = bytearray(members[1])
    for j in range(14, 26):
        bad[j] ^= 0xFF
    return _write(tmp_path / "corrupt.fastq.gz", b"".join([members[0], bytes(bad)] + members[2:]))


def test_salvage_of_a_corrupt_member(tmp_path):
    p = _corrupt(tmp_path)
    for conf in ({}, SMALL_SCAN):
        st = _both(tmp_path, p, conf=conf, errors="salvage")
        assert st.n_quarantined_members == 1 and 0 < st.n_records < 40


def test_salvage_of_a_corrupt_bgzf_member(tmp_path):
    text = make_fastq(30, seed=6)
    blob, sizes = bgzf.deflate_blocks(text, level=5, block_payload=400)
    at = int(sizes[0]) + int(sizes[1]) + 30
    bad = bytearray(blob)
    for j in range(at, at + 8):
        bad[j] ^= 0x5A
    p = _write(tmp_path / "bad.fastq.bgz", bytes(bad) + bgzf.TERMINATOR)
    st = _both(tmp_path, p, errors="salvage")
    assert st.n_quarantined_members >= 1


def test_strict_mode_raises_format_exception(tmp_path):
    p = _corrupt(tmp_path)
    with pytest.raises(JFormatException):
        jing.ingest_fastq(p, str(tmp_path / "j.bam"), level=4)
    with pytest.raises(FormatException):
        ting.ingest_fastq(p, str(tmp_path / "t.bam"), level=4, device="cpu")
    torn = _write(tmp_path / "torn.fastq", b"@a\nACGT\n+\nIII\n@b\nGG\n+\nJJ\n")
    with pytest.raises(FormatException):
        ting.ingest_fastq(torn, str(tmp_path / "t.bam"), device="cpu")
    r1 = _write(tmp_path / "u1.fastq", make_fastq(5))
    r2 = _write(tmp_path / "u2.fastq", make_fastq(4))
    with pytest.raises(FormatException, match="unequal"):
        ting.ingest_fastq(r1, str(tmp_path / "t.bam"), r2=r2, device="cpu")


@pytest.mark.parametrize("flush_members", [1, 3, 256])
def test_batched_writer_equals_per_record_writes(tmp_path, flush_members):
    """The port's writer hands many members to each deflate call; its bytes
    equal the reference writer's, which compresses every member as it
    fills."""
    rng = np.random.default_rng(flush_members)
    pieces = [bytes(rng.integers(0, 4, int(rng.integers(1, 300)), dtype=np.uint8))
              for _ in range(120)]
    with open(tmp_path / "j.bin", "wb") as fh:
        w = jing._BlockedUbamWriter(fh, None, 4, block_payload=1000)
        for p in pieces:
            w.write(p)
        w.close()
    stream = DeviceStream(__import__("torch").device("cpu"))
    with open(tmp_path / "t.bin", "wb") as fh:
        w = ting._BlockedUbamWriter(fh, stream.deflate_stream, 4, block_payload=1000,
                                    flush_members=flush_members)
        for p in pieces:
            w.write(p)
        w.close()
    assert _read(tmp_path / "t.bin") == _read(tmp_path / "j.bin")
    assert w.out_bytes == len(_read(tmp_path / "t.bin"))


def test_deflate_lanes_write_the_same_payload(tmp_path):
    """With the deflate lanes armed the reference cannot write (its writer
    asks the device codec for 65,280-byte members, past its 57,088-byte
    cap, and hands it bytes as a 0-d array); the port cuts members at the
    cap and writes the lanes-off file's payload (ROADMAP C)."""
    paths = _pe(tmp_path, n=12, seed=4)
    with pytest.raises(Exception):
        jing.ingest_fastq(paths, str(tmp_path / "j.bam"), conf=JConf({DEFLATE_LANES: "true"}))
    on, off = tmp_path / "on.bam", tmp_path / "off.bam"
    st = ting.ingest_fastq(paths, str(on), conf=Configuration({DEFLATE_LANES: "true"}),
                           device="cpu")
    ting.ingest_fastq(paths, str(off), device="cpu")

    def payload(p):
        data = _read(p)
        return bgzf.inflate_blocks(data, *bgzf.scan_blocks(data))[0].tobytes()

    assert payload(on) == payload(off) and _read(on) != _read(off)
    assert st.counters["flate.deflate.lanes"] >= 1 and st.counters["device_stream.deflates"] >= 1


@pytest.mark.parametrize("errors", ["strict", "salvage"])
def test_oracle_matches_the_reference_oracle(tmp_path, errors):
    paths = _pe(tmp_path, n=20, seed=11) if errors == "strict" else [_corrupt(tmp_path)]
    conf = {FASTQ_FILTER_FAILED_QC: "false"}
    nj = jing.ingest_oracle(paths, str(tmp_path / "j.bam"), conf=JConf(conf), level=4,
                            errors=errors)
    nt = ting.ingest_oracle(paths, str(tmp_path / "t.bam"), conf=Configuration(conf), level=4,
                            errors=errors)
    assert nt == nj > 0
    assert _read(tmp_path / "t.bam") == _read(tmp_path / "j.bam")
    st = ting.ingest_fastq(paths, str(tmp_path / "i.bam"), level=4, device="cpu", errors=errors)
    assert _read(tmp_path / "i.bam") == _read(tmp_path / "t.bam") and st.n_records == nt


def test_gzip_member_probe_steps_through_large_members():
    """The member probe feeds zlib 64 KiB at a time: payload and compressed
    size equal a one-shot decompress, across step boundaries; a truncated
    or corrupt member raises zlib.error."""
    import zlib

    rng = np.random.default_rng(2)
    a = bytes(rng.integers(0, 256, 200_000, dtype=np.uint8))  # csize > 3 steps
    b = make_fastq(20)
    blob = gzip.compress(a, 1) + gzip.compress(b, 6)
    out, csize = ting._inflate_gzip_member(blob, 0)
    assert out == a and csize == len(gzip.compress(a, 1))
    out, c2 = ting._inflate_gzip_member(blob, csize)
    assert out == b and csize + c2 == len(blob)
    with pytest.raises(zlib.error):
        ting._inflate_gzip_member(blob[: csize - 9], 0)
    bad = bytearray(blob)
    bad[csize + 30] ^= 0xFF
    with pytest.raises(zlib.error):
        ting._inflate_gzip_member(bytes(bad), csize)

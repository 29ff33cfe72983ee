"""The port's index formats against the JAX reference, on the CPU.

``build_splitting_bai`` (against the reference's walk, and against the
``.splitting-bai`` the port's own sort writes), ``SplittingBaiBuilder``'s
incremental form, ``.bgzfi`` (``BgzfBlockIndex``: bytes and navigation),
``Tabix`` (load and queries, on a ``.tbi`` the VCF tests' writer builds:
no tabix binary is needed), and ``guess_bgzf_block_start``.  The corpora
come from numpy seeds; every comparison is exact.
"""

import io

import numpy as np
import pytest

from hadoop_bam_tpu.io import guesser as jguesser
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.spec import indices as jidx
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.io import guesser as tguesser
from hadoop_bam_tpu_torch.spec import bgzf as tbgzf
from hadoop_bam_tpu_torch.spec import indices as tidx
from test_torch_vcf import CONTIGS, bgzf_bytes, vcf_text, write_tbi

REFS = [("chr1", 1 << 24), ("chr2", 1 << 22)]


def _bam(n: int, seed: int, block: int = 2_500) -> bytes:
    """An unsorted BAM of ``n`` records the JAX package builds, re-blocked
    into members of ``block`` payload bytes, so records straddle members."""
    rng = np.random.default_rng(seed)
    hdr = jbam.BamHeader("@HD\tVN:1.6\n" + "".join(f"@SQ\tSN:{c}\tLN:{n}\n" for c, n in REFS),
                         list(REFS))
    recs = []
    for i in range(n):
        L = int(rng.integers(20, 80))
        unm = rng.random() < 0.1
        refid = -1 if unm else int(rng.integers(0, 2))
        recs.append(jbam.build_record(
            f"r{i}", refid, -1 if unm else int(rng.integers(0, 1 << 20)), 30, 4 if unm else 0,
            [] if unm else [(L, "M")], "A" * L, bytes([30] * L)).encode())
    payload = hdr.encode() + b"".join(recs)
    return tbgzf.deflate_blocks(payload, block_payload=block)[0] + tbgzf.TERMINATOR


@pytest.fixture(scope="module")
def bam_bytes():
    return _bam(2_300, 4)


@pytest.mark.parametrize("g", [1, 2, 10, 100, 4096])
def test_build_splitting_bai_equals_the_reference(bam_bytes, g):
    """The offline index of a BAM whose records straddle members: the
    reference's offsets and bytes, and the incremental builder's."""
    t = tidx.build_splitting_bai(bam_bytes, granularity=g)
    j = jidx.build_splitting_bai(bam_bytes, granularity=g)
    assert t.voffsets == j.voffsets
    ts, js = io.BytesIO(), io.BytesIO()
    t.save(ts)
    j.save(js)
    assert ts.getvalue() == js.getvalue()
    inc = tidx.SplittingBaiBuilder(g)  # fed every record's offset
    for v in tidx.build_splitting_bai(bam_bytes, granularity=1).voffsets[:-1]:
        inc.process_alignment(v)
    assert inc.finish(len(bam_bytes)).voffsets == t.voffsets
    assert t.size() == len([i for i in range(2_300) if i == 0 or (i + 1) % g == 0]) + 1


def test_build_splitting_bai_of_a_truncated_bam_raises(bam_bytes):
    co = tbgzf.scan_blocks(bam_bytes)[0]
    cut = bam_bytes[: int(co[-2])] + tbgzf.TERMINATOR  # the last member's records cut
    with pytest.raises(tbgzf.BgzfError):
        tidx.build_splitting_bai(cut)
    with pytest.raises(Exception):
        jidx.build_splitting_bai(cut)


def test_build_splitting_bai_equals_the_sort_written_index(tmp_path):
    """A one-part sort's ``.splitting-bai`` (written by the part writer,
    merged after the header) is the offline index of its output."""
    src = tmp_path / "in.bam"
    src.write_bytes(_bam(5_000, 9, block=60_000))
    out = str(tmp_path / "out.bam")
    st = tpipeline.sort_bam(str(src), out, device="cpu", write_splitting_bai=True)
    assert st.n_splits == 1
    with open(out + tidx.SPLITTING_BAI_EXT, "rb") as f:
        written = tidx.SplittingBai.load(f.read())
    offline = tidx.build_splitting_bai(out)
    assert written.voffsets == offline.voffsets == jidx.build_splitting_bai(out).voffsets
    assert written.size() == 3  # alignment 0, alignment 4095, the file size


@pytest.mark.parametrize("g", [1, 2, 3, 1024])
def test_bgzfi_bytes_and_navigation_equal_the_reference(g):
    payload = bytes(range(256)) * 2000
    buf = io.BytesIO()
    w = tbgzf.BgzfWriter(buf, append_terminator=False)
    w.write(payload)
    w.close()
    blob = buf.getvalue()
    t = tidx.BgzfBlockIndex.build(blob, granularity=g)
    j = jidx.BgzfBlockIndex.build(blob, granularity=g)
    ts, js = io.BytesIO(), io.BytesIO()
    t.save(ts)
    j.save(js)
    assert ts.getvalue() == js.getvalue() and t.size() == j.size()
    assert tidx.BgzfBlockIndex.load(ts.getvalue()).offsets == t.offsets
    for pos in (0, 1, t.offsets[min(1, len(t.offsets) - 1)], len(blob) - 1, len(blob), len(blob) + 5):
        assert t.prev_block(pos) == j.prev_block(pos)
        assert t.next_block(pos) == j.next_block(pos)
    with pytest.raises(IOError):
        tidx.BgzfBlockIndex.load(b"\x00" * 7)


@pytest.fixture(scope="module")
def tbi():
    raw = bgzf_bytes(vcf_text(seed=8, n=4000))
    return raw, write_tbi(raw)


def test_tabix_loads_like_the_reference(tbi, tmp_path):
    raw, idx = tbi
    p = tmp_path / "x.vcf.bgz.tbi"
    p.write_bytes(idx)
    t, j = tidx.Tabix.load(str(p)), jidx.Tabix.load(idx)
    assert t.names == j.names == [c for c, _ in CONTIGS]
    assert (t.fmt, t.col_seq, t.col_beg, t.col_end, t.meta_char, t.skip) == \
        (j.fmt, j.col_seq, j.col_beg, j.col_end, j.meta_char, j.skip) == (2, 1, 2, 0, "#", 0)
    for name in ("chr1", "11", "1", "chrX"):
        assert t.ref_id(name) == j.ref_id(name)
    # the uncompressed form loads too
    plain = tbgzf.inflate_blocks(idx, *tbgzf.scan_blocks(idx))[0].tobytes()
    assert tidx.Tabix.load(plain).names == t.names
    with pytest.raises(IOError):
        tidx.Tabix.load(b"XXXX" + plain[4:])


def test_tabix_queries_equal_the_reference(tbi):
    """Seeded windows on every contig (and an unknown one): the reference's
    merged chunk spans; a whole-contig query starts at its first line."""
    raw, idx = tbi
    t, j = tidx.Tabix.load(idx), jidx.Tabix.load(idx)
    rng = np.random.default_rng(2)
    for name, ln in CONTIGS + [("chrX", 1000)]:
        for _ in range(40):
            beg = int(rng.integers(0, ln))
            end = beg + int(rng.integers(1, 200_000))
            assert [(c.beg, c.end) for c in t.query(name, beg, end)] == \
                [(c.beg, c.end) for c in j.query(name, beg, end)]
    spans = t.query("chr2", 0, 1 << 29)
    r = tbgzf.BgzfReader(raw)
    r.seek_voffset(spans[0].beg)
    assert r.read(5) == b"chr2\t"
    assert t.query("chrX", 0, 1000) == []


def test_guess_bgzf_block_start_equals_the_reference(bam_bytes):
    """Every window of the BAM, and the same with a member's CRC broken
    (the guess steps past a block that fails to inflate)."""
    co = tbgzf.scan_blocks(bam_bytes)[0].tolist()
    bad = bytearray(bam_bytes)
    bad[co[3] + 20] ^= 0xFF
    for data in (bam_bytes, bytes(bad)):
        for beg in list(range(0, len(data), 997)) + [co[3], co[3] + 1]:
            for span in (1, 3_000, 70_000):
                assert tguesser.guess_bgzf_block_start(data, beg, beg + span) == \
                    jguesser.guess_bgzf_block_start(data, beg, beg + span)
    assert tguesser.guess_bgzf_block_start(bytes(bad), co[3], co[3] + 1) is None

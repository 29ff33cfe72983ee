"""The port's record-at-a-time BAM writer (``io/bam.BamOutputWriter``, with
``gather_record_bytes``), the BGZF writer's virtual offsets and the
reference's list form of the block scan (``spec/bgzf.BlockInfo``,
``scan_block_infos``), the part-file helpers (``utils/nio.PARTS_GLOB``,
``delete_recursive``), ``spec/bam.SOA_NCOLS`` and the package exports,
against the reference.  Tolerance 0: the ``.bam`` and ``.splitting-bai``
bytes are equal under every flag combination."""

import io
import itertools

import numpy as np
import pytest

from hadoop_bam_tpu.io import bam as jio
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.spec import bgzf as jbgzf
from hadoop_bam_tpu.spec import indices as jindices
from hadoop_bam_tpu.utils import nio as jnio
from hadoop_bam_tpu_torch.io import bam as tio
from hadoop_bam_tpu_torch.spec import bam as tbam
from hadoop_bam_tpu_torch.spec import bgzf as tbgzf
from hadoop_bam_tpu_torch.spec import indices as tindices
from hadoop_bam_tpu_torch.utils import nio as tnio
from test_torch_chain_keys import _stream

HEADER_TEXT = "@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:c1\tLN:1000\n@SQ\tSN:c2\tLN:5000"
REFS = [("c1", 1000), ("c2", 5000)]


def _records(n=3000, seed=3):
    """Record bodies of a seeded stream: enough bytes for several members
    at the writer's 65,280-byte blocking."""
    a = _stream(n, seed)
    offs = jbam.record_offsets(a, 0)
    return a, offs, [a[o + 4: o + 4 + int.from_bytes(a[o: o + 4].tobytes(), "little")].tobytes()
                     for o in offs]


STREAM, OFFS, BODIES = _records()


def _write(pkg_io, pkg_bam, how, flags, granularity, level):
    hdr = pkg_bam.BamHeader(HEADER_TEXT, REFS)
    out, sb = io.BytesIO(), io.BytesIO()
    write_header, terminator, splitting = flags
    w = pkg_io.BamOutputWriter(out, hdr, write_header=write_header, append_terminator=terminator,
                               write_splitting_bai=splitting, splitting_bai_stream=sb,
                               granularity=granularity, level=level)
    with w:
        if how == "record":
            for body in BODIES[:300]:
                w.write_record(pkg_bam.decode_record(len(body).to_bytes(4, "little") + body)[0])
        elif how == "raw":
            for body in BODIES:
                w.write_raw(body)
        else:
            soa = pkg_bam.soa_decode(STREAM, OFFS)
            batch = pkg_io.RecordBatch(soa=soa, data=STREAM, keys=np.zeros(len(OFFS), np.int64))
            order = None if how == "batch" else np.random.default_rng(4).permutation(len(OFFS))
            w.write_batch(batch, order=order)
    return out.getvalue(), sb.getvalue()


@pytest.mark.parametrize("flags", list(itertools.product([True, False], repeat=3)),
                         ids=lambda f: "-".join(k for k, v in zip(("hdr", "eof", "sbai"), f) if v)
                         or "none")
@pytest.mark.parametrize("how", ["raw", "record", "batch", "batch_order"])
def test_writer_bytes_equal_the_reference(flags, how):
    got = _write(tio, tbam, how, flags, granularity=64, level=1)
    want = _write(jio, jbam, how, flags, granularity=64, level=1)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert bool(got[1]) == flags[2]
    if flags[0] and flags[1] and how != "record":
        assert len(tbgzf.scan_block_infos(got[0])) >= 4  # three members and the EOF


@pytest.mark.parametrize("granularity", [1, 4096])
def test_splitting_bai_equals_the_index_of_the_written_file(granularity):
    bam_bytes, sb = _write(tio, tbam, "raw", (True, True, True), granularity, level=6)
    want = io.BytesIO()
    tindices.build_splitting_bai(bam_bytes, granularity=granularity).save(want)
    assert sb == want.getvalue()
    assert sb == _write(jio, jbam, "raw", (True, True, True), granularity, level=6)[1]


def test_close_takes_the_given_file_size_for_the_index():
    hdr = tbam.BamHeader(HEADER_TEXT, REFS)
    jhdr = jbam.BamHeader(HEADER_TEXT, REFS)
    outs = []
    for pkg, h in ((tio, hdr), (jio, jhdr)):
        out, sb = io.BytesIO(), io.BytesIO()
        w = pkg.BamOutputWriter(out, h, write_header=False, append_terminator=False,
                                write_splitting_bai=True, splitting_bai_stream=sb)
        for body in BODIES[:50]:
            w.write_raw(body)
        w.close(file_size_for_index=123_456)
        outs.append((out.getvalue(), sb.getvalue()))
    assert outs[0] == outs[1]
    assert tindices.SplittingBai.load(io.BytesIO(outs[0][1])).voffsets[-1] == 123_456 << 16


def test_gather_record_bytes_as_the_reference():
    soa = tbam.soa_decode(STREAM, OFFS)
    order = np.random.default_rng(5).permutation(len(OFFS))
    t = tio.RecordBatch(soa=soa, data=STREAM, keys=np.zeros(len(OFFS), np.int64))
    j = jio.RecordBatch(soa=jbam.soa_decode(STREAM, OFFS), data=STREAM,
                        keys=np.zeros(len(OFFS), np.int64))
    for o in (None, order):
        got = tio.gather_record_bytes(t, o)
        assert isinstance(got, bytes) and got == jio.gather_record_bytes(j, o)
    assert tio.gather_record_bytes(t) == STREAM.tobytes()


def test_chunked_batch_writes_the_records_of_its_batches():
    soa = tbam.soa_decode(STREAM, OFFS)
    half = len(OFFS) // 2
    cut = int(OFFS[half])
    parts = [STREAM[:cut].copy(), STREAM[cut:].copy()]
    batches = [tio.RecordBatch(soa=tbam.soa_decode(p, jbam.record_offsets(p, 0)), data=p,
                               keys=np.zeros(0, np.int64)) for p in parts]
    chunked = tio.ChunkedRecords.from_batches(batches)
    order = np.random.default_rng(6).permutation(len(OFFS))
    hdr = tbam.BamHeader(HEADER_TEXT, REFS)
    a, b = io.BytesIO(), io.BytesIO()
    with tio.BamOutputWriter(a, hdr) as w:
        w.write_batch(chunked, order=order)
    with tio.BamOutputWriter(b, hdr) as w:
        w.write_batch(tio.RecordBatch(soa=soa, data=STREAM, keys=np.zeros(0, np.int64)),
                      order=order)
    assert a.getvalue() == b.getvalue()


def _voffsets_and_bytes(pkg):
    out, marks = io.BytesIO(), []
    with pkg.BgzfWriter(out, level=1) as w:
        for body in BODIES:
            marks.append(w.tell_voffset())
            w.write(body)
    return marks, out.getvalue()


def test_bgzf_writer_voffsets_and_block_infos_as_the_reference():
    (tm, tb), (jm, jb) = _voffsets_and_bytes(tbgzf), _voffsets_and_bytes(jbgzf)
    assert tm == jm and tb == jb and tm[0] == 0 and tm[-1] > 1 << 16
    infos = tbgzf.scan_block_infos(tb)
    assert [(i.coffset, i.csize, i.usize) for i in infos] == \
        [(i.coffset, i.csize, i.usize) for i in jbgzf.scan_blocks(jb)]
    assert infos[-1].usize == 0 and isinstance(infos[0], tbgzf.BlockInfo)
    co, cs, us = tbgzf.scan_blocks(tb)
    assert [i.coffset for i in infos] == co.tolist() and [i.usize for i in infos] == us.tolist()
    with pytest.raises(AttributeError):
        infos[0].csize = 1  # frozen, as the reference's


def test_part_glob_and_delete_recursive_as_the_reference(tmp_path):
    assert tnio.PARTS_GLOB == jnio.PARTS_GLOB
    d = tmp_path / "out"
    (d / "sub").mkdir(parents=True)
    for name in ("part-r-00000", "part-m-00001", "_SUCCESS", "x.txt"):
        (d / name).write_bytes(b"x")
    assert sorted(p.name for p in d.glob(tnio.PARTS_GLOB)) == ["part-m-00001", "part-r-00000"]
    tnio.delete_recursive(d)
    assert not d.exists()
    tnio.delete_recursive(d)  # idempotent, as the reference's
    jnio.delete_recursive(d)


def test_soa_ncols_and_package_exports():
    import hadoop_bam_tpu.io as jpkg_io
    import hadoop_bam_tpu.utils as jpkg_utils
    import hadoop_bam_tpu_torch as tpkg
    import hadoop_bam_tpu_torch.io as tpkg_io
    import hadoop_bam_tpu_torch.ops as tpkg_ops
    import hadoop_bam_tpu_torch.utils as tpkg_utils
    from hadoop_bam_tpu_torch.conf import Configuration
    from hadoop_bam_tpu_torch.io.merger import merge_bam_parts

    assert tbam.SOA_NCOLS == jbam.SOA_NCOLS == len(tbam.SOA_FIELDS) == 13
    assert tpkg.Configuration is Configuration
    assert tpkg_io.BamOutputWriter is tio.BamOutputWriter
    assert tpkg_io.merge_bam_parts is merge_bam_parts
    for name in ("FileVirtualSplit", "BamSplitGuesser", "BamInputFormat", "BamOutputWriter",
                 "merge_bam_parts"):
        assert hasattr(jpkg_io, name) and hasattr(tpkg_io, name), name
    for name in ("murmurhash3_bytes", "murmurhash3_chars", "Interval", "parse_intervals"):
        assert hasattr(jpkg_utils, name) and hasattr(tpkg_utils, name), name
    assert tpkg_utils.murmurhash3_chars("read1") == jpkg_utils.murmurhash3_chars("read1")
    assert tpkg_utils.parse_intervals("c1:1-10") == [tpkg_utils.Interval("c1", 1, 10)]
    for name in ("cigar", "decode", "keys", "sort", "quality"):
        assert getattr(tpkg_ops, name).__name__ == f"hadoop_bam_tpu_torch.ops.{name}"
    assert jindices.DEFAULT_GRANULARITY == tindices.DEFAULT_GRANULARITY

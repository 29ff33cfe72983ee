"""FASTQ and QSEQ input and output of the port against the reference, on
the CPU.

The cases are the reference's ``tests/test_fastq_qseq.py`` (``TestFastq``,
``TestQseq``, ``TestQualityHelpers``, ``TestResyncRegression``,
``TestQseqFilterFlags``, and of ``TestPairedPathologies`` the census and
salvage cases that ``test_torch_ingest.py`` lacks).  Each runs the same
bytes through both packages: the batches (names, padded seq/qual arrays,
lengths, per-record fragments), the written bytes and the exceptions
(class name and message) are equal.
"""

import dataclasses
import io

import numpy as np
import pytest

from hadoop_bam_tpu import ingest as jing
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.io import fastq as jfastq
from hadoop_bam_tpu.io import qseq as jqseq
from hadoop_bam_tpu.io.splits import ByteSplit as JByteSplit
from hadoop_bam_tpu.spec import fragment as jfragment
from hadoop_bam_tpu_torch import ingest as ting
from hadoop_bam_tpu_torch.conf import Configuration
from hadoop_bam_tpu_torch.io import fastq, qseq
from hadoop_bam_tpu_torch.io.splits import ByteSplit
from hadoop_bam_tpu_torch.spec import fragment
from test_fastq_qseq import ILLUMINA_FASTQ, ONE_FASTQ, QSEQ_LINE
from test_fastq_qseq import TestResyncRegression as _Resync

FASTQ = (fastq.FastqInputFormat, jfastq.FastqInputFormat)
QSEQ = (qseq.QseqInputFormat, jqseq.QseqInputFormat)
ILLUMINA_IN = {"hbam.fastq-input.base-quality-encoding": "illumina"}


def _fragments(batch):
    return [dataclasses.asdict(f) for f in batch.fragments]


def batch_from(fmts, data: bytes, start=0, end=None, conf=None):
    """The split ``[start, end)`` of ``data`` read by the port and the
    reference with the same conf; asserts the batches equal and returns the
    port's."""
    end = len(data) if end is None else end
    got = fmts[0](Configuration(conf)).read_split(ByteSplit("<mem>", start, end - start),
                                                  data=data)
    want = fmts[1](JConf(conf)).read_split(JByteSplit("<mem>", start, end - start), data=data)
    assert got.n_records == want.n_records
    assert got.names == want.names
    for col in ("seq", "qual", "lengths"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    np.testing.assert_array_equal(got.valid_mask(), want.valid_mask())
    assert _fragments(got) == _fragments(want)
    return got


def raises_alike(call_port, call_ref):
    """Both raise: the same class name and message."""
    with pytest.raises(Exception) as want:
        call_ref()
    with pytest.raises(Exception) as got:
        call_port()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    return got.value


def read_raises(fmts, data, conf=None):
    return raises_alike(
        lambda: fmts[0](Configuration(conf)).read_split(ByteSplit("<mem>", 0, len(data)),
                                                        data=data),
        lambda: fmts[1](JConf(conf)).read_split(JByteSplit("<mem>", 0, len(data)), data=data))


class TestFastq:
    def test_basic_record(self):
        b = batch_from(FASTQ, ONE_FASTQ)
        assert b.n_records == 1
        assert b.names[0].startswith("ERR020229.10880")
        assert b.fragments[0].read == 1  # /1 suffix
        assert len(b.fragments[0].sequence) == 91

    def test_illumina_id_parse(self):
        f = batch_from(FASTQ, ILLUMINA_FASTQ).fragments[0]
        assert (f.instrument, f.run_number, f.flowcell_id) == ("EAS139", 136, "FC706VJ")
        assert (f.lane, f.tile, f.xpos, f.ypos) == (2, 2104, 15343, 197393)
        assert (f.read, f.filter_passed, f.control_number, f.index_sequence) == (
            1, True, 18, "ATCACG")

    def test_illumina_then_slash_rule_is_stateful(self):
        """Once an ID misses the Casava pattern, the rest of the batch takes
        the ``/N`` rule only."""
        data = ILLUMINA_FASTQ + b"@plain/2\nAC\n+\nII\n" + ILLUMINA_FASTQ
        frags = batch_from(FASTQ, data).fragments
        assert [f.instrument for f in frags] == ["EAS139", None, None]
        assert [f.read for f in frags] == [1, 2, None]

    def test_split_resync_mid_record(self):
        data = ONE_FASTQ * 5
        cut = len(ONE_FASTQ) + 30
        assert (batch_from(FASTQ, data, 0, cut).n_records
                + batch_from(FASTQ, data, cut).n_records) == 5

    @pytest.mark.parametrize("cut_frac", [0.1, 0.33, 0.5, 0.77])
    def test_exactly_once_any_cut(self, cut_frac):
        data = ONE_FASTQ * 20
        cut = int(len(data) * cut_frac)
        assert (batch_from(FASTQ, data, 0, cut).n_records
                + batch_from(FASTQ, data, cut).n_records) == 20

    def test_quality_at_plus_tricky_resync(self):
        rec = b"@id1\nACGT\n+\n@@@@\n@id2\nTTTT\n+\nHHHH\n"
        assert batch_from(FASTQ, rec, 6).names == ["id2"]

    def test_illumina_encoding_conversion(self):
        illumina = b"@r\nAC\n+\n" + bytes([64 + 30, 64 + 2]) + b"\n"
        b = batch_from(FASTQ, illumina, conf=ILLUMINA_IN)
        assert b.fragments[0].quality == bytes([33 + 30, 33 + 2])

    @pytest.mark.parametrize("data, conf", [
        (b"@r\nAC\n+\n" + bytes([5, 33]) + b"\n", None),
        (b"@r\nAC\n+\n" + bytes([64, 33]) + b"\n", ILLUMINA_IN),
        (b"@r\nAC\n+\nII\nXr\nAC\n+\nII\n", None),
        (b"@r\nAC\n-\nII\n", None),
        (b"@r\nAC\n+\nII\n@s\nAC\n", None),
    ], ids=["sanger_range", "illumina_range", "bad_start", "bad_plus", "truncated"])
    def test_malformed_input_raises_alike(self, data, conf):
        err = read_raises(FASTQ, data, conf)
        assert isinstance(err, fragment.FormatException)

    def test_unknown_encoding_raises_alike(self):
        conf = {"hbam.fastq-input.base-quality-encoding": "solexa"}
        read_raises(FASTQ, ILLUMINA_FASTQ, conf)
        read_raises(QSEQ, QSEQ_LINE + b"\n", {"hbam.qseq-input.base-quality-encoding": "x"})

    @pytest.mark.parametrize("key", ["hbam.fastq-input.filter-failed-qc",
                                     "hbam.input.filter-failed-qc"])
    def test_filter_failed_qc(self, key):
        data = (b"@m:1:f:1:1:10:10 1:Y:0:\nAA\n+\nII\n"
                b"@m:1:f:1:1:10:11 1:N:0:\nCC\n+\nII\n")
        b = batch_from(FASTQ, data, conf={key: "true"})
        assert b.n_records == 1 and b.fragments[0].sequence == b"CC"

    @pytest.mark.parametrize("encoding", [None, "illumina"])
    def test_output_roundtrip_with_id_reconstruction(self, encoding):
        conf = {"hbam.fastq-output.base-quality-encoding": encoding} if encoding else None
        data = ILLUMINA_FASTQ + b"@plain/2\nAC\n+\nII\n"
        b = batch_from(FASTQ, data)
        jb = jfastq.FastqInputFormat().read_split(JByteSplit("<mem>", 0, len(data)), data=data)
        out, jout = io.BytesIO(), io.BytesIO()
        fastq.FastqOutputFormat(Configuration(conf)).write(out, b)
        jfastq.FastqOutputFormat(JConf(conf)).write(jout, jb)
        assert out.getvalue() == jout.getvalue()
        assert out.getvalue().startswith(
            b"@EAS139:136:FC706VJ:2:2104:15343:197393 1:N:18:ATCACG\n")
        back = batch_from(FASTQ, out.getvalue(), conf=ILLUMINA_IN if encoding else None)
        assert back.fragments[0].instrument == "EAS139"
        assert [f.sequence for f in back.fragments] == [f.sequence for f in b.fragments]

    def test_unknown_output_encoding_raises_alike(self):
        conf = {"hbam.fastq-output.base-quality-encoding": "x"}
        raises_alike(lambda: fastq.FastqOutputFormat(Configuration(conf)),
                     lambda: jfastq.FastqOutputFormat(JConf(conf)))

    def test_first_record_position(self):
        data = ONE_FASTQ * 3
        for start in range(0, len(data), 17):
            end = min(start + 100, len(data))
            assert (fastq.FastqInputFormat().position_at_first_record(data, start, end)
                    == jfastq.FastqInputFormat().position_at_first_record(data, start, end))

    def test_get_splits_default_size(self, tmp_path):
        p = tmp_path / "a.fastq"
        p.write_bytes(ONE_FASTQ * 60000)
        got = fastq.FastqInputFormat().get_splits([str(p)])
        want = jfastq.FastqInputFormat().get_splits([str(p)])
        assert [(s.start, s.length) for s in got] == [(s.start, s.length) for s in want]
        assert len(got) > 1 and got[0].length == 4 << 20


class TestQseq:
    def test_parse_line(self):
        (key, frag), (jkey, jfrag) = qseq.parse_qseq_line(QSEQ_LINE), jqseq.parse_qseq_line(
            QSEQ_LINE)
        assert key == jkey == "EAS139:136:2:5:1000:12850:1"
        assert dataclasses.asdict(frag) == dataclasses.asdict(jfrag)
        assert frag.sequence == b"ATCACGNTTAC" and frag.index_sequence is None
        assert frag.filter_passed is True

    def test_read_split_converts_illumina_default(self):
        b = batch_from(QSEQ, QSEQ_LINE + b"\n")
        assert b.n_records == 1 and b.fragments[0].quality == bytes([33 + 30] * 11)

    @pytest.mark.parametrize("line", [b"only\tthree\tfields", QSEQ_LINE + b"\textra"],
                             ids=["three", "twelve"])
    def test_malformed_field_count(self, line):
        raises_alike(lambda: qseq.parse_qseq_line(line), lambda: jqseq.parse_qseq_line(line))
        read_raises(QSEQ, line + b"\n")

    @pytest.mark.parametrize("conf", [None, {"hbam.qseq-input.base-quality-encoding": "sanger"}])
    def test_quality_out_of_range_raises_alike(self, conf):
        bad = QSEQ_LINE.replace(bytes([64 + 30]), bytes([31]), 1)
        read_raises(QSEQ, bad + b"\n", conf)

    def test_exactly_once_across_cut(self):
        data = (QSEQ_LINE + b"\n") * 10
        for cut in (len(QSEQ_LINE) + 10, 1, len(data) // 2):
            assert (batch_from(QSEQ, data, 0, cut).n_records
                    + batch_from(QSEQ, data, cut).n_records) == 10

    @pytest.mark.parametrize("encoding", [None, "sanger"])
    def test_writer_roundtrip(self, encoding):
        conf = {"hbam.qseq-output.base-quality-encoding": encoding} if encoding else None
        b = batch_from(QSEQ, QSEQ_LINE + b"\n")
        jb = jqseq.QseqInputFormat().read_split(JByteSplit("<mem>", 0, len(QSEQ_LINE) + 1),
                                               data=QSEQ_LINE + b"\n")
        out, jout = io.BytesIO(), io.BytesIO()
        qseq.QseqOutputFormat(Configuration(conf)).write(out, b)
        jqseq.QseqOutputFormat(JConf(conf)).write(jout, jb)
        assert out.getvalue() == jout.getvalue()
        _, frag2 = qseq.parse_qseq_line(out.getvalue().rstrip(b"\n"))
        assert frag2.sequence == b.fragments[0].sequence
        assert b"ATCACG." in out.getvalue()


class TestQualityHelpers:
    def test_convert_and_verify(self):
        q = bytes([64, 90, 110])
        s = fragment.convert_quality(q, "illumina", "sanger")
        assert s == jfragment.convert_quality(q, "illumina", "sanger") == bytes([33, 59, 79])
        for qual, enc in ((s, "sanger"), (bytes([5]), "sanger"), (q, "illumina"),
                          (bytes([64, 127]), "illumina")):
            assert fragment.verify_quality(qual, enc) == jfragment.verify_quality(qual, enc)
        assert fragment.convert_quality(s, "sanger", "illumina") == q
        for args in ((bytes([30]), "illumina", "sanger"), (bytes([20]), "sanger", "illumina"),
                     (q, "illumina", "illumina"), (q, "sanger", "solexa")):
            raises_alike(lambda: fragment.convert_quality(*args),
                         lambda: jfragment.convert_quality(*args))
        raises_alike(lambda: fragment.verify_quality(q, "x"),
                     lambda: jfragment.verify_quality(q, "x"))

    def test_batch_tensors(self):
        b = batch_from(FASTQ, ONE_FASTQ + ILLUMINA_FASTQ)
        assert b.seq.shape[0] == 2 and b.seq.dtype == np.uint8
        mask = b.valid_mask()
        assert mask[0].sum() == 91 and mask[1].sum() == 9

    def test_from_fragments(self):
        frags = [fragment.SequencedFragment(b"ACGT", b"IIII", read=1),
                 fragment.SequencedFragment(b"AC", b"#I")]
        jfrags = [jfragment.SequencedFragment(b"ACGT", b"IIII", read=1),
                  jfragment.SequencedFragment(b"AC", b"#I")]
        b = fragment.FragmentBatch.from_fragments(["a", "b"], frags)
        jb = jfragment.FragmentBatch.from_fragments(["a", "b"], jfrags)
        for col in ("seq", "qual", "lengths"):
            np.testing.assert_array_equal(getattr(b, col), getattr(jb, col))
        assert b.names == jb.names and _fragments(b) == _fragments(jb)
        assert str(frags[0]) == str(jfrags[0]) == "ACGT\tIIII"
        empty = fragment.FragmentBatch(np.zeros((2, 0), np.uint8), np.zeros((2, 0), np.uint8),
                                       np.zeros(2, np.int32))
        assert empty.names == ["", ""] and _fragments(empty) == [
            dataclasses.asdict(fragment.SequencedFragment())] * 2


class TestResyncRegression:
    def test_corrupt_prefix_resyncs_past_fake_record(self):
        data = _Resync.CORRUPT_PREFIX
        assert batch_from(FASTQ, data, 2).names == ["real1", "real2"]

    def test_a_lone_verified_frame_is_not_trusted(self):
        """A frame that verifies but is not followed by a second one (here a
        torn line) is skipped: both records must verify."""
        data = (b"XX\n@fake\nAAAA\n+\nBBBB\nGARBAGE\n"
                b"@real1\nACGT\n+\nIIII\n@real2\nTTTT\n+\nJJJJ\n")
        assert batch_from(FASTQ, data, 1).names == ["real1", "real2"]

    def test_single_record_at_eof_is_waived(self):
        data = b"XX\n@only\nACGT\n+\nIIII\n"
        assert batch_from(FASTQ, data, 1).names == ["only"]

    def test_quality_at_same_length_every_cut(self):
        data = b"".join(b"@id%d\nACGT\n+\n@@@@\n" % i for i in range(8))
        for cut in range(1, len(data)):
            n = batch_from(FASTQ, data, 0, cut).n_records + batch_from(FASTQ, data, cut).n_records
            assert n == 8, f"cut={cut}"


class TestPairedPathologies:
    """The paired ingest cases ``test_torch_ingest.py`` lacks: the census of
    pairs and orphans, and unequal R1/R2 under salvage."""

    @staticmethod
    def _both(tmp_path, tag, r1: bytes, r2: bytes, **kw):
        p1, p2 = tmp_path / f"{tag}_1.fastq", tmp_path / f"{tag}_2.fastq"
        p1.write_bytes(r1)
        p2.write_bytes(r2)
        want, got = tmp_path / f"{tag}_want.bam", tmp_path / f"{tag}_got.bam"
        sj = jing.ingest_fastq(str(p1), str(want), r2=str(p2), level=1, **kw)
        st = ting.ingest_fastq(str(p1), str(got), r2=str(p2), level=1, device="cpu", **kw)
        assert got.read_bytes() == want.read_bytes()
        assert st.counts() == dataclasses.asdict(sj)
        return st

    @pytest.mark.parametrize("tag, r1, r2", [
        ("slash", b"@q0/1\nACGT\n+\nIIII\n@q1/1\nTTTT\n+\nJJJJ\n",
         b"@q0/2\nGGGG\n+\nKKKK\n@q1/2\nCCCC\n+\nLLLL\n"),
        ("casava", b"@q0 1:N:0:AC\nACGT\n+\nIIII\n@q1 1:N:0:AC\nTTTT\n+\nJJJJ\n",
         b"@q0 2:N:0:AC\nGGGG\n+\nKKKK\n@q1 2:N:0:AC\nCCCC\n+\nLLLL\n"),
    ])
    def test_slash_suffix_and_casava_agree_on_read_numbers(self, tmp_path, tag, r1, r2):
        st = self._both(tmp_path, tag, r1, r2)
        assert st.n_records == 4 and st.n_pairs == 2 and st.n_orphans == 0

    def test_orphan_census(self, tmp_path):
        r1 = b"".join(b"@q%d/1\nACGT\n+\nIIII\n" % i for i in range(3))
        r2 = b"@q0/2\nGGGG\n+\nKKKK\n@q1/2\nCCCC\n+\nLLLL\n@z9/2\nAAAA\n+\nMMMM\n"
        st = self._both(tmp_path, "o", r1, r2)
        assert (st.n_records, st.n_pairs, st.n_orphans) == (6, 2, 2)

    def test_unequal_r1_r2_salvage_truncates(self, tmp_path):
        r1 = b"".join(b"@p%d/1\nACGT\n+\nIIII\n" % i for i in range(5))
        r2 = b"".join(b"@p%d/2\nGGGG\n+\nKKKK\n" % i for i in range(3))
        st = self._both(tmp_path, "u", r1, r2, errors="salvage")
        assert st.n_records == 6 and st.n_tail_records == 2


class TestQseqFilterFlags:
    def test_filter_failed_qc_conf_drops_zero_flag(self):
        data = QSEQ_LINE + b"\n" + QSEQ_LINE[:-1] + b"0\n"
        b = batch_from(QSEQ, data)
        assert b.n_records == 2
        assert [f.filter_passed for f in b.fragments] == [True, False]
        b2 = batch_from(QSEQ, data, conf={"hbam.qseq-input.filter-failed-qc": "true"})
        assert b2.n_records == 1 and b2.fragments[0].filter_passed is True

    def test_generic_input_filter_key_also_applies(self):
        b = batch_from(QSEQ, QSEQ_LINE[:-1] + b"0\n",
                       conf={"hbam.input.filter-failed-qc": "true"})
        assert b.n_records == 0

"""SAM text input of the port against the JAX reference, on the CPU.

The tag codec and the line codec (``spec/sam``), the vectorized parse
(``io/sam_vec``: the port keeps the NumPy tier only and must write the
reference's bytes, whose native tier is the default), ``SamInputFormat``
splits and reads, ``SamOutputWriter``, AnySAM sniffing and dispatch, and
``sort_bam`` / ``markdup_bam`` / ``fixmate_bam`` on a ``.sam`` against the
reference's job on the BAM of the same records (the reference cannot read a
SAM header in ``sort_bam``: its header reader takes BGZF).  The corpora come
from numpy and ``random`` seeds; every comparison is exact.
"""

import io
import os
import random

import numpy as np
import pytest

from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.io import anysam as janysam
from hadoop_bam_tpu.io import sam as jiosam
from hadoop_bam_tpu.io import sam_vec as jsv
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.spec import bgzf as jbgzf
from hadoop_bam_tpu.spec import sam as jsam
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.conf import ANYSAM_TRUST_EXTS, Configuration
from hadoop_bam_tpu_torch.io import anysam as tanysam
from hadoop_bam_tpu_torch.io import sam as tiosam
from hadoop_bam_tpu_torch.io import sam_vec as tsv
from hadoop_bam_tpu_torch.io.text import SplitLineReader
from hadoop_bam_tpu_torch.spec import bam as tbam
from hadoop_bam_tpu_torch.spec import sam as tsam

HDR = (
    "@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:chr1\tLN:248956422\n"
    "@SQ\tSN:chr2\tLN:242193529\n@SQ\tSN:chrM\tLN:16569"
)
REFS = [("chr1", 248956422), ("chr2", 242193529), ("chrM", 16569)]
T_HEADER = tbam.BamHeader(HDR, list(REFS))
J_HEADER = jbam.BamHeader(HDR, list(REFS))


def rich_corpus(n=3000, seed=0):
    """The reference's corpus (``tests/test_sam_vec.py``): lines covering
    '*' fields, every CIGAR and tag shape, unmapped reads."""
    random.seed(seed)
    lines = []
    for i in range(n):
        kind = i % 10
        name = f"read{i}" if kind != 3 else "*"
        flag = random.choice([0, 4, 16, 99, 147, 1024 + 4])
        rname = "*" if flag & 4 and kind % 2 else random.choice(["chr1", "chr2", "chrM"])
        pos = 0 if rname == "*" else random.randint(1, 1 << 27)
        cig = {5: "*", 6: "30M5I10D5S", 7: "100M"}.get(kind, "50M")
        if kind == 8:
            seq, qual = "*", "*"
        else:
            L = {6: 50, 7: 100}.get(kind, 50)
            seq = "".join(random.choice("ACGTNacgt") for _ in range(L))
            qual = "*" if kind == 4 else "".join(chr(random.randint(33, 73)) for _ in range(L))
        tags = {
            1: ["NM:i:3", "MD:Z:50", "AS:i:-12"],
            2: ["XX:A:q", "YY:i:300000", "ZZ:i:70000", "BQ:Z:hello:world"],
            9: ["XF:f:3.25", "XG:f:" + repr(random.random()), "XB:B:c,1,-2,3",
                "XS:B:S,1,65535", "XI:B:I", "NM:i:0"],
        }.get(kind, [])
        lines.append("\t".join(
            [name, str(flag), rname, str(pos), str(random.randint(0, 254)), cig,
             random.choice(["=", "*", "chr1"]), str(random.randint(0, 1 << 27)),
             str(random.randint(-(1 << 20), 1 << 20)), seq, qual] + tags))
    return lines


def oracle_blob(lines):
    """The reference's exact per-line parser, encoded."""
    return b"".join(jsam.sam_line_to_record(l, J_HEADER).encode() for l in lines)


def _sam_bytes(lines) -> bytes:
    return (HDR + "\n" + "\n".join(lines) + "\n").encode()


def _records(seed: int, n: int):
    """Records the JAX package's ``build_record`` makes from a numpy seed:
    mapped, placed-unmapped and unplaced reads, every tag type."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        kind = int(rng.integers(0, 5))
        refid = int(rng.integers(0, 3)) if kind != 4 else -1
        pos = int(rng.integers(0, 16000)) if refid >= 0 else -1
        flag = 4 if kind >= 3 else int(rng.choice([0, 16, 99, 147]))
        L = int(rng.integers(2, 60))  # one base of quality 9 would print as "*"
        seq = "".join("ACGTN"[int(k)] for k in rng.integers(0, 5, L))
        qual = bytes(rng.integers(0, 41, L).astype(np.uint8)) if kind != 2 else b""
        cigar = [] if flag & 4 else [(L, "M")] if kind else [(2, "S"), (L - 2, "M")] if L > 2 else [(L, "M")]
        tags = b"".join([
            jsam._encode_tag("NM", "i", str(int(rng.integers(0, 6)))),
            jsam._encode_tag("AS", "i", str(int(rng.integers(-70000, 70000)))),
            jsam._encode_tag("XZ", "Z", f"v{i}"),
            jsam._encode_tag("XA", "A", "Q"),
            jsam._encode_tag("XF", "f", "1.5"),
            jsam._encode_tag("XB", "B", "s,-3,300"),
        ][: int(rng.integers(0, 7))])
        mate = int(rng.integers(-1, 3))
        recs.append(jbam.build_record(
            f"q{i}", refid, pos, int(rng.integers(0, 61)), flag, cigar, seq, qual,
            next_refid=mate, next_pos=int(rng.integers(-1, 16000)) if mate >= 0 else -1,
            tlen=int(rng.integers(-500, 500)), tags=tags))
    return recs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A ``.sam`` the JAX package's ``write_sam`` writes and its BAM twin."""
    td = tmp_path_factory.mktemp("sam")
    recs = _records(11, 3000)
    hdr = jbam.BamHeader(HDR, list(REFS))
    sam_path, bam_path = str(td / "x.sam"), str(td / "x.bam")
    with open(sam_path, "wb") as f:
        jsam.write_sam(f, hdr, recs)
    with open(bam_path, "wb") as f:
        jbam.write_bam(f, hdr, recs)
    return {"sam": sam_path, "bam": bam_path, "recs": recs, "hdr": hdr}


# ---------------------------------------------------------------------------
# The vectorized parse (the reference's tests/test_sam_vec.py cases)
# ---------------------------------------------------------------------------


def test_vectorized_byte_identical_full_and_midsplit():
    lines = rich_corpus()
    data = _sam_bytes(lines)
    a = np.frombuffer(data, np.uint8)
    arr = tsv.parse_split_vectorized(a, 0, len(data), T_HEADER)
    assert arr is not None and arr.tobytes() == oracle_blob(lines)
    assert arr.tobytes() == jsv.parse_split_vectorized(a, 0, len(data), J_HEADER).tobytes()
    mid, hi = len(data) // 3, 2 * len(data) // 3
    want = b"".join(tsam.sam_line_to_record(l.decode(), T_HEADER).encode()
                    for _, l in SplitLineReader(data, mid, hi).lines()
                    if l and not l.startswith(b"@"))
    arr2 = tsv.parse_split_vectorized(a, mid, hi, T_HEADER)
    assert arr2.tobytes() == want == jsv.parse_split_vectorized(a, mid, hi, J_HEADER).tobytes()


@pytest.mark.parametrize("seed", [2, 5])
def test_numpy_tier_byte_identical(seed):
    """The port's only tier writes the blob of the reference's default
    (native) tier and of the exact parser."""
    lines = rich_corpus(1500, seed=seed)
    data = _sam_bytes(lines)
    a = np.frombuffer(data, np.uint8)
    arr = tsv.parse_split_vectorized(a, 0, len(data), T_HEADER)
    assert arr is not None
    assert arr.tobytes() == oracle_blob(lines) == \
        jsv.parse_split_vectorized(a, 0, len(data), J_HEADER).tobytes()


@pytest.mark.parametrize(
    "line",
    [
        "r1\t0\tchr1\t100\t60\t50M\t=\t200",  # < 11 fields
        "r1\t0\tchrUNKNOWN\t100\t60\t5M\t=\t200\t0\tACGTA\tIIIII",
        "r1\tzz\tchr1\t100\t60\t5M\t=\t200\t0\tACGTA\tIIIII",  # bad int
        "r1\t0\tchr1\t100\t60\t5Q\t=\t200\t0\tACGTA\tIIIII",  # bad CIGAR
        "r1\t0\tchr1\t100\t60\t5M\t=\t200\t0\tACGTA\tIIII ",  # qual < '!'
        "r1\t0\tchr1\t100\t60\t*\t=\t200\t0\tAÉT\tIII",  # non-ASCII SEQ
        "r1\t0\tchr1\t100\t60\t5M\t=\t200\t0\tACGTA\tIIIII\tXF:f:0x1p3",
        "r1\t0\tchr1\t100\t60\t5M\t=\t200\t0\tACGTA\tIIIII\tXF:f:nan(1)",
    ],
)
def test_bail_cases_fall_back(line):
    """Odd lines return None (the exact parser owns the error), and the
    exact parsers agree: the same record or the same exception class."""
    data = (HDR + "\n" + line + "\n").encode()
    a = np.frombuffer(data, np.uint8)
    assert tsv.parse_split_vectorized(a, 0, len(data), T_HEADER) is None
    assert jsv.parse_split_vectorized(a, 0, len(data), J_HEADER) is None
    try:
        want = jsam.sam_line_to_record(line, J_HEADER).encode()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        with pytest.raises(Exception) as got:
            tsam.sam_line_to_record(line, T_HEADER)
        assert type(got.value).__name__ == type(e).__name__
    else:
        assert tsam.sam_line_to_record(line, T_HEADER).encode() == want


def test_read_split_uses_vectorized_and_matches_loop(tmp_path):
    """``SamInputFormat.read_split`` over small splits: the reference's
    batches (bytes, every SoA column, keys), and the exact loop's blob."""
    lines = rich_corpus(4000, seed=3)
    p = tmp_path / "t.sam"
    p.write_bytes(_sam_bytes(lines))
    tf, jf = tiosam.SamInputFormat(), jiosam.SamInputFormat()
    ts = tf.get_splits([str(p)], split_size=64 << 10)
    assert len(ts) > 2
    assert [(s.start, s.length) for s in ts] == \
        [(s.start, s.length) for s in jf.get_splits([str(p)], split_size=64 << 10)]
    got = [tf.read_split(s) for s in ts]
    for t, s in zip(got, jf.get_splits([str(p)], split_size=64 << 10)):
        j = jf.read_split(s)
        assert np.asarray(t.data).tobytes() == np.asarray(j.data).tobytes()
        assert np.array_equal(t.keys, j.keys)
        for k in jbam.SOA_FIELDS:
            assert np.array_equal(t.soa[k], j.soa[k]), k
    assert sum(b.n_records for b in got) == len(lines)
    assert b"".join(np.asarray(b.data).tobytes() for b in got) == oracle_blob(lines)


def test_vectorized_large_corpus_equals_the_oracle():
    """20,000 uniform lines (the shape of the reference's speed corpus) in
    one split: the reference's blob."""
    base = [
        f"r{i:07d}\t99\tchr{1 + (i & 1)}\t{1 + (i * 97) % 200_000_000}\t60\t50M\t=\t"
        f"{1 + (i * 97) % 200_000_000 + 100}\t150\t{'ACGTACGTAC' * 5}\t{'I' * 50}\t"
        f"NM:i:2\tAS:i:45"
        for i in range(20_000)
    ]
    big = ("\n".join(base) + "\n").encode()
    a = np.frombuffer(big, np.uint8)
    arr = tsv.parse_split_vectorized(a, 0, len(big), T_HEADER)
    assert arr.tobytes() == jsv.parse_split_vectorized(a, 0, len(big), J_HEADER).tobytes()
    head = oracle_blob(base[:400])
    assert arr.tobytes()[: len(head)] == head


def test_empty_qual_field_matches_exact():
    line = "r1\t0\tchr1\t100\t60\t1M\t*\t0\t0\tA\t\tXX:i:1"
    data = (HDR + "\n" + line + "\n").encode()
    arr = tsv.parse_split_vectorized(np.frombuffer(data, np.uint8), 0, len(data), T_HEADER)
    assert arr is not None and arr.tobytes() == oracle_blob([line])


def test_bin_overflow_bails():
    hdr = tbam.BamHeader("@SQ\tSN:big\tLN:2147483647", [("big", 2147483647)])
    data = b"r1\t0\tbig\t2147483000\t60\t1M\t*\t0\t0\tA\tI\n"
    assert tsv.parse_split_vectorized(np.frombuffer(data, np.uint8), 0, len(data), hdr) is None


def test_float_overflow_tag_bails():
    line = "r1\t0\tchr1\t100\t60\t1M\t*\t0\t0\tA\tI\tXF:f:1e300"
    data = (HDR + "\n" + line + "\n").encode()
    assert tsv.parse_split_vectorized(np.frombuffer(data, np.uint8), 0, len(data),
                                      T_HEADER) is None
    with pytest.raises(OverflowError):
        tsam.sam_line_to_record(line, T_HEADER)


# ---------------------------------------------------------------------------
# The codec (the reference's tests/test_sam_anysam_cram.py SAM cases)
# ---------------------------------------------------------------------------


def test_exact_text_round_trip(corpus):
    """The reference's SAM text parses to its records and formats back to
    the same lines."""
    with open(corpus["sam"], "rb") as f:
        raw = f.read()
    hdr, recs = tsam.read_sam(raw)
    jhdr, jrecs = jsam.read_sam(raw)
    assert (hdr.text, hdr.refs) == (jhdr.text, jhdr.refs)
    assert [r.raw for r in recs] == [r.raw for r in jrecs] == [r.raw for r in corpus["recs"]]
    body = [l for l in raw.decode().split("\n") if l and not l.startswith("@")]
    assert [tsam.record_to_sam_line(r, hdr) for r in recs] == body


def test_binary_text_binary_identity(corpus):
    hdr, recs = tbam.read_bam(corpus["bam"])
    jhdr, jrecs = jbam.read_bam(corpus["bam"])
    assert hdr.encode() == jhdr.encode() and [r.raw for r in recs] == [r.raw for r in jrecs]
    t, j = io.BytesIO(), io.BytesIO()
    tsam.write_sam(t, hdr, recs)
    jsam.write_sam(j, jhdr, jrecs)
    assert t.getvalue() == j.getvalue()
    _, r2 = tsam.read_sam(t.getvalue())
    assert [r.raw for r in r2] == [r.raw for r in recs]
    t, j = io.BytesIO(), io.BytesIO()
    tbam.write_bam(t, hdr, recs, level=1)
    jbam.write_bam(j, jhdr, jrecs, level=1)
    assert t.getvalue() == j.getvalue()
    assert [tbam.alignment_key(r) for r in recs] == [jbam.alignment_key(r) for r in jrecs]


@pytest.mark.parametrize("tag", [
    "NM:i:3", "NM:i:-3", "NM:i:200", "XS:i:-200", "XS:i:40000", "XI:i:-40000",
    "XI:i:70000", "XU:i:3000000000", "XA:A:x", "XZ:Z:hello", "XH:H:1AFF",
    "XF:f:1.5", "XB:B:c,-1,2,3", "XB:B:S,1,65535", "XB:B:f,0.5,2", "XB:B:I",
])
def test_tag_codec_types(tag):
    """Each tag encodes to the reference's bytes (``i`` narrows trying
    ``c`` before ``C``: ``NM:i:3`` is ``NMc``), decodes back, and a line
    with it round-trips."""
    enc = tsam._encode_tag(tag[:2], tag[3], tag[5:])
    assert enc == jsam._encode_tag(tag[:2], tag[3], tag[5:])
    assert tsam.decode_tags(enc) == jsam.decode_tags(enc)
    if tag == "NM:i:3":
        assert enc[2:3] == b"c"
    line = f"q1\t0\tchr1\t10\t60\t4M\t*\t0\t0\tACGT\tIIII\t{tag}"
    rec = tsam.sam_line_to_record(line, T_HEADER)
    assert rec.raw == jsam.sam_line_to_record(line, J_HEADER).raw
    assert tsam.record_to_sam_line(rec, T_HEADER) == jsam.record_to_sam_line(
        jsam.sam_line_to_record(line, J_HEADER), J_HEADER)


def test_headerless_sam():
    """Without ``@SQ`` lines unplaced records parse and mapped ones raise
    the reference's ``KeyError``."""
    text = "q1\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\nq2\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n"
    hdr, recs = tsam.read_sam(text)
    jhdr, jrecs = jsam.read_sam(text)
    assert hdr.refs == jhdr.refs == [] and [r.raw for r in recs] == [r.raw for r in jrecs]
    with pytest.raises(KeyError):
        tsam.read_sam("q1\t0\tchr1\t5\t0\t4M\t*\t0\t0\tACGT\tIIII\n")
    with pytest.raises(KeyError):
        jsam.read_sam("q1\t0\tchr1\t5\t0\t4M\t*\t0\t0\tACGT\tIIII\n")


@pytest.mark.parametrize("split_size", [1_000, 9_973, 50_000, 1 << 20])
def test_split_read_exactly_once(corpus, split_size):
    """Every cut: each split's batch is the reference's, and the splits
    together hold every record once, in file order."""
    tf, jf = tiosam.SamInputFormat(), jiosam.SamInputFormat()
    ts = tf.get_splits([corpus["sam"]], split_size=split_size)
    js = jf.get_splits([corpus["sam"]], split_size=split_size)
    assert [(s.start, s.length, s.compressed) for s in ts] == \
        [(s.start, s.length, s.compressed) for s in js]
    blobs = []
    for t, j in zip(ts, js):
        tb, jb = tf.read_split(t), jf.read_split(j)
        assert np.asarray(tb.data).tobytes() == np.asarray(jb.data).tobytes()
        assert np.array_equal(tb.keys, jb.keys)
        blobs.append(np.asarray(tb.data).tobytes())
    assert b"".join(blobs) == b"".join(r.encode() for r in corpus["recs"])


def test_gzip_sam_is_one_split(corpus, tmp_path):
    import gzip

    p = tmp_path / "x.sam"  # gzip content under a .sam name
    with open(corpus["sam"], "rb") as f:
        p.write_bytes(gzip.compress(f.read(), mtime=0))
    tf, jf = tiosam.SamInputFormat(), jiosam.SamInputFormat()
    ts, js = tf.get_splits([str(p)], 5_000), jf.get_splits([str(p)], 5_000)
    assert len(ts) == len(js) == 1 and ts[0].compressed and js[0].compressed
    assert np.asarray(tf.read_split(ts[0]).data).tobytes() == \
        np.asarray(jf.read_split(js[0]).data).tobytes()


def test_writer_batch(corpus):
    """``SamOutputWriter`` record by record and from a batch in a given
    order: the reference's text."""
    batch = tiosam.SamInputFormat().read_split(
        tiosam.SamInputFormat().get_splits([corpus["sam"]])[0])
    order = np.argsort(batch.keys, kind="stable")[:300]
    hdr = tbam.BamHeader(HDR, list(REFS))
    t, j = io.BytesIO(), io.BytesIO()
    w = tiosam.SamOutputWriter(t, hdr)
    w.write_batch(batch, order)
    w.close()
    jw = jiosam.SamOutputWriter(j, corpus["hdr"])
    for i in order:
        jw.write_record(corpus["recs"][int(i)])
    assert t.getvalue() == j.getvalue()
    t2 = io.BytesIO()
    w = tiosam.SamOutputWriter(t2, hdr, write_header=False)
    for r in tsam.read_sam(t.getvalue())[1][:10]:
        w.write_record(r)
    assert t2.getvalue() == b"".join(j.getvalue().splitlines(keepends=True)[4:14])


def test_sniffing_and_header(corpus, tmp_path):
    import shutil

    odd = str(tmp_path / "odd.bam")  # SAM text under a .bam name
    shutil.copy(corpus["sam"], odd)
    mis = str(tmp_path / "misnamed.sam")  # BAM bytes under a .sam name
    shutil.copy(corpus["bam"], mis)
    for trust in ("true", "false"):
        t = tanysam.AnySamInputFormat(Configuration({ANYSAM_TRUST_EXTS: trust}))
        j = janysam.AnySamInputFormat(JConf({"hadoopbam.anysam.trust-exts": trust}))
        for p in (corpus["sam"], corpus["bam"], odd, mis):
            assert t.get_format(p) == j.get_format(p)
    t = tanysam.AnySamInputFormat(Configuration({ANYSAM_TRUST_EXTS: "false"}))
    assert t.get_format(odd) == "sam" and t.get_format(mis) == "bam"
    hdr = tanysam.AnySamInputFormat().read_header(corpus["sam"])
    assert hdr.encode() == jiosam.SamInputFormat().read_header(corpus["sam"]).encode()


def test_dispatch_reads_bam_and_sam(corpus):
    """One AnySAM job over a BAM and a SAM: the reference's splits and
    batches."""
    paths = [corpus["bam"], corpus["sam"]]
    t, j = tanysam.AnySamInputFormat(), janysam.AnySamInputFormat()
    ts, js = t.get_splits(paths, 20_000), j.get_splits(paths, 20_000)
    key = lambda s: (s.path, getattr(s, "start", None), getattr(s, "vstart", None))  # noqa: E731
    assert [key(s) for s in ts] == [key(s) for s in js]
    total = 0
    for a, b in zip(ts, js):
        tb, jb = t.read_split(a), j.read_split(b)
        assert np.array_equal(tb.keys, jb.keys)
        total += tb.n_records
    assert total == 2 * len(corpus["recs"])


# ---------------------------------------------------------------------------
# The jobs on .sam
# ---------------------------------------------------------------------------


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kw", [
    {},
    {"memory_budget": 1 << 18},
    {"sort_order": "queryname"},
    {"memory_budget": 1 << 18, "sort_order": "queryname"},
    {"mark_duplicates": True},
], ids=["in_core", "budget", "queryname", "queryname_budget", "markdup"])
def test_sort_sam_writes_the_reference_bytes_of_the_bam_twin(corpus, tmp_path, kw):
    """``sort_bam`` on the ``.sam`` writes what the reference's ``sort_bam``
    writes for the BAM of the same records, byte for byte."""
    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    st = tpipeline.sort_bam(corpus["sam"], out_t, device="cpu", **kw)
    jpipeline.sort_bam(corpus["bam"], out_j, **kw)
    assert _read(out_t) == _read(out_j)
    assert st.n_records == len(corpus["recs"])
    if "memory_budget" in kw:
        assert st.n_runs > 1


def test_fixmate_sam_writes_the_reference_bytes_of_the_bam_twin(corpus, tmp_path):
    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    st = tpipeline.fixmate_bam(corpus["sam"], out_t, device="cpu")
    jpipeline.fixmate_bam(corpus["bam"], out_j)
    assert _read(out_t) == _read(out_j)
    assert st.n_records == len(corpus["recs"])


def test_sam_sort_where_the_reference_raises(corpus, tmp_path):
    """The reference's ``sort_bam`` reads a ``.sam``'s header with its BGZF
    reader and raises ``BgzfError``; the port reads it as text and writes
    the bytes of the reference's sort of the BAM twin."""
    with pytest.raises(jbgzf.BgzfError):
        jpipeline.sort_bam(corpus["sam"], str(tmp_path / "j.sam.bam"))
    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    tpipeline.sort_bam(corpus["sam"], out_t, device="cpu")
    jpipeline.sort_bam(corpus["bam"], out_j)
    assert _read(out_t) == _read(out_j)
    assert os.path.getsize(out_t) > 0

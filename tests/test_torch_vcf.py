"""VCF text input of the port against the JAX reference, on the CPU.

``VcfInputFormat`` (sniffing, the split matrix over plain, BGZF and gzip
files, stringency, the tabix filter of splits through a ``.tbi`` that a
small writer here builds, the BCF hand-off), the vectorized tokenizer
against the exact per-line parser, the writer, the part merge, the header
reader, and the counts form of the ragged interval join.  The corpora come
from numpy seeds; every comparison is exact.
"""

import gzip
import io
import struct

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.io import vcf as jvcf
from hadoop_bam_tpu.io.splits import ByteSplit as JByteSplit
from hadoop_bam_tpu.ops.pallas import overlap as jov
from hadoop_bam_tpu.spec.vcf import FormatException as JFormatException
from hadoop_bam_tpu.spec.vcf import VcfHeader as JVcfHeader
from hadoop_bam_tpu.utils import nio as jnio
from hadoop_bam_tpu_torch.conf import (
    VCF_INTERVALS,
    VCFRECORDREADER_VALIDATION_STRINGENCY,
    Configuration,
)
from hadoop_bam_tpu_torch.io import vcf as tvcf
from hadoop_bam_tpu_torch.io.splits import ByteSplit
from hadoop_bam_tpu_torch.ops import overlap as tov
from hadoop_bam_tpu_torch.spec import bam as tbam
from hadoop_bam_tpu_torch.spec import bcf as tbcf
from hadoop_bam_tpu_torch.spec import bgzf as tbgzf
from hadoop_bam_tpu_torch.spec.vcf import FormatException, VcfHeader
from hadoop_bam_tpu_torch.utils import nio

CPU = torch.device("cpu")
CONTIGS = [("chr1", 2_000_000), ("chr2", 1_000_000), ("11", 400_000), ("1", 300_000)]
HEAD = (
    ["##fileformat=VCFv4.2"]
    + [f"##contig=<ID={c},length={n}>" for c, n in CONTIGS]
    + ['##FILTER=<ID=q10,Description="Quality below 10">',
       '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
       '##INFO=<ID=END,Number=1,Type=Integer,Description="End">',
       '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type">',
       '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
       "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tNA1\tNA2"]
)


def vcf_lines(seed: int, n: int, symbolic: int = 3):
    """Sorted data lines: REFs of 1-4 bases, one or two ALTs, QUAL as '.',
    an integer or a float, FILTER PASS or q10, INFO with DP and sometimes an
    END past the REF, genotypes; ``symbolic`` of them a ``<DEL>`` (the
    tokenizer sends their splits to the exact parser)."""
    rng = np.random.default_rng(seed)
    per = rng.multinomial(n, [0.5, 0.25, 0.15, 0.1])
    out = []
    for (c, ln), k in zip(CONTIGS, per):
        for p in np.sort(rng.integers(1, ln, k)):
            ref = "".join("ACGT"[i] for i in rng.integers(0, 4, int(rng.integers(1, 5))))
            alts = ",".join("".join("ACGT"[i] for i in rng.integers(0, 4, int(rng.integers(1, 3))))
                            for _ in range(int(rng.integers(1, 3))))
            qual = [".", str(int(rng.integers(0, 99))), f"{rng.uniform(0, 99):.2f}"][
                int(rng.integers(0, 3))]
            info = f"DP={int(rng.integers(1, 90))}"
            if rng.random() < 0.05:
                info += f";END={int(p) + len(ref) + int(rng.integers(1, 900))}"
            gts = "\t".join(["0/1", "1|1", "./."][int(g)] for g in rng.integers(0, 3, 2))
            out.append(f"{c}\t{int(p)}\trs{len(out)}\t{ref}\t{alts}\t{qual}\t"
                       f"{['PASS', 'q10'][int(rng.integers(0, 2))]}\t{info}\tGT\t{gts}")
    for i in rng.choice(len(out), symbolic, replace=False):
        f = out[i].split("\t")
        f[4], f[7] = "<DEL>", f"SVTYPE=DEL;END={int(f[1]) + 500}"
        out[i] = "\t".join(f)
    return out


def vcf_text(seed: int = 3, n: int = 2500) -> bytes:
    return ("\n".join(HEAD + vcf_lines(seed, n)) + "\n").encode()


def bgzf_bytes(payload: bytes, block: int = 3000) -> bytes:
    """Members of ``block`` payload bytes (so lines straddle members) and
    the terminator."""
    return tbgzf.deflate_blocks(payload, block_payload=block)[0] + tbgzf.TERMINATOR


def write_tbi(raw: bytes) -> bytes:
    """A ``.tbi`` of a BGZF VCF (tabix's format 2: VCF, columns 1 and 2,
    meta ``#``): per contig, each bin's chunks (runs of consecutive lines
    in one bin) and the linear index (the least line start covering each
    16 KiB window), BGZF-compressed."""
    co, cs, us = tbgzf.scan_blocks(raw)
    payload, uoffs = tbgzf.inflate_blocks(raw, co, cs, us)
    data = payload.tobytes()

    def voff(u: int) -> int:
        b = int(np.searchsorted(uoffs, u, side="right")) - 1
        if b >= len(co):
            return (len(raw) - len(tbgzf.TERMINATOR)) << 16
        return (int(co[b]) << 16) | (u - int(uoffs[b]))

    names = [c for c, _ in CONTIGS]
    bins = [dict() for _ in names]
    linear = [dict() for _ in names]
    last = [None] * len(names)
    pos = 0
    while pos < len(data):
        nl = data.index(b"\n", pos)
        line = data[pos:nl].decode()
        if not line.startswith("#"):
            f = line.split("\t")
            rid, beg = names.index(f[0]), int(f[1]) - 1
            end = beg + len(f[3])
            for kv in f[7].split(";"):
                if kv.startswith("END="):
                    end = int(kv[4:])
            b = tbam.reg2bin(beg, end)
            vb, ve = voff(pos), voff(nl + 1)
            chunks = bins[rid].setdefault(b, [])
            if last[rid] == b and chunks:
                chunks[-1][1] = ve
            else:
                chunks.append([vb, ve])
            last[rid] = b
            for w in range(beg >> 14, ((end - 1) >> 14) + 1):
                linear[rid][w] = min(linear[rid].get(w, vb), vb)
        pos = nl + 1
    nm = b"".join(n.encode() + b"\x00" for n in names)
    out = bytearray(b"TBI\x01" + struct.pack("<8i", len(names), 2, 1, 2, 0, ord("#"), 0, len(nm)))
    out += nm
    for rid in range(len(names)):
        out += struct.pack("<i", len(bins[rid]))
        for b, chunks in sorted(bins[rid].items()):
            out += struct.pack("<Ii", b, len(chunks))
            for vb, ve in chunks:
                out += struct.pack("<QQ", vb, ve)
        n_intv = max(linear[rid]) + 1 if linear[rid] else 0
        out += struct.pack("<i", n_intv)
        for w in range(n_intv):
            out += struct.pack("<Q", linear[rid].get(w, 0))
    return tbgzf.deflate_blocks(bytes(out))[0] + tbgzf.TERMINATOR


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    td = tmp_path_factory.mktemp("vcf")
    text = vcf_text()
    paths = {"plain": str(td / "x.vcf"), "bgzf": str(td / "x.vcf.bgz"),
             "gzip": str(td / "x.vcf.gz")}
    with open(paths["plain"], "wb") as f:
        f.write(text)
    with open(paths["bgzf"], "wb") as f:
        f.write(bgzf_bytes(text))
    with open(paths["gzip"], "wb") as f:
        f.write(gzip.compress(text, mtime=0))
    with open(paths["bgzf"], "rb") as f:
        tbi = write_tbi(f.read())
    with open(paths["bgzf"] + ".tbi", "wb") as f:
        f.write(tbi)
    paths["text"] = text
    paths["n"] = sum(1 for l in text.split(b"\n") if l and not l.startswith(b"#"))
    return paths


def _same_batch(t, j):
    assert np.array_equal(t.keys, j.keys)
    assert np.array_equal(t.pos, j.pos)
    assert np.array_equal(t.end, j.end)
    assert [v.format_line() for v in t.variants] == [v.format_line() for v in j.variants]


# ---------------------------------------------------------------------------
# VcfInputFormat (the reference's tests/test_vcf_fasta.py VCF cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["plain", "bgzf", "gzip"])
@pytest.mark.parametrize("split_size", [4_099, 20_000, 40_000, 1 << 20])
def test_split_matrix_exactly_once(files, which, split_size):
    """Every split's batch is the reference's, and the splits hold every
    record once; plain gzip is one split, the others split by bytes."""
    t, j = tvcf.VcfInputFormat(), jvcf.VcfInputFormat()
    ts = t.get_splits([files[which]], split_size=split_size)
    js = j.get_splits([files[which]], split_size=split_size)
    assert [(s.start, s.length, s.compressed) for s in ts] == \
        [(s.start, s.length, s.compressed) for s in js]
    if which == "gzip" or split_size == 1 << 20:
        assert len(ts) == 1
    else:
        assert len(ts) > 1
    total = 0
    for a, b in zip(ts, js):
        tb, jb = t.read_split(a), j.read_split(b)
        _same_batch(tb, jb)
        total += tb.n_records
    assert total == files["n"]


def test_bgzf_splits_cut_at_member_starts(files):
    """Splits whose ends fall exactly on member starts: a member belongs to
    the split it starts in, never to the one that ends at it."""
    with open(files["bgzf"], "rb") as f:
        co = tbgzf.scan_blocks(f.read())[0].tolist()
    cuts = co[::3] + [co[-1] + 1]
    t, j = tvcf.VcfInputFormat(), jvcf.VcfInputFormat()
    total = 0
    for a, b in zip(cuts, cuts[1:]):
        tb = t.read_split(ByteSplit(files["bgzf"], a, b - a))
        _same_batch(tb, j.read_split(JByteSplit(files["bgzf"], a, b - a)))
        total += tb.n_records
    assert total == files["n"]


def test_sniffing(files, tmp_path):
    bcf_path = tmp_path / "x.bcf"
    hdr = VcfHeader.parse("\n".join(HEAD))
    bcf_path.write_bytes(bgzf_bytes(tbcf.encode_header(hdr)))
    odd = tmp_path / "x.dat"
    odd.write_bytes(b"\x1f\x8b junk")
    none = tmp_path / "y.dat"
    none.write_bytes(b"BAM\x01")
    for p in (files["plain"], files["bgzf"], files["gzip"], str(bcf_path), str(odd), str(none)):
        for trust in (True, False):
            assert tvcf.sniff_vcf_format(p, trust) == jvcf.sniff_vcf_format(p, trust)
    assert tvcf.sniff_vcf_format(files["gzip"], False) == "vcf"
    assert tvcf.sniff_vcf_format(str(bcf_path), False) == "bcf"
    assert tvcf.sniff_vcf_format(str(none), False) is None


@pytest.mark.parametrize("stringency", ["STRICT", "LENIENT", "SILENT"])
def test_stringency_policies(stringency):
    """A malformed line: STRICT raises the reference's exception class,
    LENIENT and SILENT skip it."""
    bad = (
        "##fileformat=VCFv4.2\n##contig=<ID=c>\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        "c\t1\t.\tA\tT\t.\t.\t.\nc\tBAD\t.\tA\tT\t.\t.\t.\nc\t5\t.\tA\tT\t.\t.\t.\n"
    ).encode()
    t = tvcf.VcfInputFormat(Configuration({VCFRECORDREADER_VALIDATION_STRINGENCY: stringency}))
    j = jvcf.VcfInputFormat(JConf({"hadoopbam.vcfrecordreader.validation-stringency": stringency}))
    if stringency == "STRICT":
        with pytest.raises(FormatException):
            t.read_split(ByteSplit("<m>", 0, len(bad)), data=bad)
        with pytest.raises(JFormatException):
            j.read_split(JByteSplit("<m>", 0, len(bad)), data=bad)
        return
    tb = t.read_split(ByteSplit("<m>", 0, len(bad)), data=bad)
    _same_batch(tb, j.read_split(JByteSplit("<m>", 0, len(bad)), data=bad))
    assert tb.n_records == 2
    with pytest.raises(ValueError):
        tvcf.VcfInputFormat(Configuration({VCFRECORDREADER_VALIDATION_STRINGENCY: "x"})) \
            .read_split(ByteSplit("<m>", 0, len(bad)), data=bad)


@pytest.mark.parametrize("intervals", [
    "chr1:100-200000", "chr2:500000-500100,11:1-400000", "chr1:1999990-2000000", "chrX:1-1000",
])
def test_interval_filtering_records_and_splits(files, intervals):
    """With ``hadoopbam.vcf.intervals`` the BGZF file's splits are filtered
    through its ``.tbi`` (a file without one keeps every split) and each
    split's records by overlap: the reference's splits and batches."""
    t = tvcf.VcfInputFormat(Configuration({VCF_INTERVALS: intervals}))
    j = jvcf.VcfInputFormat(JConf({"hadoopbam.vcf.intervals": intervals}))
    for which in ("bgzf", "plain"):
        ts = t.get_splits([files[which]], split_size=8_000)
        js = j.get_splits([files[which]], split_size=8_000)
        assert [(s.start, s.length) for s in ts] == [(s.start, s.length) for s in js]
        for a, b in zip(ts, js):
            _same_batch(t.read_split(a), j.read_split(b))
    all_t = tvcf.VcfInputFormat().get_splits([files["bgzf"]], split_size=8_000)
    kept = t.get_splits([files["bgzf"]], split_size=8_000)
    assert len(kept) < len(all_t)


def test_header_reader_all_codecs(files, tmp_path):
    bcf_path = tmp_path / "x.bcf"
    hdr = VcfHeader.parse("\n".join(HEAD))
    bcf_path.write_bytes(bgzf_bytes(tbcf.encode_header(hdr)))
    for p in (files["plain"], files["bgzf"], files["gzip"], str(bcf_path)):
        th, jh = tvcf.read_vcf_header(p), jvcf.read_vcf_header(p)
        assert th.lines == jh.lines
        assert th.samples == ["NA1", "NA2"]


def test_roundtrip_plain(files):
    """The writer's text (with and without the header, plain and BGZF) is
    the reference's, and reads back to the same variants."""
    b = tvcf.VcfInputFormat().read_split(ByteSplit(files["plain"], 0, len(files["text"])))
    jb = jvcf.VcfInputFormat().read_split(JByteSplit(files["plain"], 0, len(files["text"])))
    for kw in ({}, {"write_header": False}, {"compress_bgzf": True, "append_terminator": True}):
        t, j = io.BytesIO(), io.BytesIO()
        w = tvcf.VcfRecordWriter(t, b.header, **kw)
        for v in b.variants:
            w.write(v)
        w.close()
        jw = jvcf.VcfRecordWriter(j, jb.header, **kw)
        for v in jb.variants:
            jw.write(v)
        jw.close()
        assert t.getvalue() == j.getvalue()
    out = t.getvalue()
    b2 = tvcf.VcfInputFormat().read_split(ByteSplit("<m>", 0, len(out)), data=out)
    assert [v.format_line() for v in b2.variants] == [v.format_line() for v in b.variants]


@pytest.mark.parametrize("codec", ["bgzf", "plain"])
def test_headerless_parts_merge(files, tmp_path, codec):
    """Headerless parts merge into the reference's bytes: the header, the
    parts untouched, the BGZF terminator for block-compressed parts."""
    b = tvcf.VcfInputFormat().read_split(ByteSplit(files["plain"], 0, len(files["text"])))
    part_dir = tmp_path / "out"
    part_dir.mkdir()
    vs = b.variants
    for i, chunk in enumerate((vs[:700], vs[700:1900], vs[1900:])):
        with open(part_dir / f"part-r-{i:05d}", "wb") as f:
            w = tvcf.VcfRecordWriter(f, b.header, write_header=False,
                                     compress_bgzf=codec == "bgzf")
            for v in chunk:
                w.write(v)
            w.close()
    nio.write_success(part_dir)
    out_t, out_j = tmp_path / "t.vcf", tmp_path / "j.vcf"
    tvcf.merge_vcf_parts(str(part_dir), str(out_t), b.header)
    jvcf.merge_vcf_parts(str(part_dir), str(out_j), JVcfHeader.parse("\n".join(HEAD)))
    data = out_t.read_bytes()
    assert data == out_j.read_bytes()
    assert data.endswith(tbgzf.TERMINATOR) == (codec == "bgzf")
    b2 = tvcf.VcfInputFormat().read_split(ByteSplit(str(out_t), 0, len(data)), data=data)
    assert b2.n_records == b.n_records


def test_merge_rejects_bcf(tmp_path):
    part_dir = tmp_path / "out"
    part_dir.mkdir()
    (part_dir / "part-r-00000").write_bytes(b"BCF\x02\x02xxxx")
    nio.write_success(part_dir)
    with pytest.raises(ValueError, match="BCF"):
        tvcf.merge_vcf_parts(str(part_dir), str(tmp_path / "m"),
                             VcfHeader.parse("##fileformat=VCFv4.2\n#CHROM\tPOS"))
    with pytest.raises(ValueError, match="BCF"):
        jvcf.merge_vcf_parts(str(part_dir), str(tmp_path / "m"),
                             JVcfHeader.parse("##fileformat=VCFv4.2\n#CHROM\tPOS"))
    (part_dir / "_SUCCESS").unlink()
    with pytest.raises(FileNotFoundError):
        tvcf.merge_vcf_parts(str(part_dir), str(tmp_path / "m"),
                             VcfHeader.parse("##fileformat=VCFv4.2\n#CHROM\tPOS"))
    jnio.write_success(part_dir)


def test_one_split_per_contig(files):
    """Splits cut at the contig boundaries of the plain file: each holds
    one contig's records, the reference's batch."""
    text = files["text"]
    cuts = [text.index(b"\n" + c.encode() + b"\t") + 1 for c, _ in CONTIGS]
    bounds = cuts + [len(text)]
    t, j = tvcf.VcfInputFormat(), jvcf.VcfInputFormat()
    for k, (a, b) in enumerate(zip(bounds, bounds[1:])):
        tb = t.read_split(ByteSplit(files["plain"], a, b - a, compressed=False))
        _same_batch(tb, j.read_split(JByteSplit(files["plain"], a, b - a, compressed=False)))
        assert set((tb.keys >> 32).tolist()) == {k}


def test_bcf_hand_off(files, tmp_path):
    """A ``.bcf`` in a VCF job goes to the BCF planner and reader: the
    reference's splits and batches, beside a VCF's."""
    lines = vcf_lines(5, 400, symbolic=0)
    hdr = VcfHeader.parse("\n".join(HEAD))
    from hadoop_bam_tpu_torch.spec.vcf import parse_variant_line

    recs = b"".join(tbcf.encode_record(tbcf.BcfHeader(hdr), parse_variant_line(l)) for l in lines)
    p = tmp_path / "calls.bcf"
    p.write_bytes(bgzf_bytes(tbcf.encode_header(hdr) + recs, block=2000))
    paths = [str(p), files["plain"]]
    t, j = tvcf.VcfInputFormat(), jvcf.VcfInputFormat()
    ts, js = t.get_splits(paths, 9_000), j.get_splits(paths, 9_000)
    assert [type(s).__name__ for s in ts] == [type(s).__name__ for s in js]
    for a, b in zip(ts, js):
        if type(a).__name__ == "FileVirtualSplit":
            assert (a.vstart, a.vend) == (b.vstart, b.vend)
            tb, jb = t.read_split(a), j.read_split(b)
            assert np.array_equal(tb.keys, jb.keys) and np.array_equal(tb.end, jb.end)
        else:
            _same_batch(t.read_split(a), j.read_split(b))


# ---------------------------------------------------------------------------
# The vectorized tokenizer against the loop parser
# ---------------------------------------------------------------------------

TOK_HEAD = (
    "##fileformat=VCFv4.2\n##contig=<ID=chr1,length=1000000>\n"
    "##contig=<ID=chr2,length=500000>\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
)


def _both(text, monkeypatch):
    """The port's fast and loop batches, and the reference's fast batch."""
    data = text.encode()
    fmt = tvcf.VcfInputFormat()
    fast = fmt.read_split(ByteSplit("<m>", 0, len(data)), data=data)
    ref = jvcf.VcfInputFormat().read_split(JByteSplit("<m>", 0, len(data)), data=data)
    with monkeypatch.context() as m:
        m.setattr(tvcf, "_read_vectorized", lambda *a, **k: None)
        slow = fmt.read_split(ByteSplit("<m>", 0, len(data)), data=data)
    return fast, slow, ref


def test_equality_with_loop_parser(monkeypatch):
    rows = "".join(
        f"chr{1 + i % 2}\t{100 + 13 * i}\trs{i}\tACGT\tA,G\t{i % 60}.5\tPASS;q10\tDP={i}\tGT\t0/1\n"
        for i in range(500)
    )
    fast, slow, ref = _both(TOK_HEAD + rows, monkeypatch)
    assert fast._variants is None
    _same_batch(fast, slow)
    _same_batch(fast, ref)


def test_info_end_override(monkeypatch):
    rows = ("chr1\t100\t.\tA\t<DEL>\t.\tPASS\tSVTYPE=DEL;END=5000\n"
            "chr1\t200\t.\tACGT\tA\t.\tPASS\tDP=3\n"
            "chr1\t300\t.\tA\tG\t.\tPASS\tEND=900;DP=1\n")
    fast, slow, ref = _both(TOK_HEAD + rows, monkeypatch)
    _same_batch(fast, slow)
    _same_batch(fast, ref)
    assert fast.end.tolist() == [5000, 203, 900]


def test_unknown_contig_falls_back_to_murmur_path(monkeypatch):
    fast, slow, ref = _both(TOK_HEAD + "chrZ\t100\t.\tA\tG\t.\tPASS\t.\n", monkeypatch)
    _same_batch(fast, slow)
    _same_batch(fast, ref)
    assert fast.keys[0] >> 32 != 0


def test_variants_are_lazy(monkeypatch):
    fast, _, _ = _both(TOK_HEAD + "chr1\t100\t.\tA\tG\t50\tPASS\t.\n" * 10, monkeypatch)
    assert fast._variants is None
    assert [v.pos for v in fast.select([3, 1])] == [100, 100]
    assert fast._variants is None  # select decodes only its rows
    assert len(fast.variants) == 10


def test_split_boundary_fragment_not_misparsed():
    """A cut one byte into a line ``11\\t...`` must not read its tail
    ``1\\t...`` as a record of contig ``1``."""
    head = ("##fileformat=VCFv4.2\n##contig=<ID=1>\n##contig=<ID=11>\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    data = (head + "".join(f"11\t{100 + i}\t.\tA\tG\t.\tPASS\t.\n" for i in range(50))).encode()
    cut = data.index(b"\n11\t120", len(head)) + 2
    fmt = tvcf.VcfInputFormat()
    b1 = fmt.read_split(ByteSplit("<m>", 0, cut), data=data)
    b2 = fmt.read_split(ByteSplit("<m>", cut, len(data) - cut), data=data)
    whole = fmt.read_split(ByteSplit("<m>", 0, len(data)), data=data)
    assert b1.n_records + b2.n_records == whole.n_records == 50
    assert np.array_equal(np.concatenate([b1.keys, b2.keys]), whole.keys)
    j = jvcf.VcfInputFormat()
    _same_batch(b2, j.read_split(JByteSplit("<m>", cut, len(data) - cut), data=data))


def test_a_line_starting_at_the_split_end_belongs_to_the_next_split():
    """A split ending exactly where a line starts does not read that line;
    the next split does."""
    data = (TOK_HEAD + "".join(f"chr1\t{100 + i}\t.\tA\tG\t.\tPASS\t.\n"
                               for i in range(20))).encode()
    cut = data.index(b"chr1\t110\t")
    fmt = tvcf.VcfInputFormat()
    b1 = fmt.read_split(ByteSplit("<m>", 0, cut), data=data)
    b2 = fmt.read_split(ByteSplit("<m>", cut, len(data) - cut), data=data)
    assert b1.pos.tolist() == list(range(100, 110))
    assert b2.pos.tolist() == list(range(110, 120))


# ---------------------------------------------------------------------------
# The counts form of the ragged join (the reference's test_variant_plane.py)
# ---------------------------------------------------------------------------

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _counts_all(s, e, qb, qe):
    """The port's plain and ``device="cpu"`` forms, the reference's two."""
    return (tov.join_counts_np(s, e, qb, qe),
            tov.join_counts_device(s, e, qb, qe, device=CPU).numpy(),
            jov.join_counts_np(s, e, qb, qe),
            np.asarray(jov.join_counts_device(s, e, qb, qe)))


def test_counts_match_brute_force():
    rng = np.random.default_rng(11)
    s = np.sort(rng.integers(0, 10_000, 300)).astype(np.int64)
    e = s + rng.integers(1, 400, 300)
    qb = np.sort(rng.integers(0, 10_000, 17)).astype(np.int64)
    qe = qb + rng.integers(1, 700, 17)
    brute = np.array([int(((s < b) & (e > a)).sum()) for a, b in zip(qb, qe)])
    for got in _counts_all(s, e, qb, qe):
        np.testing.assert_array_equal(got, brute)
    rng.shuffle(s)  # records in any order
    for got in _counts_all(s, e, qb, qe):
        np.testing.assert_array_equal(got, brute)


@pytest.mark.parametrize("n,m", [(0, 0), (0, 5), (7, 0)])
def test_counts_empty_sides(n, m):
    s = np.arange(n, dtype=np.int64)
    qb = np.arange(m, dtype=np.int64)
    outs = _counts_all(s, s + 1, qb, qb + 3)
    for got in outs:
        assert got.dtype == np.int32 and got.tolist() == [0] * m


def test_counts_ties():
    """Records and windows that touch at their ends count not; equal
    starts and equal windows count each."""
    s = np.array([10, 10, 10, 20, 30], np.int64)
    e = np.array([20, 20, 11, 30, 31], np.int64)
    qb = np.array([20, 10, 9, 30, 31, 10], np.int64)
    qe = np.array([30, 11, 10, 31, 40, 10], np.int64)
    want = [1, 3, 0, 1, 0, 0]
    for got in _counts_all(s, e, qb, qe):
        assert got.tolist() == want


def test_counts_int32_edges():
    """Coordinates at the int32 extremes (the device forms' domain), and a
    window beginning at ``2**31 - 1``: the reference's device form counts
    its power-of-two pad ends there (a standing deviation), the port
    counts what both host forms count."""
    s = np.array([I32_MIN, I32_MIN, -5, 0, I32_MAX - 2], np.int64)
    e = np.array([I32_MIN + 1, 0, 5, I32_MAX, I32_MAX], np.int64)
    qb = np.array([I32_MIN, I32_MIN + 1, -1, 0, I32_MAX - 1], np.int64)
    qe = np.array([I32_MIN + 1, I32_MAX, 0, 1, I32_MAX], np.int64)
    outs = _counts_all(s, e, qb, qe)
    for got in outs:
        assert got.tolist() == outs[0].tolist()
    edge = (s, e, np.array([I32_MAX], np.int64), np.array([I32_MAX], np.int64))
    t_np, t_dev, j_np, j_dev = _counts_all(*edge)
    assert t_np.tolist() == t_dev.tolist() == j_np.tolist() == [0]
    assert j_dev.tolist() == [-3]  # 5 records padded to 8: three pad ends subtracted

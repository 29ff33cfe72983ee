"""The port's variant plane against the JAX reference, on the CPU.

Kernel row 5 (the BCF record-chain walk: the port's plain version against
the reference's Pallas kernel in interpret mode and its host walk), the
BCF/VCF specs, the BCF input format (split plan, strict split reads with
the walk gate on and off, conf intervals, strict errors), the ragged
interval join, and the ranged ``variants_blob`` query end to end.  Every
comparison is exact.  Corpora are multi-member BGZF-BCF files with members
of at most 512 bytes of payload, so records straddle members; their values
come from a numpy seed.
"""

import io
import struct

import numpy as np
import pytest
import torch

from hadoop_bam_tpu import native
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.device_stream import DeviceStream as JStream
from hadoop_bam_tpu.io import bcf as jio
from hadoop_bam_tpu.io.splits import FileVirtualSplit as JSplit
from hadoop_bam_tpu.ops.pallas import bcf_chain as jchain
from hadoop_bam_tpu.ops.pallas import overlap as jov
from hadoop_bam_tpu.serve import endpoints as jend
from hadoop_bam_tpu.spec import bcf as jbcf
from hadoop_bam_tpu.spec import bgzf as jbgzf
from hadoop_bam_tpu.spec import vcf as jvcf
from hadoop_bam_tpu.utils import intervals as jiv
from hadoop_bam_tpu.utils.tracing import delta, snapshot
from hadoop_bam_tpu_torch import conf as tconf
from hadoop_bam_tpu_torch.device_stream import DeviceStream
from hadoop_bam_tpu_torch.io import bcf as tio
from hadoop_bam_tpu_torch.ops import overlap as tov
from hadoop_bam_tpu_torch.ops.kernels import bcf_chain as tchain
from hadoop_bam_tpu_torch.serve import endpoints as tend
from hadoop_bam_tpu_torch.spec import bcf as tbcf
from hadoop_bam_tpu_torch.spec import bgzf as tbgzf
from hadoop_bam_tpu_torch.spec import fragment as tfrag
from hadoop_bam_tpu_torch.spec import vcf as tvcf
from hadoop_bam_tpu_torch.utils import intervals as tiv
from hadoop_bam_tpu_torch.utils.tracing import Metrics

CPU = torch.device("cpu")
GATES_ON = {"hadoopbam.bcf.chain": "true", "hadoopbam.inflate.lanes": "true"}

# ---------------------------------------------------------------------------
# Corpora
# ---------------------------------------------------------------------------

_META = [
    '##FILTER=<ID=PASS,Description="All filters passed">',
    '##FILTER=<ID=q10,Description="Quality below 10">',
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="depth">',
    '##INFO=<ID=AF,Number=A,Type=Float,Description="allele frequency">',
    '##INFO=<ID=DB,Number=0,Type=Flag,Description="dbSNP">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="end">',
    '##INFO=<ID=NOTE,Number=1,Type=String,Description="note">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="genotype">',
    '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="allelic depths">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="genotype quality">',
    '##FORMAT=<ID=HQ,Number=2,Type=Float,Description="haplotype quality">',
]
CONTIGS = [("chr1", 300000), ("chr2", 200000), ("chrM", 16569)]


def _header_lines(idx: bool):
    """The VCF header; with ``idx``, every dictionary line carries IDX=, in
    an order that differs from the line order (contig lines included)."""
    lines = ["##fileformat=VCFv4.2"]
    contigs = [f"##contig=<ID={c},length={n}>" for c, n in CONTIGS]
    meta = list(_META)
    if idx:
        contigs = [ln[:-1] + f",IDX={i}>" for i, ln in zip((1, 0, 2), contigs)]
        meta = [ln[:-1] + f",IDX={i}>" for i, ln in
                zip((0, 3, 1, 5, 2, 4, 6, 8, 7, 10, 9), meta)]
    lines += contigs + meta
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2")
    return lines


def _variant_lines(seed: int, n: int):
    """VCF data lines in (contig, pos) order: SNVs and indels, a POS=0
    record, symbolic deletions with INFO END, sites-only records, missing
    QUAL/FILTER/values, IDs, flags and strings."""
    rng = np.random.default_rng(seed)
    out = []
    per = {"chr1": n // 2, "chr2": n // 3, "chrM": n - n // 2 - n // 3}
    for chrom, length in CONTIGS:
        k = per[chrom]
        slots = np.arange(1, length // 50) * 50
        if chrom == "chr1":  # nothing reaches into chr1:100001-101000
            slots = slots[(slots < 99000) | (slots > 101000)]
        pos = np.sort(rng.choice(slots, k, replace=False) + rng.integers(0, 50, k))
        if chrom == "chr1":
            pos[0] = 0  # telomeric POS=0: the key's sign extension
        for i, p in enumerate(pos.tolist()):
            kind = int(rng.integers(0, 10))
            ref = "AC" if p == 0 else "ACGT"[int(rng.integers(0, 4))]
            alt = "GT"[int(rng.integers(0, 2))]
            info = [f"DP={int(rng.integers(0, 400))}",
                    f"AF={float(rng.integers(1, 1000)) / 1000:g}"]
            if kind == 0:
                ref, alt = "ACGTT"[: int(rng.integers(2, 5))], "A"
            elif kind == 1:
                alt = "<DEL>"
                info = [f"END={p + int(rng.integers(10, 900))}", f"DP={int(rng.integers(0, 50))}"]
            elif kind == 2:
                info.append("DB")
            elif kind == 3:
                info.append(f"NOTE=n{int(rng.integers(0, 99))}")
            qual = "." if kind == 4 else f"{float(rng.integers(0, 99999)) / 100:g}"
            filt = ("." if kind == 5 else "q10") if kind in (5, 6) else "PASS"
            vid = f"rs{int(rng.integers(1, 10**8))}" if kind == 7 else "."
            fields = [chrom, str(p), vid, ref, alt, qual, filt, ";".join(info)]
            if kind != 8:  # kind 8: sites only
                def sample():
                    gt = ["0/0", "0/1", "1|1", "./.", "0|1"][int(rng.integers(0, 5))]
                    ad = f"{int(rng.integers(0, 300))},{int(rng.integers(0, 300))}"
                    gq = "." if rng.random() < 0.2 else str(int(rng.integers(0, 99)))
                    hq = f"{float(rng.integers(0, 500)) / 10:g},."
                    return ":".join([gt, ad, gq, hq])
                fields += ["GT:AD:GQ:HQ", sample(), sample()]
            out.append("\t".join(fields))
    return out


def _encode(vcf, variants, block_payload: int = 512) -> bytes:
    """BGZF-BCF written by the reference, members of ``block_payload`` bytes."""
    hdr = jbcf.BcfHeader(vcf)
    raw = jbcf.encode_header(vcf) + b"".join(jbcf.encode_record(hdr, v) for v in variants)
    return bytes(native.deflate_blocks(np.frombuffer(raw, np.uint8), level=6,
                                       block_payload=block_payload)) + jbgzf.TERMINATOR


@pytest.fixture(scope="module", params=["plain", "idx"])
def corpus(request, tmp_path_factory):
    idx = request.param == "idx"
    lines = _header_lines(idx)
    body = _variant_lines(3 if idx else 1, 180)
    vcf = jvcf.VcfHeader(list(lines))
    variants = [jvcf.parse_variant_line(ln) for ln in body]
    data = _encode(vcf, variants)
    path = str(tmp_path_factory.mktemp("variants") / f"{request.param}.bcf")
    with open(path, "wb") as f:
        f.write(data)
    return {"path": path, "lines": lines, "body": body, "vcf": vcf, "variants": variants,
            "data": data}


def _payload(corpus):
    """The inflated record stream of a corpus and its record offsets."""
    hdr, first = jio.read_bcf_header(corpus["data"], True)
    payload, p, lim, _ = jio._inflate_range(corpus["data"], first, len(corpus["data"]) << 16)
    offs = []
    while p + 8 <= lim:
        offs.append(p)
        ls, li = struct.unpack_from("<II", payload, p)
        p += 8 + ls + li
    return payload, offs


# ---------------------------------------------------------------------------
# Kernel row 5: the record-chain walk
# ---------------------------------------------------------------------------


def _walk_cases(payload: bytes, offs):
    """(payload, start, limit) per case."""
    bad_shared = bytearray(payload)
    struct.pack_into("<I", bad_shared, offs[9], 7)
    bad_indiv = bytearray(payload)
    struct.pack_into("<I", bad_indiv, offs[12] + 4, 0x80000000)
    cut = payload[: offs[20] + 13]
    return {
        "clean": (payload, offs[0], len(payload)),
        "window_straddling": (payload, offs[5], offs[40] - 3),
        "corrupt_l_shared": (bytes(bad_shared), offs[0], len(payload)),
        "corrupt_l_indiv": (bytes(bad_indiv), offs[0], len(payload)),
        "truncated": (cut, offs[0], len(cut)),
        "empty_window": (payload, offs[30], offs[30]),
    }


CASES = ["clean", "window_straddling", "corrupt_l_shared", "corrupt_l_indiv", "truncated",
         "empty_window"]
EXPECT_OK = {"clean": True, "window_straddling": True, "empty_window": True}


@pytest.mark.parametrize("case", CASES)
def test_walk_matches_the_reference_kernel_and_host_walk(corpus, case):
    payload, offs = _payload(corpus)
    buf, start, limit = _walk_cases(payload, offs)[case]
    cols, meta = tchain.walk_chain_device(
        torch.from_numpy(np.frombuffer(buf, np.uint8).copy()), start, limit)
    count, ok = (int(x) for x in meta)
    dev = jchain.walk_chain_device(buf, start, limit, interpret=True)
    host = jchain.walk_chain_host(buf, start, limit)
    assert count == int(dev[7]) == int(host[7])
    assert bool(ok) == bool(dev[8]) == bool(host[8]) == EXPECT_OK.get(case, False)
    for i in range(7):
        np.testing.assert_array_equal(cols[i, :count].numpy(), np.asarray(dev[i])[:count])
        np.testing.assert_array_equal(cols[i, :count].numpy(), np.asarray(host[i]))
    if case == "window_straddling":
        assert count == 35  # the record at offs[39] straddles the limit and completes
    if case == "clean":
        assert count == len(offs) == len(corpus["variants"])


def test_walk_chain_tiers(corpus, monkeypatch):
    """Clean: the walk answers ("device": the plain version for a CPU
    tensor).  Corrupt framing: the host walk re-walks, ok False.  A payload
    past the int32 domain goes to the host walk before any launch, with
    the same answer."""
    payload, offs = _payload(corpus)
    cases = _walk_cases(payload, offs)
    t = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    cols, n, ok, tier = tchain.walk_chain(t, offs[0], len(payload))
    assert (n, ok, tier) == (len(offs), True, "device")
    _, _, _, jtier = jchain.walk_chain(payload, offs[0], len(payload))
    bad, start, limit = cases["corrupt_l_shared"]
    got = tchain.walk_chain(torch.from_numpy(np.frombuffer(bad, np.uint8).copy()), start, limit)
    jgot = jchain.walk_chain(bad, start, limit)
    assert got[1:] == (9, False, "host") and jgot[1:] == (9, False, "host")
    monkeypatch.setattr(tchain, "MAX_PAYLOAD", len(payload) - 1)
    before = tchain.LAUNCHES.value
    cols_h, n_h, ok_h, tier_h = tchain.walk_chain(t, offs[0], len(payload))
    assert (n_h, ok_h, tier_h) == (n, True, "host")
    assert torch.equal(cols_h, cols)
    assert tchain.LAUNCHES.value == before  # no kernel on the CPU, none past the gate


def test_the_reference_chunk_cap_never_binds():
    """The reference's per-chunk record cap is above what a 4 MiB chunk can
    start (records are at least 32 bytes), so walking one window without
    chunks is its function: a stream of minimal records longer than a
    chunk walks whole."""
    assert jchain.CHUNK // tchain.MIN_RECORD < jchain.MAX_REC_PER_CHUNK
    n = jchain.CHUNK // 32 + 9000
    rec = struct.pack("<IIiiiIII", 24, 0, 1, 7, 1, 0x7F800001, 2 << 16, 0)
    buf = rec * n
    cols, meta = tchain.walk_chain_device(
        torch.from_numpy(np.frombuffer(buf, np.uint8).copy()), 0, len(buf))
    assert meta.tolist() == [n, 1]
    np.testing.assert_array_equal(cols[0, :n].numpy(), np.arange(n) * 32)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def test_specs_encode_and_decode_like_the_reference(corpus):
    lines, body = corpus["lines"], corpus["body"]
    jv, tv = jvcf.VcfHeader(list(lines)), tvcf.VcfHeader(list(lines))
    assert tbcf.encode_header(tv) == jbcf.encode_header(jv)
    jh, th = jbcf.BcfHeader(jv), tbcf.BcfHeader(tv)
    assert (th.strings, th.contigs, th.n_samples) == (jh.strings, jh.contigs, jh.n_samples)
    th2, off2 = tbcf.decode_header(tbcf.encode_header(tv))
    jh2, joff2 = jbcf.decode_header(jbcf.encode_header(jv))
    assert (off2, th2.strings, th2.contigs) == (joff2, jh2.strings, jh2.contigs)
    keys = []
    for ln in body:
        a, b = jvcf.parse_variant_line(ln), tvcf.parse_variant_line(ln)
        assert b.format_line() == a.format_line() == ln
        rec = tbcf.encode_record(th, b)
        assert rec == jbcf.encode_record(jh, a)
        tdec, tp = tbcf.decode_record(rec, 0, th)
        jdec, jp = jbcf.decode_record(rec, 0, jh)
        assert tp == jp == len(rec)
        assert tdec.format_line() == jdec.format_line()
        assert (tdec.start, tdec.end) == (jdec.start, jdec.end)
        assert tbcf.encode_record(th, tdec) == jbcf.encode_record(jh, jdec)
        k = tvcf.variant_key(tv, tdec)
        assert k == jvcf.variant_key(jv, jdec)
        keys.append(k)
    assert keys[0] == -1  # POS=0: the Java sign extension floods the high word
    assert tvcf.VcfHeader(list(lines)).contig_index("chrUn") == jv.contig_index("chrUn")
    assert tvcf.read_vcf("\n".join(lines + body))[1][5].format_line() == body[5]
    out = io.BytesIO()
    tbcf.write_bcf(out, tv, [tvcf.parse_variant_line(ln) for ln in body])
    jout = io.BytesIO()
    jbcf.write_bcf(jout, jv, [jvcf.parse_variant_line(ln) for ln in body])
    assert out.getvalue() == jout.getvalue()
    assert [v.format_line() for v in tbcf.read_bcf(out.getvalue())[1]] == body


@pytest.mark.parametrize(
    "text",
    ["chr1:1000-2000", "chr1", "chr1:1,000-2,000", "chr1:500", "a:b:1-5", "chr1:1,00-5",
     "chr1:5-1", ":1-2", "chr1:", "", "chr1:x-5", "chr1:0"],
)
def test_intervals_parse_like_the_reference(text):
    try:
        want = jiv.parse_interval(text)
    except jiv.FormatError as e:
        with pytest.raises(tiv.FormatError) as got:
            tiv.parse_interval(text)
        assert str(got.value) == str(e)
        return
    got = tiv.parse_interval(text)
    assert (got.contig, got.start, got.end, str(got)) == (want.contig, want.start, want.end,
                                                          str(want))
    assert tiv.MAX_END == jiv.MAX_END
    assert [str(i) for i in tiv.parse_intervals("c1:1-5,c2")] == ["c1:1-5", f"c2:1-{tiv.MAX_END}"]


def test_format_exception_is_the_interval_error():
    assert tfrag.FormatException is tiv.FormatError
    with pytest.raises(tfrag.FormatException):
        tiv.parse_interval("chr1:5-1")


# ---------------------------------------------------------------------------
# The input format
# ---------------------------------------------------------------------------


def _jsplits(path, split_size):
    return jio.BcfInputFormat(JConf()).get_splits([path], split_size=split_size)


def _port_read(split, props, gates: bool):
    conf = tconf.Configuration(dict(props, **(GATES_ON if gates else {})))
    stream = DeviceStream(CPU, conf=conf)
    fmt = tio.BcfInputFormat(conf, metrics=stream.metrics)
    return fmt.read_split(split, stream=stream), stream.metrics


def _ref_read(split, props, gates: bool):
    conf = JConf(dict(props, **({"hadoopbam.bcf.chain": "true"} if gates else {})))
    stream = JStream(conf=conf) if gates else None
    return jio.BcfInputFormat(conf).read_split(JSplit(split.path, split.vstart, split.vend),
                                               stream=stream)


def _same_batch(got, want):
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.pos, want.pos)
    np.testing.assert_array_equal(got.end, want.end)
    assert [v.format_line() for v in got.variants] == [v.format_line() for v in want.variants]


def test_get_splits_like_the_reference(corpus):
    for split_size in (2 << 10, 5000, 1 << 20):
        m = Metrics()
        got = tio.BcfInputFormat(metrics=m).get_splits([corpus["path"]], split_size=split_size)
        want = _jsplits(corpus["path"], split_size)
        assert [(s.vstart, s.vend) for s in got] == [(s.vstart, s.vend) for s in want]
        if split_size == 2 << 10:
            assert len(got) > 3
            assert m.get("bcf.guess.windows") >= len(got) - 1 and m.get("bcf.guess.verified")


@pytest.mark.parametrize("gates", [False, True], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("intervals", [None, "chr1:1000-30000,chr2:500-9000,chrM:1-1"],
                         ids=["all", "conf_intervals"])
def test_read_split_like_the_reference(corpus, gates, intervals):
    props = {} if intervals is None else {"hadoopbam.vcf.intervals": intervals}
    splits = tio.BcfInputFormat().get_splits([corpus["path"]], split_size=3000)
    total = 0
    for s in splits:
        got, m = _port_read(s, props, gates)
        want = _ref_read(s, props, gates)
        _same_batch(got, want)
        total += got.n_records
        if gates:
            assert m.get("bcf.chain.device_walks") == 1 and m.get("bcf.chain.resident_windows") == 1
            assert m.get("bcf.chain.records") >= got.n_records
            assert m.get("variants.join_device") == (intervals is not None)
            assert got.device_columns is not None
        else:
            assert not any(k.startswith(("bcf.chain", "variants.")) for k in m.counters())
    if intervals is None:
        assert total == len(corpus["variants"])
    else:
        assert 0 < total < len(corpus["variants"])


def test_read_split_counters_like_the_reference(corpus):
    """The walk and join tiers count as the reference counts them."""
    split = tio.BcfInputFormat().get_splits([corpus["path"]], split_size=1 << 30)[0]
    props = {"hadoopbam.vcf.intervals": "chr2:1-100000"}
    before = snapshot()
    _ref_read(split, props, True)
    d = delta(before)["counters"]
    _, m = _port_read(split, props, True)
    for k in ("bcf.chain.device_walks", "bcf.chain.host_walks", "bcf.chain.tierdowns",
              "bcf.chain.oracle_fallbacks", "bcf.chain.records", "variants.join_device",
              "variants.join_host"):
        assert m.get(k) == d.get(k, 0), k


def _corrupt(data: bytes, how: str) -> bytes:
    blocks = []
    p = 0
    while p < len(data) - 28:
        csize, _ = jbgzf.read_block_at(data, p)
        blocks.append((p, csize))
        p += csize
    mid, csize = blocks[len(blocks) // 2]
    if how == "flipped_byte":
        bad = bytearray(data)
        bad[mid + 20] ^= 0x55
        return bytes(bad)
    return data[: mid + csize // 2]  # truncated inside a member


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the class name is what both packages are held to
        return type(e).__name__
    return None


@pytest.mark.parametrize("gates", [False, True], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("how", ["flipped_byte", "truncated"])
def test_strict_errors_like_the_reference(corpus, tmp_path, how, gates):
    splits = tio.BcfInputFormat().get_splits([corpus["path"]], split_size=3000)
    bad = str(tmp_path / "bad.bcf")
    with open(bad, "wb") as f:
        f.write(_corrupt(corpus["data"], how))
    got = [_raised(lambda: _port_read(tbcf_split(bad, s), {}, gates)) for s in splits]
    want = [_raised(lambda: _ref_read(tbcf_split(bad, s), {}, gates)) for s in splits]
    assert got == want
    assert "BgzfError" in got


def tbcf_split(path, s):
    return type(s)(path, s.vstart, s.vend)


def test_salvage_is_not_ported(corpus, tmp_path):
    """BCF salvage is ported: on a flipped byte and a truncated member, with
    the walk gate off and on, every split reads as the reference's does,
    with its ``salvage.*`` counters; the clean splits of the gate-on read
    still take the walk."""
    splits = tio.BcfInputFormat().get_splits([corpus["path"]], split_size=3000)
    salvage = {"hadoopbam.errors": "salvage"}
    for how in ("flipped_byte", "truncated"):
        bad = str(tmp_path / f"{how}.bcf")
        with open(bad, "wb") as f:
            f.write(_corrupt(corpus["data"], how))
        for gates in (False, True):
            walks = 0
            for s in splits:
                s = tbcf_split(bad, s)
                before = snapshot()
                want = _ref_read(s, salvage, gates)
                d = delta(before)["counters"]
                got, m = _port_read(s, salvage, gates)
                _same_batch(got, want)
                for k in set(d) | set(m.counters()):
                    if k.startswith("salvage."):
                        assert m.get(k) == d.get(k, 0), (how, gates, k)
                walks += m.get("bcf.chain.device_walks")
            q = sum(_port_read(tbcf_split(bad, s), salvage, gates)[1].get(
                "salvage.members_quarantined") for s in splits)
            assert q >= 1, (how, gates)
            if gates:
                assert 0 < walks < len(splits)


# ---------------------------------------------------------------------------
# The ragged interval join
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_join_like_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 400
    refid = np.sort(rng.integers(0, 4, n))
    starts = rng.integers(-1, 50_000, n)
    ends = starts + rng.integers(1, 3000, n)
    windows = [
        (np.array([0, 0, 2, 3]), np.array([100, 30_000, 500, 10]),
         np.array([900, 30_100, 2500, 11])),
        (np.array([1]), np.array([60_000]), np.array([70_000])),  # overlaps nothing
        (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)),  # no windows
        (np.array([5, 2]), np.array([0, 0]), np.array([1, 2**31 - 1])),
    ]
    for q_refid, q_beg, q_end in windows:
        want = jov.ragged_overlap_mask(refid, starts, ends, q_refid, q_beg, q_end,
                                       use_device=True)
        host = tov.ragged_overlap_mask(refid, starts, ends, q_refid, q_beg, q_end)
        dev = tov.ragged_overlap_mask(torch.from_numpy(refid), torch.from_numpy(starts),
                                      torch.from_numpy(ends), q_refid, q_beg, q_end,
                                      use_device=True)
        np.testing.assert_array_equal(host, want)
        np.testing.assert_array_equal(dev.numpy(), want)
        for rid in np.unique(q_refid):
            rows = refid == rid
            sel = q_refid == rid
            np.testing.assert_array_equal(
                tov.join_mask_device(starts[rows], ends[rows], q_beg[sel], q_end[sel],
                                     device=torch.device("cpu")).numpy(),
                jov.join_mask_np(starts[rows], ends[rows], q_beg[sel], q_end[sel]))
    ivs = [jiv.parse_interval(t) for t in ("chr2:5-9", "chrZ:1-5", "chr1")]
    index = {"chr1": 0, "chr2": 1}.__getitem__
    np.testing.assert_array_equal(tov.intervals_to_array(index, ivs),
                                  jov.intervals_to_array(index, ivs))


# ---------------------------------------------------------------------------
# The slice: the ranged variants query
# ---------------------------------------------------------------------------

REGIONS = {
    "window": "chr1:1000-60000",
    "whole_contig": "chr2",
    "no_records": "chr1:100001-101000",
    "thousands": "chr1:120,000-180,000",
}


@pytest.mark.parametrize("region", list(REGIONS), ids=list(REGIONS))
def test_variants_blob_equals_the_reference(corpus, region):
    text = REGIONS[region]
    ctx = jend.ServeContext.from_conf(JConf(dict(GATES_ON)), with_batcher=False)
    try:
        want = jend.variants_blob(ctx, corpus["path"], text)
    finally:
        ctx.close()
    tctx = tend.ServeContext.from_conf(tconf.Configuration(dict(GATES_ON)), with_batcher=False,
                                       device="cpu")
    timings = {}
    got = tend.variants_blob(tctx, corpus["path"], text, timings=timings)
    assert got == want
    off = tend.ServeContext.from_conf(with_batcher=False, device="cpu")
    assert got == tend.variants_blob(off, corpus["path"], text)  # the gates off
    m = tctx.metrics
    n_splits = len(tio.BcfInputFormat().get_splits([corpus["path"]]))
    assert m.get("bcf.chain.device_walks") == m.get("variants.join_device") == n_splits
    assert set(timings) == {"plan", "read", "join", "encode"}
    blob = tbgzf.inflate_blocks(got, *tbgzf.scan_blocks(got))[0].tobytes()
    hdr, off = tbcf.decode_header(blob)
    rows = []
    while off + 8 <= len(blob):
        v, off = tbcf.decode_record(blob, off, hdr)
        rows.append(v.format_line())
    iv = tiv.parse_interval(text)
    expect = [ln for ln, v in zip(corpus["body"], corpus["variants"]) if iv.overlaps(
        v.chrom, v.start, v.end)]
    assert rows == expect and m.get("serve.variants.records") == len(expect)
    assert (len(expect) == 0) == (region == "no_records")


def test_unknown_contig_raises_format_error_in_both(corpus):
    ctx = jend.ServeContext.from_conf(JConf(), with_batcher=False)
    try:
        with pytest.raises(jiv.FormatError, match="unknown contig"):
            jend.variants_blob(ctx, corpus["path"], "chr9:1-100")
    finally:
        ctx.close()
    with pytest.raises(tiv.FormatError, match="unknown contig"):
        tend.variants_blob(tend.ServeContext.from_conf(with_batcher=False, device="cpu"),
                           corpus["path"], "chr9:1-100")


@pytest.mark.cuda
def test_walk_kernel_matches_plain_on_card(corpus):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the BCF chain kernel runs only on the card")
    payload, offs = _payload(corpus)
    for case, (buf, start, limit) in _walk_cases(payload, offs).items():
        t = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
        cols_k, meta_k = tchain.walk_chain_device(t.cuda(), start, limit)
        cols_p, meta_p = tchain.walk_chain_device(t, start, limit)
        count = int(meta_p[0])
        assert meta_k.cpu().tolist() == meta_p.tolist(), case
        assert torch.equal(cols_k[:, :count].cpu(), cols_p[:, :count]), case

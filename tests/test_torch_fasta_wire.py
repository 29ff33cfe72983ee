"""FASTA input and the variant wire format of the port against the
reference, on the CPU.

FASTA: the reference's two cases (``tests/test_vcf_fasta.py``
``TestFasta``) read fixture files that are not in the repo, so the input is
made from a seed: several contigs, blank lines, a description with spaces,
a last line without its newline, and gzip and BGZF copies.  Both packages
give the same splits and the same contig batches; the bases equal the
generator's.  Wire: the reference's ``tests/test_bcf.py`` cases (VCF text
round trip, BCF genotypes that travel unparsed and are re-attached, the
missing-QUAL sentinel, a re-encode mid-relay) with the bytes of both
packages' encodings held equal.
"""

import gzip
import io
import struct

import numpy as np
import pytest

from hadoop_bam_tpu.io.fasta import FastaInputFormat as JFasta
from hadoop_bam_tpu.spec import bcf as jbcf
from hadoop_bam_tpu.spec import bgzf as jbgzf
from hadoop_bam_tpu.spec import vcf as jvcf
from hadoop_bam_tpu.spec import wire as jwire
from hadoop_bam_tpu_torch.io import fs
from hadoop_bam_tpu_torch.io.fasta import FastaInputFormat
from hadoop_bam_tpu_torch.spec import bcf, vcf, wire
from test_bcf import LINES, _bcf_bytes


def make_fasta(seed=5, n_contigs=4, width=60):
    """``(text, {contig: bases})``: contigs of random length and case, with
    blank lines between some and no newline after the last."""
    rng = np.random.default_rng(seed)
    contigs, parts = {}, []
    for i in range(n_contigs):
        name = f"ctg{i}"
        n = int(rng.integers(1, 700))
        bases = bytes(rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), n))
        contigs[name] = bases
        desc = f">{name} description with spaces len={n}\n" if i % 2 else f">{name}\n"
        lines = [bases[j : j + width] for j in range(0, n, width)]
        parts.append(desc.encode() + b"\n".join(lines) + b"\n" + (b"\n" if i == 1 else b""))
    return b"".join(parts).rstrip(b"\n"), contigs


def _bgzf(data):
    buf = io.BytesIO()
    w = jbgzf.BgzfWriter(buf, level=5)
    w.write(data)
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("codec", ["plain", "gzip", "bgzf", "mem"])
def test_fasta_one_split_per_contig(tmp_path, codec):
    text, contigs = make_fasta()
    blob = {"gzip": gzip.compress, "bgzf": _bgzf}.get(codec, lambda d: d)(text)
    path = str(tmp_path / f"ref.fa{'.gz' if codec in ('gzip', 'bgzf') else ''}")
    with open(path, "wb") as f:
        f.write(blob)
    fmt, jfmt = FastaInputFormat(), JFasta()
    splits = jfmt.get_splits([path])
    if codec == "mem":
        mem = fs.MemFilesystem()
        fs.register_filesystem("mem", mem)
        with mem.open_write("mem://ref.fa") as w:
            w.write(blob)
        path = "mem://ref.fa"
    try:
        got_splits = fmt.get_splits([path])
        assert [(s.start, s.length) for s in got_splits] == [(s.start, s.length) for s in splits]
        assert len(got_splits) == len(contigs)
        for s, js, (name, bases) in zip(got_splits, splits, contigs.items()):
            b, jb = fmt.read_split(s), jfmt.read_split(js)
            assert b.contig == jb.contig == name
            np.testing.assert_array_equal(b.bases, jb.bases)
            np.testing.assert_array_equal(b.line_offsets, jb.line_offsets)
            np.testing.assert_array_equal(b.line_positions, jb.line_positions)
            assert b.bases.tobytes() == bases
            frags = b.fragments()
            assert [vars(f) for f in frags] == [vars(f) for f in jb.fragments()]
            assert frags[0].position == 1
            if len(frags) > 1:
                assert frags[1].position == 1 + len(frags[0].sequence)
    finally:
        fs._REGISTRY.pop("mem", None)


def test_fasta_split_not_at_a_description_raises_alike(tmp_path):
    text, _ = make_fasta()
    p = tmp_path / "ref.fa"
    p.write_bytes(text)
    s = FastaInputFormat().get_splits([str(p)])[1]
    js = JFasta().get_splits([str(p)])[1]
    s.start += 1
    s.length -= 1
    js.start += 1
    js.length -= 1
    with pytest.raises(IOError) as want:
        JFasta().read_split(js)
    with pytest.raises(IOError) as got:
        FastaInputFormat().read_split(s)
    assert type(got.value) is type(want.value)


def _port_variants():
    return [vcf.parse_variant_line(line) for line in LINES]


def _ref_variants():
    return [jvcf.parse_variant_line(line) for line in LINES]


def test_vcf_text_round_trip():
    for v, jv in zip(_port_variants(), _ref_variants()):
        raw = wire.encode_variant(v)
        assert raw == jwire.encode_variant(jv)
        got, used = wire.decode_variant(raw)
        assert used == len(raw)
        assert got.format_line() == v.format_line() == jv.format_line()


def test_bcf_lazy_genotypes_travel_unparsed():
    blob = _bcf_bytes()
    hdr, out = bcf.read_bcf(blob)
    jhdr, jout = jbcf.read_bcf(blob)
    v = out[0]
    raw = wire.encode_variant(v)  # genotypes still lazy at encode time
    assert v._lazy is not None
    assert raw == jwire.encode_variant(jout[0])
    got, used = wire.decode_variant(raw)  # no header: bytes survive
    assert used == len(raw) and hasattr(got, "_wire_bcf_genotypes")
    wire.reattach_genotypes(got, hdr)
    assert not hasattr(got, "_wire_bcf_genotypes")
    assert got.format_line() == v.format_line() == jout[0].format_line()
    with_header, _ = wire.decode_variant(raw, bcf_header=hdr)
    assert with_header.format_line() == v.format_line()


def test_missing_qual_wire_sentinel():
    v = _port_variants()[2]
    assert v.qual is None
    raw = wire.encode_variant(v)
    assert struct.pack("<I", bcf.FLOAT_MISSING_BITS) in raw
    got, _ = wire.decode_variant(raw)
    assert got.qual is None
    assert wire.decode_variant(raw)[0].format_line() == jwire.decode_variant(raw)[0].format_line()


def test_wire_reencode_without_header_keeps_genotypes():
    blob = _bcf_bytes()
    hdr, out = bcf.read_bcf(blob)
    v = out[0]
    hop1, _ = wire.decode_variant(wire.encode_variant(v))  # no header attached
    raw2 = wire.encode_variant(hop1)  # re-encode mid-relay
    _, jout = jbcf.read_bcf(blob)
    jhop1, _ = jwire.decode_variant(jwire.encode_variant(jout[0]))
    assert raw2 == jwire.encode_variant(jhop1)
    hop2, _ = wire.decode_variant(raw2)
    wire.reattach_genotypes(hop2, hdr)
    assert hop2.format_line() == v.format_line()


def test_stream_of_variants_decodes_in_order():
    """Encodings back to back decode one after another from one buffer."""
    hdr, out = bcf.read_bcf(_bcf_bytes(n_copies=2))
    vs = _port_variants() + out
    buf = b"".join(wire.encode_variant(v) for v in vs)
    p, back = 0, []
    while p < len(buf):
        v, p = wire.decode_variant(buf, p, bcf_header=hdr)
        back.append(v.format_line())
    assert back == [v.format_line() for v in vs]

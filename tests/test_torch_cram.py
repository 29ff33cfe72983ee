"""CRAM input of the port against the reference, byte for byte.

The rANS 4x8 codec (encode, plans, the NumPy tier, the oracle), the plain
version of the card's decode kernel against the reference's Pallas kernel
in interpret mode (and against the oracle on the streams that kernel
declines for its VMEM gates), the ``decompress_batch`` seam, the CRAM
writer and reader, container-aligned splits and ``read_split``, AnySAM
sniffing and ``sort_bam`` on ``.cram`` (no-ref and reference-based).
Inputs come from numpy seeds; every comparison is exact.
"""

import gzip
import os
import random
import struct
import types

import numpy as np
import pytest
import torch

import chip_smoke
from hadoop_bam_tpu import conf as jconf
from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.io import anysam as janysam
from hadoop_bam_tpu.io import cram as jiocram
from hadoop_bam_tpu.ops.pallas import rans_lanes as jrl
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.spec import cram as jcram
from hadoop_bam_tpu.spec import cram_codecs as jcc
from hadoop_bam_tpu_torch import pipeline as tpipeline
from hadoop_bam_tpu_torch.conf import (
    ANYSAM_TRUST_EXTS,
    CRAM_RANS_LANES,
    CRAM_REFERENCE_SOURCE_PATH,
    Configuration,
)
from hadoop_bam_tpu_torch.device_stream import DeviceStream
from hadoop_bam_tpu_torch.io import anysam as tanysam
from hadoop_bam_tpu_torch.io import cram as tiocram
from hadoop_bam_tpu_torch.ops.kernels import rans as kr
from hadoop_bam_tpu_torch.spec import bam as tbam
from hadoop_bam_tpu_torch.spec import bgzf as tbgzf
from hadoop_bam_tpu_torch.spec import cram as tcram
from hadoop_bam_tpu_torch.spec import cram_codecs as tcc

CPU = torch.device("cpu")
REFS = [("c1", 1 << 16), ("c2", 1 << 16)]


def _corpus():
    """Empty, 1-3 bytes, single-symbol runs, uniform-256, incompressible,
    small alphabets, and n % 4 tails around 4,096 bytes."""
    random.seed(7)
    return [
        b"", b"A", b"AB", b"ABC", b"hello",
        b"B" * 500, b"\x00" * 300, bytes(range(256)) * 4,
        bytes(random.choice(b"ACGT") for _ in range(1000)),
        bytes(random.getrandbits(8) for _ in range(800)),
        bytes(random.choice(b"abcdefgh") for _ in range(2000)),
        bytes(random.choice(bytes(16)) for _ in range(3000)),
        bytes(random.choice(b"xyz") for _ in range(4093)),
        bytes(random.choice(b"xyz") for _ in range(4094)),
        bytes(random.choice(b"xyz") for _ in range(4095)),
    ]


def _streams():
    """``(raw, encoded)`` of the corpus in both orders."""
    return [(r, tcc.rans_encode(r, o)) for r in _corpus() for o in (0, 1)]


def _drop_context(enc: bytes, ctx: int) -> bytes:
    """An order-1 stream whose outer table lacks ``ctx`` (not the first
    context, and not inside an RLE run)."""
    assert enc[0] == 1
    p = 9
    first = p
    cur = enc[p]
    p += 1
    while True:
        _, q = tcc._read_freq_table0(enc, p)
        nxt = enc[q]
        if nxt == ctx:
            _, r = tcc._read_freq_table0(enc, q + 1)
            assert enc[r] != ctx + 1
            return enc[:q] + enc[r:]
        assert nxt != cur + 1, "context in an RLE run"
        if nxt == 0:
            raise AssertionError(f"context {ctx} not in the table ({first})")
        cur, p = nxt, q + 1


def _corrupt_streams():
    """``{what: bytes}``: the malformed and corrupt cases."""
    good = tcc.rans_encode(b"QRSTUV" * 300, 0)
    o1 = tcc.rans_encode(b"AC" * 400 + b"AT" * 100, 1)
    zero = bytearray(good)
    n_freq = len(good) - 9 - len(tcc.parse_rans_plan(good).payload) - 16
    zero[9 + n_freq : 9 + n_freq + 16] = bytes(16)
    return {
        "truncated payload": good[:-40],
        "bad order": bytes([7]) + good[1:],
        "truncated table": good[:12],
        "zeroed states": bytes(zero),
        "order-1 missing context": _drop_context(o1, ord("T")),
    }


# ---------------------------------------------------------------------------
# The rANS codec
# ---------------------------------------------------------------------------


def test_rans_encode_writes_the_reference_bytes():
    for raw in _corpus() + [bytes(range(256)) * 8]:
        for order in (0, 1):
            enc = tcc.rans_encode(raw, order)
            assert enc == jcc.rans_encode(raw, order), (order, len(raw))
            assert tcc.compress(tcc.METHOD_RANS, raw) == jcc.compress(jcc.METHOD_RANS, raw)


def test_plans_numpy_tier_and_oracle_equal_the_reference():
    datas = [enc for _, enc in _streams()]
    for d in datas:
        tp, jp = tcc.parse_rans_plan(d), jcc.parse_rans_plan(d)
        assert (tp.order, tp.n_out, tp.states, tp.tables, tp.payload, tp.q4v) == (
            jp.order, jp.n_out, jp.states, jp.tables, jp.payload, jp.q4v)
        assert tcc.rans_decode_py(d, 0) == jcc.rans_decode_py(d, 0)
        assert tcc.rans_decode(d, 0) == jcc.rans_decode(d, 0)
    assert tcc.rans_decode_batch(datas) == jcc.rans_decode_batch(datas)
    to, tok = tcc._decode_plans_numpy([tcc.parse_rans_plan(d) for d in datas])
    jo, jok = jcc._decode_plans_numpy([jcc.parse_rans_plan(d) for d in datas])
    assert to == jo and np.array_equal(tok, jok)


@pytest.fixture(scope="module")
def declined():
    """Streams the reference's TPU gate declines: 256 order-1 contexts
    (``ctx``), 110,000 incompressible bytes (``vmem``: its payload is past
    about 104 KiB) and 1 MiB + 8 bytes (``size``)."""
    rng = np.random.default_rng(3)
    raws = [
        bytes(range(256)) * 8,
        rng.integers(0, 256, 110_000, dtype=np.uint8).tobytes(),
        rng.choice(np.frombuffer(b"ACGT", np.uint8), (1 << 20) + 8).tobytes(),
    ]
    return [(r, tcc.rans_encode(r, o)) for r, o in zip(raws, (1, 0, 0))]


def test_plain_kernel_equals_the_reference_kernel_and_oracle(declined):
    """The plain version decodes every stream the reference's interpret-mode
    kernel accepts to its bytes, with its verdicts and tier counts; the
    streams that kernel declines for VMEM reasons (the documented
    difference) decode to the oracle's bytes."""
    streams = _streams()
    datas = [enc for _, enc in streams]
    j_outs, j_stats = jrl.rans_lanes(datas, interpret=True)
    t_outs, t_stats = kr.rans_lanes(datas, CPU)
    assert j_stats.tierdown_ctx == 2  # uniform-256 in order 1, both copies
    for (raw, enc), jo, to in zip(streams, j_outs, t_outs):
        assert to == raw
        assert jo is None or jo == to
    accepted = [d for d, jo in zip(datas, j_outs) if jo is not None]
    _, ja = jrl.rans_lanes(accepted, interpret=True)
    _, ta = kr.rans_lanes(accepted, CPU)
    assert ta.as_dict() == vars(ja)
    assert t_stats.lanes == len(datas)
    reasons = []
    for raw, enc in declined:
        plan = jcc.parse_rans_plan(enc)
        ok, why = jrl.accepts(len(plan.payload), plan.n_out, len(plan.tables))
        assert (ok, why) == kr.accepts(len(plan.payload), plan.n_out, len(plan.tables))
        reasons.append(why)
    assert reasons == ["ctx", "vmem", "size"]
    got, st = kr.rans_lanes([enc for _, enc in declined], CPU)
    assert got == [raw for raw, _ in declined]
    assert got == [jcc.rans_decode_py(enc, 0) for _, enc in declined]
    assert st.as_dict() == {"lanes": 3, "host": 0, "tierdown_size": 0, "tierdown_vmem": 0,
                            "tierdown_ctx": 0, "tierdown_format": 0, "tierdown_ok0": 0}
    assert jrl.stream_geometry(100_000, 1 << 20, 40) == kr.stream_geometry(100_000, 1 << 20, 40)


def test_corrupt_streams_tier_down_and_are_rescued_like_the_reference():
    cases = _corrupt_streams()
    outs, st = kr.rans_lanes(list(cases.values()), CPU)
    assert outs == [None] * len(cases)
    assert (st.tierdown_format, st.tierdown_ok0) == (2, 3)
    j_outs, j_st = jrl.rans_lanes(list(cases.values()), interpret=True)
    assert j_outs == outs and (j_st.tierdown_format, j_st.tierdown_ok0) == (2, 3)
    for what, data in cases.items():
        blocks = [(tcc.METHOD_RANS, data, 100), (tcc.METHOD_RAW, b"ok", 2)]
        stream = DeviceStream(CPU, Configuration({CRAM_RANS_LANES: "true"}))
        try:
            want = jcc.decompress_batch(blocks, use_lanes=False)
        except Exception as e:  # the oracle's error class
            with pytest.raises(Exception) as got:
                tcc.decompress_batch(blocks, stream=stream)
            assert type(got.value).__name__ == type(e).__name__, what
        else:
            assert tcc.decompress_batch(blocks, stream=stream) == want, what
        got = tcc.decompress_batch(blocks, stream=stream, errors="salvage")
        assert got == jcc.decompress_batch(blocks, use_lanes=False, errors="salvage"), what


def test_packed_missing_context_gives_ok0():
    """The kernel's own verdict for an absent order-1 context (cmap -1)."""
    plan = tcc.parse_rans_plan(tcc.rans_encode(b"ACGT" * 64, 1))
    del plan.tables[ord("G")]
    h = kr.pack([plan])
    args = [torch.from_numpy(np.ascontiguousarray(h[k])) for k in ("payload", "meta", "lookup")]
    args += [torch.from_numpy(h["fc"].view(np.int32)), torch.from_numpy(h["cmap"])]
    _, ok = kr.rans_decode_device(*args, h["out_total"])
    assert ok.tolist() == [0]


def test_pack_aligns_and_pads_payloads():
    """Each payload starts 16-aligned and is padded with zeros to 16; the
    last is followed by ``PAY_SLACK`` zeros (what the kernel may read past a
    payload between two looks at its verdicts); the plain decode of the
    packed batch gives every stream's bytes."""
    streams = _streams()
    plans = [tcc.parse_rans_plan(enc) for _, enc in streams]
    keep = [i for i, p in enumerate(plans) if p.n_out]
    h = kr.pack([plans[i] for i in keep])
    meta, pay = h["meta"], h["payload"]
    assert kr.PAY_SLACK >= 8 * 16 + 12  # 16 groups of at most 8 bytes, and the 12-byte window
    ends = []
    for k, i in enumerate(keep):
        po, clen = int(meta[k, 0]), int(meta[k, 1])
        assert po % 16 == 0 and clen == len(plans[i].payload)
        assert pay[po : po + clen].tobytes() == plans[i].payload
        end = -(-clen // 16) * 16
        assert not pay[po + clen : po + end].any()
        ends.append(po + end)
    assert meta[1:, 0].tolist() == ends[:-1]
    assert len(pay) == ends[-1] + kr.PAY_SLACK and not pay[ends[-1]:].any()
    out, ok = kr.rans_decode_device(*chip_smoke.rans_host_tensors(h), h["out_total"])
    assert ok.tolist() == [1] * len(keep)
    for k, i in enumerate(keep):
        o, n = int(meta[k, 2]), int(meta[k, 3])
        assert out[o : o + n].numpy().tobytes() == streams[i][0]


@pytest.mark.parametrize("lanes", ["true", "false"])
@pytest.mark.parametrize("errors", ["strict", "salvage"])
def test_decompress_batch_equals_the_reference(lanes, errors):
    raws = _corpus()[:10]
    blocks = [(tcc.METHOD_RANS, tcc.rans_encode(r, i % 2), len(r)) for i, r in enumerate(raws)]
    blocks += [(tcc.METHOD_GZIP, gzip.compress(b"hello"), 5), (tcc.METHOD_RAW, b"xyz", 3),
               (tcc.METHOD_BZIP2, tcc.compress(tcc.METHOD_BZIP2, b"bz" * 9), 18),
               (tcc.METHOD_LZMA, tcc.compress(tcc.METHOD_LZMA, b"lz" * 9), 18),
               (tcc.METHOD_RANS, b"", 0)]
    if errors == "salvage":
        blocks += [(8, b"\x01\x02", 2), (tcc.METHOD_GZIP, b"\x1f\x8bgarbage", 5),
                   (tcc.METHOD_RANS, _corrupt_streams()["truncated payload"], 1800)]
    stream = DeviceStream(CPU, Configuration({CRAM_RANS_LANES: lanes}))
    got = stream.decompress_cram_blocks(blocks, errors=errors)
    assert got == jcc.decompress_batch(blocks, use_lanes=False, errors=errors)
    c = stream.metrics.counters()
    rans = [c.get(f"cram.rans.{k}", 0) for k in ("lanes_slices", "host_slices")]
    if lanes == "true":
        assert rans == [10, 1 if errors == "salvage" else 0]  # an empty block stays on the host
        assert c.get("device_stream.cram_decodes") == 1
    else:
        assert rans == [0, 0] and "device_stream.cram_decodes" not in c
    if errors == "salvage":
        assert (c["cram.codec.unsupported"], c["cram.codec.corrupt"]) == (1, 2)
    else:
        with pytest.raises(tcc.CramUnsupportedCodec):
            tcc.decompress_batch([(8, b"\x01", 1)], stream=stream)


# ---------------------------------------------------------------------------
# The CRAM spec: writer and reader
# ---------------------------------------------------------------------------


def _header_text(refs=REFS):
    return "@HD\tVN:1.6\tSO:unsorted\n" + "".join(f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in refs)


def _records(n=480, seed=2, ref=None):
    """``(port records, reference records)`` of one CRAM-representable
    corpus: mapped reads with clips, indels, skips, pads and hard clips,
    unmapped reads (MAPQ 0), detached mates and several aux types.  With
    ``ref`` (contig -> bases) every read is mapped and its M bases are the
    reference's."""
    rng = np.random.default_rng(seed)
    cigars = [[(36, "M")], [(3, "S"), (20, "M"), (2, "D"), (10, "M"), (1, "I"), (2, "M")],
              [(2, "H"), (30, "M"), (5, "N"), (6, "M")], [(10, "M"), (1, "P"), (26, "M")]]
    tags = [b"", b"NMi\x01\x00\x00\x00", b"RGZgrp1\x00", b"XSs\xff\x7fAMA\x07",
            b"BCB" + b"c" + struct.pack("<I", 3) + b"\x01\x02\x03"]
    t_recs, j_recs = [], []
    for i in range(n):
        unmapped = ref is None and i % 17 == 0
        cig = [] if unmapped else cigars[i % len(cigars)]
        refid = -1 if unmapped else int(rng.integers(0, 2))
        pos = -1 if unmapped else int(rng.integers(0, 20_000))
        l_seq = sum(k for k, op in cig if op in "MIS=X") or 36
        seq = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), l_seq).tobytes())
        if ref is not None:
            contig, rp, sp = ref[REFS[refid][0]], pos, 0
            for k, op in cig:
                if op == "M":
                    seq[sp : sp + k] = contig[rp : rp + k]
                if op in "MDN":
                    rp += k
                if op in "MIS":
                    sp += k
        flag = 4 if unmapped else (16 if i % 2 else 0) | (1 | 0x40 if i % 5 == 0 else 0)
        kw = dict(name=f"r{i:05d}", refid=refid, pos=pos, mapq=0 if unmapped else 30 + i % 7,
                  flag=flag, cigar=cig, seq=seq.decode(),
                  qual=rng.integers(2, 41, l_seq, dtype=np.uint8).tobytes(),
                  next_refid=refid if i % 5 == 0 else -1,
                  next_pos=pos + 100 if i % 5 == 0 else -1,
                  tlen=136 if i % 5 == 0 else 0, tags=tags[i % len(tags)])
        t_recs.append(tbam.decode_record(tbam.build_record(**kw))[0])
        j_recs.append(jbam.build_record(**kw))
    return t_recs, j_recs


def _write(path, recs, header=None, codec="rans", per=120, module=tcram):
    with open(path, "wb") as f:
        module.write_cram(f, header or tbam.header_from_text(_header_text()), recs,
                          records_per_container=per, codec=codec)
    return path


def _write_bam(path, recs, text):
    with open(path, "wb") as f:
        jbam.write_bam(f, jbam.header_from_text(text), iter(recs), level=1)
    return path


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    td = tmp_path_factory.mktemp("cram")
    t_recs, j_recs = _records()
    return {
        "t_recs": t_recs, "j_recs": j_recs,
        "cram": _write(str(td / "twin.cram"), t_recs),
        "gzip": _write(str(td / "twin.gz.cram"), t_recs, codec="gzip", per=80),
        "bam": _write_bam(str(td / "twin.bam"), j_recs, _header_text()),
    }


@pytest.mark.parametrize("codec", ["gzip", "rans"])
def test_writer_writes_the_reference_bytes(tmp_path, monkeypatch, twins, codec):
    # Both writers stamp gzip members with the clock: hold it still.
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1.6e9))
    t = _write(str(tmp_path / "t.cram"), twins["t_recs"], codec=codec, per=100)
    j = _write(str(tmp_path / "j.cram"), twins["j_recs"], codec=codec, per=100,
               header=jbam.header_from_text(_header_text()), module=jcram)
    with open(t, "rb") as f, open(j, "rb") as g:
        assert f.read() == g.read()
    assert tcram.encode_container(twins["t_recs"][:50], 7, codec=codec) == \
        jcram.encode_container(twins["j_recs"][:50], 7, codec=codec)
    assert tcram.encode_file_header_container("@HD\tVN:1.6\n") == \
        jcram.encode_file_header_container("@HD\tVN:1.6\n")


def test_record_writer_writes_the_reference_bytes(tmp_path, monkeypatch, twins):
    """``CramRecordWriter`` record by record and from a decoded batch (parts
    without the file header or EOF, and whole files)."""
    import io

    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1.6e9))
    th, jh = tbam.header_from_text(_header_text()), jbam.header_from_text(_header_text())
    batch = tiocram.CramInputFormat().read_split(
        tiocram.CramInputFormat().get_splits([twins["gzip"]])[0])
    order = np.argsort(batch.keys, kind="stable")
    for kw in ({}, {"write_header": False, "append_eof": True}):
        t, j, tb = io.BytesIO(), io.BytesIO(), io.BytesIO()
        with tiocram.CramRecordWriter(t, th, records_per_container=70, **kw) as w:
            for r in twins["t_recs"][:200]:
                w.write_record(r)
        with jiocram.CramRecordWriter(j, jh, records_per_container=70, **kw) as w:
            for r in twins["j_recs"][:200]:
                w.write_record(r)
        assert t.getvalue() == j.getvalue()
        with tiocram.CramRecordWriter(tb, th, **kw) as w:
            w.write_batch(batch, order=order)
        one = io.BytesIO()
        with tiocram.CramRecordWriter(one, th, **kw) as w:
            for i in order:
                w.write_record(twins["t_recs"][i])
        assert tb.getvalue() == one.getvalue()


@pytest.mark.parametrize("which", ["cram", "gzip"])
def test_reader_gives_the_reference_records(twins, which):
    with open(twins[which], "rb") as f:
        data = f.read()
    assert [vars(c) for c in tcram.iter_containers(data)] == \
        [vars(c) for c in jcram.iter_containers(data)]
    assert tcram.read_cram_header_text(data) == jcram.read_cram_header_text(data)
    th, trecs = tcram.read_cram(twins[which])
    jh, jrecs = jcram.read_cram(twins[which])
    assert (th.text, th.refs) == (jh.text, jh.refs)
    assert [r.encode() for r in trecs] == [r.encode() for r in jrecs]
    assert [r.encode() for r in trecs] == [r.encode() for r in twins["j_recs"]]
    stream = DeviceStream(CPU, Configuration({CRAM_RANS_LANES: "true"}))
    major, _ = tcram.parse_file_definition(data)
    ch = tcram.iter_containers(data)[2]
    got = tcram.decode_container(data, ch, major, stream=stream)
    assert [r.encode() for r in got] == \
        [r.encode() for r in jcram.decode_container(data, ch, major)]
    assert stream.metrics.get("cram.rans.lanes_slices") == (20 if which == "cram" else 0)


def test_corrupt_slice_salvage_counts_strict_raises(twins):
    """A bad order byte in the first rANS external block: strict raises the
    reference's error, salvage quarantines that slice as the reference does."""
    with open(twins["cram"], "rb") as f:
        data = bytearray(f.read())
    major, _ = tcram.parse_file_definition(data)
    ch = tcram.iter_containers(bytes(data))[1]
    pos = ch.offset + ch.header_size
    while True:
        p0 = pos
        fr, pos = tcram.Block.read_frame(data, pos, major)
        if fr.method == tcc.METHOD_RANS and fr.content_type == tcram.CT_EXTERNAL:
            q = p0 + 2
            for _ in range(3):
                _, q = tcram.read_itf8(data, q)
            data[q] = 7
            break
    data = bytes(data)
    with pytest.raises(tcram.CramError):
        tcram.read_cram(data)
    stream = DeviceStream(CPU, Configuration({CRAM_RANS_LANES: "true"}))
    _, got = tcram.read_cram(data, stream=stream, errors="salvage")
    _, want = jcram.read_cram(data, errors="salvage")
    assert [r.encode() for r in got] == [r.encode() for r in want] and 0 < len(got) < 480
    assert stream.metrics.get("cram.slice.quarantined") == 1


# ---------------------------------------------------------------------------
# Input formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split_size", [1 << 10, 5000, 64 << 10])
def test_splits_and_split_reads_equal_the_reference(twins, split_size):
    tf, jf = tiocram.CramInputFormat(), jiocram.CramInputFormat()
    ts = tf.get_splits([twins["cram"], twins["gzip"]], split_size)
    js = jf.get_splits([twins["cram"], twins["gzip"]], split_size)
    assert [(s.path, s.start, s.length) for s in ts] == [(s.path, s.start, s.length) for s in js]
    assert [tf.count_records(s) for s in ts] == [jf.count_records(s) for s in js]
    stream = DeviceStream(CPU, Configuration({CRAM_RANS_LANES: "true"}))
    n = 0
    for t, j in zip(ts, js):
        tb = tf.read_split(t, stream=stream, fields=("rec_off",), with_keys=False)
        jb = jf.read_split(j)
        assert bytes(tb.data) == bytes(jb.data)
        assert tb.soa.keys() == jb.soa.keys()
        assert all(np.array_equal(tb.soa[k], jb.soa[k]) for k in jb.soa)
        assert np.array_equal(tb.keys, jb.keys)
        n += tb.n_records
    assert n == 2 * 480
    with open(twins["cram"], "rb") as f:
        data = f.read()
    for t, j in zip(ts[:2], js[:2]):
        assert np.array_equal(tf.read_split(t, data=data).keys, jf.read_split(j, data=data).keys)
    assert [vars(c) for c in tf.container_inventory(twins["cram"])] == \
        [vars(c) for c in jf.container_inventory(twins["cram"])]


def test_anysam_sniffs_like_the_reference(tmp_path, twins):
    import shutil

    odd = str(tmp_path / "twin.bam")  # a CRAM with a BAM extension
    shutil.copy(twins["cram"], odd)
    noext = str(tmp_path / "data")
    shutil.copy(twins["bam"], noext)
    for b in (0x1F, 0x43, 0x40, 0x00):
        assert tanysam.infer_from_data(b) == janysam.infer_from_data(b)
    for p in ("a.BAM", "b.cram", "c.sam", "d.txt"):
        assert tanysam.infer_from_file_path(p) == janysam.infer_from_file_path(p)
    for trust in ("true", "false"):
        t = tanysam.AnySamInputFormat(Configuration({ANYSAM_TRUST_EXTS: trust}))
        j = janysam.AnySamInputFormat(jconf.Configuration({jconf.ANYSAM_TRUST_EXTS: trust}))
        for p in (twins["cram"], twins["bam"], odd, noext):
            assert t.get_format(p) == j.get_format(p)
    t = tanysam.AnySamInputFormat(Configuration({ANYSAM_TRUST_EXTS: "false"}))
    j = janysam.AnySamInputFormat(jconf.Configuration({jconf.ANYSAM_TRUST_EXTS: "false"}))
    ts, js = t.get_splits([odd, noext], 16 << 10), j.get_splits([odd, noext], 16 << 10)
    key = lambda s: (s.path, getattr(s, "start", None), getattr(s, "vstart", None))  # noqa: E731
    assert [key(s) for s in ts] == [key(s) for s in js]
    for a, b in zip(ts, js):
        assert np.array_equal(t.read_split(a).keys, j.read_split(b).keys)
    assert t.read_header(odd).text == j.read_header(odd).text
    # A SAM text twin: the reference's splits and batches, and the header
    # the port reads as text (the reference's AnySAM reader takes BGZF).
    from hadoop_bam_tpu.spec import sam as jsam

    sam = str(tmp_path / "twin.sam")
    with open(sam, "wb") as f:
        jsam.write_sam(f, jbam.header_from_text(_header_text()), twins["j_recs"])
    t, j = tanysam.AnySamInputFormat(), janysam.AnySamInputFormat()
    ts, js = t.get_splits([sam], 16 << 10), j.get_splits([sam], 16 << 10)
    assert [(s.start, s.length) for s in ts] == [(s.start, s.length) for s in js]
    assert len(ts) > 1
    for a, b in zip(ts, js):
        tb, jb = t.read_split(a), j.read_split(b)
        assert np.array_equal(tb.keys, jb.keys)
        assert np.asarray(tb.data).tobytes() == np.asarray(jb.data).tobytes()
    assert t.read_header(sam).text == _header_text().rstrip("\n")


def test_merge_cram_parts_writes_the_reference_bytes(tmp_path, monkeypatch, twins):
    """Headerless CRAM parts merge into the reference's file: the file
    definition and header container, the parts untouched, the EOF
    container; the merged file reads back to every record."""
    from hadoop_bam_tpu.io import merger as jmerger
    from hadoop_bam_tpu.utils import nio as jnio
    from hadoop_bam_tpu_torch.io import merger as tmerger

    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1.6e9))
    part_dir = tmp_path / "parts"
    part_dir.mkdir()
    recs = twins["t_recs"]
    for i, lo in enumerate(range(0, len(recs), 200)):
        (part_dir / f"part-r-{i:05d}").write_bytes(
            tcram.encode_container(recs[lo : lo + 200], 0, codec="gzip"))
    out_t, out_j = str(tmp_path / "t.cram"), str(tmp_path / "j.cram")
    with pytest.raises(FileNotFoundError):
        tmerger.merge_cram_parts(str(part_dir), out_t, tbam.header_from_text(_header_text()))
    jnio.write_success(part_dir)
    tmerger.merge_cram_parts(str(part_dir), out_t, tbam.header_from_text(_header_text()))
    jmerger.merge_cram_parts(str(part_dir), out_j, jbam.header_from_text(_header_text()))
    assert _read(out_t) == _read(out_j)
    f = tiocram.CramInputFormat()
    got = b"".join(np.asarray(f.read_split(s).data).tobytes() for s in f.get_splits([out_t]))
    assert got == b"".join(r.encode() for r in recs)


# ---------------------------------------------------------------------------
# sort_bam on .cram
# ---------------------------------------------------------------------------

RANS_ON = Configuration({CRAM_RANS_LANES: "true"})


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_sort_cram_writes_the_reference_bytes(tmp_path, twins):
    out_t, out_j, out_b = (str(tmp_path / f"{k}.bam") for k in ("t", "j", "b"))
    st = tpipeline.sort_bam(twins["cram"], out_t, conf=RANS_ON, device="cpu",
                            split_size=64 << 10)
    jpipeline.sort_bam(twins["cram"], out_j, split_size=64 << 10)
    assert _read(out_t) == _read(out_j)
    assert st.backend == "single-device" and st.n_records == 480
    assert st.counters["cram.rans.lanes_slices"] == 80 and not st.counters.get(
        "cram.rans.host_slices")
    tpipeline.sort_bam(twins["bam"], out_b, device="cpu", split_size=64 << 10)
    assert _read(out_b) == _read(out_t)
    # Several splits, the gate off, the device parse asked for: the same bytes.
    out_s, out_js = str(tmp_path / "s.bam"), str(tmp_path / "js.bam")
    st = tpipeline.sort_bam(twins["cram"], out_s, device="cpu", split_size=8 << 10,
                            device_parse=True)
    jpipeline.sort_bam(twins["cram"], out_js, split_size=8 << 10)
    assert st.n_splits > 1 and _read(out_s) == _read(out_js)
    assert not any(k.startswith("cram.rans.") for k in st.counters)


def test_sort_reference_based_cram(tmp_path, monkeypatch):
    """RR=true: every mapped base comes from the FASTA named by
    ``hadoopbam.cram.reference-source-path``."""
    rng = np.random.default_rng(9)
    ref = {n: rng.choice(np.frombuffer(b"ACGT", np.uint8), ln).tobytes() for n, ln in REFS}
    fasta = tmp_path / "ref.fa"
    fasta.write_text("".join(f">{n} x\n" + "\n".join(
        ref[n][k : k + 60].decode().lower() for k in range(0, len(ref[n]), 60)) + "\n"
        for n, _ in REFS))
    t_recs, j_recs = _records(n=240, seed=4, ref=ref)
    orig = tcram._build_compression_header
    monkeypatch.setattr(tcram, "_build_compression_header",
                        lambda *a: orig(*a).replace(b"RR\x00", b"RR\x01"))
    src = _write(str(tmp_path / "ref.cram"), t_recs, per=60)
    monkeypatch.undo()
    with open(src, "rb") as f:
        data = f.read()
    ch = tcram.iter_containers(data)[1]
    fr, _ = tcram.Block.read_frame(data, ch.offset + ch.header_size, 3)
    assert tcram.CompressionHeader.parse(
        tcc.decompress(fr.method, fr.payload, fr.raw_size)).rr_required
    with pytest.raises(tcram.CramError, match="reference-source-path"):
        tcram.read_cram(src)
    conf = {CRAM_REFERENCE_SOURCE_PATH: str(fasta), CRAM_RANS_LANES: "true"}
    fmt = tiocram.CramInputFormat(Configuration(conf))
    got = fmt.read_split(fmt.get_splits([src])[0])
    want_blob = b"".join(r.encode() for r in j_recs)
    assert bytes(got.data) == want_blob
    out_t, out_j, out_b = (str(tmp_path / f"{k}.bam") for k in ("t", "j", "b"))
    st = tpipeline.sort_bam(src, out_t, conf=Configuration(conf), device="cpu")
    jpipeline.sort_bam(src, out_j, conf=jconf.Configuration(
        {jconf.CRAM_REFERENCE_SOURCE_PATH: str(fasta)}))
    assert _read(out_t) == _read(out_j)
    assert st.counters["cram.rans.lanes_slices"] > 0
    tpipeline.sort_bam(_write_bam(str(tmp_path / "twin.bam"), j_recs, _header_text()), out_b,
                       device="cpu")
    assert _read(out_b) == _read(out_t)
    content = tbgzf.inflate_blocks(_read(out_t), *tbgzf.scan_blocks(_read(out_t)))[0]
    assert len(content) > len(want_blob)


@pytest.mark.cuda
def test_rans_kernel_matches_plain_on_card(declined):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the rANS kernel runs only on the card")
    datas = [enc for _, enc in _streams() + declined] + list(_corrupt_streams().values())
    datas += list(chip_smoke.rans_state_cases(0).values())
    plans = [tcc.parse_rans_plan(d) for d in datas if d[0] in (0, 1) and len(d) > 12]
    plans = [p for p in plans if p.n_out]
    h = kr.pack(plans)
    host = chip_smoke.rans_host_tensors(h)
    out_k, ok_k = kr.rans_decode_device(*[t.cuda() for t in host], h["out_total"])
    out_p, ok_p = kr.rans_decode_device(*host, h["out_total"])
    assert ok_k.cpu().tolist() == ok_p.tolist()
    out_k = out_k.cpu()
    for i, good in enumerate(ok_p.tolist()):
        if good:
            o, n = int(h["meta"][i, 2]), int(h["meta"][i, 3])
            assert torch.equal(out_k[o : o + n], out_p[o : o + n]), i

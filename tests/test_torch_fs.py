"""The filesystem seam of the port against the reference, on the CPU.

The cases are the reference's ``tests/test_fs.py``: scheme dispatch, the
``mem://`` round trips, split-local reads behind a counting filesystem
(``cnt://``) for SAM, BAM, plain and BGZF VCF, BCF and CRAM, the HTTP
primitives against a loopback server (one that honours ``Range`` and one
that ignores it), a sort whose input arrives over ``http://``, and the
``gs://`` adapter against the loopback endpoint.  Each runs the same input,
made from a seed, through both packages: the splits, records, bytes and
exception classes are equal, and a split of the port reads no more bytes
than the reference's.  The error cases check that nothing is swallowed:
an unknown scheme, a 404 on a sort's input and a 5xx that outlasts the
retries raise the same class in both, and the retries count the same.
"""

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from hadoop_bam_tpu import pipeline as jpipeline
from hadoop_bam_tpu.conf import Configuration as JConf
from hadoop_bam_tpu.io import fs as jfs
from hadoop_bam_tpu.io.bam import BamInputFormat as JBam
from hadoop_bam_tpu.io.bam import read_header as jread_header
from hadoop_bam_tpu.io.bcf import BcfInputFormat as JBcf
from hadoop_bam_tpu.io.bcf import BcfRecordWriter as JBcfWriter
from hadoop_bam_tpu.io.cram import CramInputFormat as JCram
from hadoop_bam_tpu.io.cram import CramRecordWriter as JCramWriter
from hadoop_bam_tpu.io.fastq import FastqInputFormat as JFastq
from hadoop_bam_tpu.io.sam import SamInputFormat as JSam
from hadoop_bam_tpu.io.vcf import VcfInputFormat as JVcf
from hadoop_bam_tpu.spec import bam as jbam
from hadoop_bam_tpu.spec import bgzf as jbgzf
from hadoop_bam_tpu.spec import sam as jsam
from hadoop_bam_tpu.spec.vcf import VcfHeader as JVcfHeader
from hadoop_bam_tpu.spec.vcf import parse_variant_line as jparse_variant_line
from hadoop_bam_tpu.utils.tracing import delta, snapshot
from hadoop_bam_tpu_torch import pipeline
from hadoop_bam_tpu_torch.conf import from_reference_conf
from hadoop_bam_tpu_torch.io import fs
from hadoop_bam_tpu_torch.io.bam import BamInputFormat, read_header
from hadoop_bam_tpu_torch.io.bcf import BcfInputFormat
from hadoop_bam_tpu_torch.io.cram import CramInputFormat
from hadoop_bam_tpu_torch.io.fastq import FastqInputFormat
from hadoop_bam_tpu_torch.io.sam import SamInputFormat
from hadoop_bam_tpu_torch.io.vcf import VcfInputFormat
from hadoop_bam_tpu_torch.utils.tracing import Metrics
from test_fs import CountingFs as JCountingFs
from test_fs import _RangeHandler, http_server, make_bam_bytes, make_vcf_text  # noqa: F401
from test_torch_sort_bam import HOST


class CountingFs(fs.LocalFilesystem):
    """Local files behind a counting seam (scheme ``cnt://``)."""

    def __init__(self):
        self.bytes_read = 0

    @staticmethod
    def _strip(path):
        return path[6:] if path.startswith("cnt://") else path

    def read_range(self, path, start, length, metrics=None):
        out = super().read_range(path, start, length, metrics=metrics)
        self.bytes_read += len(out)
        return out

    def read_all(self, path, metrics=None):
        out = super().read_all(path, metrics=metrics)
        self.bytes_read += len(out)
        return out


@pytest.fixture
def counting():
    """``cnt://`` registered in both packages: ``(port fs, reference fs)``."""
    pair = CountingFs(), JCountingFs()
    fs.register_filesystem("cnt", pair[0])
    jfs.register_filesystem("cnt", pair[1])
    yield pair
    fs._REGISTRY.pop("cnt", None)
    jfs._REGISTRY.pop("cnt", None)


@pytest.fixture
def mem():
    """``mem://`` registered in both packages: ``(port fs, reference fs)``."""
    pair = fs.MemFilesystem(), jfs.MemFilesystem()
    fs.register_filesystem("mem", pair[0])
    jfs.register_filesystem("mem", pair[1])
    yield pair
    fs._REGISTRY.pop("mem", None)
    jfs._REGISTRY.pop("mem", None)


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _keys(batches):
    return [np.asarray(b.keys).tolist() for b in batches]


def _splits(splits):
    return [(s.path, s.vstart, s.vend) for s in splits]


def _raises_alike(call_port, call_ref):
    """Both calls raise; the classes and messages are equal."""
    with pytest.raises(Exception) as ref:
        call_ref()
    with pytest.raises(Exception) as port:
        call_port()
    assert type(port.value) is type(ref.value)
    assert str(port.value) == str(ref.value)
    return port.value


def test_scheme_dispatch_and_errors(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"hello world")
    for mod in (fs, jfs):
        local = mod.get_fs(str(p))
        assert bytes(local.read_range(str(p), 6, 5)) == b"world"
        assert local.size(f"file://{p}") == 11
        assert bytes(local.read_all(f"file://{p}")) == b"hello world"
        assert mod.path_scheme("mem://a/b") == "mem"
        assert mod.path_scheme("HTTP://a/b") == "http"
        assert mod.path_scheme("/plain/path") == ""
    err = _raises_alike(lambda: fs.get_fs("gs://bucket/x.bam"),
                        lambda: jfs.get_fs("gs://bucket/x.bam"))
    assert isinstance(err, ValueError)
    _raises_alike(lambda: fs.get_fs("foo://x"), lambda: jfs.get_fs("foo://x"))


def test_unknown_scheme_raises_in_every_entry(tmp_path):
    """An unregistered scheme fails the reader and the sort alike."""
    src = "s3://bucket/in.bam"
    _raises_alike(lambda: BamInputFormat().get_splits([src]),
                  lambda: JBam().get_splits([src]))
    _raises_alike(
        lambda: pipeline.sort_bam([src], str(tmp_path / "a.bam"), device="cpu"),
        lambda: jpipeline.sort_bam([src], str(tmp_path / "b.bam"), backend="host"))


def test_mem_roundtrip_bam(mem):
    blob = make_bam_bytes(n=3000, seed=3)
    for m in mem:
        with m.open_write("mem://bams/a.bam") as w:
            w.write(blob)
    assert mem[0].listdir("mem://bams/") == mem[1].listdir("mem://bams/") == ["mem://bams/a.bam"]
    fmt, jfmt = BamInputFormat(), JBam()
    splits = fmt.get_splits(["mem://bams/a.bam"], split_size=16 << 10)
    jsplits = jfmt.get_splits(["mem://bams/a.bam"], split_size=16 << 10)
    assert len(splits) > 1 and _splits(splits) == _splits(jsplits)
    got = [fmt.read_split(s) for s in splits]
    want = [jfmt.read_split(s) for s in jsplits]
    assert sum(b.n_records for b in got) == len(jbam.read_bam(blob)[1])
    assert _keys(got) == _keys(want)
    assert read_header("mem://bams/a.bam").text == jread_header("mem://bams/a.bam").text
    with pytest.raises(FileNotFoundError):
        mem[0].size("mem://bams/none.bam")


def test_mem_roundtrip_fastq(mem):
    text = b"".join(b"@r%05d\nACGTACGT\n+\nIIIIIIII\n" % i for i in range(1000))
    for m in mem:
        with m.open_write("mem://fq/a.fastq") as w:
            w.write(text)
    fmt, jfmt = FastqInputFormat(), JFastq()
    splits = fmt.get_splits(["mem://fq/a.fastq"], split_size=4 << 10)
    assert len(splits) > 1
    assert [(s.start, s.length) for s in splits] == [
        (s.start, s.length) for s in jfmt.get_splits(["mem://fq/a.fastq"], split_size=4 << 10)]
    total = 0
    for s in splits:
        a, b = fmt.read_split(s), jfmt.read_split(s)
        assert a.names == b.names
        np.testing.assert_array_equal(a.seq, b.seq)
        np.testing.assert_array_equal(a.qual, b.qual)
        total += a.n_records
    assert total == 1000


def _sam_file(tmp_path):
    blob = make_bam_bytes(n=4000, seed=1)
    hdr, recs = jbam.read_bam(blob)
    lines = [jsam.record_to_sam_line(r, hdr) for r in recs]
    p = tmp_path / "big.sam"
    p.write_bytes((hdr.text.rstrip("\n") + "\n" + "\n".join(lines) + "\n").encode())
    return p, SamInputFormat(), JSam(), 32 << 10, len(recs), p.stat().st_size // 2


def _bam_file(tmp_path):
    p = tmp_path / "big.bam"
    p.write_bytes(make_bam_bytes(n=12000, seed=2))
    return p, BamInputFormat(), JBam(), 32 << 10, 12000, p.stat().st_size


def _vcf_file(tmp_path):
    p = tmp_path / "big.vcf"
    p.write_text(make_vcf_text(n=20000))
    return p, VcfInputFormat(), JVcf(), 32 << 10, 20000, p.stat().st_size // 2


def _vcf_bgzf_file(tmp_path):
    buf = io.BytesIO()
    w = jbgzf.BgzfWriter(buf, level=5)
    w.write(make_vcf_text(n=20000).encode())
    w.close()
    p = tmp_path / "big.vcf.bgz"
    p.write_bytes(buf.getvalue())
    return p, VcfInputFormat(), JVcf(), 16 << 10, 20000, p.stat().st_size + (1 << 20)


def _bcf_file(tmp_path):
    head = JVcfHeader.parse(
        "##fileformat=VCFv4.2\n"
        "##INFO=<ID=DP,Number=1,Type=Integer,Description=\"Depth\">\n"
        "##FILTER=<ID=PASS,Description=\"ok\">\n"
        + "".join(f"##contig=<ID=chr{c}>\n" for c in (1, 2))
        + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    buf = io.BytesIO()
    w = JBcfWriter(buf, head)
    n = 60000
    for i in range(n):
        w.write(jparse_variant_line(f"chr{1 + i % 2}\t{100 + i}\t.\tA\tG\t50\tPASS\tDP={i % 9}"))
    w.close()
    p = tmp_path / "big.bcf"
    p.write_bytes(buf.getvalue())
    return p, BcfInputFormat(), JBcf(), 8 << 10, n, p.stat().st_size


def _cram_file(tmp_path):
    hdr, recs = jbam.read_bam(make_bam_bytes(n=12000, seed=6))
    buf = io.BytesIO()
    w = JCramWriter(buf, hdr, records_per_container=200)
    for r in recs:
        w.write_record(r)
    w.close()
    p = tmp_path / "big.cram"
    p.write_bytes(buf.getvalue())
    return p, CramInputFormat(), JCram(), 16 << 10, len(recs), p.stat().st_size // 2


def _n(batch):
    return len(batch.variants) if hasattr(batch, "variants") else batch.n_records


@pytest.mark.parametrize("make", [_sam_file, _bam_file, _vcf_file, _vcf_bgzf_file, _bcf_file,
                                  _cram_file],
                         ids=["sam", "bam", "vcf", "vcf_bgzf", "bcf", "cram"])
def test_split_read_is_split_local(tmp_path, counting, make):
    """A mid-file split reads no more bytes through the seam in the port
    than in the reference, and under the reference's own bound; the splits
    together read every record once, split by split as the reference."""
    p, fmt, jfmt, split_size, n, limit = make(tmp_path)
    path = f"cnt://{p}"
    splits = fmt.get_splits([path], split_size=split_size)
    jsplits = jfmt.get_splits([path], split_size=split_size)
    assert len(splits) == len(jsplits) > 2
    mid, jmid = splits[len(splits) // 2], jsplits[len(jsplits) // 2]
    counting[0].bytes_read = counting[1].bytes_read = 0
    got, want = fmt.read_split(mid), jfmt.read_split(jmid)
    assert _n(got) == _n(want) > 0
    assert counting[0].bytes_read <= counting[1].bytes_read
    assert counting[0].bytes_read < limit
    assert [_n(fmt.read_split(s)) for s in splits] == [_n(jfmt.read_split(s)) for s in jsplits]
    assert sum(_n(fmt.read_split(s)) for s in splits) == n


def test_http_primitives(http_server):  # noqa: F811
    base, files = http_server
    files["/data.bin"] = bytes(range(256)) * 10
    url = f"{base}/data.bin"
    for h in (fs.get_fs(url), jfs.get_fs(url)):
        assert h.size(url) == 2560
        assert h.read_range(url, 0, 4) == bytes(range(4))
        assert h.read_range(url, 2550, 100) == bytes(range(246, 256))  # short at EOF
        assert h.read_range(url, 10_000, 4) == b""  # past EOF: 416
        assert h.read_range(url, 5, 0) == b""
        assert h.read_all(url) == files["/data.bin"]
        assert h.exists(url) and not h.exists(f"{base}/missing.bin")
    assert isinstance(fs.get_fs(url), fs.HttpFilesystem)
    _raises_alike(lambda: fs.get_fs(url).size(f"{base}/missing.bin"),
                  lambda: jfs.get_fs(url).size(f"{base}/missing.bin"))
    err = _raises_alike(lambda: fs.get_fs(url).open_write(url),
                        lambda: jfs.get_fs(url).open_write(url))
    assert isinstance(err, OSError)


def test_http_server_ignoring_range_still_correct():
    srv, base = _serve(_RangeHandler({"/x.bin": b"0123456789abcdef"}, honor_range=False))
    try:
        url = f"{base}/x.bin"
        for h in (fs.HttpFilesystem(), jfs.HttpFilesystem()):
            assert h.read_range(url, 4, 6) == b"456789"
            assert h.size(url) == 16
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_size_without_head():
    """A server that refuses HEAD: the size comes from a one-byte range's
    ``Content-Range`` total."""
    files = {"/x.bin": bytes(range(200))}

    class NoHead(_RangeHandler(files, honor_range=True)):
        def do_HEAD(self):
            self.send_error(405)

    srv, base = _serve(NoHead)
    try:
        url = f"{base}/x.bin"
        m = Metrics()
        assert fs.HttpFilesystem().size(url, metrics=m) == jfs.HttpFilesystem().size(url) == 200
        assert m.counters() == {}  # a 4xx fails at once: no retry
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_bam_sort_end_to_end(tmp_path, http_server):  # noqa: F811
    """A sort whose input arrives over ``http://`` writes the bytes of the
    port's local sort and of the reference's sort of either input."""
    base, files = http_server
    blob = make_bam_bytes(n=6000, seed=9)
    files["/in.bam"] = blob
    local = tmp_path / "in.bam"
    local.write_bytes(blob)
    outs = {}
    for name, src in (("http", f"{base}/in.bam"), ("local", str(local))):
        out = tmp_path / f"port_{name}.bam"
        st = pipeline.sort_bam([src], str(out), conf=from_reference_conf(HOST),
                               split_size=64 << 10, level=1, device="cpu")
        assert st.n_records == 6000
        outs[name] = out.read_bytes()
        jout = tmp_path / f"ref_{name}.bam"
        jpipeline.sort_bam([src], str(jout), conf=JConf(HOST), split_size=64 << 10,
                           backend="host", level=1)
        assert outs[name] == jout.read_bytes()
    assert outs["http"] == outs["local"]
    assert len(jbam.read_bam(outs["http"])[1]) == 6000


def test_http_404_on_sort_input_raises(tmp_path, http_server):  # noqa: F811
    base, _ = http_server
    src = f"{base}/absent.bam"
    err = _raises_alike(
        lambda: pipeline.sort_bam([src], str(tmp_path / "a.bam"), device="cpu"),
        lambda: jpipeline.sort_bam([src], str(tmp_path / "b.bam"), backend="host"))
    assert isinstance(err, FileNotFoundError)


class _Failing(BaseHTTPRequestHandler):
    """Every request answers 503."""

    def log_message(self, *a):
        pass

    def do_HEAD(self):
        self.send_error(503)

    do_GET = do_HEAD


def test_http_5xx_outlasting_retries_raises_and_counts(tmp_path):
    srv, base = _serve(_Failing)
    try:
        url = f"{base}/in.bam"
        for call in (lambda h, **kw: h.read_range(url, 0, 8, **kw),
                     lambda h, **kw: h.size(url, **kw)):
            m = Metrics()
            before = snapshot()
            with pytest.raises(OSError) as jerr:
                call(jfs.HttpFilesystem(retries=2))
            want = delta(before)["counters"].get("fs.http.retries")
            with pytest.raises(OSError) as err:
                call(fs.HttpFilesystem(retries=2), metrics=m)
            assert type(err.value) is type(jerr.value)
            assert m.get("fs.http.retries") == want > 0
        before = snapshot()
        with pytest.raises(OSError):
            jpipeline.sort_bam([url], str(tmp_path / "b.bam"), backend="host")
        want = delta(before)["counters"].get("fs.http.retries")
        m = Metrics()
        with pytest.raises(OSError):
            read_header(url, metrics=m)
        assert m.get("fs.http.retries") == want
        with pytest.raises(OSError):
            pipeline.sort_bam([url], str(tmp_path / "a.bam"), device="cpu")
    finally:
        srv.shutdown()
        srv.server_close()


def test_gcs_adapter_against_local_endpoint(http_server):  # noqa: F811
    base, files = http_server
    files["/bucket/ref/a%20b.bam"] = make_bam_bytes(n=500, seed=4)
    gcs, jgcs = fs.GcsFilesystem(endpoint=base, token="sekrit"), jfs.GcsFilesystem(
        endpoint=base, token="sekrit")
    assert gcs._headers["Authorization"] == jgcs._headers["Authorization"] == "Bearer sekrit"
    assert gcs._url("gs://bucket/ref/a b.bam") == jgcs._url("gs://bucket/ref/a b.bam")
    fs.register_filesystem("gs", gcs)
    jfs.register_filesystem("gs", jgcs)
    try:
        fmt, jfmt = BamInputFormat(), JBam()
        splits = fmt.get_splits(["gs://bucket/ref/a b.bam"], split_size=1 << 20)
        jsplits = jfmt.get_splits(["gs://bucket/ref/a b.bam"], split_size=1 << 20)
        assert _splits(splits) == _splits(jsplits)
        got = [fmt.read_split(s) for s in splits]
        assert sum(b.n_records for b in got) == 500
        assert _keys(got) == _keys([jfmt.read_split(s) for s in jsplits])
    finally:
        fs._REGISTRY.pop("gs", None)
        jfs._REGISTRY.pop("gs", None)


def test_local_range_read_is_a_writable_buffer(tmp_path):
    """The local read fills a fresh ``bytearray``: tensors are made from
    it without a copy."""
    p = tmp_path / "x.bin"
    p.write_bytes(bytes(range(100)))
    got = fs.get_fs(str(p)).read_range(str(p), 90, 50)
    assert isinstance(got, bytearray) and bytes(got) == bytes(range(90, 100))
    assert fs.read_range_retry(fs.get_fs(str(p)), f"file://{p}", 0, 4) == bytes(range(4))

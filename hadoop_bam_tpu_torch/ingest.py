"""FASTQ ingest: ``fastq[.gz] → queryname-collated unaligned BAM``.

Counterpart of ``hadoop_bam_tpu/ingest.py`` (``ingest_fastq``,
``ingest_oracle``), writing the same bytes under the same gates:

- **Decode**: gzip/BGZF members inflate through
  ``DeviceStream.decode_members`` (``csrc/inflate.cu`` on a card).  A BGZF
  input yields its member table from the header walk; a plain multi-member
  gzip is probed on the host and every member that fits a BGZF frame is
  repacked by a header rewrite (gzip and BGZF share the deflate body and
  the CRC32/ISIZE trailer); larger members inflate with host zlib.
- **Scan**: each decoded run is cut into claim regions for the record
  scan (``csrc/record_scan.cu``), which reads the windows in place from
  the run on the device (uploaded once, or the inflate output itself when
  the run is exactly that); chunks it declines fall to the NumPy scan, a
  gap in the stitched table to the serial walker.
- **Collate**: murmur3 name-hash pairs grouped by the collation core on
  the stream's device, verified against the name bytes, ranked in
  samtools natural order on the host.
- **Write**: BGZF members cut at fixed absolute payload offsets, many
  members per ``DeviceStream.deflate_stream`` call, so the in-core,
  ``memory_budget`` and salvage paths write the bytes of
  :func:`ingest_oracle`, the pure-host reference.

Salvage quarantines whole records: a corrupt member breaks the run, and
the two-record resync drops the torn frames on either side of the gap.
Only data errors are salvaged (:data:`_DATA_ERRORS`); a kernel that fails
to build or launch raises in every mode.
"""

from __future__ import annotations

import contextlib
import heapq
import os
import struct
import tempfile
import time
import zlib
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .collate.device import collate_by_name
from .collate.host import collation_counts, natural_sort_key, queryname_perm
from .collate.signature import QNAME_SEED2
from .conf import (
    ERRORS_MODE,
    FASTQ_BASE_QUALITY_ENCODING,
    FASTQ_FILTER_FAILED_QC,
    INGEST_CHUNK_BYTES,
    INGEST_DEVICE_SCAN,
    INGEST_SCAN_OVERLAP,
    INPUT_BASE_QUALITY_ENCODING,
    INPUT_FILTER_FAILED_QC,
)
from .device_stream import DeviceStream
from .io.fastq import ILLUMINA_PATTERN
from .ops import flate
from .ops.kernels.record_scan import (
    WindowOverrun,
    record_scan_windows,
    scan_window_host,
    scan_window_py,
)
from .pipeline import _not_ported
from .spec import bgzf
from .spec.bam import BamHeader, build_record
from .spec.fragment import (
    ILLUMINA_MAX,
    ILLUMINA_OFFSET,
    SANGER_MAX,
    SANGER_OFFSET,
    FormatException,
)
from .utils.backend import resolve_device
from .utils.murmur3 import murmurhash3_int32_batch
from .utils.tracing import Metrics

#: uBAM flags: PAIRED|UNMAP|MUNMAP plus READ1/READ2, or plain UNMAP.
FLAG_R1 = 0x4D
FLAG_R2 = 0x8D
FLAG_SINGLE = 0x4

#: Default claim region per scan chunk (the device inflate payload) and
#: scan overlap past it.
DEFAULT_CHUNK_BYTES = 0xDF00
DEFAULT_SCAN_OVERLAP = 2048

#: BGZF member payload cut of the uBAM writer (spec MAX_PAYLOAD).  With the
#: deflate lanes armed the cut is ``flate.DEV_LZ_PAYLOAD`` (ROADMAP C).
_BLOCK_PAYLOAD = 0xFF00

#: Members the writer hands ``deflate_stream`` at least per call.
_FLUSH_MEMBERS = 256

_GZ_MAGIC = b"\x1f\x8b\x08"

#: Input step of the gzip member probe.
_PROBE_STEP = 1 << 16

#: What salvage may quarantine: corrupt data.  Anything else raises.
_DATA_ERRORS = (bgzf.BgzfError, zlib.error, FormatException)


@dataclass
class IngestStats:
    """What one ingest job did, and what salvage cost.

    The fields through ``out_bytes`` are the reference's.  ``seconds``
    holds the host seconds of the stages (the reference's
    ``ingest.stage.*`` spans: decode, scan, collate, write) and
    ``counters`` the stream's counters."""

    n_records: int = 0
    n_pairs: int = 0
    n_singletons: int = 0
    n_orphans: int = 0
    n_members: int = 0
    n_repacked: int = 0
    n_host_members: int = 0
    n_quarantined_members: int = 0
    n_quarantined_frames: int = 0
    n_tail_records: int = 0
    n_filtered: int = 0
    scan_chunks: int = 0
    scan_lanes: int = 0
    scan_host: int = 0
    scan_serial: int = 0
    out_bytes: int = 0
    seconds: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)

    def merge_input(self, other: "IngestStats") -> None:
        for f in (
            "n_members", "n_repacked", "n_host_members",
            "n_quarantined_members", "n_quarantined_frames",
            "n_filtered", "scan_chunks", "scan_lanes", "scan_host",
            "scan_serial",
        ):
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def counts(self) -> Dict[str, int]:
        """The reference's fields as a dict."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.name not in ("seconds", "counters")}


@contextlib.contextmanager
def _stage(seconds: Dict[str, float], name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Member tables and the inflate decode


@dataclass
class _Member:
    """One compressed member: extents into the device buffer when it can
    ride the inflate kernel, else raw extents for host zlib.  ``usize`` is
    None for a corrupt gap (salvage only)."""

    usize: Optional[int]
    dev: Optional[Tuple[int, int]] = None    # (coffset, csize) in dev_buf
    raw: Optional[Tuple[int, int]] = None    # (offset, csize) in the input


def _gzip_header_len(buf: bytes, off: int) -> int:
    if buf[off: off + 3] != _GZ_MAGIC:
        raise FormatException("not a gzip member at offset %d" % off)
    flg = buf[off + 3]
    p = off + 10
    if flg & 4:
        xlen = buf[p] | (buf[p + 1] << 8)
        p += 2 + xlen
    if flg & 8:
        p = buf.index(b"\x00", p) + 1
    if flg & 16:
        p = buf.index(b"\x00", p) + 1
    if flg & 2:
        p += 2
    return p - off


def _bgzf_repack(buf: bytes, off: int, csize: int) -> Optional[bytes]:
    """A plain gzip member rewritten as one BGZF member (header swap only),
    or None when it does not fit a BGZF frame (BSIZE u16, payload < 64 KiB):
    that member inflates on the host."""
    hdr = _gzip_header_len(buf, off)
    body = csize - hdr - 8
    total = 18 + body + 8
    if body < 0 or total - 1 > 0xFFFF:
        return None
    isize = struct.unpack_from("<I", buf, off + csize - 4)[0]
    if isize > 0xFFFF:
        return None
    return (
        bgzf.MAGIC
        + b"\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
        + struct.pack("<H", total - 1)
        + buf[off + hdr: off + csize]
    )


def _inflate_gzip_member(data: bytes, pos: int) -> Tuple[bytes, int]:
    """``(payload, csize)`` of the gzip member at ``pos``; ``zlib.error`` when
    it is corrupt or truncated.  zlib gets the input in 64 KiB steps, so a
    member costs its own size (the reference hands it the whole rest of the
    file, and keeps the rest again as ``unused_data``, per member)."""
    d = zlib.decompressobj(31)
    mv = memoryview(data)
    out = []
    at = pos
    while not d.eof and at < len(data):
        out.append(d.decompress(mv[at: at + _PROBE_STEP]))
        at += _PROBE_STEP
    if not d.eof:
        raise zlib.error("truncated gzip member")
    return b"".join(out), min(at, len(data)) - pos - len(d.unused_data)


def _next_bgzf_member(data: bytes, start: int) -> int:
    """The reference guesser's resync point: the first offset from
    ``start`` holding a BGZF header whose block fits in ``data`` with ISIZE
    at most 64 KiB, or -1."""
    pos = start
    while True:
        pos = bgzf.find_next_block(data, pos)
        if pos < 0:
            return -1
        bsize = bgzf.parse_block_header(data, pos)[0]
        if struct.unpack_from("<I", data, pos + bsize - 4)[0] <= bgzf.MAX_BLOCK_SIZE:
            return pos
        pos += 1


def _member_table(
    data: bytes, errors: str, stats: IngestStats, metrics: Metrics
) -> Tuple[List[_Member], bytes]:
    """Per-member decode plan for one input, plus the buffer the ``dev``
    extents index (the input itself for BGZF, the repacked stream for
    plain gzip, empty for uncompressed text)."""
    if not data.startswith(b"\x1f\x8b"):
        return [], b""   # uncompressed: one plain run, no members
    members: List[_Member] = []
    if bgzf.is_bgzf(data):
        pos = 0
        while pos < len(data):
            hdr = bgzf.parse_block_header(data, pos)
            if hdr is None:
                if errors != "salvage":
                    raise FormatException("corrupt BGZF member chain at offset %d" % pos)
                nxt = _next_bgzf_member(data, pos + 1)
                members.append(_Member(usize=None))
                stats.n_quarantined_members += 1
                metrics.count("salvage.ingest_members", 1)
                if nxt < 0:
                    break
                pos = nxt
                continue
            bsize, _ = hdr
            usize = struct.unpack_from("<I", data, pos + bsize - 4)[0]
            members.append(_Member(usize=usize, dev=(pos, bsize)))
            pos += bsize
        return members, data

    # Plain multi-member gzip: host probe for extents, then repack the
    # members that fit into BGZF units for the inflate kernel.
    repacked = bytearray()
    pos = 0
    while pos < len(data):
        try:
            out, csize = _inflate_gzip_member(data, pos)
        except zlib.error:
            if errors != "salvage":
                raise FormatException("corrupt gzip member at offset %d" % pos)
            members.append(_Member(usize=None))
            stats.n_quarantined_members += 1
            metrics.count("salvage.ingest_members", 1)
            nxt = data.find(_GZ_MAGIC, pos + 3)
            if nxt < 0:
                break
            pos = nxt
            continue
        syn = _bgzf_repack(data, pos, csize)
        if syn is not None and len(out) <= 0xFFFF:
            members.append(_Member(usize=len(out), dev=(len(repacked), len(syn))))
            repacked += syn
            stats.n_repacked += 1
            metrics.count("ingest.inflate.repacked", 1)
        else:
            members.append(_Member(usize=len(out), raw=(pos, csize)))
            stats.n_host_members += 1
            metrics.count("ingest.inflate.host_members", 1)
        pos += csize
    return members, bytes(repacked)


def _decode_input(
    data: bytes, stream: DeviceStream, errors: str, stats: IngestStats
) -> Tuple[List[Optional[bytes]], Optional[torch.Tensor]]:
    """Decode one input into per-member payloads in stream order, with
    ``None`` gaps for quarantined members (salvage only); an uncompressed
    input is one payload.  The second value is the inflate output on the
    device when it is the whole input as one run (every member through the
    kernel, none declined), else None."""
    metrics = stream.metrics
    members, dev_buf = _member_table(data, errors, stats, metrics)
    if not members:
        return [data], None
    stats.n_members += len(members)
    metrics.count("ingest.inflate.members", len(members))
    dev_idx = [i for i, m in enumerate(members) if m.dev is not None]
    payloads: List[Optional[bytes]] = [None] * len(members)
    resident = None
    if dev_idx:
        co = np.asarray([members[i].dev[0] for i in dev_idx], np.int64)
        cs = np.asarray([members[i].dev[1] for i in dev_idx], np.int64)
        us = np.asarray([members[i].usize for i in dev_idx], np.int64)
        try:
            out, offs, dev = stream.decode_members(np.frombuffer(dev_buf, np.uint8), co, cs, us)
            blob = out.tobytes()
            for k, i in enumerate(dev_idx):
                payloads[i] = blob[int(offs[k]): int(offs[k + 1])]
            if len(dev_idx) == len(members):
                resident = dev
        except _DATA_ERRORS:
            if errors != "salvage":
                raise
            for i in dev_idx:
                off, _ = members[i].dev
                try:
                    payloads[i], _ = bgzf.inflate_block(dev_buf, off)
                except _DATA_ERRORS:
                    members[i].usize = None
                    stats.n_quarantined_members += 1
                    metrics.count("salvage.ingest_members", 1)
    for m_i, m in enumerate(members):
        if m.raw is not None:
            off, csize = m.raw
            try:
                payloads[m_i] = zlib.decompress(data[off: off + csize], 31)
            except zlib.error:
                if errors != "salvage":
                    raise FormatException("corrupt gzip member at offset %d" % off)
                m.usize = None
                stats.n_quarantined_members += 1
                metrics.count("salvage.ingest_members", 1)
    metrics.count("ingest.inflate.bytes", sum(len(p) for p in payloads if p is not None))
    return payloads, resident


def _runs_of(payloads: List[Optional[bytes]]) -> List[Tuple[bytes, bool]]:
    """Contiguous decoded runs between quarantine gaps, each tagged aligned
    (True only for the stream head: a post-gap run resyncs)."""
    runs: List[Tuple[bytes, bool]] = []
    cur: List[bytes] = []
    aligned = True
    for p in payloads:
        if p is None:
            if cur:
                runs.append((b"".join(cur), aligned))
                cur = []
            aligned = False
            continue
        cur.append(p)
    if cur:
        runs.append((b"".join(cur), aligned))
    return runs


# ---------------------------------------------------------------------------
# The record scan: kernel → host scan → serial walker


def _scan_run(
    run: bytes,
    aligned: bool,
    chunk_bytes: int,
    overlap: int,
    device_scan: bool,
    errors: str,
    stats: IngestStats,
    stream: DeviceStream,
    resident: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Record table ``[n, 8]`` (run-absolute offsets) of one decoded run,
    down the tier ladder, with the run-tiling reconciliation.  With the
    device scan on, the run is uploaded once (or ``resident``, the same
    bytes already on the device, is read in place)."""
    if not run:
        return np.zeros((0, 8), np.int32)
    metrics = stream.metrics
    offs = np.arange(0, len(run), chunk_bytes, dtype=np.int64)
    lens = np.minimum(chunk_bytes + overlap, len(run) - offs)
    chunk_lens = np.minimum(chunk_bytes, len(run) - offs)
    finals = offs + lens >= len(run)
    stats.scan_chunks += len(offs)
    metrics.count("fastq.scan.chunks", len(offs))

    tables: List[Optional[np.ndarray]] = [None] * len(offs)
    if device_scan:
        if resident is not None:
            data = resident
            metrics.count("ingest.scan.resident_runs")
        else:
            data = torch.from_numpy(np.frombuffer(run, np.uint8).copy()).to(stream.device)
            metrics.count("ingest.scan.uploaded_runs")
            if stream.device.type == "cuda":
                metrics.count_h2d(len(run), "scan_runs")
        tables, kstats = record_scan_windows(
            data, offs, lens, chunk_lens, (offs == 0) & aligned, finals, metrics=metrics)
        stats.scan_lanes += kstats.lanes
        metrics.count("fastq.scan.lanes", kstats.lanes)

    def serial() -> np.ndarray:
        stats.scan_serial += 1
        metrics.count("fastq.scan.serial_fallback", 1)
        tab, n_quar = scan_window_py(run, len(run), aligned, True, salvage=(errors == "salvage"))
        if n_quar:
            stats.n_quarantined_frames += n_quar
            metrics.count("salvage.ingest_frames", n_quar)
        return tab

    try:
        for k in range(len(offs)):
            if tables[k] is None:
                stats.scan_host += 1
                metrics.count("fastq.scan.host", 1)
                o = int(offs[k])
                tables[k] = scan_window_host(run[o: o + int(lens[k])], int(chunk_lens[k]),
                                             aligned and o == 0, bool(finals[k]))
    except WindowOverrun:
        return serial()
    except FormatException:
        if errors != "salvage":
            raise
        return serial()

    parts = [t + np.int32(o) * np.array([1, 0] * 4, np.int32)
             for t, o in zip(tables, offs.tolist()) if len(t)]
    table = np.concatenate(parts) if parts else np.zeros((0, 8), np.int32)

    # Tiling reconciliation: consecutive records must abut (one LF or CRLF
    # apart) and an aligned run must start at offset 0; a gap means a chunk
    # lost a record, so the walker decides.
    ok = True
    if len(table):
        qual_end = table[:-1, 6] + table[:-1, 7]
        sep = table[1:, 0].astype(np.int64) - qual_end.astype(np.int64)
        ok = bool(((sep >= 1) & (sep <= 2)).all())
        last_end = int(table[-1, 6] + table[-1, 7])
        ok = ok and (len(run) - last_end) in (0, 1, 2)
        if aligned:
            ok = ok and int(table[0, 0]) == 0
    elif aligned and len(run):
        ok = False
    if not ok:
        metrics.count("fastq.scan.reconciled", 1)
        return serial()
    return table


# ---------------------------------------------------------------------------
# Columns: ids, qualities, flags


@dataclass
class _InputColumns:
    """Per-input record columns in stream order; seq/qual stay offsets into
    the decoded runs."""

    runs: List[bytes] = field(default_factory=list)
    run_idx: List[int] = field(default_factory=list)
    table: List[np.ndarray] = field(default_factory=list)  # per-record rows
    qnames: List[str] = field(default_factory=list)
    reads: List[int] = field(default_factory=list)         # 0 = unnumbered

    def __len__(self) -> int:
        return len(self.qnames)

    def record_bytes(self, i: int) -> Tuple[bytes, bytes, bytes]:
        """(id line sans '@', seq, qual) raw bytes of record ``i``."""
        run = self.runs[self.run_idx[i]]
        row = self.table[i]
        return (
            run[row[0] + 1: row[0] + row[1]],
            run[row[2]: row[2] + row[3]],
            run[row[6]: row[6] + row[7]],
        )


def _parse_id(name: str, look_for_illumina: bool):
    """(qname, read, filter_passed, still_illumina): the reference's
    stateful Illumina-then-``/N`` id chain."""
    read = 0
    filter_passed = None
    if look_for_illumina:
        m = ILLUMINA_PATTERN.fullmatch(name)
        if m:
            return (name.split(None, 1)[0], int(m.group(8)), m.group(9) == "N", True)
        look_for_illumina = False
    qname = name.split(None, 1)[0] if name else ""
    if len(qname) >= 2 and qname[-2] == "/" and qname[-1].isdigit():
        read = int(qname[-1])
        qname = qname[:-2]
    return qname, read, filter_passed, look_for_illumina


def _scan_input(
    data: bytes,
    stream: DeviceStream,
    errors: str,
    chunk_bytes: int,
    overlap: int,
    device_scan: bool,
    filter_failed: bool,
    seconds: Dict[str, float],
) -> Tuple[_InputColumns, IngestStats]:
    """Decode + scan + id-parse one input into stream-order columns."""
    stats = IngestStats()
    with _stage(seconds, "decode"):
        payloads, resident = _decode_input(data, stream, errors, stats)
        runs = _runs_of(payloads)
    cols = _InputColumns()
    look = True
    with _stage(seconds, "scan"):
        for run, aligned in runs:
            table = _scan_run(run, aligned, chunk_bytes, overlap, device_scan, errors, stats,
                              stream, resident if len(runs) == 1 else None)
            r = len(cols.runs)
            cols.runs.append(run)
            for row in table:
                name = run[row[0] + 1: row[0] + row[1]].decode("latin-1")
                qname, read, fpass, look = _parse_id(name, look)
                if filter_failed and fpass is False:
                    stats.n_filtered += 1
                    continue
                cols.run_idx.append(r)
                cols.table.append(row)
                cols.qnames.append(qname)
                cols.reads.append(read)
    return cols, stats


def _sanger_quals(cols: _InputColumns, encoding: str) -> List[bytes]:
    """Per-record Sanger quality bytes, range-checked (sanger input) or
    range-checked and shifted by 31 (illumina input)."""
    out = []
    if encoding == "illumina":
        lo, hi = ILLUMINA_OFFSET, ILLUMINA_OFFSET + ILLUMINA_MAX
    elif encoding == "sanger":
        lo, hi = SANGER_OFFSET, SANGER_OFFSET + SANGER_MAX
    else:
        raise ValueError(f"Unsupported base quality encoding {encoding}")
    for i in range(len(cols)):
        _, _, qual = cols.record_bytes(i)
        a = np.frombuffer(qual, np.uint8)
        if len(a) and (int(a.min()) < lo or int(a.max()) > hi):
            raise FormatException(
                "base quality score out of range for %s encoding in record %r"
                % (encoding, cols.qnames[i])
            )
        if encoding == "illumina":
            a = (a.astype(np.int16) - (ILLUMINA_OFFSET - SANGER_OFFSET)).astype(np.uint8)
        out.append(a.tobytes())
    return out


# ---------------------------------------------------------------------------
# The blocked uBAM writer (byte-stable member cuts)


def _host_bgzf(payload: bytes, level: int, block_payload: int) -> bytes:
    """Host zlib BGZF members of ``payload``, a cut every ``block_payload``."""
    return bgzf.deflate_blocks(payload, level=level, block_payload=block_payload)[0]


class _BlockedUbamWriter:
    """BGZF writer with member cuts at fixed absolute payload offsets:
    compression only ever sees whole multiples of ``block_payload`` (the
    remainder stays buffered until ``close``), so the bytes do not depend
    on how the caller batches writes.  Each compression call takes at least
    ``flush_members`` members (the reference flushes every member).
    ``compress(payload, level=, block_payload=)`` returns the members'
    bytes (:meth:`DeviceStream.deflate_stream` or :func:`_host_bgzf`)."""

    def __init__(self, fh, compress: Callable[..., bytes], level: int,
                 block_payload: int = _BLOCK_PAYLOAD, flush_members: int = _FLUSH_MEMBERS):
        self._fh = fh
        self._compress = compress
        self._level = level
        self._bp = block_payload
        self._flush = flush_members * block_payload
        self._buf = bytearray()
        self.out_bytes = 0

    def _emit(self, payload: bytes) -> None:
        comp = self._compress(payload, level=self._level, block_payload=self._bp)
        self._fh.write(comp)
        self.out_bytes += len(comp)

    def write(self, b: bytes) -> None:
        self._buf += b
        if len(self._buf) >= self._flush:
            cut = (len(self._buf) // self._bp) * self._bp
            self._emit(bytes(self._buf[:cut]))
            del self._buf[:cut]

    def close(self) -> None:
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf.clear()
        self._fh.write(bgzf.TERMINATOR)
        self.out_bytes += len(bgzf.TERMINATOR)


_UBAM_HEADER_TEXT = "@HD\tVN:1.6\tSO:queryname\n"


def _encode_record(qname: str, flag: int, seq: bytes, qual: bytes) -> bytes:
    return build_record(
        name=qname, refid=-1, pos=-1, mapq=0, flag=flag, cigar=[],
        seq=seq.decode("latin-1"), qual=qual.decode("latin-1"),
    )


def _read_conf(conf, errors: Optional[str]):
    """``(errors, encoding, filter_failed, cget)`` from the call and conf."""
    errors = errors or ((conf.get(ERRORS_MODE, "strict") if conf is not None else "strict")
                        or "strict")
    cget = (lambda k, d=None: conf.get(k, d)) if conf is not None else (lambda k, d=None: d)
    encoding = str(cget(FASTQ_BASE_QUALITY_ENCODING,
                        cget(INPUT_BASE_QUALITY_ENCODING, "sanger")) or "sanger")
    filter_failed = str(cget(FASTQ_FILTER_FAILED_QC,
                             cget(INPUT_FILTER_FAILED_QC, "false")) or "false").lower() == "true"
    return errors, encoding, filter_failed, cget


def _input_paths(fastq, r2):
    if isinstance(fastq, (list, tuple)):
        paths = list(fastq)
        if len(paths) > 1 and r2 is None:
            r2 = paths[1]
        return paths[0], r2
    return fastq, r2


# ---------------------------------------------------------------------------
# The front door


def ingest_fastq(
    fastq: Union[str, Sequence[str]],
    output: str,
    r2: Optional[str] = None,
    conf=None,
    level: int = 6,
    memory_budget: Optional[int] = None,
    part_dir: Optional[str] = None,
    errors: Optional[str] = None,
    chunk_bytes: Optional[int] = None,
    overlap: Optional[int] = None,
    deadline=None,
    resource_cache=None,
    device: Optional[Union[str, torch.device]] = None,
) -> IngestStats:
    """Ingest FASTQ (plain, gzip or BGZF; single or paired R1/R2) into a
    queryname-collated unaligned BAM at ``output``: byte for byte what the
    reference's ``ingest_fastq`` writes with the same gates.

    ``device`` defaults to ``cuda`` and raises without a card; ``"cpu"``
    runs every kernel's plain version.  The inflate and deflate gates are
    the stream's (on by default on a card); the record scan follows
    ``hadoopbam.ingest.device-scan`` when it is true/false, else the
    inflate gate.  With the deflate lanes armed, members are cut every
    ``DEV_LZ_PAYLOAD`` bytes (the reference raises there; ROADMAP C), so the
    file decompresses to the same bytes as with them off.  ``memory_budget``
    bounds record assembly (rank-tagged spill runs, k-way merged: the same
    bytes).  ``errors="salvage"`` quarantines corrupt members and torn
    frames.  ``deadline`` and ``resource_cache`` (the serve path) raise
    ``NotImplementedError``."""
    if deadline is not None or resource_cache is not None:
        raise _not_ported("deadline / resource_cache (the serve ingest job)", "A.11")
    r1_path, r2 = _input_paths(fastq, r2)
    errors, encoding, filter_failed, cget = _read_conf(conf, errors)
    if errors not in ("strict", "salvage"):
        raise ValueError(f"unknown errors mode: {errors}")
    if chunk_bytes is None:
        chunk_bytes = int(cget(INGEST_CHUNK_BYTES, DEFAULT_CHUNK_BYTES) or DEFAULT_CHUNK_BYTES)
    if overlap is None:
        overlap = int(cget(INGEST_SCAN_OVERLAP, DEFAULT_SCAN_OVERLAP) or DEFAULT_SCAN_OVERLAP)
    stream = DeviceStream(resolve_device(device), conf=conf)
    metrics = stream.metrics
    dev_conf = str(cget(INGEST_DEVICE_SCAN, "") or "").lower()
    device_scan = (dev_conf == "true") if dev_conf in ("true", "false") \
        else stream.policy.inflate_lanes

    stats = IngestStats()
    seconds: Dict[str, float] = {}
    inputs: List[_InputColumns] = []
    for path in [r1_path] + ([r2] if r2 else []):
        with open(path, "rb") as fh:
            data = fh.read()
        cols, istats = _scan_input(data, stream, errors, chunk_bytes, overlap, device_scan,
                                   filter_failed, seconds)
        stats.merge_input(istats)
        inputs.append(cols)

    paired_files = r2 is not None
    if paired_files and len(inputs[0]) != len(inputs[1]):
        n1, n2 = len(inputs[0]), len(inputs[1])
        if errors != "salvage":
            raise FormatException(
                f"paired FASTQ inputs have unequal record counts ({n1} vs {n2})")
        lo = min(n1, n2)
        stats.n_tail_records += (n1 - lo) + (n2 - lo)
        metrics.count("salvage.ingest_tail_records", (n1 - lo) + (n2 - lo))
        for cols in inputs:
            del cols.qnames[lo:], cols.reads[lo:]
            del cols.run_idx[lo:], cols.table[lo:]

    # Global record list in read order: R1 stream then R2 stream (the
    # collation interleaves them back into queryname order).
    qnames: List[str] = []
    flags: List[int] = []
    src: List[Tuple[int, int]] = []
    for fi, cols in enumerate(inputs):
        default_read = fi + 1 if paired_files else 0
        for i in range(len(cols)):
            read = cols.reads[i] or default_read
            flags.append(FLAG_SINGLE if read == 0 else (FLAG_R2 if read == 2 else FLAG_R1))
            qnames.append(cols.qnames[i])
            src.append((fi, i))
    n = len(qnames)
    stats.n_records = n
    metrics.count("ingest.records", n)

    with _stage(seconds, "collate"):
        name_bytes = [q.encode("latin-1") for q in qnames]
        blob = np.frombuffer(b"".join(name_bytes), np.uint8)
        name_len = np.asarray([len(b) for b in name_bytes], np.int32)
        name_off = np.zeros(n, np.int64)
        if n:
            np.cumsum(name_len[:-1], out=name_off[1:])
        flag_col = np.asarray(flags, np.int32)
        ccols = {
            "qh1": murmurhash3_int32_batch(blob, name_off, name_len.astype(np.int64), 0),
            "qh2": murmurhash3_int32_batch(blob, name_off, name_len.astype(np.int64),
                                           QNAME_SEED2),
            "flag": flag_col,
            "pos": np.full(n, -1, np.int32),
            "cand": ((flag_col & 0x1) != 0).astype(np.int32),
            "name_len": name_len,
            "name_off": name_off,
            "names": blob,
        }
        perm, _ = queryname_perm(ccols, device=stream.device, metrics=metrics)
        census = collation_counts(
            ccols, collate_by_name(ccols, device=stream.device, metrics=metrics), metrics)
        stats.n_pairs = int(census["pairs"])
        stats.n_singletons = int(census["singletons"])
        stats.n_orphans = int(census["orphans"])
        metrics.count("ingest.pairs", stats.n_pairs)
        metrics.count("ingest.orphans", stats.n_orphans)

    quals = [_sanger_quals(cols, encoding) for cols in inputs]

    def record_payload(i: int) -> bytes:
        fi, ri = src[i]
        _, seq, _ = inputs[fi].record_bytes(ri)
        return _encode_record(qnames[i], flags[i], seq, quals[fi][ri])

    header = BamHeader(_UBAM_HEADER_TEXT, []).with_sort_order("queryname")
    bp = flate.DEV_LZ_PAYLOAD if stream.policy.deflate_lanes else _BLOCK_PAYLOAD
    with _stage(seconds, "write"), open(output, "wb") as fh:
        w = _BlockedUbamWriter(fh, stream.deflate_stream, level, block_payload=bp)
        w.write(header.encode())
        if memory_budget is None:
            for i in perm:
                w.write(record_payload(int(i)))
        else:
            _spill_merge(w, record_payload, perm, n, memory_budget, part_dir)
        w.close()
        stats.out_bytes = w.out_bytes
    metrics.count("ingest.out_bytes", stats.out_bytes)
    counters = metrics.counters()
    counters.update({f"flate.inflate.{k}": v for k, v in stream.inflate_stats.as_dict().items()})
    stats.counters = counters
    stats.seconds = seconds
    return stats


def _spill_merge(w, record_payload, perm, n, memory_budget, part_dir):
    """Budget-bounded emission: encode records in read order into
    rank-sorted spill runs of at most ``memory_budget`` bytes, then k-way
    merge the runs by rank: the in-core path's order, hence its bytes."""
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n, dtype=np.int64)
    with contextlib.ExitStack() as stack:
        if part_dir is None:
            spill_dir = stack.enter_context(tempfile.TemporaryDirectory(prefix="hbam-ingest-"))
        else:
            os.makedirs(part_dir, exist_ok=True)
            spill_dir = part_dir
        run_paths: List[str] = []
        batch: List[Tuple[int, bytes]] = []
        batch_bytes = 0

        def flush():
            nonlocal batch, batch_bytes
            if not batch:
                return
            batch.sort(key=lambda t: t[0])
            path = os.path.join(spill_dir, "ingest-run-%05d.bin" % len(run_paths))
            with open(path, "wb") as rf:
                for rk, payload in batch:
                    rf.write(struct.pack("<qI", rk, len(payload)))
                    rf.write(payload)
            run_paths.append(path)
            batch = []
            batch_bytes = 0

        for i in range(n):
            payload = record_payload(i)
            batch.append((int(rank[i]), payload))
            batch_bytes += len(payload)
            if batch_bytes >= max(memory_budget, 1):
                flush()
        flush()

        def reader(path):
            with open(path, "rb") as rf:
                while True:
                    hdr = rf.read(12)
                    if not hdr:
                        return
                    rk, ln = struct.unpack("<qI", hdr)
                    yield rk, rf.read(ln)

        for _, payload in heapq.merge(*[reader(p) for p in run_paths], key=lambda t: t[0]):
            w.write(payload)


# ---------------------------------------------------------------------------
# The pure-host oracle


def ingest_oracle(
    fastq: Union[str, Sequence[str]],
    output: str,
    r2: Optional[str] = None,
    conf=None,
    level: int = 6,
    errors: Optional[str] = None,
) -> int:
    """Reference ingest: Python gzip decode, serial two-record-resync
    parse, Python natural sort; no kernels, no collation core, no device
    stream.  Shares only the byte encoders (``build_record`` and the blocked
    member cuts), so equality with :func:`ingest_fastq` checks the device
    path.  Returns the record count."""
    r1_path, r2 = _input_paths(fastq, r2)
    errors, encoding, filter_failed, _ = _read_conf(conf, errors)

    def decode(path):
        with open(path, "rb") as fh:
            data = fh.read()
        if not data.startswith(b"\x1f\x8b"):
            return [data]
        chunks: List[Optional[bytes]] = []
        pos = 0
        while pos < len(data):
            d = zlib.decompressobj(31)
            try:
                out = d.decompress(data[pos:])
                if not d.eof:
                    raise zlib.error("truncated member")
            except zlib.error:
                if errors != "salvage":
                    raise FormatException("corrupt gzip member at offset %d" % pos)
                chunks.append(None)
                nxt = data.find(_GZ_MAGIC, pos + 3)
                if nxt < 0:
                    break
                pos = nxt
                continue
            chunks.append(out)
            pos += (len(data) - pos) - len(d.unused_data)
        return chunks

    def lines_of(run):
        out = []
        pos = 0
        while pos < len(run):
            nl = run.find(b"\n", pos)
            if nl < 0:
                nl = len(run)
            line = run[pos:nl]
            if line.endswith(b"\r"):
                line = line[:-1]
            out.append(line)
            pos = nl + 1
        return out

    def parse_run(run, aligned):
        lines = lines_of(run)

        def frame(i):
            if i + 3 >= len(lines):
                return None
            return (lines[i][:1] == b"@" and lines[i + 2][:1] == b"+"
                    and len(lines[i + 1]) == len(lines[i + 3]))

        i = 0
        if not aligned:
            while i < len(lines):
                fa = frame(i)
                if fa is None:
                    i = len(lines)
                    break
                if fa and (frame(i + 4) or frame(i + 4) is None):
                    break
                i += 1
        recs = []
        while i < len(lines):
            fr = frame(i)
            if fr:
                recs.append((lines[i][1:], lines[i + 1], lines[i + 3]))
                i += 4
                continue
            if errors != "salvage":
                raise FormatException("fastq: %s in record %d" % (
                    "truncated record" if fr is None else "frame violation", len(recs)))
            if fr is None:
                break
            i += 1
            while i < len(lines):
                fa = frame(i)
                if fa is None:
                    i = len(lines)
                    break
                if fa and (frame(i + 4) or frame(i + 4) is None):
                    break
                i += 1
        return recs

    def parse_input(path):
        recs = []
        aligned = True
        pending: List[bytes] = []
        for chunk in decode(path):
            if chunk is None:
                if pending:
                    recs.extend(parse_run(b"".join(pending), aligned))
                    pending = []
                aligned = False
                continue
            pending.append(chunk)
        if pending:
            recs.extend(parse_run(b"".join(pending), aligned))
        out = []
        look = True
        for name_b, seq, qual in recs:
            qname, read, fpass, look = _parse_id(name_b.decode("latin-1"), look)
            if filter_failed and fpass is False:
                continue
            a = np.frombuffer(qual, np.uint8)
            if encoding == "illumina":
                if len(a) and (int(a.min()) < ILLUMINA_OFFSET
                               or int(a.max()) > ILLUMINA_OFFSET + ILLUMINA_MAX):
                    raise FormatException("base quality score out of range")
                qual = (a.astype(np.int16)
                        - (ILLUMINA_OFFSET - SANGER_OFFSET)).astype(np.uint8).tobytes()
            elif len(a) and (int(a.min()) < SANGER_OFFSET
                             or int(a.max()) > SANGER_OFFSET + SANGER_MAX):
                raise FormatException("base quality score out of range")
            out.append((qname, read, seq, qual))
        return out

    paired = r2 is not None
    records = [parse_input(path) for path in [r1_path] + ([r2] if r2 else [])]
    if paired and len(records[0]) != len(records[1]):
        if errors != "salvage":
            raise FormatException(
                "paired FASTQ inputs have unequal record counts "
                f"({len(records[0])} vs {len(records[1])})")
        lo = min(len(records[0]), len(records[1]))
        records = [r[:lo] for r in records]

    flat = []
    for fi, recs in enumerate(records):
        for qname, read, seq, qual in recs:
            read = read or (fi + 1 if paired else 0)
            flag = FLAG_SINGLE if read == 0 else (FLAG_R2 if read == 2 else FLAG_R1)
            flat.append((qname, flag, seq, qual))

    order = sorted(
        range(len(flat)),
        key=lambda i: (natural_sort_key(flat[i][0].encode("latin-1")), flat[i][1], i),
    )
    header = BamHeader(_UBAM_HEADER_TEXT, []).with_sort_order("queryname")
    with open(output, "wb") as fh:
        w = _BlockedUbamWriter(fh, _host_bgzf, level)
        w.write(header.encode())
        for i in order:
            qname, flag, seq, qual = flat[i]
            w.write(_encode_record(qname, flag, seq, qual))
        w.close()
    return len(flat)

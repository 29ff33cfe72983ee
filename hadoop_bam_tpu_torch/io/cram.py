"""CRAM input and output: container-aligned splits, record decode, writer.

Counterpart of ``hadoop_bam_tpu/io/cram.py`` (CRAMInputFormat.java:58-80,
CRAMRecordReader.java:43-88, CRAMRecordWriter.java:98-116), reading local
files.  Splits snap byte ranges to container starts; the reference FASTA
comes from ``hadoopbam.cram.reference-source-path``; the writer emits bare
containers with the EOF marker suppressed for parts.  Record decode lives
in ``spec/cram.py``; its rANS blocks decode on the card through a
:class:`~hadoop_bam_tpu_torch.device_stream.DeviceStream`.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional

from ..conf import CRAM_REFERENCE_SOURCE_PATH, Configuration
from ..spec import bam, cram
from .bam import _read_range
from .splits import ByteSplit


def _read_all(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


class ReferenceSource:
    """FASTA reference lookup by reference index: the whole FASTA is parsed
    once and every sequence kept uppercase in memory."""

    def __init__(self, fasta_path: str):
        self.path = fasta_path
        self._cache: Dict[int, bytes] = {}
        self._names: List[str] = []
        self._load()

    def _load(self) -> None:
        seqs: Dict[str, List[str]] = {}
        name = None
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line.startswith(">"):
                    name = line[1:].split()[0]
                    self._names.append(name)
                    seqs[name] = []
                elif name is not None:
                    seqs[name].append(line)
        for i, n in enumerate(self._names):
            self._cache[i] = "".join(seqs[n]).upper().encode()

    def get(self, refid: int) -> bytes:
        try:
            return self._cache[refid]
        except KeyError:
            raise cram.CramError(f"reference index {refid} not in FASTA")


class CramInputFormat:
    def __init__(self, conf: Optional[Configuration] = None):
        self.conf = conf or Configuration()
        self._ref: Optional[ReferenceSource] = None

    def reference_source_path(self) -> Optional[str]:
        return self.conf.get(CRAM_REFERENCE_SOURCE_PATH)

    def _ref_getter(self) -> Optional[Callable[[int], bytes]]:
        if self._ref is None:
            p = self.reference_source_path()
            if p is None:
                return None
            self._ref = ReferenceSource(p)
        return self._ref.get

    def get_splits(self, paths, split_size: int = 4 << 20) -> List[ByteSplit]:
        """Byte ranges of ``split_size`` snapped to data-container starts
        (the header container and the EOF container excluded)."""
        out: List[ByteSplit] = []
        for path in sorted(paths):
            data = _read_all(path)
            containers = cram.iter_containers(data)
            offsets = [c.offset for c in containers[1:] if not c.is_eof]
            if not offsets:
                continue
            size = len(data)
            eof_start = next((c.offset for c in containers if c.is_eof), size)
            for s in range(0, size, split_size):
                e = min(s + split_size, size)
                start = _next_offset(offsets, s)
                end = _next_offset(offsets, e)
                if start is None or start >= eof_start:
                    continue
                end = eof_start if end is None else min(end, eof_start)
                if start < end:
                    out.append(ByteSplit(path, start, end - start))
        return out

    def container_inventory(self, path: str) -> List[cram.ContainerHeader]:
        return cram.iter_containers(_read_all(path))

    def count_records(self, split: ByteSplit) -> int:
        """Record count from container headers alone (no decode)."""
        return sum(
            c.n_records
            for c in cram.iter_containers(_read_all(split.path))
            if split.start <= c.offset < split.end
        )

    def read_split(
        self,
        split: ByteSplit,
        data: Optional[bytes] = None,
        with_keys: bool = True,
        threads: Optional[int] = None,
        fields: Optional[object] = None,
        device_inflate: Optional[bool] = None,
        inflate_fn=None,
        errors: Optional[str] = None,
        stream=None,
    ):
        """Decode every record of the split's containers into the standard
        :class:`~.bam.RecordBatch` (full SoA and host keys).

        Without a preloaded buffer only the 26-byte file definition and the
        split's own byte window are read.  ``stream`` (a DeviceStream)
        routes block decompression through its rANS gate;
        ``errors="salvage"`` quarantines undecodable slices.  The BAM
        reader's keyword arguments (``with_keys``, ``threads``, ``fields``,
        ``device_inflate``, ``inflate_fn``) are accepted so the reader drops
        into ``DeviceStream.read_splits``; CRAM decode always reconstructs
        whole records, so they change nothing."""
        del with_keys, threads, fields, device_inflate, inflate_fn
        from .sam import _records_to_batch

        errors = errors or "strict"
        ref = self._ref_getter()
        records: List[bam.BamRecord] = []
        if data is None:
            major, _ = cram.parse_file_definition(
                bytes(_read_range(split.path, 0, cram.FILE_DEFINITION_LEN)))
            window = bytes(_read_range(split.path, split.start, split.length))
            pos = 0
            while pos < len(window):
                ch = cram.parse_container_header(window, pos, major)
                records.extend(
                    cram.decode_container(window, ch, major, ref, stream=stream, errors=errors)
                )
                pos = ch.next_offset
            return _records_to_batch(records)
        major, _ = cram.parse_file_definition(data)
        for ch in cram.iter_containers(data):
            if ch.offset < split.start or ch.offset >= split.end:
                continue
            records.extend(
                cram.decode_container(data, ch, major, ref, stream=stream, errors=errors)
            )
        return _records_to_batch(records)

    def read_header(self, path: str) -> bam.BamHeader:
        return read_cram_header(path)


def read_cram_header(path_or_bytes) -> bam.BamHeader:
    data = (
        path_or_bytes
        if isinstance(path_or_bytes, (bytes, bytearray))
        else _read_all(path_or_bytes)
    )
    return bam.header_from_text(cram.read_cram_header_text(data))


class CramRecordWriter:
    """Container-stream writer.  ``write_header=False`` omits the file
    definition and header container (headerless parts); ``append_eof=False``
    suppresses the EOF marker so parts can be concatenated."""

    def __init__(
        self,
        stream,
        header: bam.BamHeader,
        write_header: bool = True,
        append_eof: bool = False,
        records_per_container: int = 10000,
    ):
        self._stream = stream
        self._header = header
        self._append_eof = append_eof
        self._n_per = records_per_container
        self._pending: List[bam.BamRecord] = []
        self._counter = 0
        if write_header:
            stream.write(cram.MAGIC + bytes([3, 0]) + b"\x00" * 20)
            stream.write(cram.encode_file_header_container(header.text, 3))

    def write_record(self, rec: bam.BamRecord) -> None:
        self._pending.append(rec)
        if len(self._pending) >= self._n_per:
            self._flush()

    def write_batch(self, batch, order=None) -> None:
        """The batch's records (in ``order``, when given)."""
        idx = order if order is not None else range(batch.n_records)
        off = batch.soa["rec_off"]
        for i in idx:
            self.write_record(bam.decode_record(batch.data, int(off[int(i)]) - 4)[0])

    def _flush(self) -> None:
        if self._pending:
            self._stream.write(cram.encode_container(self._pending, self._counter, 3))
            self._counter += len(self._pending)
            self._pending = []

    def close(self) -> None:
        self._flush()
        if self._append_eof:
            self._stream.write(cram.EOF_V3)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _next_offset(offsets: List[int], pos: int) -> Optional[int]:
    i = bisect.bisect_left(offsets, pos)
    return offsets[i] if i < len(offsets) else None

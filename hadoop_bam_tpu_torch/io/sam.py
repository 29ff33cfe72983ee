"""SAM text input and output: split reading with the header re-read, the
text writer, decoded records → the standard record batch.

Counterpart of ``hadoop_bam_tpu/io/sam.py`` (SAMRecordReader.java,
SAMRecordWriter.java): byte splits with the skip-first-line /
read-past-the-end protocol (:108-146); a mid-file split parses its records
against the header read from the file's head (the WorkaroundingStream's
role, :183-330: a data line never starts with ``@``, since QNAME's alphabet
excludes it).  Gzip SAM is one unsplittable split.  A split's lines go
through the vectorized parser (:mod:`.sam_vec`), else the exact per-line
parser.  The CRAM reader shares :func:`_records_to_batch`: it encodes its
decoded records to BAM bytes, so both text and CRAM feed the same SoA
decode, host keys and sort as BAM.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..conf import Configuration
from ..spec import bam, sam
from .bam import RecordBatch
from .sam_vec import parse_split_vectorized
from .splits import ByteSplit
from .text import SplitLineReader, plan_byte_splits, read_header_prefix, read_split_window


class SamInputFormat:
    def __init__(self, conf: Optional[Configuration] = None):
        self.conf = conf or Configuration()

    def get_splits(self, paths, split_size: int = 4 << 20) -> List[ByteSplit]:
        out: List[ByteSplit] = []
        for p in sorted(paths):
            out.extend(plan_byte_splits(p, split_size))
        return out

    def read_header(self, path: str, data: Optional[bytes] = None) -> bam.BamHeader:
        """The leading ``@`` lines of ``data`` (default: the file's head,
        read in growing prefixes) as a header."""
        if data is None:
            data = read_header_prefix(path, b"@")
        lines = []
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            line = data[pos : nl if nl >= 0 else len(data)]
            if not line.startswith(b"@"):
                break
            lines.append(line.decode().rstrip("\r"))
            if nl < 0:
                break
            pos = nl + 1
        hdr, _ = sam.read_sam("\n".join(lines) + "\n")
        return hdr

    def read_split(self, split: ByteSplit, data: Optional[bytes] = None) -> RecordBatch:
        """Every record whose line starts inside the split.  Without
        ``data`` only the split's window is read, and the header from the
        file's head; gzip input reads the whole payload (one split)."""
        if data is None:
            data, split = read_split_window(split)
            header = (
                self.read_header(split.path, data=data)
                if split.start == 0  # the window starts at the file's head
                else self.read_header(split.path)
            )
        else:
            header = self.read_header(split.path, data=data)
        a = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
        blob = parse_split_vectorized(a, split.start, split.end, header)
        if blob is not None:
            return _blob_to_batch(blob)
        records: List[bam.BamRecord] = []
        for _, line in SplitLineReader(data, split.start, split.end).lines():
            if line and not line.startswith(b"@"):
                records.append(sam.sam_line_to_record(line.decode(), header))
        return _records_to_batch(records)


def _records_to_batch(records: List[bam.BamRecord]) -> RecordBatch:
    """Binary-encode the records and decode the batch from those bytes."""
    blob = b"".join(r.encode() for r in records)
    return _blob_to_batch(np.frombuffer(blob, np.uint8))


def _blob_to_batch(arr: np.ndarray) -> RecordBatch:
    offsets = bam.record_offsets(arr, 0) if len(arr) else np.empty(0, np.int64)
    soa = (
        bam.soa_decode(arr, offsets)
        if len(offsets)
        else {k: np.empty(0, np.int64) for k in bam.SOA_FIELDS}
    )
    keys = bam.soa_keys(soa, arr) if len(offsets) else np.empty(0, np.int64)
    return RecordBatch(soa=soa, data=arr, keys=keys)


class SamOutputWriter:
    """Text SAM writer (SAMRecordWriter.java:84-104 semantics)."""

    def __init__(self, stream, header: bam.BamHeader, write_header: bool = True):
        self._stream = stream
        self.header = header
        if write_header and header.text:
            stream.write((header.text.rstrip("\n") + "\n").encode())

    def write_record(self, rec: bam.BamRecord) -> None:
        self._stream.write((sam.record_to_sam_line(rec, self.header) + "\n").encode())

    def write_batch(self, batch: RecordBatch, order=None) -> None:
        """The batch's records, in ``order`` when given."""
        idx = range(batch.n_records) if order is None else order
        offs = batch.soa["rec_off"]
        for i in idx:
            self.write_record(bam.decode_record(batch.data, int(offs[int(i)]) - 4)[0])

    def close(self) -> None:
        pass

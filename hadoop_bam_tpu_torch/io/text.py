"""Text-format plumbing: byte splits, line tables, the split resync rule.

Counterpart of ``hadoop_bam_tpu/io/text.py`` (the LineReader layer): CR, LF
and CRLF ends, and the split protocol: a reader whose split starts
mid-file drops the partial first line and reads one line past its end, so
every record belongs to exactly one split (SAMRecordReader.java:108-146,
QseqInputFormat.java:136-155).  Gzip text is one unsplittable split
(FastqInputFormat.java:393-398); BGZF VCF has its own virtual splits.
Files are read through the filesystem seam (:mod:`.fs`).
``gather_padded`` keeps the NumPy arm only: the reference's other arm is
its C++ library.
"""

from __future__ import annotations

import gzip
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..spec import bgzf
from . import fs
from .splits import ByteSplit

MAX_LINE_LENGTH = 20000  # FastqInputFormat.java MAX_LINE_LENGTH


def read_range(path: str, start: int, length: int) -> bytes:
    """Bytes ``[start, start + length)`` of ``path`` through its filesystem."""
    return fs.get_fs(path).read_range(path, start, length)


def read_all(path: str) -> bytes:
    return fs.get_fs(path).read_all(path)


def file_size(path: str) -> int:
    return fs.get_fs(path).size(path)


def line_table(
    a: np.ndarray,
    start: int,
    stop: int,
    tail: int = 4 * (MAX_LINE_LENGTH + 1),
) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, lens) of every line beginning in ``[start, stop)`` of the
    uint8 buffer ``a``.

    Lines may end past ``stop`` — the read-past-the-split-end protocol —
    so the scan window extends ``tail`` bytes beyond ``stop`` (enough for
    a full trailing FASTQ record at the reference's MAX_LINE_LENGTH), NOT
    to EOF: per-split cost is O(split), independent of file size.  CR/LF
    terminators are excluded from ``lens``.
    """
    window_end = min(len(a), stop + tail)
    stop = min(stop, window_end)
    nl = start + np.nonzero(a[start:window_end] == 0x0A)[0]
    starts = np.concatenate(([start], nl + 1)).astype(np.int64)
    ends = np.concatenate((nl, [window_end])).astype(np.int64)
    if len(starts) > 1 and starts[-1] >= window_end:
        starts = starts[:-1]
        ends = ends[:-1]
    keep = starts < stop
    starts, ends = starts[keep], ends[keep]
    lens = ends - starts
    # Strip a trailing CR (CRLF files).
    has_cr = (lens > 0) & (a[np.maximum(ends - 1, 0)] == 0x0D)
    lens = lens - has_cr.astype(np.int64)
    return starts, lens


def gather_padded(
    a: np.ndarray,
    starts: np.ndarray,
    lens: np.ndarray,
    width: Optional[int] = None,
    chunk_rows: int = 1 << 16,
) -> np.ndarray:
    """Ragged byte slices → 0-padded uint8[N, width] matrix.

    Chunked fancy-index gather: the index temporaries are ``chunk_rows *
    width``, not ``N * width``.  A row past EOF (the read-past-the-split
    protocol on a file without a final newline) is clamped and zeroed.
    """
    n = len(starts)
    W = int(width if width is not None else (lens.max() if n else 0))
    out = np.empty((n, W), dtype=np.uint8)
    if n == 0 or W == 0:
        return out.reshape(n, W)
    col = np.arange(W, dtype=np.int64)[None, :]
    amax = len(a) - 1
    uniform = bool((lens == W).all())
    for r0 in range(0, n, chunk_rows):
        r1 = min(n, r0 + chunk_rows)
        idx = starts[r0:r1, None] + col
        # Only the final rows can index past EOF; everything else skips the
        # clip+mask entirely (the uniform-length fast path is the common
        # case: fixed-length reads).
        tail = int(idx[-1, -1]) > amax
        if tail:
            np.clip(idx, 0, amax, out=idx)
        chunk = a[idx]
        if not uniform:
            chunk[col >= lens[r0:r1, None]] = 0
        elif tail:
            chunk[(starts[r0:r1, None] + col) > amax] = 0
        out[r0:r1] = chunk
    return out


def decode_slices(
    data, starts: np.ndarray, lens: np.ndarray
) -> List[str]:
    """Per-row substrings as Python strs (names/keys stay host-side)."""
    mv = memoryview(data)
    return [
        str(mv[int(s) : int(s + l)], "utf-8")
        for s, l in zip(starts, lens)
    ]


def is_gzip(path: str) -> bool:
    return read_range(path, 0, 2) == b"\x1f\x8b"


def plan_byte_splits(
    path: str, split_size: int, splittable: Optional[bool] = None
) -> List[ByteSplit]:
    size = file_size(path)
    compressed = None
    if splittable is None:
        compressed = is_gzip(path)
        splittable = not compressed
    if not splittable:
        return (
            [ByteSplit(path, 0, size, compressed=compressed)]
            if size
            else []
        )
    return [
        ByteSplit(path, s, min(split_size, size - s), compressed=compressed)
        for s in range(0, size, split_size)
    ]


def read_decompressed(path: str) -> bytes:
    """Whole-file read through the gzip/BGZF codec chain (the
    CompressionCodecFactory role, VCFRecordReader.java:121-131)."""
    raw = read_all(path)
    if raw[:2] == b"\x1f\x8b":
        if bgzf.is_bgzf(raw):
            return bgzf.decompress_all(raw)
        return gzip.decompress(raw)
    return raw


def read_split_window(
    split: ByteSplit,
    min_lines_past_end: int = 1,
    tail: int = 1 << 16,
) -> Tuple[bytes, ByteSplit]:
    """Split-local bytes of an uncompressed text split + the rebased split.

    Reads only ``[start-1, end+tail')`` — the reference's contract that a
    split costs O(split) bytes, not O(file) (SAMRecordReader.java:108-146
    seeks to ``start-1`` and reads one line past ``end``).  The window
    grows geometrically until ``min_lines_past_end`` newlines lie at/after
    ``end`` (or EOF), so a record that *starts* inside the split always
    completes inside the window (FASTQ needs 4 lines; single-line formats
    1).  Returns ``(window_bytes, split_rebased_to_window_offsets)``.

    A gzip-magic file falls back to the whole decompressed payload (such
    files are unsplittable — the caller holds its single full split).

    When the split carries the planner's ``compressed`` probe, the only
    reads are the window's own (EOF shows as a short read).
    """
    compressed = split.compressed
    if compressed is None:
        compressed = is_gzip(split.path)
    if compressed:
        data = read_decompressed(split.path)
        return data, ByteSplit(
            split.path, 0, len(data), compressed=False
        )
    w0 = max(0, split.start - 1)
    end = split.end
    while True:
        w1 = end + tail
        data = read_range(split.path, w0, w1 - w0)
        if len(data) < w1 - w0:
            # Short read: the window reached EOF — nothing left to grow
            # into, and the split end clamps to the actual file size.
            end = min(end, w0 + len(data))
            break
        # Enough complete lines past the split end?
        pos = end - w0 - 1  # a terminator exactly at end-1 counts for the
        found = True  # line *ending* at the boundary
        for _ in range(min_lines_past_end):
            at = data.find(b"\n", max(pos, 0))
            if at < 0:
                found = False
                break
            pos = at + 1
        if found:
            break
        tail *= 4
    return data, ByteSplit(
        split.path,
        split.start - w0,
        max(0, end - split.start),
        compressed=False,
    )


def read_header_prefix(path: str, marker: bytes) -> bytes:
    """The leading ``marker``-prefixed header lines of a text file without
    reading the whole file: growing prefix reads until a terminated
    non-header line (or EOF) appears — O(header) bytes.  Gzip input falls
    back to full decompression (such files are unsplittable anyway).

    The shared header re-injection primitive (SAM ``@`` lines per
    SAMRecordReader.java:183-330, VCF ``#`` lines per
    VCFRecordReader.java:111-154)."""
    size = file_size(path)
    n = 8 << 10
    while True:
        blob = read_range(path, 0, min(n, size))
        if blob[:2] == b"\x1f\x8b":
            return read_decompressed(path)
        pos = 0
        while pos < len(blob) and blob[pos : pos + 1] == marker:
            nl = blob.find(b"\n", pos)
            if nl < 0:
                pos = len(blob)
                break
            pos = nl + 1
        if pos < len(blob) or len(blob) >= size:
            return blob
        n *= 4


class SplitLineReader:
    """Iterate complete lines of one byte split of an uncompressed file.

    A split starting at ``start > 0`` skips the (possibly partial) first
    line; iteration continues past ``end`` to finish the last line that
    *started* inside the split.  Line terminators (LF or CRLF) are stripped,
    as in the reference LineReader (:111-173).
    """

    def __init__(self, data: bytes, start: int, end: int):
        self.data = data
        self.end = end
        if start > 0:
            nl = data.find(b"\n", start - 1)
            self.pos = len(data) if nl < 0 else nl + 1
        else:
            self.pos = 0

    def tell(self) -> int:
        return self.pos

    def at_end(self) -> bool:
        return self.pos >= self.end or self.pos >= len(self.data)

    def read_line(self) -> Optional[bytes]:
        """Next line (terminator stripped) regardless of the split end;
        None at EOF."""
        if self.pos >= len(self.data):
            return None
        nl = self.data.find(b"\n", self.pos)
        if nl < 0:
            line = self.data[self.pos :]
            self.pos = len(self.data)
        else:
            line = self.data[self.pos : nl]
            self.pos = nl + 1
        if line.endswith(b"\r"):
            line = line[:-1]
        return line

    def lines(self) -> Iterator[Tuple[int, bytes]]:
        """(start_offset, line) for every line starting inside the split."""
        while not self.at_end():
            at = self.pos
            line = self.read_line()
            if line is None:
                break
            yield at, line

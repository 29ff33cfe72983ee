"""The ``.splitting-bai`` index: reader, incremental builder, part merge.

Counterpart of the ``.splitting-bai`` part of
``hadoop_bam_tpu/spec/indices.py`` (SplittingBAMIndexer.java semantics):
big-endian u64 virtual offsets of every g-th alignment, terminated by
``fileSize << 16``.
"""

from __future__ import annotations

import bisect
import struct
from typing import BinaryIO, List, Optional, Sequence, Union

SPLITTING_BAI_EXT = ".splitting-bai"
DEFAULT_GRANULARITY = 4096


class SplittingBai:
    """Reader: the sorted virtual offsets, queried by floor/higher."""

    def __init__(self, voffsets: Sequence[int]):
        if len(voffsets) < 1:
            raise IOError(
                "Invalid splitting BAM index: should contain at least the file size"
            )
        if any(b < a for a, b in zip(voffsets, voffsets[1:])):
            raise IOError("Invalid splitting BAM index; offsets not in order")
        self.voffsets: List[int] = list(voffsets)

    @staticmethod
    def load(source: Union[str, bytes, BinaryIO]) -> "SplittingBai":
        if isinstance(source, str):
            with open(source, "rb") as f:
                raw = f.read()
        elif isinstance(source, bytes):
            raw = source
        else:
            raw = source.read()
        if len(raw) % 8 != 0:
            raise IOError("Invalid splitting BAM index: truncated")
        return SplittingBai(list(struct.unpack(f">{len(raw) // 8}Q", raw)))

    def save(self, stream: BinaryIO) -> None:
        stream.write(struct.pack(f">{len(self.voffsets)}Q", *self.voffsets))

    def prev_alignment(self, file_pos: int) -> Optional[int]:
        i = bisect.bisect_right(self.voffsets, file_pos << 16)
        return self.voffsets[i - 1] if i > 0 else None

    def next_alignment(self, file_pos: int) -> Optional[int]:
        i = bisect.bisect_right(self.voffsets, file_pos << 16)
        return self.voffsets[i] if i < len(self.voffsets) else None

    def bam_size(self) -> int:
        return self.voffsets[-1] >> 16

    def size(self) -> int:
        return len(self.voffsets)


class SplittingBaiBuilder:
    """Records the offset of alignment 0 and of every alignment whose
    ``(count + 1) % granularity == 0``; finishes with ``fileSize << 16``."""

    def __init__(self, granularity: int = DEFAULT_GRANULARITY):
        if granularity < 1:
            raise ValueError("granularity must be >= 1")
        self.granularity = granularity
        self.count = 0
        self.voffsets: List[int] = []

    def finish(self, input_size: int) -> SplittingBai:
        self.voffsets.append(input_size << 16)
        return SplittingBai(self.voffsets)


def merge_splitting_bais(
    indices: Sequence[SplittingBai],
    part_lengths: Sequence[int],
    header_length: int,
    total_length: int,
    out: BinaryIO,
) -> None:
    """Shift each part's offsets by the bytes before it and concatenate."""
    shift = header_length
    merged: List[int] = []
    for idx, plen in zip(indices, part_lengths):
        for v in idx.voffsets[:-1]:
            merged.append(((v >> 16) + shift) << 16 | (v & 0xFFFF))
        shift += plen
    merged.append(total_length << 16)
    SplittingBai(merged).save(out)

"""FASTA input: one split per contig, line-granular reference fragments.

Counterpart of ``hadoop_bam_tpu/io/fasta.py`` (FastaInputFormat.java):
``get_splits`` scans for ``>`` description lines and makes one split per
contig (:62-154); a contig reads as its whole sequence in one uint8 array
with each source line's offset and 1-based position, and
:meth:`ContigBatch.fragments` gives the reference's per-line
``ReferenceFragment`` (contig, position, line; :334-372).  Gzip and BGZF
files are read whole through the filesystem seam (:mod:`.fs`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..conf import Configuration
from .splits import ByteSplit
from .text import SplitLineReader, read_decompressed


@dataclass
class ReferenceFragment:
    contig: str
    position: int  # 1-based coordinate of the first base in this line
    sequence: bytes


@dataclass
class ContigBatch:
    contig: str
    bases: np.ndarray  # uint8, concatenated sequence
    line_offsets: np.ndarray  # int64 offsets of each source line in `bases`
    line_positions: np.ndarray  # int64 1-based coordinate per line

    def fragments(self) -> List[ReferenceFragment]:
        out = []
        ends = list(self.line_offsets[1:]) + [len(self.bases)]
        for off, end, pos in zip(self.line_offsets, ends, self.line_positions):
            out.append(
                ReferenceFragment(
                    self.contig,
                    int(pos),
                    self.bases[int(off) : int(end)].tobytes(),
                )
            )
        return out


class FastaInputFormat:
    def __init__(self, conf: Optional[Configuration] = None):
        self.conf = conf or Configuration()

    def get_splits(self, paths) -> List[ByteSplit]:
        """One split per contig, found by scanning for '>' lines
        (FastaInputFormat.java:62-154)."""
        out: List[ByteSplit] = []
        for path in sorted(paths):
            data = read_decompressed(path)
            starts = []
            pos = 0
            while True:
                if pos == 0 and data[:1] == b">":
                    starts.append(0)
                    pos = 1
                idx = data.find(b"\n>", pos)
                if idx < 0:
                    break
                starts.append(idx + 1)
                pos = idx + 2
            for i, s in enumerate(starts):
                end = starts[i + 1] if i + 1 < len(starts) else len(data)
                out.append(ByteSplit(path, s, end - s))
        return out

    def read_split(
        self, split: ByteSplit, data: Optional[bytes] = None
    ) -> ContigBatch:
        if data is None:
            data = read_decompressed(split.path)
        r = SplitLineReader(data, 0, split.end)
        r.pos = split.start
        desc_line = r.read_line()
        if desc_line is None or not desc_line.startswith(b">"):
            raise IOError(f"split does not start at a FASTA description: {split}")
        contig = desc_line[1:].split()[0].decode()
        chunks: List[bytes] = []
        offsets: List[int] = []
        positions: List[int] = []
        pos_1based = 1
        total = 0
        while r.pos < split.end:
            line = r.read_line()
            if line is None:
                break
            if line.startswith(b">"):
                break
            if not line:
                continue
            offsets.append(total)
            positions.append(pos_1based)
            chunks.append(line)
            total += len(line)
            pos_1based += len(line)
        bases = (
            np.frombuffer(b"".join(chunks), dtype=np.uint8)
            if chunks
            else np.empty(0, np.uint8)
        )
        return ContigBatch(
            contig=contig,
            bases=bases,
            line_offsets=np.asarray(offsets, dtype=np.int64),
            line_positions=np.asarray(positions, dtype=np.int64),
        )

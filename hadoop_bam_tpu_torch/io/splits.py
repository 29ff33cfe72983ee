"""Split descriptors: virtual-offset ranges over BGZF files, byte ranges.

Counterpart of ``hadoop_bam_tpu/io/splits.py`` (FileVirtualSplit.java): a
BGZF split is ``[vstart, vend)`` in virtual-offset space over one file,
optionally carrying the interval filter's chunk spans
(FileVirtualSplit.java:91-98) so the reader keeps only the records that
start inside them; a :class:`ByteSplit` is a plain byte range (CRAM
container runs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass
class FileVirtualSplit:
    path: str
    vstart: int  # virtual offset of the first record
    vend: int  # virtual offset one past the last record byte
    interval_chunks: Optional[List[Tuple[int, int]]] = None


@dataclass
class ByteSplit:
    """A plain byte-range split.  ``compressed`` caches a planner's
    gzip-magic probe; ``None`` means unknown."""

    path: str
    start: int
    length: int
    compressed: Optional[bool] = None

    @property
    def end(self) -> int:
        return self.start + self.length

"""Split descriptors: virtual-offset ranges over BGZF files, byte ranges.

Counterpart of ``hadoop_bam_tpu/io/splits.py`` (FileVirtualSplit.java): a
BGZF split is ``[vstart, vend)`` in virtual-offset space over one file; a
:class:`ByteSplit` is a plain byte range (CRAM container runs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class FileVirtualSplit:
    path: str
    vstart: int  # virtual offset of the first record
    vend: int  # virtual offset one past the last record byte


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

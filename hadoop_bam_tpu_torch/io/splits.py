"""Split descriptors: virtual-offset ranges over BGZF files.

Counterpart of ``hadoop_bam_tpu/io/splits.py`` (FileVirtualSplit.java): a
split is ``[vstart, vend)`` in virtual-offset space over one file.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FileVirtualSplit:
    path: str
    vstart: int  # virtual offset of the first record
    vend: int  # virtual offset one past the last record byte

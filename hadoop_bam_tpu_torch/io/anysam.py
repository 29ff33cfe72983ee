"""AnySAM dispatch: extension trust, then first-byte content sniffing.

Counterpart of ``hadoop_bam_tpu/io/anysam.py`` (AnySAMInputFormat.java,
SAMFormat.java): with ``hadoopbam.anysam.trust-exts`` (default true) the
``.bam``/``.cram``/``.sam`` extension decides, otherwise the first byte
(``0x1f`` BAM, ``C`` CRAM, ``@`` SAM); per-path decisions are cached;
``get_splits`` groups the paths by format and asks each format's planner.

A SAM header is read from the text by ``SamInputFormat.read_header``.  The
reference sends a SAM file's header to its BGZF reader
(``hadoop_bam_tpu/io/anysam.py`` ``read_header`` → ``io/bam.read_header``),
which raises ``BgzfError`` on text, so its ``sort_bam`` cannot take a
``.sam``; the port reads the header the SAM reader's way.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

from ..conf import ANYSAM_TRUST_EXTS, Configuration
from ..utils.tracing import Metrics
from .bam import BamInputFormat, RecordBatch
from .cram import CramInputFormat, read_cram_header
from .sam import SamInputFormat
from .splits import ByteSplit, FileVirtualSplit
from .text import read_range

AnySplit = Union[ByteSplit, FileVirtualSplit]


def infer_from_file_path(path: str) -> Optional[str]:
    low = path.lower()
    if low.endswith(".bam"):
        return "bam"
    if low.endswith(".cram"):
        return "cram"
    if low.endswith(".sam"):
        return "sam"
    return None


def infer_from_data(first_byte: int) -> Optional[str]:
    """SAMFormat.inferFromData (SAMFormat.java:53-62)."""
    if first_byte == 0x1F:
        return "bam"
    if first_byte == 0x43:  # 'C' of the CRAM magic
        return "cram"
    if first_byte == 0x40:  # '@' of a header line
        return "sam"
    return None


class AnySamInputFormat:
    def __init__(self, conf: Optional[Configuration] = None, metrics: Optional[Metrics] = None):
        self.conf = conf or Configuration()
        self._format_cache: Dict[str, Optional[str]] = {}
        self._bam = BamInputFormat(self.conf, metrics)
        self.metrics = self._bam.metrics
        self._sam = SamInputFormat(self.conf)
        self._cram = CramInputFormat(self.conf)  # one FASTA parse for all splits

    def get_format(self, path: str) -> str:
        if path in self._format_cache:
            fmt = self._format_cache[path]
        else:
            fmt = None
            if self.conf.get_boolean(ANYSAM_TRUST_EXTS, True):
                fmt = infer_from_file_path(path)
            if fmt is None:
                head = read_range(path, 0, 1)
                fmt = infer_from_data(head[0]) if head else None
            self._format_cache[path] = fmt
        if fmt is None:
            raise IOError(f"unknown SAM format in {path}")
        return fmt

    def get_splits(self, paths, split_size: int = 4 << 20) -> List[AnySplit]:
        by_fmt: Dict[str, List[str]] = {}
        for p in paths:
            by_fmt.setdefault(self.get_format(p), []).append(p)
        out: List[AnySplit] = []
        for fmt, group in sorted(by_fmt.items()):
            if fmt == "bam":
                out.extend(self._bam.get_splits(group, split_size))
            elif fmt == "sam":
                out.extend(self._sam.get_splits(group, split_size))
            else:
                out.extend(self._cram.get_splits(group, split_size))
        return out

    def read_split(self, split: AnySplit, **kw) -> RecordBatch:
        """Per-format dispatch with the read-drive keyword arguments
        passed through, so this format drops into
        ``DeviceStream.read_splits`` like a BamInputFormat.  The text
        reader takes none of them but ``data``: it has no codec tiers and
        no projection."""
        if isinstance(split, FileVirtualSplit):
            return self._bam.read_split(split, **kw)
        if self.get_format(split.path) == "sam":
            return self._sam.read_split(split, data=kw.get("data"))
        return self._cram.read_split(split, **kw)

    def read_header(self, path: str):
        fmt = self.get_format(path)
        if fmt == "cram":
            return read_cram_header(path)
        if fmt == "sam":
            return self._sam.read_header(path)
        return self._bam.read_header(path)

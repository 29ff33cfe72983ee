"""FASTQ quality encodings and the FASTQ format error.

Counterpart of the constants of ``hadoop_bam_tpu/spec/fragment.py``
(SequencedFragment.java: Sanger Phred+33 in [0, 93], Illumina Phred+64 in
[0, 62]) and of the reference's ``FormatException``, which is the
interval parser's :class:`~..utils.intervals.FormatError` (one ``except``
catches a malformed region and a malformed FASTQ record alike).
"""

from __future__ import annotations

from ..utils.intervals import FormatError as FormatException  # noqa: F401

SANGER_OFFSET = 33
SANGER_MAX = 93
ILLUMINA_OFFSET = 64
ILLUMINA_MAX = 62

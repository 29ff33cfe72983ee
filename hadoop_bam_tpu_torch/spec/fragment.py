"""FASTQ quality encodings and the FASTQ format error.

Counterpart of the constants of ``hadoop_bam_tpu/spec/fragment.py``
(SequencedFragment.java: Sanger Phred+33 in [0, 93], Illumina Phred+64 in
[0, 62]) and of the reference's ``FormatException``.
"""

from __future__ import annotations

SANGER_OFFSET = 33
SANGER_MAX = 93
ILLUMINA_OFFSET = 64
ILLUMINA_MAX = 62


class FormatException(ValueError):
    """Malformed FASTQ input: a frame violation, a truncated record, a
    corrupt gzip member in strict mode, a quality out of range."""

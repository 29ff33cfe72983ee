"""FASTQ id parsing: the CASAVA 1.8 pattern.

Counterpart of ``ILLUMINA_PATTERN`` in ``hadoop_bam_tpu/io/fastq.py``.
"""

from __future__ import annotations

import re

# Casava 1.8: instrument:run:flowcell:lane:tile:x:y read:filtered:control:index
ILLUMINA_PATTERN = re.compile(
    r"([^:]+):(\d+):([^:]*):(\d+):(\d+):(-?\d+):(-?\d+)\s+([123]):([YN]):(\d+):(.*)"
)

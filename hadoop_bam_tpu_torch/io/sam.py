"""Decoded records → the standard record batch.

Counterpart of ``_records_to_batch`` and ``_blob_to_batch`` of
``hadoop_bam_tpu/io/sam.py``: the CRAM reader encodes its decoded records
to BAM bytes and runs the SoA decode and the host keys over them, so CRAM
feeds the same sort as BAM.  The SAM text reader is not ported yet
(ROADMAP A.9).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..spec import bam
from .bam import RecordBatch


def _records_to_batch(records: List[bam.BamRecord]) -> RecordBatch:
    """Binary-encode the records and decode the batch from those bytes."""
    blob = b"".join(r.encode() for r in records)
    return _blob_to_batch(np.frombuffer(blob, np.uint8))


def _blob_to_batch(arr: np.ndarray) -> RecordBatch:
    offsets = bam.record_offsets(arr, 0) if len(arr) else np.empty(0, np.int64)
    soa = (
        bam.soa_decode(arr, offsets)
        if len(offsets)
        else {k: np.empty(0, np.int64) for k in bam.SOA_FIELDS}
    )
    keys = bam.soa_keys(soa, arr) if len(offsets) else np.empty(0, np.int64)
    return RecordBatch(soa=soa, data=arr, keys=keys)

"""Host-side signature columns for duplicate marking.

Counterpart of ``hadoop_bam_tpu/dedup/signature.py``.  One call per decoded
split while the read loop still holds its bytes: the ragged parts (CIGAR
clip spans, quality sums, read-name hashes) reduce to fixed-width int32
columns, so the job's decision (:mod:`.device`) is dense device work over
about 36 bytes a record whatever the records' size.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..collate.signature import QNAME_SEED2, name_hash_pair
from ..ops.cigar import clip_spans_np
from ..ops.quality import sum_base_qualities_np
from ..spec.bam import (
    FLAG_MATE_UNMAPPED,
    FLAG_PAIRED,
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
    FLAG_UNMAPPED,
)

#: SoA columns the dedup stage needs beyond ``io.bam.SORT_FIELDS``.
DEDUP_EXTRA_FIELDS = ("l_read_name", "n_cigar_op", "l_seq")

#: The collation's second name-hash seed, under the reference's old name.
_QNAME_SEED2 = QNAME_SEED2

#: Scores are clamped so that a pair's sum stays within int32.
_SCORE_CAP = 1 << 30

_EXEMPT_FLAGS = FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_UNMAPPED

#: The signature columns, in the decision's argument order.
_COLUMNS = ("refid", "pos5", "rev", "exempt", "cand", "score", "qh1", "qh2", "flag")


def signature_columns(data: np.ndarray, soa: Dict) -> Dict[str, np.ndarray]:
    """The dedup columns of one decoded batch, in read order: int32
    ``refid``, ``pos5`` (the unclipped 5′ coordinate: the unclipped start of
    a forward read, the unclipped end of a reverse one), ``rev``, ``exempt``
    (secondary, supplementary, unmapped, or refid/pos < 0), ``cand`` (a pair
    collation candidate), ``score`` (capped quality sum), ``qh1``/``qh2``
    (the 64-bit name hash) and ``flag``."""
    refid = soa["refid"].astype(np.int32)
    pos = soa["pos"].astype(np.int64)
    flag = soa["flag"].astype(np.int32)
    rev = ((flag & FLAG_REVERSE) != 0).astype(np.int32)
    exempt = (((flag & _EXEMPT_FLAGS) != 0) | (refid < 0) | (pos < 0)).astype(np.int32)
    cand = ((exempt == 0) & ((flag & FLAG_PAIRED) != 0)
            & ((flag & FLAG_MATE_UNMAPPED) == 0)).astype(np.int32)
    lead, trail, span = clip_spans_np(data, soa)
    pos5 = np.where(rev.astype(bool), pos + np.maximum(span, 1) - 1 + trail,
                    pos - lead).astype(np.int32)
    score = np.minimum(sum_base_qualities_np(data, soa), _SCORE_CAP).astype(np.int32)
    qh1, qh2 = name_hash_pair(data, soa)
    return {"refid": refid, "pos5": pos5, "rev": rev, "exempt": exempt, "cand": cand,
            "score": score, "qh1": qh1, "qh2": qh2, "flag": flag}


def concat_columns(parts: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The job's columns from the per-split ones."""
    if not parts:
        return {k: np.empty(0, np.int32) for k in _COLUMNS}
    if len(parts) == 1:
        return parts[0]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

"""Host-side collation columns: what the name collation needs of each
decoded split, as fixed-width int32 columns plus two packed ragged blobs
(read names, raw CIGARs).

Counterpart of ``hadoop_bam_tpu/collate/signature.py``.  Names hash with
murmur3 under seed 0 and under :data:`QNAME_SEED2`, 64 bits in all: the
collation key of markdup, the queryname sort and fixmate.  The name blob
lets the host verify each hash bucket against the actual names
(:func:`~.host.verify_and_repair`); the CIGAR blob feeds fixmate's MC tags.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ..ops.cigar import clip_spans_np
from ..spec.bam import FLAG_PAIRED, FLAG_SECONDARY, FLAG_SUPPLEMENTARY
from ..utils.murmur3 import murmurhash3_int32_batch

#: SoA columns the collation stages need beyond ``io.bam.SORT_FIELDS``.
COLLATE_EXTRA_FIELDS = ("l_read_name", "n_cigar_op", "l_seq")

#: Second murmur3 seed of the 64-bit read-name hash pair (seed 0 is the first).
QNAME_SEED2 = 0x9747B28C

#: Ragged-blob columns rebased by :func:`concat_collation`.
_BLOB_COLS = (("name_off", "names"), ("cig_off", "cigs"))


def name_hash_pair(data: np.ndarray, soa: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """The 64-bit collation key: murmur3 of the name bytes (without the
    trailing NUL) under the two seeds, as an (int32, int32) column pair."""
    name_off = soa["rec_off"].astype(np.int64) + 32
    name_len = np.maximum(soa["l_read_name"].astype(np.int64) - 1, 0)
    qh1 = murmurhash3_int32_batch(data, name_off, name_len, 0)
    qh2 = murmurhash3_int32_batch(data, name_off, name_len, QNAME_SEED2)
    return qh1, qh2


def ragged_slice(data: np.ndarray, offs: np.ndarray,
                 lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``data[offs[i] : offs[i] + lens[i]]`` for every i packed into one
    blob, by one fancy-index pass: ``(blob, blob_offs)``."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    out_off = np.cumsum(lens) - lens
    if total == 0:
        return np.empty(0, np.uint8), out_off
    idx = np.repeat(offs.astype(np.int64) - out_off, lens) + np.arange(total, dtype=np.int64)
    return np.asarray(data, dtype=np.uint8)[idx], out_off


def collation_columns(data: np.ndarray, soa: Dict, with_cigars: bool = False) -> Dict[str, np.ndarray]:
    """The collation columns of one decoded batch, in read order.

    int32 ``qh1``/``qh2`` (the name hash), ``flag``, ``refid``, ``pos``,
    ``span`` (reference span from the CIGAR with ``with_cigars``, else 0),
    ``cand`` (paired, neither secondary nor supplementary: unmapped records
    are candidates, since fixmate pairs an unmapped mate), ``name_len``;
    int64 ``name_off`` into the uint8 ``names`` blob.  ``with_cigars`` adds
    ``n_cig``, ``cig_off`` and the raw little-endian u32 ``cigs`` blob."""
    flag = soa["flag"].astype(np.int32)
    refid = soa["refid"].astype(np.int32)
    pos = soa["pos"].astype(np.int32)
    qh1, qh2 = name_hash_pair(data, soa)
    if with_cigars:
        _, _, span = clip_spans_np(data, soa)
    else:
        span = np.zeros(len(flag), dtype=np.int64)
    cand = (((flag & FLAG_PAIRED) != 0)
            & ((flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0)).astype(np.int32)
    name_src = soa["rec_off"].astype(np.int64) + 32
    name_len = np.maximum(soa["l_read_name"].astype(np.int64) - 1, 0).astype(np.int32)
    names, name_off = ragged_slice(data, name_src, name_len)
    cols = {
        "qh1": qh1, "qh2": qh2, "flag": flag, "refid": refid, "pos": pos,
        "span": span.astype(np.int32), "cand": cand, "name_len": name_len,
        "name_off": name_off, "names": names,
    }
    if with_cigars:
        cig_src = soa["rec_off"].astype(np.int64) + 32 + soa["l_read_name"].astype(np.int64)
        n_cig = soa["n_cigar_op"].astype(np.int32)
        cigs, cig_off = ragged_slice(data, cig_src, n_cig * 4)
        cols.update({"n_cig": n_cig, "cig_off": cig_off, "cigs": cigs})
    return cols


def concat_collation(parts: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The job's columns from the per-split ones, the blob offsets rebased
    into the concatenated blobs."""
    if not parts:
        return collation_columns(np.empty(0, np.uint8), {
            k: np.empty(0, np.int64)
            for k in ("rec_off", "rec_len", "flag", "refid", "pos", "l_read_name", "n_cigar_op")
        })
    if len(parts) == 1:
        return parts[0]
    out: Dict[str, np.ndarray] = {}
    for off_key, blob_key in _BLOB_COLS:
        if off_key not in parts[0]:
            continue
        base = np.cumsum([0] + [len(p[blob_key]) for p in parts[:-1]]).astype(np.int64)
        out[off_key] = np.concatenate([p[off_key] + base[i] for i, p in enumerate(parts)])
        out[blob_key] = np.concatenate([p[blob_key] for p in parts])
    for k in parts[0]:
        if k not in out:
            out[k] = np.concatenate([p[k] for p in parts])
    return out

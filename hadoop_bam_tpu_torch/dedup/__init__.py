"""Duplicate marking, fused into the coordinate sort.

Counterpart of ``hadoop_bam_tpu/dedup``.  The sort reads each split's
signature columns (:mod:`.signature`), the decision runs on the card over
the whole job (:mod:`.device`), and the part writers OR ``FLAG_DUPLICATE``
(0x400) into the written copy of each duplicate's flag (the host gather's
``io.bam.patch_flags``, or the gather kernel's patch on the device write
path); the source payloads never change.  The mask is in read order, the
index space the part writers' ``order`` slices address.

Semantics, shared bit for bit by the decision and the per-record oracle
(:mod:`.oracle`):

- **Exempt** records are never marked and never take part: secondary
  (0x100), supplementary (0x800), unmapped (0x4, or refid/pos < 0).
- A record's **end signature** is ``(refid, unclipped 5′, strand)``: the
  unclipped start of a forward read, the unclipped end of a reverse one.
- **Pairs**: candidates (paired, mate mapped) collate by the 64-bit murmur3
  name hash; a name with exactly two candidates is a mated pair.  Pairs
  sharing both end signatures form a family; the best summed base quality
  survives (ties: name hash, then the earliest record), the rest are marked.
- **Fragments** (everything else that is not exempt) sharing an end with
  any mated pair are marked; otherwise the best score survives its family
  (ties: name hash, flag, index).
"""

from .device import mark_duplicates_device
from .oracle import mark_duplicates_oracle
from .signature import DEDUP_EXTRA_FIELDS, concat_columns, signature_columns

__all__ = [
    "DEDUP_EXTRA_FIELDS",
    "concat_columns",
    "mark_duplicates_device",
    "mark_duplicates_oracle",
    "signature_columns",
]

"""The name collation and the jobs built on it.

Counterpart of ``hadoop_bam_tpu/collate``: one device primitive
(:mod:`.device`, the 64-bit read-name hash grouping with content
tie-breaks), host verification of every bucket against the actual names
(:mod:`.host`), and the jobs on top: the queryname sort
(``pipeline.sort_bam(sort_order="queryname")``), fixmate
(``pipeline.fixmate_bam``, :mod:`.fixmate`) and markdup's pair collation
(:mod:`hadoop_bam_tpu_torch.dedup.device`).  :mod:`.oracle` holds the
per-record oracles.  The reference's ``group_representatives`` and
``global_name_ranks`` serve its mesh and come with it (ROADMAP A.10).
"""

from .device import Collation, collate_by_name, collate_core
from .fixmate import FIXMATE_FIELDS, FixmateEdits, apply_fixmate, compute_fixmate_edits
from .host import (
    QuerynameStats,
    collation_counts,
    natural_compare,
    natural_sort_key,
    queryname_perm,
    verify_and_repair,
)
from .oracle import collate_oracle, fixmate_oracle, mc_tag_of, queryname_sort_oracle
from .signature import (
    COLLATE_EXTRA_FIELDS,
    QNAME_SEED2,
    collation_columns,
    concat_collation,
    name_hash_pair,
)

__all__ = [
    "COLLATE_EXTRA_FIELDS",
    "Collation",
    "FIXMATE_FIELDS",
    "FixmateEdits",
    "QNAME_SEED2",
    "QuerynameStats",
    "apply_fixmate",
    "collate_by_name",
    "collate_core",
    "collate_oracle",
    "collation_columns",
    "collation_counts",
    "compute_fixmate_edits",
    "concat_collation",
    "fixmate_oracle",
    "mc_tag_of",
    "name_hash_pair",
    "natural_compare",
    "natural_sort_key",
    "queryname_perm",
    "queryname_sort_oracle",
    "verify_and_repair",
]

"""Host-side fan-out: the elastic part executor (:mod:`.executor`).

Counterpart of ``hadoop_bam_tpu/parallel``; the mesh, the shuffle and the
multi-host runner are not ported (ROADMAP A.10)."""

from .executor import (
    AttemptTimeout,
    ElasticExecutor,
    ExecutionReport,
    PartFailedError,
    bgzf_part_valid,
)

__all__ = ["AttemptTimeout", "ElasticExecutor", "ExecutionReport", "PartFailedError",
           "bgzf_part_valid"]

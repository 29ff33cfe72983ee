"""Distributed execution: the elastic part executor (:mod:`.executor`), the
device mesh (:mod:`.mesh`), the range-partitioned shuffle sort
(:mod:`.shuffle`) and the multi-process sort (:mod:`.multihost`).

Counterpart of ``hadoop_bam_tpu/parallel``: data parallelism over file
splits becomes shards of a :class:`~.mesh.Mesh`, and the MapReduce sort
shuffle a range-partitioned exchange between them, keyed by the same
64-bit ``(refIdx<<32|pos0)`` packing; across processes the exchange is
``torch.distributed``'s ``all_to_all_single`` and the record bytes move
through the byte plane of :func:`~.multihost.sort_bam_multihost` (with
speculative re-execution of a straggler's parts and the mesh trace);
:func:`~.multihost.fixmate_bam_multihost` pairs mates across the
processes."""

from .executor import (
    AttemptTimeout,
    ElasticExecutor,
    ExecutionReport,
    PartFailedError,
    bgzf_part_valid,
)
from .mesh import Mesh, ProcessLayout, data_axis, make_mesh
from .multihost import MultihostContext, fixmate_bam_multihost, initialize, sort_bam_multihost
from .shuffle import DistributedSort

__all__ = ["AttemptTimeout", "DistributedSort", "ElasticExecutor", "ExecutionReport", "Mesh",
           "MultihostContext", "PartFailedError", "ProcessLayout", "bgzf_part_valid",
           "data_axis", "fixmate_bam_multihost", "initialize", "make_mesh",
           "sort_bam_multihost"]

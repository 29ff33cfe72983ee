"""Serve: the resident daemon on the card and what it keeps warm.

Counterpart of ``hadoop_bam_tpu/serve/`` without the fleet and the router
(ROADMAP A.11b): :mod:`.server` (the daemon), :mod:`.client`, :mod:`.admission`,
:mod:`.batching` (the cross-request lane batcher), :mod:`.arena` (decoded
windows), :mod:`.cache` (headers and indices), :mod:`.journal`,
:mod:`.flightrec`, :mod:`.exemplars`, :mod:`.slo`, :mod:`.endpoints` (view,
flagstat, depth and variants, shared with one-shot callers) and
:mod:`.warmup`.
"""

from .admission import ERROR_CODES, AdmissionController, FleetLedger, ShedError
from .arena import HbmArena
from .batching import LaneBatcher
from .cache import LruByteCache, ResourceCache, file_identity
from .client import (
    DeadlineExceededError,
    JobLostError,
    ServeClient,
    ServeConnectionError,
    ServeError,
    ServeShedError,
)
from .endpoints import (
    ServeContext,
    depth_stat,
    flagstat,
    variants_blob,
    variants_records,
    view_blob,
    view_records,
)
from .exemplars import ExemplarStore, TailSampler
from .flightrec import AccessLog, FlightRecorder
from .journal import JobJournal
from .server import BamDaemon, default_socket_path
from .slo import SloMonitor, SloObjective, fold_slo, parse_objectives
from .warmup import ALL_KINDS, compile_count, ensure_compile_watcher, warm_kernels

__all__ = [
    "ALL_KINDS",
    "AccessLog",
    "AdmissionController",
    "BamDaemon",
    "DeadlineExceededError",
    "ERROR_CODES",
    "ExemplarStore",
    "FleetLedger",
    "FlightRecorder",
    "HbmArena",
    "JobJournal",
    "JobLostError",
    "LaneBatcher",
    "LruByteCache",
    "ResourceCache",
    "ServeClient",
    "ServeConnectionError",
    "ServeContext",
    "ServeError",
    "ServeShedError",
    "ShedError",
    "SloMonitor",
    "SloObjective",
    "TailSampler",
    "compile_count",
    "default_socket_path",
    "depth_stat",
    "ensure_compile_watcher",
    "file_identity",
    "flagstat",
    "fold_slo",
    "parse_objectives",
    "variants_blob",
    "variants_records",
    "view_blob",
    "view_records",
    "warm_kernels",
]

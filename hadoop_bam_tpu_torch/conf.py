"""Configuration: the string property map of the Hadoop ``Configuration``.

Counterpart of ``hadoop_bam_tpu/conf.py`` with only the keys the in-core
coordinate sort (of BAM and CRAM input, with interval traversal), the
FASTQ ingest, the BCF variant plane, the region reads, the part executor,
the fault plan and the resident daemon read.  The key strings are the
reference's, so one dict drives both packages (:func:`from_reference_conf`).
"""

from __future__ import annotations

import os
from typing import Iterator, Mapping, Optional

#: Interval traversal of BAM input: the switch, the intervals
#: (``chr:start-stop[,...]``) and the extra pass over the unplaced,
#: unmapped tail.
BAM_BOUNDED_TRAVERSAL = "hadoopbam.bam.bounded-traversal"
BAM_INTERVALS = "hadoopbam.bam.intervals"
BAM_TRAVERSE_UNPLACED_UNMAPPED = "hadoopbam.bam.traverse-unplaced-unmapped"
BAM_ENABLE_BAI_SPLITTER = "hadoopbam.bam.enable-bai-splitter"
BAM_WRITE_SPLITTING_BAI = "hadoopbam.bam.write-splitting-bai"
BAM_MARK_DUPLICATES = "hadoopbam.bam.mark-duplicates"
BAM_SORT_ORDER = "hadoopbam.bam.sort-order"
#: BGZF inflate on the device ("true"/"false"; unset: on for a CUDA device).
INFLATE_LANES = "hadoopbam.inflate.lanes"
#: Device DEFLATE of parts ("true"/"false"; unset: on for a CUDA device).
DEFLATE_LANES = "hadoopbam.deflate.lanes"
#: Device-resident part writes: gather, CRC32 and deflate on the card
#: ("true"/"false"; unset: on for a CUDA device).
WRITE_DEVICE = "hadoopbam.write.device"
#: Split read-ahead depth (this key → HBAM_READ_DEPTH → 2).
READ_DEPTH = "hadoopbam.read.depth"
#: "strict" (raise on corrupt input) or "salvage" (quarantine and go on).
ERRORS_MODE = "hadoopbam.errors"
#: A fault-injection plan (``faults/plan.py`` grammar); ``HBAM_FAULTS``
#: takes precedence.  Unset: disarmed.
FAULTS_PLAN = "hadoopbam.faults.plan"
#: The part executor's per-attempt deadline (milliseconds; 0/unset: none;
#: an attempt past it counts failed and is retried) and the base backoff
#: between attempts (milliseconds, doubled per attempt with deterministic
#: jitter; default 50).
EXECUTOR_ATTEMPT_TIMEOUT_MS = "hadoopbam.executor.attempt-timeout-ms"
EXECUTOR_BACKOFF_MS = "hadoopbam.executor.backoff-ms"
#: FASTQ quality encoding ("sanger"/"illumina") and failed-QC filtering
#: ("true"/"false"): the FASTQ-specific key, else the generic input key.
FASTQ_BASE_QUALITY_ENCODING = "hbam.fastq-input.base-quality-encoding"
FASTQ_FILTER_FAILED_QC = "hbam.fastq-input.filter-failed-qc"
INPUT_BASE_QUALITY_ENCODING = "hbam.input.base-quality-encoding"
INPUT_FILTER_FAILED_QC = "hbam.input.filter-failed-qc"
#: QSEQ input's quality encoding (default "illumina") and failed-QC
#: filtering, each else the generic input key; the FASTQ and QSEQ writers'
#: quality encodings (defaults "sanger" and "illumina").
QSEQ_BASE_QUALITY_ENCODING = "hbam.qseq-input.base-quality-encoding"
QSEQ_FILTER_FAILED_QC = "hbam.qseq-input.filter-failed-qc"
FASTQ_OUTPUT_BASE_QUALITY_ENCODING = "hbam.fastq-output.base-quality-encoding"
QSEQ_OUTPUT_BASE_QUALITY_ENCODING = "hbam.qseq-output.base-quality-encoding"
#: FASTQ ingest: claim region per record-scan chunk (default 57088), scan
#: overlap past the claim (default 2048), and the device scan gate
#: ("true"/"false"; unset: follows the inflate gate).
INGEST_CHUNK_BYTES = "hadoopbam.ingest.chunk-bytes"
INGEST_SCAN_OVERLAP = "hadoopbam.ingest.scan-overlap"
INGEST_DEVICE_SCAN = "hadoopbam.ingest.device-scan"
#: BCF input: intervals a split keeps (``chr:start-stop[,...]``), the
#: record decoder's stringency ("STRICT" raises on a bad record, anything
#: else stops the split there) and the device record-chain walk
#: ("true"/"false"; unset: on for a CUDA device).
VCF_INTERVALS = "hadoopbam.vcf.intervals"
VCFRECORDREADER_VALIDATION_STRINGENCY = "hadoopbam.vcfrecordreader.validation-stringency"
BCF_CHAIN = "hadoopbam.bcf.chain"
#: VCF input: trust the .vcf/.vcf.gz/.vcf.bgz/.bcf extensions (default
#: true), else sniff the content.  VCF output: the format ("VCF" or "BCF")
#: and whether a part writes the header (named, as the reference names
#: them; no writer reads them).
VCF_TRUST_EXTS = "hadoopbam.vcf.trust-exts"
VCF_OUTPUT_FORMAT = "hadoopbam.vcf.output-format"
VCF_WRITE_HEADER = "hadoopbam.vcf.write-header"
#: CRAM input: the reference FASTA of reference-based CRAM, and the card's
#: rANS 4x8 decode ("true"/"false"; unset: on for a CUDA device).
CRAM_REFERENCE_SOURCE_PATH = "hadoopbam.cram.reference-source-path"
CRAM_RANS_LANES = "hadoopbam.cram.rans-lanes"
#: AnySAM input: trust the .bam/.cram/.sam extensions (default true), else
#: sniff the first byte.
ANYSAM_TRUST_EXTS = "hadoopbam.anysam.trust-exts"
#: AnySAM output: the format ("BAM", "SAM" or "CRAM") and whether a part
#: writes the header; the SAM header reader's stringency (named, as the
#: reference names them; nothing reads them).
ANYSAM_OUTPUT_FORMAT = "hadoopbam.anysam.output-format"
ANYSAM_WRITE_HEADER = "hadoopbam.anysam.write-header"
SAMHEADERREADER_VALIDATION_STRINGENCY = "hadoopbam.samheaderreader.validation-stringency"

#: The resident daemon (``serve/``): its UNIX socket or 127.0.0.1 TCP port
#: (the socket wins; neither: a per-user socket under the temp dir), the
#: byte budgets of the header/index cache and of the decoded-window arena,
#: the lane batcher's coalescing window (milliseconds; 0: no coalescing),
#: the job pool's size, the admission budget (tokens), queue depth and
#: queue-wait p95 bound (milliseconds; 0: off), the job journal, the flight
#: recorder (base path, cadence, bytes), request tracing (default true),
#: the exemplar threshold (milliseconds; 0: outcome triggers only), store
#: size and spill directory, the access log (base path, bytes), the SLO
#: objectives and windows ("fast_s,slow_s") and the startup warm-up.
SERVE_SOCKET = "hadoopbam.serve.socket"
SERVE_PORT = "hadoopbam.serve.port"
SERVE_CACHE_BYTES = "hadoopbam.serve.cache-bytes"
SERVE_ARENA_BYTES = "hadoopbam.serve.arena-bytes"
SERVE_BATCH_WINDOW_MS = "hadoopbam.serve.batch-window-ms"
SERVE_MAX_INFLIGHT = "hadoopbam.serve.max-inflight"
SERVE_ADMISSION_TOKENS = "hadoopbam.serve.admission-tokens"
SERVE_MAX_QUEUE = "hadoopbam.serve.max-queue"
SERVE_MAX_QUEUE_MS = "hadoopbam.serve.max-queue-ms"
SERVE_JOURNAL = "hadoopbam.serve.journal"
SERVE_FLIGHTREC = "hadoopbam.serve.flightrec"
SERVE_FLIGHTREC_CADENCE_MS = "hadoopbam.serve.flightrec-cadence-ms"
SERVE_FLIGHTREC_BYTES = "hadoopbam.serve.flightrec-bytes"
SERVE_REQUEST_TRACING = "hadoopbam.serve.request-tracing"
SERVE_EXEMPLAR_THRESHOLD_MS = "hadoopbam.serve.exemplar-threshold-ms"
SERVE_EXEMPLARS_MAX = "hadoopbam.serve.exemplars-max"
SERVE_EXEMPLAR_DIR = "hadoopbam.serve.exemplar-dir"
SERVE_ACCESS_LOG = "hadoopbam.serve.access-log"
SERVE_ACCESS_LOG_BYTES = "hadoopbam.serve.access-log-bytes"
SERVE_SLO = "hadoopbam.serve.slo"
SERVE_SLO_WINDOWS = "hadoopbam.serve.slo-windows"
SERVE_WARMUP = "hadoopbam.serve.warmup"
#: The fleet (``serve/fleet.py``, ``serve/router.py``): with the shared
#: directory set, a daemon publishes its member record there under its name
#: (default ``daemon-<pid>``) every heartbeat (milliseconds; default 500);
#: the router declares a member dead after the heartbeat timeout
#: (milliseconds; default 3000), spreads ownership over the vnodes a member
#: (default 64), listens on its own socket or 127.0.0.1 port (default a
#: per-user ``hbam-fleet-<uid>.sock`` in the temporary directory), admits
#: at most the fleet's tokens in flight (default 32) and the file tokens for
#: one routing key (default 8), and with migrate-warmth (default false)
#: ships a draining member's warm windows to their new owners.
FLEET_DIR = "hadoopbam.fleet.dir"
FLEET_NAME = "hadoopbam.fleet.member-name"
FLEET_HEARTBEAT_MS = "hadoopbam.fleet.heartbeat-ms"
FLEET_HEARTBEAT_TIMEOUT_MS = "hadoopbam.fleet.heartbeat-timeout-ms"
FLEET_VNODES = "hadoopbam.fleet.vnodes"
FLEET_SOCKET = "hadoopbam.fleet.socket"
FLEET_PORT = "hadoopbam.fleet.port"
FLEET_TOKENS = "hadoopbam.fleet.tokens"
FLEET_FILE_TOKENS = "hadoopbam.fleet.file-tokens"
FLEET_MIGRATE_WARMTH = "hadoopbam.fleet.migrate-warmth"
#: The timeline tracer's ring capacity (events; unset: 65536).
TRACE_EVENTS = "hadoopbam.trace.events"
#: The multi-process sort's wire (``parallel/multihost.py``): record bytes
#: cross processes as BGZF members (default "true"; "false" ships the raw
#: record stream), members of at most member-bytes of payload (default and
#: cap ``DEV_MAX_PAYLOAD``, 57088), fetched from the peers by fetch-threads
#: workers (default 8, at most the peer count).  Each has its ``HBAM_*``
#: env twin (``HBAM_SHUFFLE_COMPRESS``, ``..._MEMBER_BYTES``,
#: ``..._FETCH_THREADS``), read when the key is unset.
SHUFFLE_COMPRESS = "hadoopbam.shuffle.compress"
SHUFFLE_MEMBER_BYTES = "hadoopbam.shuffle.member-bytes"
SHUFFLE_FETCH_THREADS = "hadoopbam.shuffle.fetch-threads"
#: The multi-process sort's skew healing: a routed round whose records a
#: destination shard, max over mean, pass skew-bound (default 1.5; 0
#: disables) re-cuts its splitters once from repartition-samples keys a
#: process (default 4096).  Env twins ``HBAM_MESH_SKEW_BOUND``,
#: ``HBAM_MESH_REPARTITION_SAMPLES``.
MESH_SKEW_BOUND = "hadoopbam.mesh.skew-bound"
MESH_REPARTITION_SAMPLES = "hadoopbam.mesh.repartition-samples"
#: The multi-process sort's speculative re-execution of a straggler's
#: parts stage (speculate-factor > 0; default 0, off) and its mesh trace
#: (trace, default off; trace-dir, default ``<out>.mesh-trace``, which
#: alone arms nothing).  Env twins ``HBAM_MESH_SPECULATE_FACTOR``,
#: ``HBAM_MESH_TRACE``, ``HBAM_MESH_TRACE_DIR``.
MESH_SPECULATE_FACTOR = "hadoopbam.mesh.speculate-factor"
MESH_TRACE = "hadoopbam.mesh.trace"
MESH_TRACE_DIR = "hadoopbam.mesh.trace-dir"

_TRUE_WORDS = frozenset(("yes", "true", "t", "y", "1", "on", "enabled"))
_FALSE_ENV = ("0", "false", "no", "off", "")
_FALSE_WORDS = frozenset(("no", "false", "f", "n", "0", "off", "disabled"))


class Configuration:
    """A string-property map with the reference's lenient parsing."""

    def __init__(self, props: Optional[Mapping[str, str]] = None) -> None:
        self._props: dict = {k: str(v) for k, v in (props or {}).items()}

    def set(self, key: str, value) -> None:
        self._props[key] = str(value)

    def set_int(self, key: str, value: int) -> None:
        self._props[key] = str(int(value))

    def set_boolean(self, key: str, value: bool) -> None:
        self._props[key] = "true" if value else "false"

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._props.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self._props

    def __iter__(self) -> Iterator[str]:
        return iter(self._props)

    def get_boolean(self, key: str, default: bool = False) -> bool:
        """yes/no, true/false, t/f, y/n, 1/0, on/off, enabled/disabled, any
        case; anything else is ``default``."""
        raw = self._props.get(key)
        if raw is None:
            return default
        word = raw.strip().lower()
        if word in _TRUE_WORDS:
            return True
        if word in _FALSE_WORDS:
            return False
        return default

    def get_int(self, key: str, default: int = 0) -> int:
        raw = self._props.get(key)
        if raw is None:
            return default
        try:
            return int(raw.strip())
        except ValueError:
            return default


def from_reference_conf(d: Mapping[str, str]) -> Configuration:
    """The port's Configuration from the key/value dict the reference's
    ``Configuration`` takes; every key above keeps the reference's string,
    so one dict drives both packages."""
    return Configuration(d)


def gate(env_var: str, conf: Optional["Configuration"], key: str, auto: bool) -> bool:
    """A device tier's switch: the env var (0/1 force) → the conf key →
    ``auto`` (the reference's local-accelerator rule: on for a CUDA
    device, off for the CPU)."""
    env = os.environ.get(env_var)
    if env is not None:
        return env.strip().lower() not in _FALSE_ENV
    if conf is not None and key in conf:
        return conf.get_boolean(key)
    return auto

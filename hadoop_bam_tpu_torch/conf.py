"""Configuration: the string property map of the Hadoop ``Configuration``.

Counterpart of ``hadoop_bam_tpu/conf.py`` with only the keys the in-core
coordinate sort (of BAM and CRAM input, with interval traversal), the
FASTQ ingest, the BCF variant plane, the region reads, the part executor
and the fault plan read.  The key strings are the
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

_TRUE_WORDS = frozenset(("yes", "true", "t", "y", "1", "on", "enabled"))
_FALSE_ENV = ("0", "false", "no", "off", "")
_FALSE_WORDS = frozenset(("no", "false", "f", "n", "0", "off", "disabled"))


class Configuration:
    """A string-property map with the reference's lenient parsing."""

    def __init__(self, props: Optional[Mapping[str, str]] = None) -> None:
        self._props: dict = {k: str(v) for k, v in (props or {}).items()}

    def set(self, key: str, value) -> None:
        self._props[key] = str(value)

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

"""The jobs over BAM, CRAM and SAM files on one device: the coordinate and
queryname sorts, duplicate marking and fixmate, in-core or under a memory
budget.

Counterpart of ``hadoop_bam_tpu/pipeline.py`` ``sort_bam`` (coordinate or
queryname order, with or without duplicate marking, in-core or out of core),
``markdup_bam``, ``fixmate_bam``, ``_input_format``, ``_read_any_header``,
``_finish_device_parse``, ``_unmapped_hash32``, ``_sort_perm``,
``_sort_bam_external`` and ``_queryname_rank_column``.  Splits are read
double-buffered; a BAM split's members inflate on the device and the chain
and key kernels build its int64 keys from the resident window (a CRAM
split's rANS blocks decode on the device, its records and keys on the
host); one stable ``torch.sort`` orders the job (the queryname sort groups
by name hash with the collation core on the device and ranks the names on
the host); the duplicate decision runs on the device over the job's
signature columns; each part is gathered, flag-patched, CRC'd and deflated
on the device from the resident windows (or, when a split has no window,
gathered on the host and deflated by the lanes), framed on the host and
merged into one BAM.  Fixmate rewrites each split on the host and writes
it as one part.

Under ``memory_budget`` the sort spills sorted runs (:mod:`~.io.runs`) of
about one budget each, then merges them by exact key ranges of at most one
budget each, one range a part, written one at a time.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .collate import (
    FIXMATE_FIELDS,
    apply_fixmate,
    collate_by_name,
    collation_columns,
    compute_fixmate_edits,
    concat_collation,
    queryname_perm,
    verify_and_repair,
)
from .conf import (
    BAM_MARK_DUPLICATES,
    BAM_SORT_ORDER,
    BAM_WRITE_SPLITTING_BAI,
    ERRORS_MODE,
    EXECUTOR_ATTEMPT_TIMEOUT_MS,
    EXECUTOR_BACKOFF_MS,
    Configuration,
)
from .dedup import DEDUP_EXTRA_FIELDS, concat_columns, mark_duplicates_device, signature_columns
from .device_stream import DeviceStream
from .io.anysam import AnySamInputFormat, infer_from_file_path
from .io.bam import SORT_FIELDS, BamInputFormat, ChunkedRecords, RecordBatch, read_header, write_part_fast
from .io.merger import merge_bam_parts
from .io.runs import Run, input_identity, load_manifest, plan_ranges, write_manifest, write_run
from .io.splits import FileVirtualSplit
from .ops.decode import patch_unmapped_keys
from .ops.sort import sort_keys
from .parallel.executor import ElasticExecutor, bgzf_part_valid
from .spec import bam as bam_spec
from .utils.backend import resolve_device
from .utils.murmur3 import murmurhash3_int32_batch
from .utils.tracing import Metrics


@dataclass
class SortStats:
    n_records: int
    n_splits: int
    backend: str
    device: str
    counters: Dict[str, int] = field(default_factory=dict)
    #: Host seconds of the phases: read (split reads, inflate and parse
    #: launches, signature columns), sort (validation, hash patch, sort or
    #: name collation and ranking, permutation fetch), markdup (the
    #: duplicate decision; duplicate-marking jobs only), write (part gathers
    #: and deflates, merge).  Under a memory budget: prepass (queryname
    #: only: the read for the collation columns and the ranking), spill
    #: (split reads, chunk sorts, run writes), markdup, plan (the key
    #: ranges), merge (range loads and sorts, part writes, merge).
    seconds: Dict[str, float] = field(default_factory=dict)
    n_duplicates: int = 0  # records flagged 0x400 by the duplicate marking
    n_runs: int = 0  # spill runs (out-of-core only)
    n_ranges: int = 0  # merge ranges = parts (out-of-core only)
    #: The largest chunk or range materialized, in record bytes
    #: (out-of-core only).
    peak_bytes: int = 0


@dataclass
class FixmateStats:
    n_records: int
    n_splits: int
    n_pairs: int
    n_singletons: int
    n_orphans: int
    backend: str
    counters: Dict[str, int] = field(default_factory=dict)
    #: Host seconds of the phases: read (split reads, collation columns),
    #: collate (name collation, verification, the edit plan), write (the
    #: rewrite of each split, part deflates, merge).
    seconds: Dict[str, float] = field(default_factory=dict)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _input_format(conf, in_paths):
    """BamInputFormat when every input is ``.bam``, else the AnySAM
    dispatcher (``.cram`` and ``.sam`` input)."""
    if all(infer_from_file_path(p) == "bam" for p in in_paths):
        return BamInputFormat(conf)
    return AnySamInputFormat(conf)


def _read_any_header(fmt, path):
    """The header by the format's own reader (CRAM: the file-header
    container; SAM: the text's ``@`` lines), else the BAM reader."""
    rh = getattr(fmt, "read_header", None)
    return rh(path) if rh is not None else read_header(path)


def sort_bam(
    in_paths: Union[Sequence[str], str],
    out_path: str,
    conf: Optional[Configuration] = None,
    split_size: int = 32 << 20,
    level: int = 6,
    write_splitting_bai: bool = False,
    part_dir: Optional[str] = None,
    write_workers: Optional[int] = None,
    device_parse: Optional[bool] = None,
    device: Optional[Union[str, torch.device]] = None,
    memory_budget: Optional[int] = None,
    mark_duplicates: bool = False,
    sort_order: Optional[str] = None,
    mesh=None,
    distributed=None,
    errors: Optional[str] = None,
    backend: str = "device",
    max_attempts: int = 3,
    resource_cache=None,
    deadline=None,
) -> SortStats:
    """Sort BAM, CRAM or SAM file(s) into one BAM, byte for byte what the
    reference's ``sort_bam`` writes for the same input and options (for a
    ``.sam``, which the reference cannot read, what it writes for the BAM
    of the same records).

    ``device`` defaults to ``cuda`` and raises when there is no card; pass
    ``"cpu"`` to run every kernel's plain version instead.  Member inflate
    follows ``hadoopbam.inflate.lanes`` / ``HBAM_INFLATE_LANES``, the part
    deflate ``hadoopbam.deflate.lanes`` / ``HBAM_DEFLATE_LANES`` and the
    device-resident part write ``hadoopbam.write.device`` /
    ``HBAM_DEVICE_WRITE``; each is on by default on a card.  With all three
    off, parts are gathered and compressed by host zlib at ``level``.
    ``device_parse`` (default ``HBAM_DEVICE_PARSE``, else on for a card)
    builds keys with the chain kernels from the resident windows, else keys
    are built on the host.  A device record count that disagrees with the
    host walk raises: on clean input only a kernel bug can cause it.

    CRAM input (``.cram``, or sniffed when ``hadoopbam.anysam.trust-exts``
    is false) is read by container-aligned splits; its rANS 4x8 blocks
    decode on the card per ``hadoopbam.cram.rans-lanes`` /
    ``HBAM_RANS_LANES`` (on by default on a card), its records and keys on
    the host (the device parse applies only to BGZF splits);
    reference-based CRAM needs ``hadoopbam.cram.reference-source-path``.
    SAM text input (``.sam``, or sniffed) is read by byte splits, its lines
    tokenized on the host (:mod:`~.io.sam_vec`); like CRAM it takes host
    keys, the card's ``torch.sort`` and the part writers.

    ``sort_order`` (default ``hadoopbam.bam.sort-order``, else
    "coordinate") is "coordinate" or "queryname": the name collation groups
    the records by their 64-bit name hash on ``device``, the host ranks the
    verified buckets in samtools' natural name order, and ties break on
    flag, position and read index (``backend`` "collate-queryname").  The
    header's ``SO:`` says the order written.  Queryname raises the
    reference's ``ValueError`` with ``mesh`` / ``distributed``, with
    ``mark_duplicates`` and with a true ``device_parse``.

    ``mark_duplicates`` (or ``hadoopbam.bam.mark-duplicates``) marks
    duplicates in the same job: each split's signature columns are taken
    during the read, the decision runs once on ``device`` over the job, and
    the part writers OR 0x400 into the written flags of the duplicates
    (``SortStats.n_duplicates``, counter ``sort_bam.duplicates``).

    ``backend`` is "device" (keys sorted on ``device``, built there by the
    chain kernels when ``device_parse``) or "host" (keys built and sorted
    on the host, a stable NumPy argsort: the reference's oracle; the reads
    and part writes still follow the gates); the output bytes are the same.

    Parts are written by :class:`~.parallel.executor.ElasticExecutor`: up
    to ``max_attempts`` attempts a part (``ValueError`` below 1, raised
    when the write phase starts, as the reference raises it), the
    attempt deadline and backoff of ``hadoopbam.executor.attempt-timeout-ms``
    and ``hadoopbam.executor.backoff-ms``, and, with a persistent
    ``part_dir``, a rerun skips the parts already there that
    :func:`~.parallel.executor.bgzf_part_valid` accepts
    (``executor.skipped_existing``).

    ``memory_budget`` (bytes of decoded record stream) sorts out of core,
    as the reference does: splits are clamped to ``memory_budget // 16``
    (at least 64 KiB), chunks of about one budget are sorted (``backend``:
    on ``device``, or a NumPy argsort) and spilled as runs under
    ``part_dir/spill`` (else a temporary directory), the runs are cut into
    exact key ranges of at most one budget, and each range is loaded,
    stable-sorted and written as one part, one range at a time (backend
    "external[device]" or "external[host]").  Keys are host keys; parts
    carry no resident window, so each tiers down ``no_residency`` to the
    host gather and the deflate lanes.  Duplicate marking adds a read-order
    index to each run; the queryname order first reads the splits once for
    the name ranks, which become the keys.  With a persistent ``part_dir``
    a completed spill phase is certified by ``spill/manifest.json``, and a
    rerun on the same inputs and options reuses the runs (counter
    ``sort_bam.resume_spill_reused``) and writes only the parts that are
    missing.

    ``errors`` (default ``hadoopbam.errors``, else "strict"): "salvage"
    degrades instead of dying.  A split that raises a data error is read
    again by the quarantining reader, on the host (corrupt members and
    unparseable records quarantined, the chain re-synced by the guesser;
    ``salvage.*`` counters say what was lost); its batch has no resident
    window, so its part tiers down ``no_residency`` and its keys come from
    the host.  A split whose read still fails becomes an empty batch
    (``salvage.splits_failed``), and a part that fails every attempt is
    quarantined (``salvage.parts_quarantined``) instead of failing the job.
    A kernel or card failure raises in either mode.

    ``errors`` and ``sort_order`` are checked first, with the reference's
    ``ValueError`` outside their domains, then the queryname combinations,
    then ``memory_budget`` with a mesh or a true ``device_parse``.  Not
    ported yet (each raises ``NotImplementedError``): ``mesh`` /
    ``distributed`` (coordinate order) and the serve job's
    ``resource_cache`` / ``deadline`` (ROADMAP A.11)."""
    if backend not in ("device", "host"):
        raise ValueError(f"backend must be 'device' or 'host', got {backend!r}")
    if errors is None:
        errors = (conf.get(ERRORS_MODE, "strict") if conf is not None else "strict") or "strict"
    if errors not in ("strict", "salvage"):
        raise ValueError(f"errors must be strict|salvage, got {errors!r}")
    if sort_order is None:
        sort_order = (conf.get(BAM_SORT_ORDER, "coordinate") if conf is not None
                      else "coordinate") or "coordinate"
    if sort_order not in ("coordinate", "queryname"):
        raise ValueError(f"sort_order must be coordinate|queryname, got {sort_order!r}")
    if conf is not None:
        write_splitting_bai = write_splitting_bai or conf.get_boolean(BAM_WRITE_SPLITTING_BAI)
        mark_duplicates = mark_duplicates or conf.get_boolean(BAM_MARK_DUPLICATES)
    queryname = sort_order == "queryname"
    if queryname:
        if mesh is not None or distributed is not None:
            raise ValueError(
                "sort_order='queryname' with a mesh goes through "
                "parallel.multihost.sort_bam_multihost(sort_order="
                "'queryname') — its distributed rank pass replaces "
                "this driver's single-host collation"
            )
        if mark_duplicates:
            raise ValueError(
                "mark_duplicates needs the coordinate stream; markdup "
                "already accepts unsorted/queryname-grouped input by "
                "collating signatures — run it without sort_order"
            )
        if device_parse:
            raise ValueError(
                "device_parse builds coordinate keys; queryname keys "
                "come from the collation engine"
            )
    if memory_budget is not None:
        if mesh is not None or distributed is not None:
            raise ValueError(
                "memory_budget is single-host; use the multi-host runner "
                "for distributed out-of-core sorts"
            )
        if device_parse:
            raise ValueError(
                "device_parse is not supported with memory_budget: spill "
                "runs sort host-side (the device-resident parse applies to "
                "the in-memory path only)"
            )
    dev = resolve_device(device)
    if isinstance(in_paths, str):
        in_paths = [in_paths]
    if resource_cache is not None or deadline is not None:
        raise _not_ported("deadline / resource_cache (the serve sort job)", "A.11")
    if mesh is not None or distributed is not None:
        raise _not_ported("mesh / distributed sorting", "A.10")
    stream = DeviceStream(dev, conf=conf)
    use_device_write = stream.policy.device_write
    write = _WriteSettings(conf, max_attempts, errors, write_workers)

    fmt = _input_format(conf, in_paths)
    header = _read_any_header(fmt, in_paths[0]).with_sort_order(sort_order)
    if memory_budget is not None:
        # A split is the memory floor (it inflates as one batch): keep its
        # compressed size well under the budget, as the reference does.
        splits = fmt.get_splits(in_paths, split_size=_budget_split_size(split_size,
                                                                         memory_budget))
        t0 = time.perf_counter()
        key_column = (_queryname_rank_column(fmt, splits, stream, errors) if queryname
                      else None)
        seconds = {"prepass": time.perf_counter() - t0} if queryname else {}
        return _sort_bam_external(
            fmt, splits, header, out_path, memory_budget, level, backend,
            write_splitting_bai, part_dir, stream, mark_duplicates, sort_order, key_column,
            seconds, write)
    splits = fmt.get_splits(in_paths, split_size=split_size)
    if backend == "host" or queryname:
        device_parse = False
    elif device_parse is None:
        env = os.environ.get("HBAM_DEVICE_PARSE")
        device_parse = (
            env.strip().lower() not in ("0", "false", "no", "off", "")
            if env is not None
            else stream.default_device_parse()
        )
    # CRAM's and SAM's byte splits have no BGZF window for the chain kernels, and the
    # records bounded traversal keeps are no contiguous stream.
    device_parse = device_parse and all(
        isinstance(s, FileVirtualSplit) and s.interval_chunks is None for s in splits)

    t_read = time.perf_counter()
    batches: List[RecordBatch] = []
    parsed: List[Optional[tuple]] = []
    collate_cols: List[dict] = []
    sig_cols: List[dict] = []
    fields = ("rec_off", "rec_len") if device_parse else SORT_FIELDS
    if queryname:
        fields = SORT_FIELDS + ("l_read_name",)
    if mark_duplicates:
        fields = tuple(dict.fromkeys(fields + SORT_FIELDS + DEDUP_EXTRA_FIELDS))
    for b in stream.read_splits(fmt, splits, fields=fields,
                                with_keys=not (device_parse or queryname), errors=errors):
        # The columns come from the whole SoA, before it is trimmed.
        if mark_duplicates:
            sig_cols.append(signature_columns(b.data, b.soa))
        if queryname:
            collate_cols.append(collation_columns(b.data, b.soa))
        if device_parse:
            # A salvaged batch is no back-to-back chain: host keys.
            parsed.append(_host_parse(b, dev, stream.metrics) if b.salvaged
                          else stream.parse_split(b))
        if not use_device_write:
            b.device_data = None  # the chain kernels hold their own view
        b.soa = {"rec_off": b.soa["rec_off"], "rec_len": b.soa["rec_len"]}
        batches.append(b)
    n = sum(b.n_records for b in batches)
    t_sort = time.perf_counter()

    if n and queryname:
        backend = "collate-queryname"
        perm, _ = queryname_perm(concat_collation(collate_cols), device=dev,
                                 metrics=stream.metrics)
        collate_cols = []
    elif n and device_parse:
        backend = "device-parse"
        perm = _finish_device_parse(batches, parsed, dev, stream.metrics)
    elif n and backend == "host":
        perm = np.argsort(np.concatenate([b.keys for b in batches]), kind="stable")
    elif n:
        backend = "single-device"
        keys = torch.from_numpy(np.concatenate([b.keys for b in batches])).to(dev)
        if dev.type == "cuda":
            stream.metrics.count_h2d(keys.numel() * 8, "keys")
        perm = _fetch_perm(sort_keys(keys)[1], stream.metrics)
    else:
        backend = "host"  # the reference's label of a job with no record
        perm = np.empty(0, dtype=np.int64)

    # The decision over the job's columns, in read order: the index space
    # that the part writers' ``order`` slices address.
    t_markdup = time.perf_counter()
    dup_mask = None
    n_dup = 0
    if mark_duplicates and n:
        dup_mask = mark_duplicates_device(concat_columns(sig_cols), device=dev,
                                          metrics=stream.metrics)
        n_dup = int(dup_mask.sum())
        stream.metrics.count("sort_bam.duplicates", n_dup)
    sig_cols = []

    t_write = time.perf_counter()
    merged = ChunkedRecords.from_batches(batches, keep_device=use_device_write)
    for b in batches:
        b.device_data = None  # the flat stream, if any, holds the windows now
    n_parts = max(1, len(batches))
    bounds = [n * i // n_parts for i in range(n_parts + 1)]
    try:
        _write_job(out_path, header, part_dir, n_parts,
                   lambda pi: (merged, perm[bounds[pi] : bounds[pi + 1]], dup_mask),
                   level, write_splitting_bai, write, stream, use_device_write)
    finally:
        merged.release_device()  # the resident payload is dead once the parts exist
    counters = stream.metrics.counters()
    counters.update({f"flate.inflate.{k}": v for k, v in stream.inflate_stats.as_dict().items()})
    seconds = {"read": t_sort - t_read, "sort": t_markdup - t_sort}
    if mark_duplicates:
        seconds["markdup"] = t_write - t_markdup
    seconds["write"] = time.perf_counter() - t_write
    return SortStats(n, len(splits), backend, str(dev), counters, seconds, n_dup)


def markdup_bam(in_paths: Union[Sequence[str], str], out_path: str, **kwargs) -> SortStats:
    """Duplicate marking as a job of its own: ``sort_bam`` with
    ``mark_duplicates`` on.  The sort is stable, so a coordinate-sorted
    input keeps its order and the job only marks; an unsorted input is
    sorted and marked in one pass.  Takes every ``sort_bam`` keyword."""
    kwargs["mark_duplicates"] = True
    return sort_bam(in_paths, out_path, **kwargs)


def fixmate_bam(
    in_paths: Union[Sequence[str], str],
    out_path: str,
    conf: Optional[Configuration] = None,
    split_size: int = 32 << 20,
    level: int = 6,
    memory_budget: Optional[int] = None,
    max_attempts: int = 3,
    part_dir: Optional[str] = None,
    write_workers: Optional[int] = None,
    write_splitting_bai: bool = False,
    errors: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> FixmateStats:
    """Fill in mate information from the collated pairs, keeping the record
    order (samtools fixmate, without needing name-grouped input): mate
    coordinates, the mate-unmapped and mate-reverse flags, TLEN, MC tags,
    and unmapped reads placed beside their mapped mates
    (:mod:`~.collate.fixmate`).  Byte for byte what the reference's
    ``fixmate_bam`` writes.

    Pass A reads every split for its collation columns (and name and CIGAR
    blobs), collates the names on ``device`` (None: the card, which raises
    when there is none; ``"cpu"`` runs the plain version) and verifies the
    buckets on the host; pass B rewrites each split by the edit plan and
    writes it as one part, deflated per ``hadoopbam.deflate.lanes`` (host
    zlib at ``level`` when off), through the part executor as in
    ``sort_bam`` (``max_attempts``, resume from ``part_dir``).  The header
    is the input's: fixmate changes no order.  ``errors="salvage"`` reads
    as ``sort_bam``'s does, in both passes, and quarantines a part that
    fails every attempt.

    With ``memory_budget`` the splits are clamped as ``sort_bam``'s are,
    pass A keeps no batch, and pass B reads each split again (backend
    "collate-fixmate[budget]"): the record bytes held stay bounded while
    the columns (~20 B a record + the name and CIGAR bytes) stay in memory."""
    if isinstance(in_paths, str):
        in_paths = [in_paths]
    if conf is not None:
        write_splitting_bai = write_splitting_bai or conf.get_boolean(BAM_WRITE_SPLITTING_BAI)
    if errors is None:
        errors = (conf.get(ERRORS_MODE, "strict") if conf is not None else "strict") or "strict"
    if errors not in ("strict", "salvage"):
        raise ValueError(f"errors must be strict|salvage, got {errors!r}")
    dev = resolve_device(device)
    stream = DeviceStream(dev, conf=conf)
    write = _WriteSettings(conf, max_attempts, errors, write_workers)
    fmt = _input_format(conf, in_paths)
    header = _read_any_header(fmt, in_paths[0])
    if memory_budget is not None:
        split_size = _budget_split_size(split_size, memory_budget)
    splits = fmt.get_splits(in_paths, split_size=split_size)
    keep_batches = memory_budget is None

    t_read = time.perf_counter()
    batches: List[Optional[RecordBatch]] = []
    cols_parts: List[dict] = []
    row_bases = [0]
    for b in stream.read_splits(fmt, splits, fields=FIXMATE_FIELDS, with_keys=False,
                                errors=errors):
        cols_parts.append(collation_columns(b.data, b.soa, with_cigars=True))
        b.device_data = None  # the rewrite is on the host
        row_bases.append(row_bases[-1] + b.n_records)
        batches.append(b if keep_batches else None)
    n = row_bases[-1]
    stream.metrics.count("fixmate.records", n)

    t_collate = time.perf_counter()
    cols = concat_collation(cols_parts)
    cols_parts = []
    col = collate_by_name(cols, device=dev, metrics=stream.metrics)
    col, _ = verify_and_repair(col, cols, stream.metrics)
    edits = compute_fixmate_edits(cols, col, stream.metrics)
    cols = col = None

    def part_of(pi: int):
        b = batches[pi]
        if b is None:  # under a budget: pass B reads the split again
            b = fmt.read_split(splits[pi], fields=FIXMATE_FIELDS, with_keys=False,
                               stream=stream, errors=errors)
            b.device_data = None
        return apply_fixmate(b, edits, row_bases[pi]), None, None

    def part_done(pi: int) -> None:
        batches[pi] = None  # the split's bytes die with its part

    t_write = time.perf_counter()
    _write_job(out_path, header, part_dir, len(splits), part_of, level, write_splitting_bai,
               write, stream, False, part_done)
    counters = stream.metrics.counters()
    counters.update({f"flate.inflate.{k}": v for k, v in stream.inflate_stats.as_dict().items()})
    seconds = {"read": t_collate - t_read, "collate": t_write - t_collate,
               "write": time.perf_counter() - t_write}
    return FixmateStats(n, len(splits), edits.counts["pairs"], edits.counts["singletons"],
                        edits.counts["orphans"],
                        "collate-fixmate" + ("[budget]" if memory_budget is not None else ""),
                        counters, seconds)


@contextlib.contextmanager
def _job_dir(part_dir: Optional[str], out_path: str):
    """``part_dir`` (created if need be), else a temporary directory beside
    ``out_path``, removed on exit."""
    if part_dir is not None:
        os.makedirs(part_dir, exist_ok=True)
        yield part_dir
        return
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(out_path)) or ".") as td:
        yield td


class _WriteSettings:
    """How a job's parts are written: the executor's attempts, its attempt
    deadline and backoff (from the conf keys, as the reference reads
    them), quarantine under salvage, and the writer threads."""

    def __init__(self, conf, max_attempts: int, errors: str, workers: Optional[int]) -> None:
        timeout_ms = conf.get_int(EXECUTOR_ATTEMPT_TIMEOUT_MS, 0) if conf is not None else 0
        self.attempt_timeout = timeout_ms / 1e3 if timeout_ms > 0 else None
        self.retry_backoff = (conf.get_int(EXECUTOR_BACKOFF_MS, 50) if conf is not None
                              else 50) / 1e3
        self.max_attempts = max_attempts
        self.errors = errors
        self.workers = workers

    def executor(self, td: str, metrics: Metrics, workers: Optional[int] = None):
        return ElasticExecutor(
            td, max_attempts=self.max_attempts, max_workers=workers or self.workers,
            validate_part=bgzf_part_valid, quarantine=self.errors == "salvage",
            attempt_timeout=self.attempt_timeout, retry_backoff=self.retry_backoff,
            metrics=metrics)


def _write_job(out_path, header, part_dir, n_parts, part_of, level, write_splitting_bai,
               write: _WriteSettings, stream, device_write, part_done=None) -> None:
    """The parts in ``part_dir`` (else a temporary directory beside
    ``out_path``), then their merge under ``header``.  ``n_parts`` 0 writes
    one empty part, as the reference's fixmate of no split does."""
    with _job_dir(part_dir, out_path) as td:
        _write_parts(td, n_parts, part_of, level, write_splitting_bai,
                     write.executor(td, stream.metrics), stream, device_write, part_done)
        merge_bam_parts(td, out_path, header, write_splitting_bai=write_splitting_bai)


def _write_parts(td, n_parts, part_of, level, write_splitting_bai, executor: ElasticExecutor,
                 stream, device_write, part_done=None) -> None:
    """One part per split or range through ``executor``: ``part-r-NNNNN``
    (+ ``.splitting-bai``), then ``_SUCCESS``.  Part ``pi`` is
    ``part_of(pi)``'s ``(batch, order, dup_mask)``, called again by a
    retry; ``part_done(pi)`` follows its written part.  The deflate tier
    follows ``stream``'s policy, the device write ``device_write``."""
    threads = max(1, (os.cpu_count() or 4) // executor.max_workers)

    def write_one(pi: int, tmp: str) -> None:
        batch, order, dup_mask = part_of(pi)
        sb = open(tmp + ".sb", "wb") if write_splitting_bai else None
        try:
            with open(tmp, "wb") as f:
                write_part_fast(f, batch, order=order, level=level,
                                splitting_bai_stream=sb, threads=threads,
                                device_deflate=stream.policy.deflate_lanes,
                                device_write=device_write, dup_mask=dup_mask,
                                device_stream=stream)
        finally:
            if sb is not None:
                sb.close()
        if sb is not None:
            os.replace(tmp + ".sb", os.path.join(td, f"part-r-{pi:05d}.splitting-bai"))
        if part_done is not None:
            part_done(pi)

    executor.run(list(range(max(1, n_parts))), write_one if n_parts else _write_empty_part)


def _write_empty_part(pi: int, tmp: str) -> None:
    open(tmp, "wb").close()


def _budget_split_size(split_size: int, memory_budget: int) -> int:
    """The split size under a budget: at most ``memory_budget // 16``
    (BGZF inflates 3-5x, past 10x on low-entropy data), at least 64 KiB."""
    return max(64 << 10, min(split_size, memory_budget // 16))


def _queryname_rank_column(fmt, splits, stream: DeviceStream, errors: str) -> np.ndarray:
    """The out-of-core queryname prepass: one read of the splits for their
    collation columns, the name collation on the stream's device, and each
    record's output rank in read order: unique int64 keys for the spill
    runs."""
    cols: List[dict] = []
    for b in stream.read_splits(fmt, splits, fields=SORT_FIELDS + ("l_read_name",),
                                with_keys=False, errors=errors):
        cols.append(collation_columns(b.data, b.soa))
        b.device_data = None
    perm, _ = queryname_perm(concat_collation(cols), device=stream.device,
                             metrics=stream.metrics)
    rank = np.empty(len(perm), dtype=np.int64)
    rank[perm] = np.arange(len(perm), dtype=np.int64)
    return rank


def _sort_perm(keys: np.ndarray, backend: str, dev: torch.device, metrics: Metrics) -> np.ndarray:
    """Stable sort permutation of a key column: ``sort_keys`` on ``dev``
    (``backend`` "device"), else NumPy's stable argsort (the oracle)."""
    if backend == "device" and len(keys):
        t = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int64)).to(dev)
        if dev.type == "cuda":
            metrics.count_h2d(t.numel() * 8, "keys")
        return _fetch_perm(sort_keys(t)[1], metrics)
    return np.argsort(keys, kind="stable")


def _load_range(runs: List[Run], cuts, dup_mask: Optional[np.ndarray]):
    """One key range as a batch: each run's slice read from disk into one
    buffer, in run order, and the range rows' duplicate flags through the
    runs' read-order index.  Returns ``(batch, dup_rows)``."""
    live = [(r, i0, i1) for r, (i0, i1) in enumerate(cuts) if i1 > i0]
    data = np.empty(sum(runs[r].bytes_between(i0, i1) for r, i0, i1 in live), dtype=np.uint8)
    keys_l, off_l, len_l, orig_l = [], [], [], []
    base = 0
    for r, i0, i1 in live:
        size = runs[r].bytes_between(i0, i1)
        runs[r].slice_stream(i0, i1, out=data[base : base + size])
        offs = np.asarray(runs[r].offs[i0 : i1 + 1], dtype=np.int64)
        off_l.append(base + offs[:-1] - offs[0] + 4)  # body starts
        len_l.append(np.diff(offs) - 4)
        keys_l.append(np.asarray(runs[r].keys[i0:i1], dtype=np.int64))
        if dup_mask is not None:
            orig_l.append(np.asarray(runs[r].orig_idx[i0:i1], dtype=np.int64))
        base += size
    if not live:
        soa = {"rec_off": np.empty(0, np.int64), "rec_len": np.empty(0, np.int64)}
        return RecordBatch(soa=soa, data=data, keys=np.empty(0, np.int64)), None
    soa = {"rec_off": np.concatenate(off_l), "rec_len": np.concatenate(len_l)}
    batch = RecordBatch(soa=soa, data=data, keys=np.concatenate(keys_l))
    return batch, (dup_mask[np.concatenate(orig_l)] if dup_mask is not None else None)


def _sort_bam_external(fmt, splits, header, out_path: str, memory_budget: int, level: int,
                       backend: str, write_splitting_bai: bool, part_dir: Optional[str],
                       stream: DeviceStream, mark_duplicates: bool, sort_order: str,
                       key_column: Optional[np.ndarray], seconds: Dict[str, float],
                       write: _WriteSettings) -> SortStats:
    """Bounded-memory sort: spill sorted runs, merge by exact key ranges.

    Phase 1 reads the splits in file order and gathers decoded batches
    until about one budget of record bytes is held, sorts that chunk
    (:func:`_sort_perm`) and spills it as a run (:func:`~.io.runs.write_run`).
    Phase 2 cuts the runs' union into key ranges of at most one budget
    (:func:`~.io.runs.plan_ranges`), loads each range's slices in run order,
    stable-sorts them (ties keep run order, so the output is the one-pass
    stable sort's) and writes the range as one part, one range at a time so
    that one budget bounds the peak.  ``key_column`` (int64, read order)
    replaces the coordinate keys: the queryname ranks.  With
    ``mark_duplicates`` each run carries every record's read-order index and
    the job's duplicate mask is decided once between the phases.

    With a persistent ``part_dir``, ``spill/manifest.json`` (written last,
    after the runs and ``dupmask.npy``) certifies a completed phase 1; a
    rerun whose inputs, budget, duplicate marking and order match it skips
    phase 1, and the executor skips the ranges whose parts are there.  A
    manifest that does not match is ignored and phase 1 runs again.  Under
    salvage the split reads (and the queryname prepass's) salvage as the
    in-core sort's do; the key column stays aligned, because both passes
    salvage the same records."""
    dev = stream.device
    metrics = stream.metrics
    read_fields = (tuple(dict.fromkeys(SORT_FIELDS + DEDUP_EXTRA_FIELDS)) if mark_duplicates
                   else SORT_FIELDS)
    with _job_dir(part_dir, out_path) as td:
        spill_dir = os.path.join(td, "spill")
        os.makedirs(spill_dir, exist_ok=True)

        # Phase 0: a completed spill phase of the same job, when part_dir
        # persists.
        identity = None
        if part_dir is not None:
            try:
                identity = input_identity(list(dict.fromkeys(s.path for s in splits)))
            except OSError:
                identity = None
        dupmask_path = os.path.join(spill_dir, "dupmask.npy")
        manifest = (load_manifest(spill_dir, identity, memory_budget, mark_duplicates,
                                  sort_order=sort_order) if identity is not None else None)
        if manifest is not None and mark_duplicates and not os.path.exists(dupmask_path):
            manifest = None

        dup_mask = None
        n_dup = 0
        peak = 0
        t_spill = time.perf_counter()
        if manifest is not None:
            n = int(manifest["n_records"])
            run_count = int(manifest["run_count"])
            metrics.count("sort_bam.resume_spill_reused", 1)
            if mark_duplicates:
                dup_mask = np.load(dupmask_path)
                n_dup = int(dup_mask.sum())
            t_markdup = time.perf_counter()
        else:
            # Phase 1: the splits in read order into sorted runs.
            n = 0
            run_count = 0
            acc: List[RecordBatch] = []
            acc_bytes = 0
            sig_cols: List[dict] = []

            def flush() -> None:
                nonlocal run_count, acc, acc_bytes, peak
                if not acc:
                    return
                merged = ChunkedRecords.from_batches(acc, with_keys=True)
                peak = max(peak, acc_bytes)
                perm = _sort_perm(merged.keys, backend, dev, metrics)
                # Runs flush in read order: this chunk holds records
                # [n - k, n) of the job.
                orig = (np.arange(n - merged.n_records, n, dtype=np.int64)
                        if mark_duplicates else None)
                write_run(spill_dir, run_count, merged, perm, orig_idx=orig)
                run_count += 1
                acc = []
                acc_bytes = 0

            for b in stream.read_splits(fmt, splits, fields=read_fields,
                                        with_keys=key_column is None, errors=write.errors):
                if key_column is not None:
                    b.keys = key_column[n : n + b.n_records]
                if mark_duplicates:  # from the whole SoA, before it is trimmed
                    sig_cols.append(signature_columns(b.data, b.soa))
                b.soa = {"rec_off": b.soa["rec_off"], "rec_len": b.soa["rec_len"]}
                # Runs live on disk: a window kept on the card would stay
                # pinned there until its run flushes.
                b.device_data = None
                if acc and acc_bytes + len(b.data) > memory_budget:
                    flush()
                n += b.n_records
                acc.append(b)
                acc_bytes += len(b.data)
                if acc_bytes >= memory_budget:
                    flush()
            flush()

            t_markdup = time.perf_counter()
            if mark_duplicates and n:
                dup_mask = mark_duplicates_device(concat_columns(sig_cols), device=dev,
                                                  metrics=metrics)
                n_dup = int(dup_mask.sum())
            sig_cols = []

            if identity is not None:
                # Sidebands first, the manifest last: a manifest on disk
                # certifies everything it names.
                if dup_mask is not None:
                    with open(dupmask_path + ".tmp", "wb") as f:
                        np.save(f, dup_mask)
                    os.replace(dupmask_path + ".tmp", dupmask_path)
                write_manifest(spill_dir, identity, n_records=n, run_count=run_count,
                               memory_budget=memory_budget, mark_duplicates=mark_duplicates,
                               sort_order=sort_order)
        metrics.count("sort_bam.records", n)
        metrics.count("sort_bam.splits", len(splits))
        metrics.count("sort_bam.runs", run_count)
        if n_dup:
            metrics.count("sort_bam.duplicates", n_dup)

        # Phase 2: the exact key-range merge.
        t_plan = time.perf_counter()
        runs = [Run.open(spill_dir, k) for k in range(run_count)]
        ranges = plan_ranges(runs, memory_budget) if runs else []
        metrics.count("sort_bam.ranges", len(ranges))

        def part_of(pi: int):
            nonlocal peak
            batch, dup_rows = _load_range(runs, ranges[pi], dup_mask)
            peak = max(peak, len(batch.data))
            return batch, _sort_perm(batch.keys, backend, dev, metrics), dup_rows

        t_merge = time.perf_counter()
        # One range in flight: each holds up to a budget of record bytes.
        _write_parts(td, len(ranges), part_of, level, write_splitting_bai,
                     write.executor(td, metrics, workers=1), stream, stream.policy.device_write)
        merge_bam_parts(td, out_path, header, write_splitting_bai=write_splitting_bai)
    seconds["spill"] = t_markdup - t_spill
    if mark_duplicates:
        seconds["markdup"] = t_plan - t_markdup
    seconds["plan"] = t_merge - t_plan
    seconds["merge"] = time.perf_counter() - t_merge
    counters = metrics.counters()
    counters.update({f"flate.inflate.{k}": v for k, v in stream.inflate_stats.as_dict().items()})
    return SortStats(n, len(splits), f"external[{backend}]", str(dev), counters, seconds,
                     n_dup, run_count, len(ranges), peak)


def _fetch_perm(perm: torch.Tensor, metrics: Metrics) -> np.ndarray:
    if perm.device.type == "cuda":
        metrics.count_d2h(perm.numel() * 8, "perm")
    return perm.cpu().numpy()


def _finish_device_parse(
    batches: List[RecordBatch], parsed: List[Optional[tuple]], dev: torch.device,
    metrics: Metrics,
) -> np.ndarray:
    """Validate every split's device walk against the host walk, patch the
    unmapped rows' murmur3 hashes in, sort on the device.

    One download brings every split's ``[count, ok]``.  Any split whose
    walk failed or counted other records than the host raises."""
    live = [(b, p) for b, p in zip(batches, parsed) if p is not None]
    meta = torch.stack([p[2] for _, p in live]).cpu().numpy()
    host = np.asarray([b.n_records for b, _ in live])
    if not (np.all(meta[:, 1] == 1) and np.array_equal(meta[:, 0], host)):
        bad = [i for i, (m, h) in enumerate(zip(meta, host)) if m[1] != 1 or m[0] != h]
        raise RuntimeError(
            f"device record chain disagrees with the host walk in splits {bad}: "
            f"device [count, ok] {meta[bad].tolist()}, host counts {host[bad].tolist()}"
        )
    keys = torch.cat([p[0] for _, p in live])
    unm = torch.cat([p[1] for _, p in live])
    mask = unm.cpu().numpy()
    if dev.type == "cuda":
        metrics.count_d2h(mask.nbytes, "unmapped_mask")
    if mask.any():
        cols: List[np.ndarray] = []
        base = 0
        for b, _ in live:
            cols.append(_unmapped_hash32(b, mask[base : base + b.n_records]))
            base += b.n_records
        h = torch.from_numpy(np.concatenate(cols)).to(dev)
        if dev.type == "cuda":
            metrics.count_h2d(h.numel() * 4, "unmapped_hash")
        keys = patch_unmapped_keys(keys, unm, h)
    return _fetch_perm(sort_keys(keys)[1], metrics)


def _host_parse(b: RecordBatch, dev: torch.device, metrics: Metrics):
    """``parse_split``'s ``(keys, unmapped, meta)`` for a salvaged batch,
    from its host keys: the unmapped rows' hashes are in the keys already,
    so no row is flagged for the patch."""
    n_i = b.n_records
    if n_i == 0:
        return None
    off = np.asarray(b.soa["rec_off"], dtype=np.int64) - 4
    keys = bam_spec.soa_keys(bam_spec.soa_decode(b.data, off, fields=SORT_FIELDS), b.data)
    if dev.type == "cuda":
        metrics.count_h2d(keys.nbytes, "keys")
    return (torch.from_numpy(keys).to(dev), torch.zeros(n_i, dtype=torch.bool, device=dev),
            torch.tensor([n_i, 1], dtype=torch.int64, device=dev))


def _unmapped_hash32(b: RecordBatch, mask: np.ndarray) -> np.ndarray:
    """murmur3 of each unmapped row's bytes past the 32 fixed ones (seed 0,
    as a signed int32); 0 for the other rows."""
    h = np.zeros(len(mask), dtype=np.int32)
    rows = np.nonzero(mask)[0]
    if len(rows):
        off = np.asarray(b.soa["rec_off"], dtype=np.int64)[rows] + 32
        ln = np.maximum(np.asarray(b.soa["rec_len"], dtype=np.int64)[rows] - 32, 0)
        h[rows] = murmurhash3_int32_batch(b.data, off, ln, 0)
    return h

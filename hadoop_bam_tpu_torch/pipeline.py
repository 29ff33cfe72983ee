"""The in-core coordinate sort of BAM and CRAM files on one device.

Counterpart of ``hadoop_bam_tpu/pipeline.py`` ``sort_bam`` (in-core,
coordinate order), ``_input_format``, ``_read_any_header``,
``_finish_device_parse`` and ``_unmapped_hash32``.  Splits are read
double-buffered; a BAM split's members inflate on the device and the chain
and key kernels build its int64 keys from the resident window (a CRAM
split's rANS blocks decode on the device, its records and keys on the
host); one stable ``torch.sort`` orders the job; each part is
gathered, CRC'd and deflated on the device from the resident windows (or,
when a split has no window, gathered on the host and deflated by the
lanes), framed on the host and merged into one BAM.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .conf import (
    BAM_MARK_DUPLICATES,
    BAM_SORT_ORDER,
    BAM_WRITE_SPLITTING_BAI,
    ERRORS_MODE,
    Configuration,
)
from .device_stream import DeviceStream
from .io.anysam import AnySamInputFormat, infer_from_file_path
from .io.bam import SORT_FIELDS, BamInputFormat, ChunkedRecords, RecordBatch, read_header, write_part_fast
from .io.merger import SUCCESS_MARKER, merge_bam_parts
from .io.splits import FileVirtualSplit
from .ops.decode import patch_unmapped_keys
from .ops.sort import sort_keys
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
    #: launches), sort (validation, hash patch, sort, permutation fetch),
    #: write (part gathers and deflates, merge).
    seconds: Dict[str, float] = field(default_factory=dict)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _input_format(conf, in_paths):
    """BamInputFormat when every input is ``.bam``, else the AnySAM
    dispatcher (``.cram`` input; ``.sam`` raises, ROADMAP A.9)."""
    if all(infer_from_file_path(p) == "bam" for p in in_paths):
        return BamInputFormat(conf)
    return AnySamInputFormat(conf)


def _read_any_header(fmt, path):
    """The header by the format's own reader (CRAM: the file-header
    container), else the BAM reader."""
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
    """Coordinate-sort BAM or CRAM file(s) into one BAM, byte for byte what
    the reference's ``sort_bam`` writes for the same input and options.

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

    ``backend`` is "device" (keys sorted on ``device``, built there by the
    chain kernels when ``device_parse``) or "host" (keys built and sorted
    on the host, a stable NumPy argsort: the reference's oracle; the reads
    and part writes still follow the gates); the output bytes are the same.
    ``max_attempts`` is taken for the reference's signature and is inert:
    parts are written once, with no retry executor yet (ROADMAP A.2).

    ``errors`` (default ``hadoopbam.errors``, else "strict") and
    ``sort_order`` (default ``hadoopbam.bam.sort-order``, else
    "coordinate") are checked first, with the reference's ``ValueError``
    outside their domains.  Not ported yet (each raises
    ``NotImplementedError``): ``memory_budget``, ``mark_duplicates``,
    ``sort_order="queryname"``, ``mesh`` / ``distributed``,
    ``errors="salvage"`` and the serve job's ``resource_cache`` /
    ``deadline``."""
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
    dev = resolve_device(device)
    if isinstance(in_paths, str):
        in_paths = [in_paths]
    if conf is not None:
        write_splitting_bai = write_splitting_bai or conf.get_boolean(BAM_WRITE_SPLITTING_BAI)
        mark_duplicates = mark_duplicates or conf.get_boolean(BAM_MARK_DUPLICATES)
    if resource_cache is not None or deadline is not None:
        raise _not_ported("deadline / resource_cache (the serve sort job)", "A.11")
    if memory_budget is not None:
        raise _not_ported("memory_budget (the out-of-core sort)", "A.4")
    if mark_duplicates:
        raise _not_ported("mark_duplicates", "A.5")
    if sort_order != "coordinate":
        raise _not_ported(f"sort_order={sort_order!r}", "A.6")
    if mesh is not None or distributed is not None:
        raise _not_ported("mesh / distributed sorting", "A.10")
    if errors != "strict":
        raise _not_ported(f"errors={errors!r}", "A.7")
    stream = DeviceStream(dev, conf=conf)
    use_device_write = stream.policy.device_write

    fmt = _input_format(conf, in_paths)
    header = _read_any_header(fmt, in_paths[0]).with_sort_order("coordinate")
    splits = fmt.get_splits(in_paths, split_size=split_size)
    if backend == "host":
        device_parse = False
    elif device_parse is None:
        env = os.environ.get("HBAM_DEVICE_PARSE")
        device_parse = (
            env.strip().lower() not in ("0", "false", "no", "off", "")
            if env is not None
            else stream.default_device_parse()
        )
    # CRAM's byte splits have no BGZF window for the chain kernels, and the
    # records bounded traversal keeps are no contiguous stream.
    device_parse = device_parse and all(
        isinstance(s, FileVirtualSplit) and s.interval_chunks is None for s in splits)

    t_read = time.perf_counter()
    batches: List[RecordBatch] = []
    parsed: List[Optional[tuple]] = []
    fields = ("rec_off", "rec_len") if device_parse else SORT_FIELDS
    for b in stream.read_splits(fmt, splits, fields=fields, with_keys=not device_parse):
        if device_parse:
            parsed.append(stream.parse_split(b))
        if not use_device_write:
            b.device_data = None  # the chain kernels hold their own view
        b.soa = {"rec_off": b.soa["rec_off"], "rec_len": b.soa["rec_len"]}
        batches.append(b)
    n = sum(b.n_records for b in batches)
    t_sort = time.perf_counter()

    if n and device_parse:
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
        backend = "empty"
        perm = np.empty(0, dtype=np.int64)

    t_write = time.perf_counter()
    merged = ChunkedRecords.from_batches(batches, keep_device=use_device_write)
    for b in batches:
        b.device_data = None  # the flat stream, if any, holds the windows now
    with contextlib.ExitStack() as stack:
        if part_dir is not None:
            td = part_dir
            os.makedirs(td, exist_ok=True)
        else:
            td = stack.enter_context(tempfile.TemporaryDirectory(
                dir=os.path.dirname(os.path.abspath(out_path)) or "."))
        try:
            _write_parts(td, merged, perm, len(batches), level, write_splitting_bai,
                         write_workers, stream)
        finally:
            merged.release_device()  # the resident payload is dead once the parts exist
        merge_bam_parts(td, out_path, header, write_splitting_bai=write_splitting_bai)
    counters = stream.metrics.counters()
    counters.update({f"flate.inflate.{k}": v for k, v in stream.inflate_stats.as_dict().items()})
    seconds = {
        "read": t_sort - t_read,
        "sort": t_write - t_sort,
        "write": time.perf_counter() - t_write,
    }
    return SortStats(n, len(splits), backend, str(dev), counters, seconds)


def _write_parts(td, merged, perm, n_batches, level, write_splitting_bai, workers, stream):
    """One part per split, as the reference's executor writes them:
    ``part-r-NNNNN`` (+ ``.splitting-bai``), then ``_SUCCESS``.  The write
    tiers follow ``stream``'s policy."""
    n = len(perm)
    n_parts = max(1, n_batches)
    bounds = [n * i // n_parts for i in range(n_parts + 1)]
    workers = max(1, min(n_parts, workers or min(4, os.cpu_count() or 1)))
    threads = max(1, (os.cpu_count() or 4) // workers)

    def write_one(pi: int) -> None:
        final = os.path.join(td, f"part-r-{pi:05d}")
        tmp = final + ".tmp"
        order = perm[bounds[pi] : bounds[pi + 1]]
        sb = open(final + ".splitting-bai.tmp", "wb") if write_splitting_bai else None
        try:
            with open(tmp, "wb") as f:
                write_part_fast(f, merged, order=order, level=level,
                                splitting_bai_stream=sb, threads=threads,
                                device_deflate=stream.policy.deflate_lanes,
                                device_write=stream.policy.device_write,
                                device_stream=stream)
        finally:
            if sb is not None:
                sb.close()
        os.replace(tmp, final)
        if sb is not None:
            os.replace(sb.name, final + ".splitting-bai")

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(write_one, range(n_parts)))
    open(os.path.join(td, SUCCESS_MARKER), "wb").close()


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

"""The multi-process sort: one process a host (or a card), SPMD over one mesh.

Counterpart of ``hadoop_bam_tpu/parallel/multihost.py``: the coordinate
and queryname sort with its skew healing (the repartition, speculative
re-execution of a straggler's parts stage), the mesh trace and
:func:`fixmate_bam_multihost`.  The reference's scale-out runtime is the
Hadoop cluster: one mapper a split, record bytes through the MapReduce
shuffle's spill and fetch.  Here:

- **control plane**: ``torch.distributed`` over a gloo group
  (:func:`initialize`); every process plans the same splits and owns
  ``split_idx % num_processes == process_id`` (no coordinator).  Barriers,
  the host allgathers and the endpoint publication ride it.
- **key plane**: the range-partitioned shuffle
  (:class:`~.shuffle.DistributedSort`) over the mesh of every process's
  shards: the samples are gathered from every process and the buckets
  cross in one ``all_to_all_single``, over NCCL when every rank holds a
  card of its own, else over gloo staged through pinned host memory
  (:class:`~.mesh.ProcessLayout`, chosen from the layout at
  :func:`initialize`).  The shuffle also returns each input row's
  destination shard, the sender's routing table.
- **byte plane**: each process writes one run of records a destination
  process, in global source-row order, with ``.rows``/``.offs`` sidecars;
  after a barrier every process gathers the bytes its shards own, from a
  filesystem every process reads (``byte_plane="fs"``) or over
  token-authenticated HTTP range reads of each peer's local disk
  (``"http"``, Hadoop's map-output servlet).  Under ``memory_budget`` the
  key-sorted spill runs are the byte plane: a destination shard's share
  of each run is one slice, merged by (key, ordinal) one shard at a time.

The wire is compressed by default: a destination's run is re-blocked into
BGZF members through the job's :class:`~..device_stream.DeviceStream`
(row 3, ``csrc/deflate.cu``, on the card) with a member table
``(raw_off, raw_len, comp_off, comp_len)``, and the receiver inflates the
members it fetched through the same stream (row 1, ``csrc/inflate.cu``);
the sidecars address raw bytes, so the gather is the raw plane's.
``hadoopbam.shuffle.compress=false`` ships the raw stream.  The split
reads and the part writes run on the host, as in the reference.

:func:`sort_bam_multihost` writes one part a global shard, and process 0
merges them: the record stream of the single-process sort of the input.

- **speculation** (``hadoopbam.mesh.speculate-factor`` > 0): every process
  publishes its parts' routes before its writes and a done marker after
  them; the lowest finished process re-runs a straggler's fetch and
  writes from the byte plane, and ``os.link`` lets the first copy of a
  part win (the bytes are a function of the route, so either copy is
  the same).
- **the mesh trace** (``mesh_trace``): each process records a trace shard
  and a host manifest, anchored at one barrier; process 0 collects them
  and folds a :class:`~..utils.tracing.ClusterManifest`, which
  ``tools/mesh_report.py`` reduces.
"""

from __future__ import annotations

import contextlib
import datetime
import hmac
import io
import json
import os
import secrets
import socket
import tempfile
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import faults
from ..collate import (
    FIXMATE_FIELDS,
    Collation,
    apply_fixmate,
    collate_by_name,
    collation_columns,
    compute_fixmate_edits,
    concat_collation,
    global_name_ranks,
    group_representatives,
    verify_and_repair,
)
from ..conf import (
    ERRORS_MODE,
    MESH_REPARTITION_SAMPLES,
    MESH_SKEW_BOUND,
    MESH_SPECULATE_FACTOR,
    MESH_TRACE,
    MESH_TRACE_DIR,
    SHUFFLE_COMPRESS,
    SHUFFLE_FETCH_THREADS,
    SHUFFLE_MEMBER_BYTES,
    TRACE_EVENTS,
)
from ..device_stream import DeviceStream
from ..io import runs as runs_mod
from ..io.bam import SORT_FIELDS, BamInputFormat, RecordBatch, gather_record_array, read_header
from ..io.bam import write_part_fast
from ..io.fs import HttpFilesystem
from ..io.merger import merge_bam_parts
from ..ops.flate import DEV_MAX_PAYLOAD
from ..ops.keys import split_keys_np
from ..spec import bgzf
from ..spec.bam import FLAG_PAIRED
from ..utils import nio
from ..utils.backend import resolve_device
from ..utils.hbm import LEDGER
from ..utils.tracing import (
    DEFAULT_TRACE_EVENTS,
    TRACER,
    MetricsRegistry,
    cluster_manifest,
    delta,
    run_manifest,
    snapshot,
    span,
    trace_ctx,
)
from .mesh import Mesh, ProcessLayout, choose_transport, device_ident, make_mesh, process_of_device
from .shuffle import DistributedSort

#: The process group's timeout: a collective that waits longer for a dead
#: or stuck peer fails the job instead of hanging it.
DEFAULT_TIMEOUT_S = 300.0

#: The wire's data errors: the only failures a salvaging inflate catches
#: (a kernel or card failure raises).
WIRE_ERRORS = (bgzf.BgzfError, zlib.error)


@dataclass
class MultihostContext:
    """Process identity and the mesh (this process's shards, with the
    process layout when the run spans processes); ``timeout_s`` bounds a
    wait on a peer (the group's collectives, the speculation's poll)."""

    process_id: int
    num_processes: int
    mesh: Mesh
    timeout_s: float = DEFAULT_TIMEOUT_S

    @property
    def local_device_count(self) -> int:
        return len(self.mesh)

    @property
    def global_device_count(self) -> int:
        return self.mesh.size

    def owned(self, items: Sequence) -> List:
        """Round-robin ownership: deterministic, planner-free (every process
        computes the same global plan)."""
        return [it for k, it in enumerate(items) if k % self.num_processes == self.process_id]

    def barrier(self, name: str, metrics: Optional[MetricsRegistry] = None) -> None:
        """A named barrier over every process, timed into ``metrics`` (its
        span and the ``mh.barrier.<name>`` histogram, milliseconds) and, with
        the tracer armed, a stage event whose start is this process's
        arrival."""
        t0 = time.perf_counter()
        with span(f"mh.barrier.{name}", registry=metrics, category="stage"):
            if self.mesh.layout is not None:
                import torch.distributed as dist

                dist.barrier()
        if metrics is not None:
            metrics.observe(f"mh.barrier.{name}", (time.perf_counter() - t0) * 1e3)

    def allgather_counts(self, n: int) -> np.ndarray:
        """[num_processes] int64: one scalar from each process."""
        return self.allgather_array(np.array([n], np.int64)).reshape(-1)

    def allgather_array(self, a: np.ndarray) -> np.ndarray:
        """[num_processes, *a.shape]: a same-shape array from each process,
        through the control group (the default gloo group; host bytes)."""
        a = np.ascontiguousarray(a)
        if self.mesh.layout is None:
            return a.reshape((1,) + a.shape).copy()
        import torch.distributed as dist

        raw = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
        out = torch.empty((self.num_processes, raw.numel()), dtype=torch.uint8)
        dist.all_gather(list(out.unbind(0)), raw)
        return out.numpy().view(a.dtype).reshape((self.num_processes,) + a.shape)

    def close(self) -> None:
        """Leave the process group (a no-op for a one-process context)."""
        if self.mesh.layout is not None:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    init_method: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    shards: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> MultihostContext:
    """Join the process group and build the mesh.

    With no ``coordinator_address`` and no ``init_method`` this is one
    process over its own mesh: ``make_mesh(shards, device=device)`` (the
    visible cards on ``cuda``, ``shards`` host shards on ``cpu``), no group
    and the one-process exchange.  Otherwise ``torch.distributed`` starts
    a gloo group (``init_method``, e.g. ``file://…``, else
    ``tcp://<coordinator_address>``; rank ``process_id`` of
    ``num_processes``; collectives time out after ``timeout_s``) and this
    process holds ``shards`` (default 1) shards of ``device`` (None: the
    card, which raises without one).  Every rank tells the others which
    physical device its shards sit on: the key plane takes a NCCL group
    when every rank holds a card of its own, else the gloo group, staged
    through pinned host memory on a card."""
    dev = resolve_device(device)
    if coordinator_address is None and init_method is None:
        return MultihostContext(0, 1, make_mesh(shards, device=dev))
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs num_processes and process_id")
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group("gloo", init_method=init_method or f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=timeout)
    idents: List[Optional[str]] = [None] * num_processes
    dist.all_gather_object(idents, device_ident(dev))
    transport = choose_transport(idents)
    key_group = None  # the gloo group
    if transport == "nccl":
        torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
        key_group = dist.new_group(backend="nccl", timeout=timeout)
    layout = ProcessLayout(process_id, num_processes, key_group=key_group, transport=transport)
    return MultihostContext(process_id, num_processes,
                            Mesh([dev] * (shards or 1), layout=layout), timeout_s)


#: The last :func:`sort_bam_multihost` of this process: ``peak_bytes``
#: (budget mode's accounted peak of materialized record bytes; also the
#: ``mh.peak_bytes`` gauge).
LAST_STATS: dict = {}


# ---------------------------------------------------------------------------
# The byte plane's files.
# ---------------------------------------------------------------------------


def _bytes_name(src: int, dst: int) -> str:
    return f"shufbytes-s{src:03d}-d{dst:03d}"


def _bytes_file(d: str, src: int, dst: int) -> str:
    return os.path.join(d, _bytes_name(src, dst))


#: The member table's suffix: one flat int64 ``.npy`` of ``(raw_off,
#: raw_len, comp_off, comp_len)`` a member (flat, so that the ranged
#: ``.npy`` reader takes it on the HTTP plane).
_MTAB_SUFFIX = ".mtab.npy"


def _env_int(name: str) -> int:
    env = os.environ.get(name, "")
    try:
        return int(env) if env else 0
    except ValueError:
        return 0


def _conf_float(conf, key: str, env: str, default: float) -> float:
    if conf is not None:
        got = conf.get(key)
        if got is not None:
            try:
                return float(got)
            except ValueError:
                pass
    raw = os.environ.get(env, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _resolve_shuffle_compress(conf) -> bool:
    """``hadoopbam.shuffle.compress`` → HBAM_SHUFFLE_COMPRESS → True."""
    if conf is not None and conf.get(SHUFFLE_COMPRESS) is not None:
        return conf.get_boolean(SHUFFLE_COMPRESS, True)
    env = os.environ.get("HBAM_SHUFFLE_COMPRESS", "").strip().lower()
    if env:
        return env not in ("0", "false", "off", "no")
    return True


def _resolve_member_bytes(conf) -> int:
    """A wire member's payload: conf → env → ``DEV_MAX_PAYLOAD``, clamped
    to [512, ``DEV_MAX_PAYLOAD``] (a member of at most 64 KiB)."""
    v = conf.get_int(SHUFFLE_MEMBER_BYTES, 0) if conf is not None else 0
    if v <= 0:
        v = _env_int("HBAM_SHUFFLE_MEMBER_BYTES")
    if v <= 0:
        v = DEV_MAX_PAYLOAD
    return max(512, min(v, DEV_MAX_PAYLOAD))


def _resolve_fetch_threads(conf) -> int:
    """The fetch pool's width: ``hadoopbam.shuffle.fetch-threads`` →
    HBAM_SHUFFLE_FETCH_THREADS → 8 (capped at the peer count)."""
    v = conf.get_int(SHUFFLE_FETCH_THREADS, 0) if conf is not None else 0
    if v <= 0:
        v = _env_int("HBAM_SHUFFLE_FETCH_THREADS")
    return v if v > 0 else 8


def _resolve_skew_bound(conf) -> float:
    """The repartition trigger: ``hadoopbam.mesh.skew-bound`` →
    HBAM_MESH_SKEW_BOUND → 1.5; ``<= 0`` disables it."""
    return _conf_float(conf, MESH_SKEW_BOUND, "HBAM_MESH_SKEW_BOUND", 1.5)


def _resolve_repartition_samples(conf) -> int:
    """Keys a process contributes to the repartition's reservoir:
    ``hadoopbam.mesh.repartition-samples`` → HBAM_MESH_REPARTITION_SAMPLES
    → 4096."""
    v = conf.get_int(MESH_REPARTITION_SAMPLES, 0) if conf is not None else 0
    if v <= 0:
        v = _env_int("HBAM_MESH_REPARTITION_SAMPLES")
    return v if v > 0 else 4096


def _resolve_speculate_factor(conf) -> float:
    """The straggler trigger: ``hadoopbam.mesh.speculate-factor`` →
    HBAM_MESH_SPECULATE_FACTOR → 0 (off).  A finished process re-runs a
    straggler's parts stage once it has run longer than the factor times
    the median finished stage."""
    return _conf_float(conf, MESH_SPECULATE_FACTOR, "HBAM_MESH_SPECULATE_FACTOR", 0.0)


def _resolve_mesh_trace(conf, mesh_trace: Optional[bool]) -> bool:
    """The argument → ``hadoopbam.mesh.trace`` → HBAM_MESH_TRACE.  A trace
    directory alone names a place and arms nothing."""
    if mesh_trace is not None:
        return bool(mesh_trace)
    if conf is not None and conf.get(MESH_TRACE) is not None:
        return conf.get_boolean(MESH_TRACE, False)
    return os.environ.get("HBAM_MESH_TRACE", "").strip().lower() not in (
        "", "0", "false", "off", "no")


def _resolve_mesh_trace_dir(conf, mesh_trace_dir: Optional[str], out_path: str) -> str:
    """The argument → ``hadoopbam.mesh.trace-dir`` → HBAM_MESH_TRACE_DIR →
    ``<out_path>.mesh-trace``."""
    if mesh_trace_dir:
        return mesh_trace_dir
    got = conf.get(MESH_TRACE_DIR) if conf is not None else None
    if got:
        return got
    return os.environ.get("HBAM_MESH_TRACE_DIR") or os.path.abspath(out_path) + ".mesh-trace"


# ---------------------------------------------------------------------------
# The compressed wire: BGZF members and a member table in raw space.
# ---------------------------------------------------------------------------


def _deflate_member_stream(raw, dstream: DeviceStream, level: int,
                           member_bytes: int) -> Tuple[bytes, np.ndarray]:
    """Re-block a raw record stream into BGZF members for the wire:
    ``(member stream, flat int64 member table)``.  The deflate is the
    job's stream seam (row 3 with the deflate lanes armed, host zlib
    otherwise).  A stream the codec grew (incompressible payload) is
    stored instead (level 0), counted ``mh.shuffle.store_fallback``."""
    n = int(len(raw))
    if n == 0:
        return b"", np.zeros(0, dtype=np.int64)
    comp = dstream.deflate_stream(raw, level=level if level > 0 else 1,
                                  block_payload=member_bytes)
    if len(comp) >= n:
        dstream.metrics.count("mh.shuffle.store_fallback", 1)
        comp = bgzf.deflate_blocks(raw, level=0, block_payload=member_bytes)[0]
    return comp, _member_table(comp, n)


def _member_table(comp: bytes, raw_total: int) -> np.ndarray:
    """The flat ``(raw_off, raw_len, comp_off, comp_len)`` table of a
    member stream; the raw sizes must tile the raw stream the ``.offs``
    sidecar addresses (else an accounting desync, caught here)."""
    co, cs, us = bgzf.scan_blocks(np.frombuffer(comp, dtype=np.uint8))
    us64 = us.astype(np.int64)
    if int(us64.sum()) != raw_total:
        raise RuntimeError(f"shuffle member table desync: members carry {int(us64.sum())} "
                           f"raw bytes, sidecars address {raw_total}")
    mtab = np.empty((len(us), 4), dtype=np.int64)
    mtab[:, 0] = np.concatenate(([0], np.cumsum(us64[:-1])))
    mtab[:, 1] = us64
    mtab[:, 2] = co
    mtab[:, 3] = cs
    return mtab.reshape(-1)


def _member_cover(mtab: np.ndarray, b0: int, b1: int) -> Tuple[int, int]:
    """The member index range [m0, m1) covering raw bytes [b0, b1)."""
    m = mtab.reshape(-1, 4)
    if b1 <= b0 or len(m) == 0:
        return 0, 0
    raw_off = m[:, 0]
    m0 = max(0, int(np.searchsorted(raw_off, b0, side="right")) - 1)
    m1 = int(np.searchsorted(raw_off, b1, side="left"))
    return m0, m1


def _cover_comp_bytes(mtab: np.ndarray, b0: int, b1: int) -> int:
    """Wire bytes of the members covering raw bytes [b0, b1): the unit
    both sides of the budget plane's byte matrix count in."""
    m0, m1 = _member_cover(mtab, b0, b1)
    if m1 <= m0:
        return 0
    m = mtab.reshape(-1, 4)
    return int(m[m1 - 1, 2] + m[m1 - 1, 3] - m[m0, 2])


def _decode_wire(dstream: DeviceStream, data, co, cs, us) -> Tuple[np.ndarray, np.ndarray]:
    """Inflate wire members through the stream's gate: row 1
    (:meth:`~..device_stream.DeviceStream.decode_members`, whose resident
    window is released at once) with the inflate lanes armed, host zlib
    otherwise.  ``(out, out_offsets)``; a corrupt member raises
    :class:`~..spec.bgzf.BgzfError`."""
    if dstream.policy.inflate_lanes:
        out, offs, window = dstream.decode_members(data, co, cs, us)
        LEDGER.release(window)
        return out, offs
    return bgzf.inflate_blocks(data, co, cs, us)


def _inflate_member_stream(comp: np.ndarray, mtab: np.ndarray, dstream: DeviceStream,
                           errors: Optional[str]) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Inflate a fetched member stream back to raw record bytes:
    ``(raw uint8, quarantined raw intervals)``.  The armed ``mh.corrupt``
    seam flips a byte of a member's compressed payload here, after the
    wire and before the inflate, so the BGZF CRC catches it.  Strict mode
    raises the codec's error; ``errors="salvage"`` inflates member by
    member, quarantines exactly the corrupt ones (``salvage.*``) and
    zero-fills their raw spans, so the gather drops the records they
    carried and the survivors stay byte-exact.  Only the wire's data
    errors (:data:`WIRE_ERRORS`) are caught."""
    metrics = dstream.metrics
    m = mtab.reshape(-1, 4)
    nm = len(m)
    if nm == 0:
        return np.empty(0, dtype=np.uint8), []
    co = np.ascontiguousarray(m[:, 2], dtype=np.int64)
    cs = np.ascontiguousarray(m[:, 3], dtype=np.int32)
    us = np.ascontiguousarray(m[:, 1], dtype=np.int32)
    plan = faults.ACTIVE
    if plan is not None:
        for i in range(nm):
            if plan.mh_corrupt(i, metrics):
                comp = np.array(comp, copy=True)
                # Mid-payload of member i: past the 18-byte gzip header,
                # before the 8-byte CRC/ISIZE trailer.
                comp[int(co[i]) + 18 + max(0, (int(cs[i]) - 26) // 2)] ^= 0xFF
    if errors != "salvage":
        return _decode_wire(dstream, comp, co, cs, us)[0], []
    try:
        return _decode_wire(dstream, comp, co, cs, us)[0], []
    except WIRE_ERRORS:
        pass  # member by member below, quarantining the failures
    offs = np.zeros(nm + 1, dtype=np.int64)
    np.cumsum(us.astype(np.int64), out=offs[1:])
    out = np.zeros(int(offs[-1]), dtype=np.uint8)
    bad: List[Tuple[int, int]] = []
    for i in range(nm):
        try:
            p, _ = bgzf.inflate_blocks(comp, co[i : i + 1], cs[i : i + 1], us[i : i + 1])
            out[int(offs[i]) : int(offs[i + 1])] = p
        except WIRE_ERRORS:
            bad.append((int(offs[i]), int(offs[i + 1])))
            metrics.count("salvage.members_quarantined", 1)
            metrics.count("salvage.bytes_quarantined", int(us[i]))
    return out, bad


def _atomic_write(path: str, writer) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        writer(f)
    os.replace(tmp, path)


def _write_run_compressed(directory: str, idx: int, batch, perm: np.ndarray,
                          dstream: DeviceStream, level: int, member_bytes: int) -> None:
    """Spill one sorted run in the wire's form: the data file is a BGZF
    member stream plus the ``.mtab.npy`` member table; the key and offset
    sidecars address raw bytes, so the budget plane's cuts, slices and
    (key, ordinal) merge do not depend on the form."""
    data_p, keys_p, offs_p, _ = runs_mod.run_paths(directory, idx)
    stream = gather_record_array(batch, perm)
    keys_sorted = np.ascontiguousarray(batch.keys[perm], dtype=np.int64)
    lens = batch.soa["rec_len"].astype(np.int64)[perm] + 4
    offs = np.empty(len(lens) + 1, dtype=np.int64)
    offs[0] = 0
    np.cumsum(lens, out=offs[1:])
    with span("mh.byte_shuffle.deflate", registry=dstream.metrics, category="stage"):
        comp, mtab = _deflate_member_stream(stream, dstream, level, member_bytes)
    _atomic_write(data_p, lambda f: f.write(comp))
    _atomic_write(keys_p, lambda f: np.save(f, keys_sorted))
    _atomic_write(offs_p, lambda f: np.save(f, offs))
    _atomic_write(os.path.join(directory, f"run-{idx:05d}{_MTAB_SUFFIX}"),
                  lambda f: np.save(f, mtab))


# ---------------------------------------------------------------------------
# The HTTP plane.
# ---------------------------------------------------------------------------


def _serve_dir(directory: str, token: str, metrics: Optional[MetricsRegistry] = None):
    """Serve ``directory`` read-only over HTTP with ``Range`` support: the
    role of Hadoop's map-output servlet.  Every request must carry
    ``token`` in ``X-Hbam-Token`` or gets 403; one flat directory, no
    path-like names.  Counts ``mh.http.requests``, ``.range_requests``
    and ``.bytes_served`` into ``metrics``, each before the reply is sent.  Listens on
    ``HBAM_SHUFFLE_HOST`` when set (and publishes it), else on every
    interface under the host's name.  Returns ``(server, base_url)``; the
    caller shuts it down."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    root = os.path.abspath(directory)

    def count(name: str, n: int) -> None:
        if metrics is not None:
            metrics.count(name, n)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _path(self):
            got = self.headers.get("X-Hbam-Token") or ""
            if not hmac.compare_digest(got, token):
                self.send_error(403)
                return None
            name = self.path.lstrip("/")
            if "/" in name or ".." in name or not name:
                self.send_error(404)
                return None
            p = os.path.join(root, name)
            if not os.path.isfile(p):
                self.send_error(404)
                return None
            return p

        def do_HEAD(self):
            count("mh.http.requests", 1)
            p = self._path()
            if p is None:
                return
            self.send_response(200)
            self.send_header("Content-Length", str(os.path.getsize(p)))
            self.send_header("Accept-Ranges", "bytes")
            self.end_headers()

        def do_GET(self):
            count("mh.http.requests", 1)
            p = self._path()
            if p is None:
                return
            size = os.path.getsize(p)
            rng = self.headers.get("Range")
            if rng:
                count("mh.http.range_requests", 1)
            lo, hi = 0, size - 1
            status = 200
            if rng:
                try:
                    a, b = rng.split("=")[1].split("-")
                    if a == "":  # the suffix form: the last N bytes
                        lo = max(0, size - int(b))
                    else:
                        lo = int(a)
                        hi = min(int(b) if b else size - 1, size - 1)
                except ValueError:
                    self.send_error(400)
                    return
                if lo >= size or hi < lo:
                    self.send_error(416)
                    return
                status = 206
            n = hi - lo + 1
            self.send_response(status)
            if status == 206:
                self.send_header("Content-Range", f"bytes {lo}-{hi}/{size}")
            self.send_header("Content-Length", str(n))
            self.end_headers()
            with open(p, "rb") as f:
                f.seek(lo)
                remaining = n
                while remaining > 0:
                    chunk = f.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    # Counted before it is sent: a reader that holds the
                    # bytes sees them counted.
                    count("mh.http.bytes_served", len(chunk))
                    self.wfile.write(chunk)
                    remaining -= len(chunk)

    pinned = os.environ.get("HBAM_SHUFFLE_HOST")
    srv = ThreadingHTTPServer((pinned or "0.0.0.0", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host = pinned or socket.gethostname()
    return srv, f"http://{host}:{srv.server_address[1]}"


_ENDPOINT_REC = 512  # fits http:// + a 253-character name + port + 32-hex token


def _publish_endpoints(ctx: MultihostContext, url: str, token: str) -> List[Tuple[str, str]]:
    """Every process's (URL, fetch token), gathered as fixed-width UTF-8;
    the gather is also the "server is up" barrier."""
    rec = f"{url} {token}".encode()
    if len(rec) > _ENDPOINT_REC:
        raise ValueError(f"shuffle endpoint too long: {rec!r}")
    buf = np.zeros(_ENDPOINT_REC, dtype=np.uint8)
    buf[: len(rec)] = np.frombuffer(rec, np.uint8)
    out = []
    for row in ctx.allgather_array(buf):
        u, t = bytes(row).rstrip(b"\x00").decode().split(" ", 1)
        out.append((u, t))
    return out


def _start_http_plane(ctx: MultihostContext, serve_dir: str, stack: contextlib.ExitStack,
                      metrics: Optional[MetricsRegistry]) -> List:
    """Serve ``serve_dir``, publish the endpoint and return each source's
    locator (this process's own files stay a directory).  The server's
    shutdown is on ``stack``, so every failure path closes the port."""
    token = secrets.token_hex(16)
    srv, url = _serve_dir(serve_dir, token, metrics)
    stack.callback(srv.server_close)
    stack.callback(srv.shutdown)
    sources: List = list(_publish_endpoints(ctx, url, token))
    sources[ctx.process_id] = serve_dir
    return sources


# ---------------------------------------------------------------------------
# The byte plane in core.
# ---------------------------------------------------------------------------


def _write_byte_runs(shuffle_dir: str, ctx: MultihostContext, batch, dest_dev: np.ndarray,
                     row_of_record: np.ndarray, rows_per_device: int, dstream: DeviceStream,
                     compress: bool = False, member_bytes: int = 0, level: int = 1) -> None:
    """Ship this process's records to their destination processes: one
    run a destination, records ascending by global source row, with
    ``.rows``/``.offs`` sidecars (raw addresses).  Compressed: ``.bgzf``
    members and the ``.mtab.npy`` table; raw: the ``.bin`` stream.  Counts
    the wire bytes a destination (``mh.shuffle.sent.<dst>``; the diagonal
    is this process's own share) and the raw ones (``.sent_raw.<dst>``)."""
    metrics = dstream.metrics
    L = ctx.local_device_count
    first = ctx.process_id * L
    g_row = ((first + row_of_record // rows_per_device).astype(np.int64) * rows_per_device
             + (row_of_record % rows_per_device).astype(np.int64))
    dest_proc = process_of_device(dest_dev, L)
    lens = batch.soa["rec_len"].astype(np.int64) + 4
    sent_track: dict = {}
    for q in range(ctx.num_processes):
        sel = np.nonzero(dest_proc == q)[0]
        order = sel[np.argsort(g_row[sel], kind="stable")]
        stream = gather_record_array(batch, order)
        offs = np.empty(len(order) + 1, dtype=np.int64)
        offs[0] = 0
        np.cumsum(lens[order], out=offs[1:])
        metrics.count(f"mh.shuffle.sent_raw.{q}", int(offs[-1]))
        base = _bytes_file(shuffle_dir, ctx.process_id, q)
        if compress:
            with span("mh.byte_shuffle.deflate", registry=metrics, category="stage"):
                comp, mtab = _deflate_member_stream(stream, dstream, level, member_bytes)
            wire = len(comp)
            targets = ((base + ".bgzf", lambda f, b=comp: f.write(b)),
                       (base + _MTAB_SUFFIX, lambda f, a=mtab: np.save(f, a)))
        else:
            wire = int(offs[-1])
            targets = ((base + ".bin", lambda f, b=stream: f.write(memoryview(b))),)
        targets += ((base + ".rows", lambda f, a=g_row[order]: np.save(f, a)),
                    (base + ".offs", lambda f, a=offs: np.save(f, a)))
        metrics.count(f"mh.shuffle.sent.{q}", wire)
        sent_track[str(q)] = float(wire)
        TRACER.counter("mh.shuffle.sent", sent_track)
        for path, writer in targets:
            _atomic_write(path, writer)


class _ByteFetcher:
    """The receiver: resolve (src_dev, src_row) → record bytes across the
    runs addressed to this process.  ``sources`` locates each process's
    runs: a directory (the fs plane, and this process's own files) or an
    ``(http_base, token)`` endpoint.  Peers are fetched by a pool of
    ``fetch_threads``; on the compressed plane each fetch inflates its
    members inside its thread, so one source's inflate overlaps another's
    fetch.  ``errors="salvage"`` quarantines corrupt members; their
    records are dropped at :meth:`gather`.

    ``dest_pid`` (speculation) fetches another process's share: redundant
    bytes, counted ``mh.speculate.fetch_bytes`` and never in the recv
    matrix, which must keep balancing against what the senders sent."""

    def __init__(self, sources: List, ctx: MultihostContext, rows_per_device: int,
                 dstream: DeviceStream, compress: bool = False, fetch_threads: int = 8,
                 errors: Optional[str] = None, dest_pid: Optional[int] = None):
        metrics = dstream.metrics
        self.rows = rows_per_device
        self.ctx = ctx
        self.metrics = metrics
        P_ = ctx.num_processes
        dest = ctx.process_id if dest_pid is None else dest_pid
        speculative = dest != ctx.process_id
        #: Per source: the quarantined raw intervals (salvage only).
        self.bad: List[List[Tuple[int, int]]] = [[] for _ in range(P_)]

        def fetch_one(s: int):
            name = _bytes_name(s, dest)
            ext = ".bgzf" if compress else ".bin"
            if isinstance(sources[s], tuple):
                url, token = sources[s]
                f = HttpFilesystem(headers={"X-Hbam-Token": token},
                                   retry_metric="mh.http.fetch_retries")
                base = url.rstrip("/")

                def rd(suffix: str) -> bytes:
                    return f.read_all(f"{base}/{name}{suffix}", metrics=metrics)

                wire_buf = np.frombuffer(rd(ext), dtype=np.uint8)
                rows = np.load(io.BytesIO(rd(".rows")))
                offs = np.load(io.BytesIO(rd(".offs")))
                mtab = np.load(io.BytesIO(rd(_MTAB_SUFFIX))) if compress else None
            else:
                p = os.path.join(sources[s], name)
                with open(p + ext, "rb") as fh:
                    wire_buf = np.frombuffer(fh.read(), dtype=np.uint8)
                rows = np.load(p + ".rows")
                offs = np.load(p + ".offs")
                mtab = np.load(p + _MTAB_SUFFIX) if compress else None
            # The receiver's side of the byte matrix, from what arrived.
            if speculative:
                metrics.count("mh.speculate.fetch_bytes", int(len(wire_buf)))
            else:
                metrics.count(f"mh.shuffle.recv.{s}", int(len(wire_buf)))
                TRACER.counter("mh.shuffle.recv", {str(s): float(len(wire_buf))})
            if compress:
                with span("mh.byte_shuffle.inflate", registry=metrics, category="stage"):
                    raw, bad = _inflate_member_stream(wire_buf, mtab, dstream, errors)
                self.bad[s] = bad
            else:
                raw = wire_buf
            if not speculative:
                metrics.count(f"mh.shuffle.recv_raw.{s}", int(len(raw)))
            if len(offs) and int(offs[-1]) != len(raw):
                raise RuntimeError(f"byte shuffle sidecar desync from process {s}: offs "
                                   f"address {int(offs[-1])} raw bytes, stream carries {len(raw)}")
            return raw, rows, offs

        with ThreadPoolExecutor(max_workers=max(1, min(fetch_threads, P_))) as pool:
            got = list(pool.map(fetch_one, range(P_)))
        bufs = [g[0] for g in got]
        self.rows_tab = [g[1] for g in got]
        self.offs_tab = [g[2] for g in got]
        # One buffer, built once: gather() runs once a local shard.
        self.base = np.zeros(P_ + 1, dtype=np.int64)
        np.cumsum([len(b) for b in bufs], out=self.base[1:])
        self.big = np.concatenate(bufs) if bufs else np.empty(0, np.uint8)

    def gather(self, src_dev: np.ndarray, src_row: np.ndarray):
        """The raw records of the (src_dev, src_row) references, in their
        order: ``(data uint8, rec_off, rec_len)``.  Under salvage the
        records whose bytes touch a quarantined member are dropped
        (``salvage.records_dropped``) and the survivors keep their order."""
        L = self.ctx.local_device_count
        g = src_dev.astype(np.int64) * self.rows + src_row.astype(np.int64)
        src_proc = src_dev // L
        n = len(g)
        out_len = np.zeros(n, dtype=np.int64)
        src_off = np.zeros(n, dtype=np.int64)
        keep: Optional[np.ndarray] = None
        for s in range(self.ctx.num_processes):
            m = src_proc == s
            if not m.any():
                continue
            idx = np.searchsorted(self.rows_tab[s], g[m])
            if np.any(idx >= len(self.rows_tab[s])) or np.any(self.rows_tab[s][idx] != g[m]):
                raise RuntimeError(f"byte shuffle missing rows from process {s}")
            src_off[m] = self.offs_tab[s][idx] + self.base[s]
            out_len[m] = self.offs_tab[s][idx + 1] - self.offs_tab[s][idx]
            if self.bad[s]:
                # Quarantined intervals are sorted and disjoint: a record
                # overlaps one iff the first interval ending after its
                # start begins before its end.
                lo = np.asarray(self.offs_tab[s][idx], dtype=np.int64)
                hi = lo + out_len[m]
                starts = np.array([a for a, _ in self.bad[s]], np.int64)
                ends = np.array([b for _, b in self.bad[s]], np.int64)
                j = np.searchsorted(ends, lo, side="right")
                ov = (j < len(starts)) & (starts[np.minimum(j, len(starts) - 1)] < hi)
                if ov.any():
                    if keep is None:
                        keep = np.ones(n, dtype=bool)
                    keep[np.nonzero(m)[0][ov]] = False
        if keep is not None:
            self.metrics.count("salvage.records_dropped", int((~keep).sum()))
            src_off = src_off[keep]
            out_len = out_len[keep]
            n = len(src_off)
        data = gather_record_array(RecordBatch(soa={"rec_off": src_off + 4,
                                                    "rec_len": out_len - 4},
                                               data=self.big, keys=None))
        out_off = np.empty(n + 1, dtype=np.int64)
        out_off[0] = 0
        np.cumsum(out_len, out=out_off[1:])
        return data, out_off[:-1] + 4, out_len - 4


# ---------------------------------------------------------------------------
# The byte plane under a memory budget.
# ---------------------------------------------------------------------------


class _RemoteNpy:
    """Ranged slices of a remote int64 ``.npy`` sideband: only the header
    and the requested element ranges cross the wire (the local plane
    memmaps its sidecars, and the network plane must not read more)."""

    def __init__(self, fs, url: str, metrics=None):
        self._fs = fs
        self._url = url
        self._metrics = metrics
        head = fs.read_range(url, 0, 128, metrics=metrics)
        if head[:6] != b"\x93NUMPY":
            raise IOError(f"not an npy file: {url}")
        if head[6] == 1:
            hlen = int.from_bytes(head[8:10], "little")
            self._data0 = 10 + hlen
            hdr = head[10 : 10 + hlen]
        else:
            hlen = int.from_bytes(head[8:12], "little")
            self._data0 = 12 + hlen
            hdr = head[12 : 12 + hlen]
        if len(hdr) < hlen:
            hdr = fs.read_range(url, self._data0 - hlen, hlen, metrics=metrics)
        text = hdr.decode("latin-1")
        if "'<i8'" not in text or "'fortran_order': False" not in text:
            raise IOError(f"unexpected npy layout for ranged reads: {url}")

    def slice(self, i0: int, i1: int) -> np.ndarray:
        n = i1 - i0
        if n <= 0:
            return np.empty(0, np.int64)
        raw = self._fs.read_range(self._url, self._data0 + 8 * i0, 8 * n, metrics=self._metrics)
        if len(raw) != 8 * n:
            raise IOError(f"short sideband read from {self._url}")
        return np.frombuffer(raw, dtype="<i8")


class _RunAccess:
    """One process's spill runs for the budget plane: a local directory
    (memmapped sidecars) or an ``(http_base, token)`` endpoint (ranged
    reads).  Handles are cached a run; bulk data never is.  On the
    compressed plane a run's data file is a member stream addressed in raw
    space by its member table: :meth:`read_into` fetches exactly the
    members covering a span and inflates them; a one-member cache a run
    keeps a boundary member shared by two adjacent windows from being
    fetched (or counted) twice."""

    def __init__(self, source, dstream: DeviceStream, compressed: bool = False):
        self._source = source
        self._cache: dict = {}
        self.compressed = compressed
        self._dstream = dstream
        self._last: dict = {}  # run → (member index, its inflated payload)

    def _handles(self, j: int):
        got = self._cache.get(j)
        if got is not None:
            return got
        metrics = self._dstream.metrics
        if isinstance(self._source, tuple):
            url, token = self._source
            f = HttpFilesystem(headers={"X-Hbam-Token": token})
            stem = f"{url.rstrip('/')}/run-{j:05d}"
            mtab = (np.load(io.BytesIO(f.read_all(stem + _MTAB_SUFFIX, metrics=metrics)))
                    if self.compressed else None)
            got = (_RemoteNpy(f, stem + runs_mod.RUN_KEYS_EXT, metrics),
                   _RemoteNpy(f, stem + runs_mod.RUN_OFFS_EXT, metrics),
                   _RemoteNpy(f, stem + ".org.npy", metrics),
                   (f, stem + runs_mod.RUN_DATA_EXT), mtab)
        else:
            run = runs_mod.Run.open(self._source, j)
            org = np.load(os.path.join(self._source, f"run-{j:05d}.org.npy"), mmap_mode="r")
            mtab = (np.load(os.path.join(self._source, f"run-{j:05d}{_MTAB_SUFFIX}"))
                    if self.compressed else None)
            got = (run.keys, run.offs, org, run.data_path, mtab)
        self._cache[j] = got
        return got

    @staticmethod
    def _sl(arr, i0: int, i1: int) -> np.ndarray:
        if isinstance(arr, _RemoteNpy):
            return arr.slice(i0, i1)
        return np.asarray(arr[i0:i1], dtype=np.int64)

    def slices(self, j: int, i0: int, i1: int):
        """(keys[i0:i1], org[i0:i1], lens, byte_start, byte_len)."""
        keys, offs, org, _, _ = self._handles(j)
        o = self._sl(offs, i0, i1 + 1)
        return self._sl(keys, i0, i1), self._sl(org, i0, i1), np.diff(o), int(o[0]), \
            int(o[-1] - o[0])

    def _read_span(self, loc, start: int, size: int) -> np.ndarray:
        if isinstance(loc, tuple):
            f, url = loc
            data = f.read_range(url, start, size, metrics=self._dstream.metrics)
            if len(data) != size:
                raise IOError(f"short HTTP read from {url}")
            return np.frombuffer(data, np.uint8)
        out = np.empty(size, dtype=np.uint8)
        with open(loc, "rb") as fh:
            fh.seek(start)
            got = fh.readinto(memoryview(out))
        if got != size:
            raise IOError(f"short read from spill run {loc}")
        return out

    def read_into(self, j: int, view, byte_start: int, size: int) -> int:
        """Fill ``view`` with raw bytes [byte_start, byte_start + size) of
        run ``j``; returns the wire bytes newly pulled (``size`` on the raw
        plane; the members fetched, the boundary member once, compressed)."""
        _, _, _, loc, mtab = self._handles(j)
        if not self.compressed:
            view[:] = self._read_span(loc, byte_start, size)
            return size
        m = mtab.reshape(-1, 4)
        m0, m1 = _member_cover(mtab, byte_start, byte_start + size)
        if m1 <= m0:
            return 0
        parts: List[np.ndarray] = []
        wire = 0
        fetch0 = m0
        cached = self._last.get(j)
        if cached is not None and cached[0] == m0:
            parts.append(cached[1])
            fetch0 = m0 + 1
        if fetch0 < m1:
            c0 = int(m[fetch0, 2])
            c1 = int(m[m1 - 1, 2] + m[m1 - 1, 3])
            comp = self._read_span(loc, c0, c1 - c0)
            wire = c1 - c0
            co = np.ascontiguousarray(m[fetch0:m1, 2] - c0, np.int64)
            cs = np.ascontiguousarray(m[fetch0:m1, 3], np.int32)
            us = np.ascontiguousarray(m[fetch0:m1, 1], np.int32)
            with span("mh.byte_shuffle.inflate", registry=self._dstream.metrics, category="stage"):
                raw, roffs = _decode_wire(self._dstream, comp, co, cs, us)
            parts.append(raw)
            # The last member alone, for the next window's seam.
            self._last[j] = (m1 - 1, np.array(raw[int(roffs[-2]) : int(roffs[-1])], copy=True))
        raw_all = parts[0] if len(parts) == 1 else np.concatenate(parts)
        s0 = byte_start - int(m[m0, 0])
        view[:] = raw_all[s0 : s0 + size]
        return wire


def _empty_batch() -> RecordBatch:
    return RecordBatch(soa={"rec_off": np.empty(0, np.int64), "rec_len": np.empty(0, np.int64)},
                       data=np.empty(0, np.uint8), keys=np.empty(0, np.int64))


def _budget_byte_plane(ctx: MultihostContext, td: str, sources: List, n_splits: int,
                       own_counts: List[int], dest_of_record: np.ndarray, level: int, D: int,
                       peak_bytes: int, dstream: DeviceStream,
                       compress: bool = False) -> Tuple[int, List[int]]:
    """The out-of-core byte plane: the key-sorted spill runs are the
    shuffle.  A destination is monotone in the key, so a run's share of
    shard ``g`` is one slice; a [runs, D+1] cut table a process (gathered,
    a few KB) tells every receiver its slices, merged by (key, ordinal) one
    shard at a time, so the peak materialized bytes are one shard's
    output.  Both sides of the byte matrix are measured: the sender's from
    its runs' offsets (and member tables) at the cuts, the receiver's from
    the bytes it read.  Returns ``(peak_bytes, records a local shard)``."""
    metrics = dstream.metrics
    P_ = ctx.num_processes
    L = ctx.local_device_count
    n_runs_of = [sum(1 for k in range(n_splits) if k % P_ == s) for s in range(P_)]
    cuts = np.zeros((max(1, max(n_runs_of)), D + 1), dtype=np.int64)
    rbase = 0
    for j, c in enumerate(own_counts):
        cuts[j] = np.searchsorted(dest_of_record[rbase : rbase + c], np.arange(D + 1),
                                  side="left")
        rbase += c
    cuts_all = ctx.allgather_array(cuts)  # [P, max_runs, D+1]
    own_dir = sources[ctx.process_id]
    sent_bytes = np.zeros(P_, dtype=np.int64)
    sent_raw = np.zeros(P_, dtype=np.int64)
    for j in range(len(own_counts)):
        run = runs_mod.Run.open(own_dir, j)
        mtab_j = (np.load(os.path.join(own_dir, f"run-{j:05d}{_MTAB_SUFFIX}"))
                  if compress else None)
        for q in range(P_):
            i0, i1 = int(cuts[j][q * L]), int(cuts[j][(q + 1) * L])
            raw_b = run.bytes_between(i0, i1)
            sent_raw[q] += raw_b
            if compress:
                b0 = int(run.offs[i0])
                sent_bytes[q] += _cover_comp_bytes(mtab_j, b0, b0 + raw_b)
            else:
                sent_bytes[q] += raw_b
    for q in range(P_):
        metrics.count(f"mh.shuffle.sent.{q}", int(sent_bytes[q]))
        metrics.count(f"mh.shuffle.sent_raw.{q}", int(sent_raw[q]))
    TRACER.counter("mh.shuffle.sent", {str(q): float(sent_bytes[q]) for q in range(P_)})
    ctx.barrier("spill_published", metrics)

    access = [_RunAccess(src, dstream, compressed=compress) for src in sources]
    recv_bytes = np.zeros(P_, dtype=np.int64)
    recv_raw = np.zeros(P_, dtype=np.int64)
    out_counts: List[int] = []
    with span("mh.range_merge", registry=metrics, category="stage"):
        for g in range(ctx.process_id * L, (ctx.process_id + 1) * L):
            # Size every slice first, then read each straight into its
            # place in one buffer.
            slices = []  # (source, run, byte_start, byte_len)
            key_parts, org_parts, len_parts = [], [], []
            for s in range(P_):
                for j in range(n_runs_of[s]):
                    i0, i1 = int(cuts_all[s][j][g]), int(cuts_all[s][j][g + 1])
                    if i1 <= i0:
                        continue
                    keys_s, org_s, lens_s, b0, sz = access[s].slices(j, i0, i1)
                    slices.append((s, j, b0, sz))
                    recv_raw[s] += sz
                    key_parts.append(keys_s)
                    org_parts.append(org_s)
                    len_parts.append(lens_s)
            if slices:
                data = np.empty(sum(sz for _, _, _, sz in slices), dtype=np.uint8)
                pos = 0
                for s, j, b0, sz in slices:
                    recv_bytes[s] += access[s].read_into(j, data[pos : pos + sz], b0, sz)
                    pos += sz
                lens = np.concatenate(len_parts)
                off = np.empty(len(lens) + 1, dtype=np.int64)
                off[0] = 0
                np.cumsum(lens, out=off[1:])
                perm = np.lexsort((np.concatenate(org_parts), np.concatenate(key_parts)))
                # The part writer gathers a permuted copy while ``data``
                # lives: the materialized peak is twice the shard's bytes.
                peak_bytes = max(peak_bytes, 2 * int(len(data)))
                batch = RecordBatch(soa={"rec_off": off[:-1] + 4, "rec_len": lens - 4},
                                    data=data, keys=np.concatenate(key_parts))
            else:
                perm = None
                batch = _empty_batch()
            out_counts.append(int(batch.n_records))
            _promote_part(td, ctx.process_id, g,
                          lambda f, b=batch, o=perm: write_part_fast(f, b, order=o, level=level),
                          first_wins=False)
            del batch
    for s in range(P_):
        metrics.count(f"mh.shuffle.recv.{s}", int(recv_bytes[s]))
        metrics.count(f"mh.shuffle.recv_raw.{s}", int(recv_raw[s]))
    TRACER.counter("mh.shuffle.recv", {str(s): float(recv_bytes[s]) for s in range(P_)})
    ctx.barrier("parts_written", metrics)
    return peak_bytes, out_counts


# ---------------------------------------------------------------------------
# The queryname rank pass, the repartition's splitters, the part promotion.
# ---------------------------------------------------------------------------


def _distributed_name_ranks(ctx: MultihostContext, parts: List[dict], device: torch.device,
                            metrics: MetricsRegistry) -> Tuple[np.ndarray, np.ndarray]:
    """The distributed half of the collation's rank pass: each process
    collates its own splits by name hash on ``device``, verifies every
    bucket against the name bytes, and gathers one name a group; every
    process ranks the union in natural order.  Returns per local record
    (read order) ``(grank, tiebreak)``: the name's global rank (the
    shuffle's primary word, which keeps a name's records on one shard) and
    ``(flag << 32) | (pos + 1)`` (the secondary word; the global read
    ordinal breaks what is left, as the single-process lexsort does)."""
    cols = concat_collation(parts)
    n = len(cols["qh1"])
    col = collate_by_name(cols, candidates=np.zeros(n, np.int32), device=device, metrics=metrics)
    col, _ = verify_and_repair(col, cols, metrics)
    grank, _ = _global_name_rank_pass(ctx, cols, col, metrics)
    tiebreak = (cols["flag"].astype(np.int64) << 32) | (cols["pos"].astype(np.int64) + 1)
    return grank, tiebreak


def _global_name_rank_pass(ctx: MultihostContext, cols: dict, col,
                           metrics: MetricsRegistry) -> Tuple[np.ndarray, int]:
    """Gather every process's group names, rank the union and return
    (each local record's global rank in read order, the distinct names).
    Collective: every process calls it, those with no records too."""
    n = len(cols["qh1"])
    reps = group_representatives(cols, col) if n else []
    blob = np.frombuffer(b"".join(reps), np.uint8) if reps else np.empty(0, np.uint8)
    lens = np.array([len(r) for r in reps], np.int64)
    # Sizes first, so that every process pads to the same widths.
    sizes = ctx.allgather_array(np.array([len(reps), len(blob)], np.int64))
    lens_pad = np.zeros(max(1, int(sizes[:, 0].max())), np.int64)
    lens_pad[: len(lens)] = lens
    blob_pad = np.zeros(max(1, int(sizes[:, 1].max())), np.uint8)
    blob_pad[: len(blob)] = blob
    all_lens = ctx.allgather_array(lens_pad)
    all_blobs = ctx.allgather_array(blob_pad)
    rep_lists = []
    for p in range(ctx.num_processes):
        g = int(sizes[p, 0])
        offs = np.concatenate([[0], np.cumsum(all_lens[p][:g])]).astype(np.int64)
        buf = all_blobs[p].tobytes()
        rep_lists.append([buf[int(offs[i]) : int(offs[i + 1])] for i in range(g)])
    rank = global_name_ranks(rep_lists)
    metrics.count("mh.rank.names", len(rank))
    grank = np.zeros(n, np.int64)
    if n:
        rank_of_group = np.array([rank[r] for r in reps], np.int64)
        grank[col.order] = rank_of_group[col.group]
    return grank, len(rank)


def _reservoir_splitters(ctx: MultihostContext, keys: np.ndarray, n_reservoir: int,
                         n_devices: int, rng: np.random.Generator
                         ) -> Tuple[Optional[Tuple[np.ndarray, np.ndarray]], int]:
    """Re-cut the range splitters from a reservoir of keys: every process
    contributes up to ``n_reservoir`` keys drawn uniformly, the gathered
    pool is sorted and cut at the balanced quantiles.  Returns the
    splitters as ``(hi int32, lo uint32)`` columns (the form
    :class:`~.shuffle.DistributedSort` takes) and the pool's size, or
    ``(None, 0)`` for an empty mesh."""
    n = len(keys)
    take = int(min(n, n_reservoir))
    samp = rng.choice(keys, size=take, replace=False) if 0 < take < n else keys[:take].copy()
    buf = np.full(max(1, n_reservoir), np.iinfo(np.int64).max, np.int64)
    buf[:take] = samp
    counts = ctx.allgather_counts(take)
    allb = ctx.allgather_array(buf)
    pool = np.concatenate([allb[p, : int(counts[p])] for p in range(len(counts))])
    if pool.size == 0:
        return None, 0
    pool.sort()
    cut = np.clip(np.arange(1, n_devices, dtype=np.int64) * len(pool) // n_devices,
                  0, len(pool) - 1)
    return split_keys_np(pool[cut]), int(pool.size)


def _promote_part(td: str, writer_pid: int, g_dev: int, write_fn,
                  first_wins: bool) -> Tuple[bool, int]:
    """Write part ``g_dev`` through a temporary and promote it:
    ``(won, bytes of a losing copy)``.  Without ``first_wins``, a rename
    into place.  With it, the temporary carries the writer's process id and
    the promotion is ``os.link``, the filesystem's compare-and-swap: the
    first copy of the part wins, a later one gets ``FileExistsError``, is
    unlinked and is reported with its size (the speculation's waste).  The
    parts directory must be one filesystem."""
    final = os.path.join(td, f"part-r-{g_dev:05d}")
    if not first_wins:
        _atomic_write(final, write_fn)
        return True, 0
    tmp = os.path.join(td, f"_tmp-h{writer_pid:03d}.part-r-{g_dev:05d}")
    with open(tmp, "wb") as f:
        write_fn(f)
    size = int(os.path.getsize(tmp))
    try:
        os.link(tmp, final)
        won = True
    except FileExistsError:
        won = False
    os.unlink(tmp)
    return won, size


# ---------------------------------------------------------------------------
# Speculative re-execution of a straggler's parts stage.  Route sidecars
# (which source rows feed each part) and done markers (each process's stage
# duration) live in the parts directory, which every process and the merge
# reach.
# ---------------------------------------------------------------------------


def _route_sidecar(td: str, g_dev: int) -> str:
    return os.path.join(td, f"_route-d{g_dev:05d}.npy")


def _write_route_sidecar(td: str, g_dev: int, sd: np.ndarray, sr: np.ndarray) -> None:
    _atomic_write(_route_sidecar(td, g_dev),
                  lambda f: np.save(f, np.stack([sd.astype(np.int64), sr.astype(np.int64)])))


def _done_marker(td: str, pid: int) -> str:
    return os.path.join(td, f"_done-h{pid:03d}.json")


def _write_done_marker(td: str, pid: int, dur_s: float) -> None:
    _atomic_write(_done_marker(td, pid),
                  lambda f: f.write(json.dumps({"pid": pid, "dur_s": dur_s}).encode()))


def _try_read_json(path: str) -> Optional[dict]:
    """A poll loop's read: a marker that is absent, torn or mid-rename
    reads as None."""
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError):
        return None


def _gather_part(fetcher: "_ByteFetcher", sd: np.ndarray, sr: np.ndarray) -> RecordBatch:
    """The records of one part, in its route's order, as a batch for the
    part writer (which uses no keys)."""
    data, rec_off, rec_len = fetcher.gather(sd, sr)
    return RecordBatch(soa={"rec_off": rec_off, "rec_len": rec_len}, data=data,
                       keys=np.zeros(len(rec_off), dtype=np.int64))


def _speculate_stage(ctx: MultihostContext, td: str, sources: List, rows: int,
                     dstream: DeviceStream, compress: bool, fetch_threads: int,
                     errors: Optional[str], target: int, level: int) -> dict:
    """Re-run process ``target``'s fetch and part writes from the byte
    plane: every sender wrote its runs for ``target`` before the
    ``byte_shuffle_written`` barrier, and ``target`` published its routes
    before its writes.  The copy fetches with ``dest_pid=target`` (inflated
    through the job's stream: row 1 on the card) and races the original
    through :func:`_promote_part`.  A route not yet published is skipped."""
    metrics = dstream.metrics
    L = ctx.local_device_count
    plan = faults.ACTIVE
    with span("mh.speculate", registry=metrics, category="stage"):
        metrics.count("mh.speculate.launched", 1)
        fetcher = _ByteFetcher(sources, ctx, rows, dstream, compress=compress,
                               fetch_threads=fetch_threads, errors=errors, dest_pid=target)
        won_parts = wasted = 0
        for g_dev in range(target * L, (target + 1) * L):
            try:
                route = np.load(_route_sidecar(td, g_dev))
            except (OSError, ValueError):
                continue
            batch = _gather_part(fetcher, route[0], route[1])
            if plan is not None:
                plan.mh_speculate_lose(metrics)
            won, size = _promote_part(
                td, ctx.process_id, g_dev,
                lambda f, b=batch: write_part_fast(f, b, order=None, level=level),
                first_wins=True)
            if won:
                won_parts += 1
                metrics.count("mh.speculate.won", 1)
            else:
                wasted += size
                metrics.count("mh.speculate.wasted_bytes", size)
    return {"launched": 1, "target": target, "won_parts": won_parts, "wasted_bytes": wasted}


#: The poll loop's period, seconds.
SPECULATE_POLL_S = 0.05


def _maybe_speculate(ctx: MultihostContext, td: str, sources: List, rows: int,
                     dstream: DeviceStream, compress: bool, fetch_threads: int,
                     errors: Optional[str], factor: float, my_dur: float, level: int) -> dict:
    """The loop every process runs after its own parts: read the done
    markers; once the stage has run longer than ``factor`` times the
    median finished duration, the lowest finished process (one speculator)
    re-runs the first missing process's stage.  Returns when every marker
    is present: the wait the ``parts_written`` barrier imposes anyway.  A
    marker still missing after ``ctx.timeout_s`` (a dead peer) raises
    ``TimeoutError``, as a collective would."""
    P_ = ctx.num_processes
    t0 = time.perf_counter()
    info: dict = {}
    speculated: set = set()
    while True:
        done = {}
        for p in range(P_):
            blob = _try_read_json(_done_marker(td, p))
            if blob is not None:
                done[p] = float(blob.get("dur_s", 0.0))
        missing = [p for p in range(P_) if p not in done]
        if not missing:
            return info
        if time.perf_counter() - t0 > ctx.timeout_s:
            raise TimeoutError(f"speculation: no done marker from processes {missing} after "
                               f"{ctx.timeout_s} s")
        cand = [p for p in missing if p not in speculated]
        if cand and min(done) == ctx.process_id:
            durs = sorted(done.values())
            med = max(durs[len(durs) // 2], 1e-3)
            if my_dur + (time.perf_counter() - t0) > factor * med:
                speculated.add(cand[0])
                got = _speculate_stage(ctx, td, sources, rows, dstream, compress,
                                       fetch_threads, errors, cand[0], level)
                info = {k: v if k == "target" else info.get(k, 0) + v for k, v in got.items()}
        time.sleep(SPECULATE_POLL_S)


# ---------------------------------------------------------------------------
# The mesh trace: a trace shard and a host manifest a process, folded by
# process 0 into the cluster manifest.
# ---------------------------------------------------------------------------

#: This process's host manifest of the last mesh-traced run ({} until one
#: completes): the run manifest, its rows of the byte and key matrices,
#: the barrier waits.
LAST_MANIFEST: dict = {}

#: Process 0 only: the folded cluster manifest of the last mesh-traced run
#: ({} elsewhere); the CLI's ``--metrics`` report carries it.
LAST_CLUSTER_MANIFEST: dict = {}


def _shard_name(pid: int) -> str:
    return f"trace-h{pid:03d}.json"


def _manifest_name(pid: int) -> str:
    return f"manifest-h{pid:03d}.json"


def _read_from_source(source, name: str, metrics: Optional[MetricsRegistry] = None) -> bytes:
    """One flat file of a byte-plane source: a directory, or an ``(url,
    token)`` endpoint read as the ``shufbytes-*`` runs are."""
    if isinstance(source, tuple):
        url, token = source
        f = HttpFilesystem(headers={"X-Hbam-Token": token}, retry_metric="mh.http.fetch_retries")
        return f.read_all(f"{url.rstrip('/')}/{name}", metrics=metrics)
    with open(os.path.join(source, name), "rb") as fh:
        return fh.read()


class _MeshObservability:
    """The mesh trace of one :func:`sort_bam_multihost` call.

    Armed, every process arms the process-wide :data:`TRACER` unless it is
    armed already, stamps its clock right after a ``trace_sync`` barrier
    (the anchors, gathered over the control group, go into each shard's
    ``otherData.mesh`` so that ``tools/mesh_report.py`` can put every shard
    on one timeline), and after its parts exports ``trace-h<pid>.json`` and
    ``manifest-h<pid>.json`` into its byte-plane directory.  Process 0
    fetches every peer's through the byte plane's sources into
    ``trace_dir`` and, after the merge, folds the manifests into
    ``cluster_manifest.json`` and :data:`LAST_CLUSTER_MANIFEST`.  The
    manifests read the job's registry (``metrics``): its counters, spans
    and ``mh.barrier.*`` waits since :meth:`arm`.

    Disarmed, every method returns at once: no barrier, no export, no
    trace event, the same bytes."""

    def __init__(self, ctx: MultihostContext, enabled: bool, trace_dir: str, byte_plane: str,
                 conf, budget: bool, compressed: bool, fetch_threads: int,
                 metrics: MetricsRegistry, device: torch.device):
        self.ctx = ctx
        self.enabled = enabled
        self.trace_dir = trace_dir
        self.byte_plane = byte_plane
        self.conf = conf
        self.budget = budget
        self.compressed = compressed
        self.fetch_threads = fetch_threads
        self.metrics = metrics
        self.device = device
        self._started = False
        self.anchor_us = 0.0
        self.anchors: List[float] = []
        self._peer_manifests: dict = {}
        self._mesh_meta: dict = {}
        self._before: Optional[dict] = None
        #: The skew healing's blocks, set by the sort before :meth:`publish`.
        self.repartition: dict = {}
        self.speculation: dict = {}

    def arm(self) -> None:
        if not self.enabled:
            return
        self._before = snapshot(self.metrics)
        if not TRACER.armed:
            cap = (self.conf.get_int(TRACE_EVENTS, DEFAULT_TRACE_EVENTS) if self.conf is not None
                   else DEFAULT_TRACE_EVENTS)
            TRACER.start(capacity=cap)
            self._started = True
        # Every process leaves this barrier at about one instant: shifting
        # each shard so that the anchors meet aligns the timelines.
        self.ctx.barrier("trace_sync", self.metrics)
        self.anchor_us = float(TRACER.now_us())
        gathered = self.ctx.allgather_array(np.array([self.anchor_us], np.float64))
        self.anchors = [float(a) for a in gathered.reshape(-1)]

    def stage_barrier(self, name: str) -> None:
        """A barrier that measures a stage's skew at a named point (armed
        only)."""
        if self.enabled:
            self.ctx.barrier(name, self.metrics)

    def host_manifest(self, peak_bytes: int, n_local: int, out_counts: List[int],
                      skew_ratio: float) -> dict:
        d = delta(self._before, registry=self.metrics)
        counters = d["counters"]
        spans = d["span_seconds"]

        def edges(prefix: str) -> dict:
            return {k[len(prefix):]: int(v) for k, v in counters.items() if k.startswith(prefix)}

        return {
            "host": self.ctx.process_id,
            "num_processes": self.ctx.num_processes,
            "byte_plane": self.byte_plane,
            "memory_budget": self.budget,
            "peak_bytes": int(peak_bytes),
            "records_local": int(n_local),
            "records_out": [int(c) for c in out_counts],
            "skew_ratio": float(skew_ratio),
            "shuffle_compressed": self.compressed,
            "fetch_threads": int(self.fetch_threads),
            "shuffle_sent_bytes": edges("mh.shuffle.sent."),
            "shuffle_recv_bytes": edges("mh.shuffle.recv."),
            "shuffle_sent_raw_bytes": edges("mh.shuffle.sent_raw."),
            "shuffle_recv_raw_bytes": edges("mh.shuffle.recv_raw."),
            "keys_sent_bytes": edges("mh.keys.sent."),
            "keys_recv_bytes": edges("mh.keys.recv."),
            "barrier_wait_ms": {k[len("mh.barrier."):]: round(v * 1e3, 3)
                                for k, v in spans.items() if k.startswith("mh.barrier.")},
            "http": {k[len("mh.http."):]: int(v) for k, v in counters.items()
                     if k.startswith("mh.http.")},
            "anchor_us": self.anchor_us,
            "repartition": dict(self.repartition),
            "speculation": dict(self.speculation),
            "run_manifest": run_manifest(backend="multihost", conf=self.conf, counters=counters,
                                         device=self.device).as_dict(),
        }

    def publish(self, serve_dir: str, sources: List, peak_bytes: int, n_local: int,
                out_counts: List[int], skew_ratio: float) -> None:
        """Export this process's shard and manifest into ``serve_dir``;
        process 0 then collects every peer's into ``trace_dir``.  Runs
        before the byte-plane directories are removed."""
        if not self.enabled:
            return
        global LAST_MANIFEST
        pid = self.ctx.process_id
        self._mesh_meta = {"mesh": {"host": pid, "num_hosts": self.ctx.num_processes,
                                    "anchor_us": self.anchor_us, "anchors_us": self.anchors,
                                    "byte_plane": self.byte_plane}}
        LAST_MANIFEST = self.host_manifest(peak_bytes, n_local, out_counts, skew_ratio)
        TRACER.export_chrome(os.path.join(serve_dir, _shard_name(pid)), other=self._mesh_meta)
        with open(os.path.join(serve_dir, _manifest_name(pid)), "w") as f:
            json.dump(LAST_MANIFEST, f)
        self.ctx.barrier("trace_published", self.metrics)
        if pid == 0:
            os.makedirs(self.trace_dir, exist_ok=True)
            for s in range(1, self.ctx.num_processes):
                for name in (_shard_name(s), _manifest_name(s)):
                    blob = _read_from_source(sources[s], name, self.metrics)
                    with open(os.path.join(self.trace_dir, name), "wb") as f:
                        f.write(blob)
                self._peer_manifests[s] = json.loads(blob.decode())  # the manifest, read last
        # The peers keep their directories until process 0 has their files.
        self.ctx.barrier("trace_collected", self.metrics)

    def finalize(self, peak_bytes: int, n_local: int, out_counts: List[int],
                 skew_ratio: float) -> None:
        """After the merge: process 0 exports its own shard again (now with
        ``mh.merge``) into ``trace_dir`` and folds the cluster manifest;
        every process stops the tracer that it started."""
        if not self.enabled:
            return
        global LAST_MANIFEST, LAST_CLUSTER_MANIFEST
        try:
            if self.ctx.process_id == 0:
                os.makedirs(self.trace_dir, exist_ok=True)
                own = self.host_manifest(peak_bytes, n_local, out_counts, skew_ratio)
                LAST_MANIFEST = own
                TRACER.export_chrome(os.path.join(self.trace_dir, _shard_name(0)),
                                     other=self._mesh_meta)
                with open(os.path.join(self.trace_dir, _manifest_name(0)), "w") as f:
                    json.dump(own, f)
                manifests = [own] + [self._peer_manifests[s] for s in sorted(self._peer_manifests)]
                LAST_CLUSTER_MANIFEST = cluster_manifest(manifests,
                                                         byte_plane=self.byte_plane).as_dict()
                with open(os.path.join(self.trace_dir, "cluster_manifest.json"), "w") as f:
                    json.dump(LAST_CLUSTER_MANIFEST, f, indent=2, sort_keys=True)
        finally:
            self.close()

    def close(self) -> None:
        """Stop the tracer if this plane started it (once; also the
        failure path's callback)."""
        if self._started:
            self._started = False
            TRACER.stop()


# ---------------------------------------------------------------------------
# The sort.
# ---------------------------------------------------------------------------


def _concat(batches: List[RecordBatch], keys: Optional[np.ndarray] = None) -> RecordBatch:
    """One batch of the record extents and keys of ``batches``."""
    if not batches:
        return _empty_batch()
    base = np.cumsum([0] + [len(b.data) for b in batches[:-1]]).astype(np.int64)
    return RecordBatch(
        soa={"rec_off": np.concatenate([b.soa["rec_off"].astype(np.int64) + base[i]
                                        for i, b in enumerate(batches)]),
             "rec_len": np.concatenate([b.soa["rec_len"].astype(np.int64) for b in batches])},
        data=np.concatenate([b.data for b in batches]),
        keys=keys if keys is not None else np.concatenate([b.keys for b in batches]))


def sort_bam_multihost(
    in_paths: Union[Sequence[str], str],
    out_path: str,
    ctx: Optional[MultihostContext] = None,
    conf=None,
    split_size: int = 32 << 20,
    level: int = 6,
    samples_per_device: int = 64,
    memory_budget: Optional[int] = None,
    byte_plane: str = "fs",
    mesh_trace: Optional[bool] = None,
    mesh_trace_dir: Optional[str] = None,
    errors: Optional[str] = None,
    sort_order: str = "coordinate",
    device: Optional[Union[str, torch.device]] = None,
    metrics: Optional[MetricsRegistry] = None,
) -> int:
    """Sort BAM(s) across every process of ``ctx`` (default
    :func:`initialize` on ``device``: one process over its own mesh).
    Returns the global record count (the same in every process); process
    0 writes the merged output, the record stream of the single-process
    ``sort_bam`` of the input.  Input, output and the parts directory
    beside the output are on a filesystem every process reads.

    ``device`` (default: the first shard of ``ctx``'s mesh; without a
    ``ctx``, the card, which raises when there is none) is the device of
    the job's :class:`~..device_stream.DeviceStream`, whose gates (on by
    default on a card) send the wire's deflate through row 3 and its
    inflate through row 1; pass ``"cpu"`` for their plain versions (gates
    off unless the conf or env arms them).

    ``sort_order`` is "coordinate" or "queryname".  Queryname ranks the
    names across the processes (each collates its own splits, verifies the
    buckets against the name bytes and gathers one name a group; every
    process ranks the union in natural order) and routes by (rank, flag,
    pos); it is in core only (``memory_budget`` raises ``ValueError``).

    ``byte_plane`` "fs" moves record bytes through files under the output's
    directory; "http" through each process's local disk, served over
    token-authenticated HTTP range reads.  ``memory_budget`` (bytes of
    record stream a process) spills each split as a key-sorted run at read
    time and merges each shard's slices of every run at the end: the
    materialized peak (``LAST_STATS["peak_bytes"]``, gauge
    ``mh.peak_bytes``) is about one split or twice one shard's output.

    ``errors`` (default ``hadoopbam.errors``, strict): "salvage"
    quarantines a wire member that arrives corrupt on the in-core fetch
    (``salvage.*``) and writes the surviving records.

    A round whose records a shard pass ``hadoopbam.mesh.skew-bound`` times
    their mean re-cuts its splitters once from a key reservoir
    (``mh.repartition.*``); a bucket overflow then retries once at the
    measured capacity (``mh.shuffle.capacity_retry``).  ``mh.*`` counters
    and gauges go to ``metrics`` (a fresh registry by default).

    ``hadoopbam.mesh.speculate-factor`` (HBAM_MESH_SPECULATE_FACTOR; 0,
    off, by default) arms speculation in core: once a process's parts
    stage has run longer than the factor times the median finished one,
    the lowest finished process re-runs it from the byte plane and the
    first copy of each part wins (``mh.speculate.launched``, ``.won``,
    ``.wasted_bytes``, ``.fetch_bytes``).

    ``mesh_trace`` (default ``hadoopbam.mesh.trace``, then HBAM_MESH_TRACE;
    off) arms the mesh trace: a trace shard and a host manifest a process,
    collected by process 0 into ``mesh_trace_dir`` (default
    ``hadoopbam.mesh.trace-dir``, HBAM_MESH_TRACE_DIR, else
    ``<out_path>.mesh-trace``) with ``cluster_manifest.json``; reduce it
    with ``tools/mesh_report.py``.  A directory alone arms nothing."""
    with contextlib.ExitStack() as stack:
        return _sort_bam_multihost_impl(
            in_paths, out_path, ctx, conf, split_size, level, samples_per_device,
            memory_budget, byte_plane, stack, mesh_trace, mesh_trace_dir, errors, sort_order,
            device, metrics if metrics is not None else MetricsRegistry())


def _sort_bam_multihost_impl(in_paths, out_path: str, ctx: Optional[MultihostContext], conf,
                             split_size: int, level: int, samples_per_device: int,
                             memory_budget: Optional[int], byte_plane: str,
                             stack: contextlib.ExitStack, mesh_trace: Optional[bool],
                             mesh_trace_dir: Optional[str], errors: Optional[str],
                             sort_order: str, device, metrics: MetricsRegistry) -> int:
    if isinstance(in_paths, str):
        in_paths = [in_paths]
    if byte_plane not in ("fs", "http"):
        raise ValueError(f"byte_plane must be 'fs' or 'http': {byte_plane!r}")
    if sort_order not in ("coordinate", "queryname"):
        raise ValueError(f"sort_order must be 'coordinate' or 'queryname': {sort_order!r}")
    queryname = sort_order == "queryname"
    if queryname and memory_budget is not None:
        raise ValueError(
            "sort_order='queryname' is in-core on the mesh: the spill plane's monotone-key cut "
            "tables need keys at read time, and queryname ranks exist only after the "
            "distributed rank pass")
    if ctx is None:
        ctx = initialize(device=device)
    dev = resolve_device(device) if device is not None else ctx.mesh[0]
    if errors is None and conf is not None:
        errors = conf.get(ERRORS_MODE)
    compress = _resolve_shuffle_compress(conf)
    member_bytes = _resolve_member_bytes(conf)
    fetch_threads = _resolve_fetch_threads(conf)
    skew_bound = _resolve_skew_bound(conf)
    spec_factor = _resolve_speculate_factor(conf)
    n_reservoir = _resolve_repartition_samples(conf)
    # The wire's codec seams resolve once, here: every deflate and inflate
    # of the shuffle rides this stream.
    dstream = DeviceStream(dev, conf=conf, metrics=metrics)
    if ctx.mesh.layout is not None:
        ctx.mesh.layout.metrics = metrics  # the key plane's staged bytes
        stack.callback(setattr, ctx.mesh.layout, "metrics", None)
    obs = _MeshObservability(ctx, _resolve_mesh_trace(conf, mesh_trace),
                             _resolve_mesh_trace_dir(conf, mesh_trace_dir, out_path), byte_plane,
                             conf, memory_budget is not None, compress, fetch_threads, metrics,
                             dev)
    obs.arm()
    stack.callback(obs.close)
    if memory_budget is not None:
        # A split inflates as one batch: well under the budget.
        split_size = max(64 << 10, min(split_size, memory_budget // 16))
    fmt = BamInputFormat(conf, metrics)
    header = read_header(in_paths[0], metrics).with_sort_order(sort_order)
    with span("mh.plan", registry=metrics, category="stage"):
        splits = fmt.get_splits(in_paths, split_size=split_size)
    mine = ctx.owned(splits)
    P_ = ctx.num_processes

    out_dir_pre = os.path.dirname(os.path.abspath(out_path)) or "."
    td = os.path.join(out_dir_pre, f"_mh_{os.path.basename(out_path)}.parts")
    shuffle_dir = os.path.join(td, "shuffle")
    spill_dir = os.path.join(shuffle_dir, f"spill-{ctx.process_id:03d}")
    if memory_budget is not None:
        if byte_plane == "http":
            # Spill runs on local disk, served over HTTP; the stack
            # removes them on every outcome.
            spill_dir = tempfile.mkdtemp(prefix="hbam_spill_")
            stack.callback(nio.delete_recursive, spill_dir)
        else:
            os.makedirs(spill_dir, exist_ok=True)

    # The straggler drill's seam: ``exec.*`` directives fire a split with
    # item = this process and attempt = the local split ordinal.
    plan = faults.ACTIVE
    torn = os.path.join(out_dir_pre, f"_mh_torn_{ctx.process_id:03d}.tmp")

    peak_bytes = 0
    if memory_budget is None:
        qn_fields = tuple(dict.fromkeys(SORT_FIELDS + ("l_read_name",)))
        collate_cols: List[dict] = []
        with span("mh.read", registry=metrics, category="stage"):
            batches = []
            for j, s in enumerate(mine):
                if plan is not None:
                    plan.exec_attempt(ctx.process_id, j, torn, metrics)
                with trace_ctx(split=ctx.process_id + j * P_):
                    if queryname:
                        # The name columns now: the rank pass works on
                        # these, never on whole records.
                        b = fmt.read_split(s, fields=qn_fields, with_keys=False)
                        collate_cols.append(collation_columns(b.data, b.soa))
                    else:
                        b = fmt.read_split(s)
                    batches.append(b)
            own_counts = [b.n_records for b in batches]
            local = _concat(batches, np.empty(int(sum(own_counts)), np.int64)
                            if queryname else None)
            del batches
        n_local = local.n_records
    else:
        # Each split spills as a key-sorted run at once; only the sorted
        # key and ordinal columns stay.
        local = None
        own_counts: List[int] = []
        key_cols: List[np.ndarray] = []
        perm_cols: List[np.ndarray] = []
        with span("mh.read_spill", registry=metrics, category="stage"):
            for ri, s in enumerate(mine):
                if plan is not None:
                    plan.exec_attempt(ctx.process_id, ri, torn, metrics)
                with trace_ctx(split=ctx.process_id + ri * P_):
                    b = fmt.read_split(s)
                peak_bytes = max(peak_bytes, int(len(b.data)))
                perm = np.argsort(b.keys, kind="stable")
                if compress:
                    _write_run_compressed(spill_dir, ri, b, perm, dstream, level, member_bytes)
                else:
                    runs_mod.write_run(spill_dir, ri, b, perm)
                key_cols.append(np.ascontiguousarray(b.keys[perm]))
                perm_cols.append(perm.astype(np.int64))
                own_counts.append(b.n_records)
                del b
        n_local = int(sum(own_counts))
    # Armed, the processes align here, so that the read's skew is measured
    # at a named barrier and not blamed on whoever is late to the next
    # collective.
    obs.stage_barrier("read_done")

    # Global record ordinals: every process derives the same exclusive
    # scan over the splits in plan order from the gathered counts; they
    # break key ties as the single-process stable sort does.
    max_owned = max(1, -(-len(splits) // P_))
    cm = np.zeros(max_owned, dtype=np.int64)
    cm[: len(own_counts)] = own_counts
    M = ctx.allgather_array(cm)  # [P, max_owned]
    counts_by_split = np.zeros(max(1, len(splits)), dtype=np.int64)
    for k in range(len(splits)):
        counts_by_split[k] = M[k % P_][k // P_]
    split_base = np.concatenate([[0], np.cumsum(counts_by_split)]).astype(np.int64)
    n_total = int(split_base[len(splits)])
    if n_total >= (1 << 31):
        raise ValueError("record ordinals exceed int32; shard the input further")
    if memory_budget is None:
        orig_local = (np.concatenate([split_base[ctx.process_id + j * P_] + np.arange(c)
                                      for j, c in enumerate(own_counts)]).astype(np.int32)
                      if own_counts else np.empty(0, np.int32))
        if queryname:
            # Queryname keys are the global name ranks.
            with span("mh.rank", registry=metrics, category="stage"):
                keys_local, qn_tiebreak = _distributed_name_ranks(ctx, collate_cols, dev,
                                                                  metrics)
            del collate_cols
        else:
            keys_local = local.keys
    else:
        # Run r's ordinals: its split's base + its sort permutation.
        org_cols = [(split_base[ctx.process_id + j * P_] + perm_cols[j]).astype(np.int64)
                    for j in range(len(own_counts))]
        orig_local = (np.concatenate(org_cols).astype(np.int32) if org_cols
                      else np.empty(0, np.int32))
        keys_local = np.concatenate(key_cols) if key_cols else np.empty(0, np.int64)
        for j, oc in enumerate(org_cols):  # the receivers' merge reads them
            _atomic_write(os.path.join(spill_dir, f"run-{j:05d}.org.npy"),
                          lambda f, a=oc: np.save(f, a))
        del perm_cols, key_cols, org_cols

    counts = M.sum(axis=1)
    L = ctx.local_device_count
    D = ctx.global_device_count
    rows = max(1, -(-int(counts.max()) // L))

    # Local records into local shard slots: a per-process permutation
    # spreads a key-ordered input over the slots, so that no (src, dst)
    # bucket takes a monotone run.
    rng = np.random.default_rng(0x5EED + ctx.process_id)
    slots = rng.permutation(L * rows)[:n_local]
    hi_l = np.full(L * rows, 0x7FFFFFFF, np.int32)
    lo_l = np.full(L * rows, 0xFFFFFFFF, np.uint32)
    val_l = np.zeros(L * rows, dtype=bool)
    org_l = np.full(L * rows, 0x7FFFFFFF, np.int32)
    k_hi, k_lo = split_keys_np(keys_local)
    hi_l[slots] = k_hi
    lo_l[slots] = k_lo
    val_l[slots] = True
    org_l[slots] = orig_local
    extra = {}
    if queryname:
        # The secondary word, (flag, pos + 1), rides as a second key; the
        # global read ordinal breaks the ties left.
        hi2_l = np.full(L * rows, 0x7FFFFFFF, np.int32)
        lo2_l = np.full(L * rows, 0xFFFFFFFF, np.uint32)
        hi2_l[slots], lo2_l[slots] = split_keys_np(qn_tiebreak)
        extra = {"hi2": hi2_l, "lo2": lo2_l}
    row_of_record = slots.astype(np.int64)

    kw = 2 if queryname else 1
    dev_of_slot = np.arange(L * rows, dtype=np.int64) // rows
    cap = None
    splitters = None
    repartitioned = False
    cap_resolved = False
    repart_info: dict = {}
    with span("mh.key_shuffle", registry=metrics, category="stage"):
        while True:
            ds = DistributedSort(ctx.mesh, rows_per_device=rows, capacity_per_pair=cap,
                                 samples_per_device=samples_per_device, key_words=kw,
                                 splitters=splitters)
            res = ds(hi_l, lo_l, val_l, org_l, **extra)
            overflow = int(res.overflow)
            # The post-route census, gathered so that every process branches
            # alike: records a destination shard (what the skew bound
            # judges) and the largest (src, dst) bucket (the capacity a
            # retry needs, measured).
            dest_l = res.dest.cpu().numpy()
            pair = np.zeros((L, D), dtype=np.int64)
            np.add.at(pair, (dev_of_slot[val_l], dest_l[val_l]), 1)
            all_stats = ctx.allgather_array(np.concatenate([pair.sum(axis=0), [pair.max()]]))
            per_dev = all_stats[:, :D].sum(axis=0)
            need = int(all_stats[:, D].max())
            mean = float(per_dev.mean())
            ratio = float(per_dev.max()) / mean if mean > 0 else 0.0
            if repartitioned and "ratio_after" not in repart_info:
                repart_info["ratio_after"] = ratio
                metrics.set_gauge("mh.repartition.ratio_after", ratio)
            skewed = skew_bound > 0 and ratio > skew_bound
            if overflow == 0 and (not skewed or repartitioned):
                break  # balanced, or refreshed once already: the bound is advisory after
            if not repartitioned and skew_bound > 0:
                # Rescue 1: re-cut the splitters from a key reservoir and
                # route again (it removes the imbalance a capacity bump
                # would only make room for).
                repartitioned = True
                splitters, n_pool = _reservoir_splitters(ctx, keys_local, n_reservoir, D, rng)
                repart_info.update(triggered=1, sample_keys=n_pool, ratio_before=ratio)
                metrics.count("mh.repartition.triggered", 1)
                metrics.count("mh.repartition.sample_keys", n_pool)
                metrics.set_gauge("mh.repartition.ratio_before", ratio)
                continue
            if overflow > 0 and not cap_resolved:
                # Rescue 2: one retry at the measured worst bucket.
                cap_resolved = True
                cap = max(16, min(rows, need))
                metrics.count("mh.shuffle.capacity_retry", 1)
                continue
            if overflow > 0:
                raise RuntimeError("shuffle overflow persists after repartition and the "
                                   "measured-capacity retry")
            break  # skewed, but the repartition is disabled
    obs.repartition = repart_info
    metrics.count("mh.records", n_total)

    # The byte plane labels global rows pid*L*rows + slot, right only when
    # this process's shards are the mesh's [pid*L, (pid+1)*L) and every
    # process has L of them: checked, not assumed.
    widths = ctx.allgather_counts(L)
    starts = [(ds.mesh.first_shard + k) * rows for k in range(L)]
    expect = [(ctx.process_id * L + k) * rows for k in range(L)]
    if starts != expect or len(set(widths.tolist())) != 1:
        raise RuntimeError(f"process shards are not mesh-contiguous: shard starts {starts} != "
                           f"{expect}, shards a process {widths.tolist()}")
    dest_of_record = dest_l[row_of_record]

    # The key plane's bytes: rows routed to each process times the sort's
    # row width (21 B, 29 with queryname's second word).
    key_rows = np.bincount(process_of_device(dest_of_record, L), minlength=P_).astype(np.int64)
    key_matrix = ctx.allgather_array(key_rows)  # [P, P]: rows sent s → q
    for q in range(P_):
        metrics.count(f"mh.keys.sent.{q}", int(key_rows[q]) * ds.key_row_bytes)
    for s in range(P_):
        metrics.count(f"mh.keys.recv.{s}",
                      int(key_matrix[s][ctx.process_id]) * ds.key_row_bytes)
    TRACER.counter("mh.keys.sent", {str(q): float(key_rows[q] * ds.key_row_bytes)
                                    for q in range(P_)})

    if ctx.process_id == 0:
        os.makedirs(shuffle_dir, exist_ok=True)
    ctx.barrier("mkdirs", metrics)
    os.makedirs(shuffle_dir, exist_ok=True)

    if memory_budget is None:
        write_dir = shuffle_dir
        if byte_plane == "http":
            write_dir = tempfile.mkdtemp(prefix="hbam_shuf_")
            stack.callback(nio.delete_recursive, write_dir)
        with span("mh.byte_shuffle.write", registry=metrics, category="stage"):
            _write_byte_runs(write_dir, ctx, local, dest_of_record, row_of_record, rows,
                             dstream, compress=compress, member_bytes=member_bytes, level=level)
        if byte_plane == "http":
            sources: List = _start_http_plane(ctx, write_dir, stack, metrics)
        else:
            sources = [shuffle_dir] * P_
        # The input is on disk in destination runs: release it.
        del local, dest_of_record, row_of_record
        ctx.barrier("byte_shuffle_written", metrics)

        # Armed, this stage can be re-run: the routes published below are
        # what a finished peer needs to redo a straggler's gather.
        speculate = spec_factor > 0.0
        out_counts: List[int] = []
        spec_info: dict = {}
        t_parts0 = time.perf_counter()
        with span("mh.byte_shuffle.fetch", registry=metrics, category="stage"):
            v_sh = res.valid.cpu().numpy().reshape(L, -1)
            sd_sh = res.src_dev.cpu().numpy().reshape(L, -1)
            sr_sh = res.src_row.cpu().numpy().reshape(L, -1)
            first = ctx.mesh.first_shard
            if speculate:
                for k in range(L):
                    v = v_sh[k]
                    _write_route_sidecar(td, first + k, sd_sh[k][v], sr_sh[k][v])
            fetcher = _ByteFetcher(sources, ctx, rows, dstream, compress=compress,
                                   fetch_threads=fetch_threads, errors=errors)
            for k in range(L):
                # The parts stage's seam, offset by 1000 from the read's.
                if plan is not None:
                    plan.exec_attempt(ctx.process_id, 1000 + k, torn, metrics)
                v = v_sh[k]
                # Fewer records than routed only under salvage.
                batch = _gather_part(fetcher, sd_sh[k][v], sr_sh[k][v])
                out_counts.append(batch.n_records)
                won, size = _promote_part(
                    td, ctx.process_id, first + k,
                    lambda f, b=batch: write_part_fast(f, b, order=None, level=level),
                    first_wins=speculate)
                if not won:
                    # A speculative copy linked first: the part on disk has
                    # the same bytes, and this copy is the waste.
                    spec_info["lost_parts"] = spec_info.get("lost_parts", 0) + 1
                    spec_info["wasted_bytes"] = spec_info.get("wasted_bytes", 0) + size
                    metrics.count("mh.speculate.wasted_bytes", size)
            del fetcher
        if speculate:
            my_dur = time.perf_counter() - t_parts0
            _write_done_marker(td, ctx.process_id, my_dur)
            # The poll is a barrier over the done markers: timed as one, so
            # that the mesh trace blames its wait on the straggler.
            t_poll = time.perf_counter()
            with span("mh.barrier.parts_done", registry=metrics, category="stage"):
                got = _maybe_speculate(ctx, td, sources, rows, dstream, compress, fetch_threads,
                                       errors, spec_factor, my_dur, level)
            metrics.observe("mh.barrier.parts_done", (time.perf_counter() - t_poll) * 1e3)
            for key, val in got.items():
                spec_info[key] = val if key == "target" else spec_info.get(key, 0) + val
        obs.speculation = spec_info
        ctx.barrier("parts_written", metrics)
        serve_dir = write_dir
        cleanup_dir = write_dir if byte_plane == "http" else None
    else:
        if byte_plane == "http":
            sources = _start_http_plane(ctx, spill_dir, stack, metrics)
        else:
            sources = [os.path.join(shuffle_dir, f"spill-{s:03d}") for s in range(P_)]
        peak_bytes, out_counts = _budget_byte_plane(
            ctx, td, sources, len(splits), own_counts, dest_of_record, level, D, peak_bytes,
            dstream, compress=compress)
        serve_dir = spill_dir
        cleanup_dir = spill_dir if byte_plane == "http" else None

    # The partition skew: output records a shard, gathered so that every
    # process derives the same ratio.
    oc = np.zeros(L, dtype=np.int64)
    oc[: len(out_counts)] = out_counts
    all_oc = ctx.allgather_array(oc).reshape(-1)
    mean_oc = float(all_oc.mean()) if all_oc.size else 0.0
    skew_ratio = float(all_oc.max()) / mean_oc if mean_oc > 0 else 0.0
    metrics.set_gauge("mh.skew_ratio", skew_ratio)
    metrics.set_gauge("mh.peak_bytes", float(peak_bytes))
    LAST_STATS["peak_bytes"] = peak_bytes
    # The trace's files leave through the byte plane, before its
    # directories go.
    obs.publish(serve_dir, sources, peak_bytes, n_local, out_counts, skew_ratio)
    if cleanup_dir is not None:
        # Every process has its share: the outgoing directory goes now
        # (the stack's callback stays the failure path's).
        nio.delete_recursive(cleanup_dir)

    if ctx.process_id == 0:
        with span("mh.merge", registry=metrics, category="stage"):
            nio.write_success(td)
            merge_bam_parts(td, out_path, header)
            nio.delete_recursive(td)
    obs.finalize(peak_bytes, n_local, out_counts, skew_ratio)
    ctx.barrier("merged", metrics)
    return n_total


# ---------------------------------------------------------------------------
# Fixmate across processes.
# ---------------------------------------------------------------------------


def fixmate_bam_multihost(
    in_paths: Union[Sequence[str], str],
    out_path: str,
    ctx: Optional[MultihostContext] = None,
    conf=None,
    split_size: int = 32 << 20,
    level: int = 6,
    errors: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    metrics: Optional[MetricsRegistry] = None,
):
    """Fixmate across every process of ``ctx`` (default :func:`initialize`
    on ``device``): the record stream of the single-process
    ``pipeline.fixmate_bam`` of the input, written by process 0.

    Fixmate keeps the record order, so no record crosses the processes;
    the pairing decision does:

    1. each process reads its round-robin splits on the host and collates
       the names on ``device`` (None: the first shard of ``ctx``'s mesh),
       verified against the name bytes;
    2. the distributed rank pass gives every record its name's global rank;
    3. the candidates a rank are gathered: a local pair survives only when
       its name has exactly two candidates in all, and a rank with one
       candidate here and two in all is a half-open pair, whose
       mate-facing columns (flag, refid, pos, span, the CIGAR ops) are
       gathered over the control group, never whole records;
    4. each process appends the remote mates as virtual rows, runs the
       edit pass over the extended columns and applies it to its own rows;
    5. one part a split, on the host; process 0 merges them under the
       input's header.

    Returns a ``pipeline.FixmateStats`` of mesh-wide counts (the same in
    every process; a pair across processes is counted by the process that
    owns its lower ordinal), backend ``collate-fixmate[mesh]``.  Counts
    ``mh.fixmate.records``, ``.half_open`` and ``.virtual_mates`` into
    ``metrics`` (a fresh registry by default)."""
    from ..pipeline import FixmateStats

    if isinstance(in_paths, str):
        in_paths = [in_paths]
    if ctx is None:
        ctx = initialize(device=device)
    dev = resolve_device(device) if device is not None else ctx.mesh[0]
    metrics = metrics if metrics is not None else MetricsRegistry()
    if errors is None and conf is not None:
        errors = conf.get(ERRORS_MODE)
    fmt = BamInputFormat(conf, metrics)
    header = read_header(in_paths[0], metrics)  # fixmate changes no order
    with span("mh.plan", registry=metrics, category="stage"):
        splits = fmt.get_splits(in_paths, split_size=split_size)
    mine = ctx.owned(splits)
    P_ = ctx.num_processes
    plan = faults.ACTIVE
    out_dir_pre = os.path.dirname(os.path.abspath(out_path)) or "."
    torn = os.path.join(out_dir_pre, f"_mh_torn_{ctx.process_id:03d}.tmp")

    batches: List[RecordBatch] = []
    cols_parts: List[dict] = []
    with span("mh.read", registry=metrics, category="stage"):
        for j, s in enumerate(mine):
            if plan is not None:
                plan.exec_attempt(ctx.process_id, j, torn, metrics)
            with trace_ctx(split=ctx.process_id + j * P_):
                b = fmt.read_split(s, fields=FIXMATE_FIELDS, with_keys=False, errors=errors)
            cols_parts.append(collation_columns(b.data, b.soa, with_cigars=True))
            batches.append(b)
    own_counts = [b.n_records for b in batches]
    row_bases = np.concatenate([[0], np.cumsum(own_counts)]).astype(np.int64)
    n = int(row_bases[-1])

    # Global ordinals (the sort's padded gather): they decide which process
    # counts a pair that straddles two.
    max_owned = max(1, -(-len(splits) // P_))
    cm = np.zeros(max_owned, dtype=np.int64)
    cm[: len(own_counts)] = own_counts
    M = ctx.allgather_array(cm)
    counts_by_split = np.zeros(max(1, len(splits)), dtype=np.int64)
    for k in range(len(splits)):
        counts_by_split[k] = M[k % P_][k // P_]
    split_base = np.concatenate([[0], np.cumsum(counts_by_split)]).astype(np.int64)
    n_total = int(split_base[len(splits)])
    org_local = (np.concatenate([split_base[ctx.process_id + j * P_] + np.arange(c)
                                 for j, c in enumerate(own_counts)]).astype(np.int64)
                 if own_counts else np.empty(0, np.int64))
    metrics.count("mh.fixmate.records", n_total)

    with span("mh.rank", registry=metrics, category="stage"):
        cols = concat_collation(cols_parts)
        cols_parts = []
        col = collate_by_name(cols, device=dev, metrics=metrics)
        col, _ = verify_and_repair(col, cols, metrics)
        rk, n_names = _global_name_rank_pass(ctx, cols, col, metrics)

    with span("mh.fixmate.pair", registry=metrics, category="stage"):
        cand_mask = cols["cand"] != 0
        local_cand = np.bincount(rk[cand_mask], minlength=max(1, n_names)).astype(np.int64)
        global_cand = ctx.allgather_array(local_cand).sum(axis=0)
        # A third candidate on another process breaks a local pair, as a
        # third local one would.
        mate_loc = col.mate.astype(np.int64).copy()
        lp = np.flatnonzero(mate_loc >= 0)
        if len(lp):
            mate_loc[lp[global_cand[rk[lp]] != 2]] = -1
        half_rows = np.flatnonzero(cand_mask & (local_cand[rk] == 1) & (global_cand[rk] == 2))
        n_half = len(half_rows)
        metrics.count("mh.fixmate.half_open", n_half)
        tab = np.zeros((n_half, 7), np.int64)
        if n_half:
            tab[:, 0] = rk[half_rows]
            tab[:, 1] = org_local[half_rows]
            for c, name in enumerate(("flag", "refid", "pos", "span", "n_cig"), start=2):
                tab[:, c] = cols[name][half_rows]
        chunks = [cols["cigs"][int(cols["cig_off"][r]) : int(cols["cig_off"][r])
                               + 4 * int(cols["n_cig"][r])] for r in half_rows]
        blob = np.concatenate(chunks) if chunks else np.empty(0, np.uint8)
        sizes = ctx.allgather_array(np.array([n_half, len(blob)], np.int64))
        tab_pad = np.zeros((max(1, int(sizes[:, 0].max())), 7), np.int64)
        tab_pad[:n_half] = tab
        blob_pad = np.zeros(max(1, int(sizes[:, 1].max())), np.uint8)
        blob_pad[: len(blob)] = blob
        all_tab = ctx.allgather_array(tab_pad)
        all_blob = ctx.allgather_array(blob_pad)

        # Virtual rows: each remote half-open candidate whose rank is one of
        # ours (two candidates in all: exactly one match).
        rank_to_row = {int(rk[r]): int(r) for r in half_rows}
        v_local: List[int] = []
        v_tab: List[np.ndarray] = []
        v_cig: List[np.ndarray] = []
        straddle_owned = 0
        for p in range(P_):
            if p == ctx.process_id:
                continue
            tp = all_tab[p][: int(sizes[p, 0])]
            offs = np.concatenate([[0], np.cumsum(4 * tp[:, 6])]).astype(np.int64)
            for i in range(len(tp)):
                r = rank_to_row.get(int(tp[i, 0]))
                if r is None:
                    continue
                v_local.append(r)
                v_tab.append(tp[i])
                v_cig.append(all_blob[p][int(offs[i]) : int(offs[i + 1])])
                if int(org_local[r]) < int(tp[i, 1]):
                    straddle_owned += 1
        n_virt = len(v_local)
        metrics.count("mh.fixmate.virtual_mates", n_virt)
        vt = np.stack(v_tab) if n_virt else np.zeros((0, 7), np.int64)
        v_cig_off = (np.concatenate([[0], np.cumsum(4 * vt[:, 6])[:-1]]) if n_virt
                     else np.empty(0, np.int64)).astype(np.int64) + len(cols["cigs"])
        cols_ext = {
            "flag": np.concatenate([cols["flag"], vt[:, 2]]).astype(cols["flag"].dtype),
            "refid": np.concatenate([cols["refid"], vt[:, 3]]).astype(np.int32),
            "pos": np.concatenate([cols["pos"], vt[:, 4]]).astype(np.int32),
            "span": np.concatenate([cols["span"], vt[:, 5]]).astype(np.int32),
            "cand": np.concatenate([cols["cand"], np.ones(n_virt, cols["cand"].dtype)]),
            "n_cig": np.concatenate([cols["n_cig"], vt[:, 6]]).astype(np.int32),
            "cig_off": np.concatenate([cols["cig_off"], v_cig_off]).astype(np.int64),
            "cigs": np.concatenate([cols["cigs"]] + v_cig),
        }
        mate_ext = np.concatenate([mate_loc, np.full(n_virt, -1, np.int64)]).astype(np.int32)
        for k, r in enumerate(v_local):
            mate_ext[r] = n + k
            mate_ext[n + k] = r
        n_ext = n + n_virt
        col_ext = Collation(order=np.arange(n_ext, dtype=np.int64),
                            group=np.zeros(n_ext, np.int32), n_groups=0, mate=mate_ext,
                            n_pairs=int((mate_ext >= 0).sum()) // 2)

    with span("mh.fixmate.edits", registry=metrics, category="stage"):
        edits = compute_fixmate_edits(cols_ext, col_ext, metrics)

    # Singletons and orphans are facts of a process's own rows.
    own_pairs = int((mate_loc >= 0).sum()) // 2 + straddle_owned
    singles = int(((cols["flag"] & FLAG_PAIRED) == 0).sum())
    orphans = int((cand_mask & (mate_ext[:n] < 0)).sum())
    totals = ctx.allgather_array(np.array([own_pairs, singles, orphans], np.int64)).sum(axis=0)

    td = os.path.join(out_dir_pre, f"_mh_{os.path.basename(out_path)}.parts")
    if ctx.process_id == 0:
        os.makedirs(td, exist_ok=True)
    ctx.barrier("fixmate_mkdirs", metrics)
    os.makedirs(td, exist_ok=True)
    with span("mh.fixmate.write", registry=metrics, category="stage"):
        for j, b in enumerate(batches):
            patched = apply_fixmate(b, edits, int(row_bases[j]))
            _promote_part(td, ctx.process_id, ctx.process_id + j * P_,
                          lambda f, pb=patched: write_part_fast(f, pb, order=None, level=level),
                          first_wins=False)
    ctx.barrier("fixmate_parts_written", metrics)
    if ctx.process_id == 0:
        with span("mh.merge", registry=metrics, category="stage"):
            nio.write_success(td)
            merge_bam_parts(td, out_path, header)
            nio.delete_recursive(td)
    ctx.barrier("fixmate_merged", metrics)
    return FixmateStats(n_total, len(splits), int(totals[0]), int(totals[1]), int(totals[2]),
                        "collate-fixmate[mesh]", metrics.counters())

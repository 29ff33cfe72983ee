"""BCF record chain: ``csrc/bcf_chain.cu`` and its plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/bcf_chain.py``
(``walk_chain_device``, ``walk_chain_host``, ``walk_chain``).  The walk
emits, per record, its start offset and the six fixed shared words as
int32 columns (:data:`COLUMNS`), plus ``[count, ok]``; validity is framing
only (CHROM range, dictionaries and typed values stay with the host
decoder, ``spec/bcf.py``).

On the card one walk is a map over segments of :data:`SEG` bytes (each
position's segment exit), a compose (exits over groups of segments), a
hop through them from ``start``, a fill and an emit
(``csrc/bcf_chain_core.cuh``): :data:`PHASES`, five CUDA launches a slab
of :data:`SLAB` bytes; :data:`LAUNCHES` counts the walk once.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from ... import _build
from . import LaunchCounter, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("bcf_chain")

#: Column order of the walk after the start offsets.
COLUMNS = ("chrom", "pos", "rlen", "qual_bits", "n_allele_info", "n_fmt_sample")
MIN_SHARED = 24  # the fixed shared fields every record carries
MAX_SHARED = 1 << 24
MAX_INDIV = 1 << 28
MIN_RECORD = 8 + MIN_SHARED
#: The reference's int32 payload domain (``walk_chain_device``): offsets and
#: ``cur + 8 + l_shared + l_indiv`` stay inside int32 below it.  A larger
#: payload goes to the host walk before any launch.
MAX_PAYLOAD = 2**31 - (1 << 29)
#: Bytes a segment of the card's walk.
SEG = 16384
#: Bytes a slab (a multiple of :data:`SEG`): the workspace holds ~6 bytes a
#: position of one slab; a longer window goes slab by slab.
SLAB = 16 << 20
#: The card's phases, in launch order.
PHASES = ("map", "compose", "hop", "fill", "emit")


def capacity(start: int, limit: int) -> int:
    """Records a window can start: at least :data:`MIN_RECORD` bytes apart,
    each with ``pos + 8 <= limit``."""
    return max(0, int(limit) - int(start)) // MIN_RECORD + 1


def _check_args(payload: torch.Tensor, start: int) -> None:
    check_tensor(payload, "payload", torch.uint8)
    if payload.dim() != 1:
        raise ValueError("payload must be one-dimensional")
    if start < 0:
        raise ValueError("start must be >= 0")
    n = payload.numel()
    if n > MAX_PAYLOAD:
        raise ValueError(f"payload of {n} bytes is past the int32 column domain")


def _launch(payload: torch.Tensor, start: int, limit: int, seg: int = SEG, slab: int = SLAB,
            phase_ms=None):
    """One walk on the card in segments of ``seg`` bytes and slabs of
    ``slab``: ``(cols, meta, work, segments)``."""
    n, start, limit = payload.numel(), int(start), int(limit)
    lib = _build.load("bcf_chain")
    plan = (ctypes.c_longlong * 2)()  # workspace bytes, segments
    _build.check(lib.hbt_bcf_chain_plan(n, start, limit, seg, slab, plan), "bcf_chain")
    cap = capacity(start, limit)
    cols = torch.empty((7, cap), dtype=torch.int32, device=payload.device)
    meta = torch.empty(2, dtype=torch.int64, device=payload.device)
    work = torch.empty(plan[0], dtype=torch.uint8, device=payload.device)
    rc = lib.hbt_bcf_chain_walk(
        payload.data_ptr(), n, start, limit, cols.data_ptr(), cap, meta.data_ptr(),
        work.data_ptr(), seg, slab, phase_ms, stream_handle(payload),
    )
    _build.check(rc, "bcf_chain")
    LAUNCHES.add()
    return cols, meta, work, plan[1]


def walk_chain_device(payload: torch.Tensor, start: int, limit: int):
    """Walk the chain over a uint8 payload tensor: ``(cols, meta)``.

    ``cols`` is int32 ``[7, capacity]`` (rows ``[:count]`` live: start
    offset, then :data:`COLUMNS`), ``meta`` int64 ``[count, ok]``.  A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version."""
    _check_args(payload, start)
    if use_plain(payload):
        return walk_chain_plain(payload, start, limit)
    cols, meta, _, _ = _launch(payload, start, limit)
    return cols, meta


def walk_chain_phases(payload: torch.Tensor, start: int, limit: int):
    """One walk on the card with each phase timed by CUDA events: ``(cols,
    meta, info)``, ``info`` holding :data:`PHASES` as ``<phase>_ms`` (summed
    over the slabs), ``segments`` (the window's, from the kernel's plan) and
    ``hops`` (the hop's exit reads, from the device's carry).  It waits for
    the walk.  Counts as a launch."""
    _check_args(payload, start)
    if use_plain(payload):
        raise ValueError("the phases are timed on a CUDA tensor only")
    ms = (ctypes.c_float * len(PHASES))()
    cols, meta, work, segments = _launch(payload, start, limit, phase_ms=ms)
    info = {f"{k}_ms": v for k, v in zip(PHASES, ms)}
    info["segments"] = segments
    info["hops"] = int(work[:32].view(torch.int64)[3])  # Carry{cur, rows, status, hops}
    return cols, meta, info


def walk_chain_host(buf, start: int, limit: int):
    """The host walk (``walk_chain_host`` of the reference): a loop over
    the bytes.  Returns ``(cols, count, ok)`` with ``cols`` int32
    ``[7, count]``."""
    if isinstance(buf, np.ndarray):
        buf = buf.tobytes()
    n_payload = len(buf)
    rows = []
    p, lim = int(start), int(limit)
    ok = True
    unpack_len = struct.Struct("<II").unpack_from
    unpack_fixed = struct.Struct("<IIIIII").unpack_from
    while p + 8 <= lim:
        if p + 8 > n_payload:
            ok = False  # past the payload the lengths read as 0
            break
        l_shared, l_indiv = unpack_len(buf, p)
        if (
            l_shared < MIN_SHARED
            or l_shared >= MAX_SHARED
            or l_indiv >= MAX_INDIV
            or p + 8 + l_shared + l_indiv > n_payload
        ):
            ok = False
            break
        rows.append((p,) + unpack_fixed(buf, p + 8))
        p += 8 + l_shared + l_indiv
    cols = np.asarray(rows, dtype=np.int64).reshape(-1, 7).T
    return cols.astype(np.uint32).view(np.int32), len(rows), ok


def walk_chain_plain(payload: torch.Tensor, start: int, limit: int):
    """The plain version on a CPU tensor, in the kernel's output form."""
    cols_h, count, ok = walk_chain_host(payload.numpy(), start, limit)
    cols = torch.zeros((7, capacity(start, limit)), dtype=torch.int32)
    cols[:, :count] = torch.from_numpy(np.ascontiguousarray(cols_h))
    return cols, torch.tensor([count, int(ok)], dtype=torch.int64)


def walk_chain(payload: torch.Tensor, start: int, limit: int, host=None):
    """The tiered walk of one window: ``(cols, count, ok, tier)``.

    ``cols`` is int32 ``[7, count]``; ``tier`` says which walk answered.
    ``"device"``: the kernel (the plain version for a CPU tensor) walked
    the window cleanly, and ``cols`` lies on the payload's device.
    ``"host"``: the payload is past :data:`MAX_PAYLOAD`, or the kernel
    reported ``ok = 0`` (corrupt or truncated framing), and the host walk
    re-walked the window (``cols`` on the CPU; ``ok`` is its verdict).
    ``host`` is the payload's bytes on the host, when the caller has them.
    A kernel that fails to build or launch raises."""
    if payload.numel() <= MAX_PAYLOAD:
        cols, meta = walk_chain_device(payload, start, limit)
        count, ok = (int(x) for x in meta.cpu())
        if ok:
            return cols[:, :count], count, True, "device"
    if host is None:
        host = payload.cpu().numpy()
    cols_h, count, ok = walk_chain_host(host, start, limit)
    return torch.from_numpy(np.ascontiguousarray(cols_h)), count, ok, "host"

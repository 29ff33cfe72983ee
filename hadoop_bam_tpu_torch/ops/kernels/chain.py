"""BAM record chain: ``csrc/chain.cu`` and its plain versions.

Counterpart of ``hadoop_bam_tpu/ops/pallas/chain.py`` (the record-boundary
walk) and of the key gather ``hadoop_bam_tpu/ops/decode.py _stream_keys``
with ``ops/keys.py make_keys``/``unmapped_mask``.  Offsets are int64, so a
stream is not limited to the reference's 2 GiB int32 domain.

On the card one walk is a map over segments of :data:`SEG` bytes (each
position's segment exit), a compose (exits over groups of segments), a hop
through them from 0, a fill and an emit (``csrc/chain_core.cuh``):
:data:`PHASES`, five CUDA launches a slab of :data:`SLAB` bytes;
:data:`WALK_LAUNCHES` counts the walk once.  :func:`record_chain_keys` has
the emit write the sort keys too, from the bytes it staged for the walk;
:func:`stream_keys` is the same gather standalone.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from ... import _build
from ..keys import make_keys, unmapped_mask
from . import LaunchCounter, check_tensor, stream_handle, use_plain

WALK_LAUNCHES = LaunchCounter("record_chain")
KEYS_LAUNCHES = LaunchCounter("stream_keys")

MIN_BODY = 32  # BAM fixed fields; a smaller size word is corruption
MAX_BODY = 1 << 28
#: Bytes a segment of the card's walk.
SEG = 16384
#: Bytes a slab (a multiple of :data:`SEG`): the workspace holds 8 bytes a
#: position of one slab; a longer stream goes slab by slab.
SLAB = 64 << 20
#: The card's phases, in launch order.
PHASES = ("map", "compose", "hop", "fill", "emit")


def offsets_capacity(n_bytes: int) -> int:
    """Records a stream of ``n_bytes`` can start: each takes >= 36 bytes."""
    return int(n_bytes) // (4 + MIN_BODY) + 1


def _check_args(stream: torch.Tensor, n_bytes: int) -> None:
    check_tensor(stream, "stream", torch.uint8)
    if stream.numel() < n_bytes:
        raise ValueError("stream shorter than n_bytes")


def _launch(stream: torch.Tensor, n_bytes: int, seg: int = SEG, slab: int = SLAB,
            phase_ms=None, n_rows=None):
    """One walk on the card in segments of ``seg`` bytes and slabs of
    ``slab``: ``(offs, meta, work, segments, keys, unmapped)``; with
    ``n_rows``, the emit writes the keys and the unmapped mask of rows
    ``[0, n_rows)`` (else both are None)."""
    n = int(n_bytes)
    lib = _build.load("chain")
    plan = (ctypes.c_longlong * 2)()  # workspace bytes, segments
    _build.check(lib.hbt_chain_plan(n, seg, slab, plan), "record_chain")
    dev = stream.device
    offs = torch.empty(offsets_capacity(n), dtype=torch.int64, device=dev)
    meta = torch.empty(2, dtype=torch.int64, device=dev)
    work = torch.empty(plan[0], dtype=torch.uint8, device=dev)
    keys = unm = None
    if n_rows is not None:
        keys = torch.empty(int(n_rows), dtype=torch.int64, device=dev)
        unm = torch.empty(int(n_rows), dtype=torch.bool, device=dev)
    ptrs = (keys.data_ptr(), unm.data_ptr()) if n_rows else (None, None)
    rc = lib.hbt_chain_walk(
        stream.data_ptr(), n, offs.data_ptr(), meta.data_ptr(), work.data_ptr(), seg, slab,
        *ptrs, int(n_rows or 0), phase_ms, stream_handle(stream),
    )
    _build.check(rc, "record_chain")
    WALK_LAUNCHES.add()
    return offs, meta, work, plan[1], keys, unm


def record_chain(stream: torch.Tensor, n_bytes: int):
    """Walk ``pos += 4 + u32(pos)`` over ``stream[:n_bytes]``.

    Returns ``(offs, meta)``: int64 record offsets (``offs[:count]`` live)
    and int64 ``[count, ok]``.  ``ok`` is 1 when no size word was below 32
    or above 2^28 and the walk ended exactly on ``n_bytes``; bytes at or
    past ``n_bytes`` read as 0.  ``stream`` may be longer than
    ``n_bytes`` (a view into a resident window).  A CUDA tensor launches
    the kernel; a CPU tensor takes the plain version."""
    _check_args(stream, n_bytes)
    if use_plain(stream):
        return record_chain_plain(stream, n_bytes)
    offs, meta = _launch(stream, n_bytes)[:2]
    return offs, meta


def record_chain_keys(stream: torch.Tensor, n_bytes: int, n_rows: int):
    """The walk of :func:`record_chain` with the sort keys of
    :func:`stream_keys`: ``(offs, meta, keys, unmapped)``, the keys and the
    unmapped mask of rows ``[0, n_rows)`` (rows the walk did not reach get
    key 0 and False).  On the card the walk's emit writes them from the
    bytes it staged, in the same launch; a CPU tensor takes the plain
    versions."""
    _check_args(stream, n_bytes)
    if use_plain(stream):
        offs, meta = record_chain_plain(stream, n_bytes)
        return (offs, meta, *stream_keys_plain(stream, n_bytes, offs, meta, n_rows))
    offs, meta, _, _, keys, unm = _launch(stream, n_bytes, n_rows=n_rows)
    return offs, meta, keys, unm


def record_chain_phases(stream: torch.Tensor, n_bytes: int, n_rows=None):
    """One walk on the card with each phase timed by CUDA events: ``(offs,
    meta, info)``, ``info`` holding :data:`PHASES` as ``<phase>_ms`` (summed
    over the slabs), ``segments`` (the stream's, from the kernel's plan) and
    ``hops`` (the hop's exit reads, from the device's carry).  With
    ``n_rows`` the emit writes the keys too.  It waits for the walk.
    Counts as a launch."""
    _check_args(stream, n_bytes)
    if use_plain(stream):
        raise ValueError("the phases are timed on a CUDA tensor only")
    ms = (ctypes.c_float * len(PHASES))()
    offs, meta, work, segments = _launch(stream, n_bytes, phase_ms=ms, n_rows=n_rows)[:4]
    info = {f"{k}_ms": v for k, v in zip(PHASES, ms)}
    info["segments"] = segments
    info["hops"] = int(work[:32].view(torch.int64)[3])  # Carry{cur, rows, status, hops}
    return offs, meta, info


def record_chain_plain(stream: torch.Tensor, n_bytes: int):
    """The plain walk: a loop over the CPU tensor's bytes."""
    a = stream.numpy()
    unpack = struct.Struct("<I").unpack_from
    offs = np.zeros(offsets_capacity(n_bytes), dtype=np.int64)
    cur = count = 0
    err = False
    while cur < n_bytes:
        if cur + 4 <= n_bytes:
            (bs,) = unpack(a, cur)
        else:
            bs = int.from_bytes(a[cur:n_bytes].tobytes(), "little")
        if bs < MIN_BODY or bs > MAX_BODY:
            err = True
            break
        offs[count] = cur
        count += 1
        cur += 4 + bs
    ok = int(not err and cur == n_bytes)
    return torch.from_numpy(offs), torch.tensor([count, ok], dtype=torch.int64)


def stream_keys(
    stream: torch.Tensor,
    n_bytes: int,
    offs: torch.Tensor,
    meta: torch.Tensor,
    n_rows: int,
):
    """Packed int64 sort keys and the unmapped mask of rows ``[0, n_rows)``.

    Row i reads refid/pos/flag at ``offs[i] + 4``.  Keys equal
    ``pack_keys_np(*make_keys(refid, pos, flag, 0))`` of the reference; rows
    the walk did not reach (``i >= meta[0]``) get key 0 and mask False.
    Unmapped rows hold ``INT_MAX << 32`` until the murmur3 hash is patched
    in (:func:`hadoop_bam_tpu_torch.ops.decode.patch_unmapped_keys`)."""
    check_tensor(stream, "stream", torch.uint8)
    check_tensor(offs, "offs", torch.int64)
    check_tensor(meta, "meta", torch.int64)
    if use_plain(stream, offs, meta):
        return stream_keys_plain(stream, n_bytes, offs, meta, n_rows)
    keys = torch.empty(n_rows, dtype=torch.int64, device=stream.device)
    unm = torch.empty(n_rows, dtype=torch.bool, device=stream.device)
    if n_rows == 0:
        return keys, unm
    if offs.numel() < n_rows:
        raise ValueError("offs shorter than n_rows")
    lib = _build.load("chain")
    rc = lib.hbt_stream_keys(
        stream.data_ptr(), int(n_bytes), offs.data_ptr(), meta.data_ptr(),
        int(n_rows), keys.data_ptr(), unm.data_ptr(), stream_handle(stream),
    )
    _build.check(rc, "stream_keys")
    KEYS_LAUNCHES.add()
    return keys, unm


def _le(stream: torch.Tensor, at: torch.Tensor, nbytes: int, n_bytes: int):
    """Little-endian unsigned gather of ``nbytes`` at ``at`` (int64);
    bytes at or past ``n_bytes`` read as 0."""
    idx = at[:, None] + torch.arange(nbytes, device=at.device)
    inb = idx < n_bytes
    b = torch.where(
        inb, stream[idx.clamp(0, max(n_bytes - 1, 0))].to(torch.int64), 0
    )
    shifts = 8 * torch.arange(nbytes, device=at.device)
    return (b << shifts).sum(dim=1)


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """Reinterpret unsigned 32-bit values (in int64) as signed int32."""
    return torch.where(v >= 2**31, v - 2**32, v)


def stream_keys_plain(stream, n_bytes, offs, meta, n_rows):
    """The plain gather in torch ops (runs on any device)."""
    dev = stream.device
    keys = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    unm = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    rows = min(int(meta[0]), n_rows)
    if rows == 0:
        return keys, unm
    body = offs[:rows] + 4
    refid = _as_int32(_le(stream, body, 4, n_bytes))
    pos = _as_int32(_le(stream, body + 4, 4, n_bytes))
    flag = _le(stream, body + 14, 2, n_bytes)
    keys[:rows] = make_keys(refid, pos, flag, torch.zeros_like(pos))
    unm[:rows] = unmapped_mask(refid, pos, flag)
    return keys, unm

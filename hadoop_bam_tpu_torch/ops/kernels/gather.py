"""Sorted record gather with the duplicate-flag patch: ``csrc/write.cu``
(``gather_stream_kernel``, the core in ``csrc/write_core.cuh``) and its
plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/gather_stream.py``
(``gather_stream_device``): a part's records, in sorted order, are copied
out of the resident split payloads into one stream on the device, so the
uncompressed part never visits the host.  :func:`bench_write_marginal` is
the reference's bench probe of the gather and the CRC32 (card only).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ... import _build
from . import LaunchCounter, OutsideInt32Domain, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("gather_stream")

#: SAM FLAG_DUPLICATE, the patch the duplicate-marking write applies.
FLAG_DUPLICATE = 0x400

#: The card's geometry: output bytes a block (a tile, a multiple of 16) and
#: threads a block (``csrc/write.cu``).
TILE = 2048
THREADS = 64


def gather_stream_device(
    stream: torch.Tensor,
    src_starts,
    lens,
    dup_mask: Optional[np.ndarray] = None,
    bits: int = FLAG_DUPLICATE,
) -> Tuple[torch.Tensor, int]:
    """Assemble a permuted record stream on ``stream``'s device.

    Output record r is ``stream[src_starts[r] : + lens[r]]`` (size word +
    body, already in output order), placed back to back; where
    ``dup_mask[r]`` is set, the low and high bytes of ``bits`` are ORed into
    the record's bytes 18 and 19 (the flag field).  ``src_starts``, ``lens``
    and ``dup_mask`` are host columns.  Returns ``(uint8 tensor [total],
    total)``.  A geometry past the reference's int32 domain raises
    :class:`~hadoop_bam_tpu_torch.ops.kernels.OutsideInt32Domain` before
    any launch; a record outside ``stream`` raises ``IndexError``."""
    check_tensor(stream, "stream", torch.uint8)
    src = np.asarray(src_starts, dtype=np.int64)
    ln = np.asarray(lens, dtype=np.int64)
    r = len(src)
    if len(ln) != r:
        raise ValueError("src_starts and lens differ in length")
    if r == 0:
        return torch.empty(0, dtype=torch.uint8, device=stream.device), 0
    if use_plain(stream):
        total = _check(stream, src, ln)
        dm = _marks(dup_mask, r)
        t = torch.from_numpy
        dst = np.cumsum(ln) - ln
        return gather_stream_plain(stream, t(src), t(dst), t(ln.astype(np.int32)),
                                   None if dm is None else t(dm), bits), total
    dev = stream.device
    src_t, ln_t = torch.from_numpy(src).to(dev), torch.from_numpy(ln).to(dev)
    # The checks on the card, one kernel and one read-back: the host never
    # passes over the columns (on a loaded host each pass costs more than
    # the gather).
    lens_t = torch.empty(r, dtype=torch.int32, device=dev)
    stats = torch.tensor([0, -(2**63), 2**63 - 1], dtype=torch.int64).to(dev)
    lib = _build.load("write")
    _build.check(lib.hbt_gather_check(src_t.data_ptr(), ln_t.data_ptr(), r, lens_t.data_ptr(),
                                      stats.data_ptr(), stream_handle(stream)), "gather_check")
    total, end, low = stats.tolist()
    if total >= 2**31 or end >= 2**31:
        raise OutsideInt32Domain("gather geometry outside the int32 domain")
    if low < 0 or end > stream.numel():
        raise IndexError("gather_stream_device: a record lies outside the stream")
    dm = _marks(dup_mask, r)
    if total == 0:
        return torch.empty(0, dtype=torch.uint8, device=dev), 0
    dst_end = torch.cumsum(lens_t, 0, dtype=torch.int32)
    dup_t = None if dm is None else torch.from_numpy(dm.view(np.uint8)).to(dev)
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    tile_first = torch.empty(-(-total // TILE), dtype=torch.int32, device=dev)
    _launch(stream, src_t, lens_t, dst_end, dup_t, bits, out, tile_first)
    LAUNCHES.add()
    return out, total


def _check(stream: torch.Tensor, src: np.ndarray, ln: np.ndarray) -> int:
    """The output's bytes, after the reference's int32-domain gate and the
    bounds check, on host columns."""
    total = int(ln.sum())
    end = int((src + ln).max())
    if total >= 2**31 or end >= 2**31:
        raise OutsideInt32Domain("gather geometry outside the int32 domain")
    if int(src.min()) < 0 or int(ln.min()) < 0 or end > stream.numel():
        raise IndexError("gather_stream_device: a record lies outside the stream")
    return total


def _marks(dup_mask, r: int) -> Optional[np.ndarray]:
    if dup_mask is None:
        return None
    dm = np.asarray(dup_mask, dtype=np.uint8).reshape(-1)
    if dm.size != r:
        raise ValueError("dup_mask differs in length from src_starts")
    return dm != 0


def _columns(src: np.ndarray, ln: np.ndarray, dm: Optional[np.ndarray], device: torch.device):
    """The kernel's columns for host columns, without the wrapper's checks
    (for timing the bare launch): ``(src, lens, dst_end, marks or None)``."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    lens_t = t(np.asarray(ln, np.int64)).to(torch.int32)
    return (t(np.asarray(src, np.int64)), lens_t, torch.cumsum(lens_t, 0, dtype=torch.int32),
            None if dm is None else t((np.asarray(dm).reshape(-1) != 0).view(np.uint8)))


def _launch(stream: torch.Tensor, src: torch.Tensor, lens: torch.Tensor, dst_end: torch.Tensor,
            dup: Optional[torch.Tensor], bits: int, out: torch.Tensor, tile_first: torch.Tensor,
            tile: int = TILE, threads: int = THREADS) -> None:
    """The two passes over columns already on the card: the tile map (int32
    ``tile_first``, one entry a ``tile`` bytes of ``out``), then the gather,
    ``threads`` (32, 64, 128 or 256) a block.  Raises on a launch error."""
    lib = _build.load("write")
    rc = lib.hbt_gather_stream(
        stream.data_ptr(), stream.numel(), src.data_ptr(), lens.data_ptr(), dst_end.data_ptr(),
        None if dup is None else dup.data_ptr(), src.numel(), int(bits), out.data_ptr(),
        out.numel(), tile_first.data_ptr(), tile, threads, stream_handle(stream),
    )
    _build.check(rc, "gather_stream")


def gather_stream_plain(stream, src, dst, lens, dup, bits: int) -> torch.Tensor:
    """The plain version on CPU tensors: one slice per record, joined, then
    the flag bytes of the marked records ORed in."""
    mv = memoryview(stream.numpy())
    s = src.numpy().tolist()
    n = lens.numpy().tolist()
    out = np.frombuffer(
        bytearray(b"".join(mv[a : a + k] for a, k in zip(s, n))), dtype=np.uint8
    )
    if dup is not None:
        mark = dup.numpy() != 0
        d, n = dst.numpy(), lens.numpy()
        out[d[mark & (n > 18)] + 18] |= np.uint8(bits & 0xFF)
        out[d[mark & (n > 19)] + 19] |= np.uint8((bits >> 8) & 0xFF)
    return torch.from_numpy(out)


def bench_write_marginal(n_small: int = 1 << 20, n_big: int = 4 << 20, device=None) -> dict:
    """The write front end's marginal throughput on the card (the sorted
    gather with the flag patch, then the member CRC32s), by the
    reference's two-point fit: one resident stream of 168-byte records,
    two output sizes, each the best of three timed calls after a warm-up
    (host clock, the card synchronised).  Returns ``fixed_ms``,
    ``bytes_per_s``, ``projected_mb_s``, ``t_small_ms`` and ``t_big_ms``."""
    from ...utils.backend import resolve_device
    from .crc32 import crc32_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("bench_write_marginal times the card: pass a CUDA device")
    rng = np.random.default_rng(3)
    rec_len = 168
    n_rec = n_big // rec_len + 1
    stream = torch.from_numpy(rng.integers(0, 256, n_rec * rec_len, dtype=np.uint8)).to(dev)
    src = (rng.permutation(n_rec) * rec_len).astype(np.int64)
    lens = np.full(n_rec, rec_len, dtype=np.int64)
    dup = rng.random(n_rec) < 0.1

    def timed(nbytes: int) -> float:
        k = nbytes // rec_len
        offs = np.arange(0, k * rec_len, 57088, dtype=np.int64)
        mlens = np.minimum(57088, k * rec_len - offs)

        def once():
            out, _ = gather_stream_device(stream, src[:k], lens[:k], dup_mask=dup[:k])
            crc32_device(out, offs, mlens)
            torch.cuda.synchronize(dev)

        once()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            once()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    dt_s = timed(n_small)
    dt_b = timed(n_big)
    per_byte = (dt_b - dt_s) / (n_big - n_small)
    bytes_per_s = 1.0 / per_byte if per_byte > 0 else float("inf")
    return {
        "fixed_ms": (dt_s - per_byte * n_small) * 1e3,
        "bytes_per_s": bytes_per_s,
        "projected_mb_s": bytes_per_s / 1e6,
        "t_small_ms": dt_s * 1e3,
        "t_big_ms": dt_b * 1e3,
    }

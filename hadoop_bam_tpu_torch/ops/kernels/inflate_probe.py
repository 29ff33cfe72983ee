"""The lockstep-walk probe: ``csrc/inflate_probe.cu`` and its plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/inflate_probe.py`` (``make_walk``,
``reference_walk``, ``bench_marginal``): a bench probe of the serial walk
the inflate kernels are built on.  Each of 128 lanes holds a bit cursor
into its own column of a transposed int32 ``[R, 128]`` stream and runs T
waves of: read the two words under the cursor (words outside ``[0, R)``
read as 0), take a 32-bit window, classify it into one of 15 lengths by
range compares, advance the cursor by that length plus the window's low 3
bits and add the window to a checksum (int32 wrap).  It decodes nothing;
its time per wave is the cost of one dependent step of such a walk.

Run ``python -m hadoop_bam_tpu_torch.ops.kernels.inflate_probe`` on a card
for the two-point fit of :func:`bench_marginal`.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ... import _build
from ...utils.backend import resolve_device
from . import LaunchCounter, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("inflate_probe_walk")

LANES = 128


def _check(streams: torch.Tensor, cursors: torch.Tensor, R: int) -> None:
    check_tensor(streams, "streams", torch.int32)
    check_tensor(cursors, "cursors", torch.int32)
    if tuple(streams.shape) != (R, LANES):
        raise ValueError(f"streams must be [{R}, {LANES}]")
    if tuple(cursors.shape) != (1, LANES):
        raise ValueError(f"cursors must be [1, {LANES}]")


def make_walk(R: int, T: int, device: Optional[Union[str, torch.device]] = None
              ) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """``walk(streams, cursors) -> (cur, acc)``: T waves over int32
    ``streams [R, 128]`` from int32 ``cursors [1, 128]``, both on
    ``device`` (default cuda); the results are int32 ``[1, 128]``.  On a
    CUDA device each call launches the kernel (one block of 128 threads, a
    thread a lane); on the CPU it runs the plain version."""
    resolve_device(device)

    def walk(streams: torch.Tensor, cursors: torch.Tensor):
        _check(streams, cursors, R)
        if use_plain(streams, cursors):
            return walk_plain(streams, cursors, T)
        cur = torch.empty((1, LANES), dtype=torch.int32, device=streams.device)
        acc = torch.empty_like(cur)
        lib = _build.load("inflate_probe")
        rc = lib.hbt_inflate_probe_walk(streams.data_ptr(), R, cursors.data_ptr(), T,
                                        cur.data_ptr(), acc.data_ptr(), stream_handle(streams))
        _build.check(rc, "inflate_probe_walk")
        LAUNCHES.add()
        return cur, acc

    return walk


def walk_plain(streams: torch.Tensor, cursors: torch.Tensor, T: int):
    """The plain version: the reference's waves as torch ops over the 128
    lanes, in int64 with the int32 results wrapped at the end."""
    R = streams.shape[0]
    dev = streams.device
    s = streams.long() & 0xFFFFFFFF
    lane = torch.arange(LANES, device=dev)
    c = cursors[0].long()
    a = torch.zeros_like(c)

    def word(widx: torch.Tensor) -> torch.Tensor:
        inside = (widx >= 0) & (widx < R)
        return torch.where(inside, s[widx.clamp(0, R - 1), lane], 0)

    for _ in range(T):
        widx = c >> 5
        w0, w1 = word(widx), word(widx + 1)
        sh = c & 31
        win = torch.where(sh == 0, w0, ((w0 >> sh) | (w1 << (32 - sh))) & 0xFFFFFFFF)
        rev = win & 0x7FFF
        Lsel = torch.full_like(c, 15)
        for L in range(15, 0, -1):
            Lsel = torch.where((rev >> (15 - L)) < ((rev >> 7) & 0x7F) + L, L, Lsel)
        c = c + Lsel + (win & 7)
        a = (a + win) & 0xFFFFFFFF
    wrap = lambda v: (((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)[None, :]
    return wrap(c), wrap(a)


def reference_walk(streams: np.ndarray, cursors: np.ndarray, T: int):
    """NumPy oracle of the probe walk (the reference's own): cursors and
    checksums as int64, the checksum mod 2**32."""
    R = streams.shape[0]
    c = cursors.astype(np.int64).copy()
    a = np.zeros_like(c)
    lane = np.arange(LANES)
    for _ in range(T):
        widx = c >> 5
        in0 = (widx >= 0) & (widx < R)
        in1 = (widx + 1 >= 0) & (widx + 1 < R)
        w0 = np.where(in0, streams[np.clip(widx, 0, R - 1), lane], 0).astype(np.uint32)
        w1 = np.where(in1, streams[np.clip(widx + 1, 0, R - 1), lane], 0).astype(np.uint32)
        sh = (c & 31).astype(np.uint32)
        win = np.where(
            sh == 0, w0, (w0 >> sh) | (w1 << (np.uint32(32) - sh))
        ).astype(np.uint32).astype(np.int32)
        rev = win & 0x7FFF
        Lsel = np.full_like(c, 15)
        for L in range(15, 0, -1):
            cand = rev >> (15 - L)
            match = cand < ((rev >> 7) & 0x7F) + L
            Lsel = np.where(match, L, Lsel)
        c = c + Lsel + (win & 7)
        a = (a + win) & 0xFFFFFFFF
    return c, a


def bench_marginal(R: int = 4096, t_small: int = 32768, t_big: int = 131072,
                   device: Optional[Union[str, torch.device]] = None) -> dict:
    """The walk's marginal cost per wave on the card: each of two launch
    sizes timed with CUDA events over five launches after a warm-up,
    and a line fitted through the two.  Returns ``fixed_ms`` (the line's
    intercept), ``ns_per_wave`` (its slope), ``tokens_per_s`` (128 lanes a
    wave), ``projected_mb_s`` (at 2 output bytes a token), ``t_small_ms``
    and ``t_big_ms``.  A cursor advances 4.5 bits a wave on average, so at
    the defaults it leaves the ``R * 32``-bit stream after ~29,000 waves:
    the slope is then the cost of waves whose words read as 0.  Run it
    with the card otherwise idle."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("bench_marginal times the card: pass a CUDA device")
    rng = np.random.default_rng(0)
    streams = torch.from_numpy(rng.integers(0, 1 << 31, (R, LANES), dtype=np.int32)).to(dev)

    def timed(T: int) -> float:
        walk = make_walk(R, T, dev)
        walk(streams, torch.full((1, LANES), 3, dtype=torch.int32, device=dev))
        cursors = [torch.full((1, LANES), i, dtype=torch.int32, device=dev) for i in range(5)]
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in cursors:
            walk(streams, c)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / len(cursors) / 1e3

    dt_s = timed(t_small)
    dt_b = timed(t_big)
    per_wave = (dt_b - dt_s) / (t_big - t_small)
    tokens_per_s = LANES / per_wave if per_wave > 0 else float("inf")
    return {
        "fixed_ms": (dt_s - per_wave * t_small) * 1e3,
        "ns_per_wave": per_wave * 1e9,
        "tokens_per_s": tokens_per_s,
        "projected_mb_s": 2 * tokens_per_s / 1e6,
        "t_small_ms": dt_s * 1e3,
        "t_big_ms": dt_b * 1e3,
    }


if __name__ == "__main__":
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout.strip() else "no nvidia-smi")
    r = bench_marginal()
    print(f"fixed {r['fixed_ms']:.4f} ms (intercept), marginal {r['ns_per_wave']:.2f} ns/wave "
          f"-> {r['tokens_per_s'] / 1e6:.1f}M tokens/s, ~{r['projected_mb_s']:.1f} MB/s "
          f"walk ceiling (T={32768}: {r['t_small_ms']:.3f} ms, T={131072}: "
          f"{r['t_big_ms']:.3f} ms)")

"""Inflate of literal-only fixed-Huffman members: ``csrc/inflate_fixed.cu``
(+ ``csrc/inflate_fixed_core.cuh``) and its plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/inflate_fixed.py``
(``inflate_fixed_literal``): single-block ``btype=01`` members whose
symbols are literals and one EOB, exactly what ``ops.flate.deflate_fixed``
writes.  A member comes back ``ok = False`` (and a zero row) on a header
other than ``011``, any length code, an EOB ending past ``clens * 8``, or
a byte count other than its ISIZE; bits past a row's ``C`` bytes read as
zero, as in the reference.  The reference's walk is bounded by ``T`` waves
(a power of two at least ``max_isize + 4``); here a member stops at the
round where its literals pass its ISIZE, which decides the same verdict
earlier.  The reference declines launches past its 10 MiB VMEM budget; the
card has no such limit, so every member is decoded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ... import _build
from . import LaunchCounter, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("inflate_fixed_literal")

#: Output rows are this many bytes apart on the card, and input rows are
#: padded to it: the kernel moves 16 bytes at a time.
ROW_ALIGN = 16

#: The card's geometry: bits a segment and threads a block (a member's block
#: reads SEG * THREADS bits a round; ``csrc/inflate_fixed.cu``).
SEG = 512
THREADS = 128

#: The kernel's phases, in the order of its cycle counts (``_launch``'s
#: ``cycles``): the round loads' wait, the segment maps, the two block scans,
#: the emit and its stores, the row's zero tail and verdict.
PHASES = ("wait", "map", "compose", "emit", "finish")


def _symbol_table() -> np.ndarray:
    """For each 9-bit stream window (first bit in bit 0): ``kind << 12 |
    adv << 8 | literal``, kind 0 a literal, 1 the EOB, 2 a length code,
    classified by the fixed code's canonical ranges as the kernel does."""
    tab = np.zeros(512, dtype=np.int64)
    for w in range(512):
        rev = int(f"{w:09b}"[::-1], 2)  # the code's MSB-first value
        c7, c8 = rev >> 2, rev >> 1
        if c7 <= 0x17:  # symbols 256-279
            tab[w] = (1 if c7 == 0 else 2) << 12
        elif 0x30 <= c8 <= 0xBF:  # literals 0-143
            tab[w] = 8 << 8 | (c8 - 0x30)
        elif 0xC0 <= c8 <= 0xC7:  # symbols 280-287
            tab[w] = 2 << 12
        else:  # literals 144-255
            tab[w] = 9 << 8 | (rev - 0x190 + 144)
    return tab


_SYMBOLS = _symbol_table()


def _check(comp: torch.Tensor, clens: torch.Tensor, isizes: torch.Tensor) -> None:
    check_tensor(comp, "comp", torch.uint8)
    if comp.dim() != 2:
        raise ValueError("comp must be [B, C]")
    for name, t in (("clens", clens), ("isizes", isizes)):
        check_tensor(t, name, torch.int32)
        if t.dim() != 1 or t.numel() != comp.shape[0]:
            raise ValueError(f"{name} must be one-dimensional with {comp.shape[0]} entries")
    # The output is [B, max ISIZE]: the reference refuses a negative width,
    # so a batch whose every ISIZE is below 0 raises here, on either route.
    if comp.shape[0] and int(isizes.max()) < 0:
        raise ValueError("inflate_fixed_literal: every ISIZE is below 0 (a negative row width)")


def inflate_fixed_literal(
    comp: torch.Tensor, clens: torch.Tensor, isizes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inflate ``B`` literal-only fixed-Huffman members at once.

    ``comp`` uint8 ``[B, C]`` (member i's stream in row i, zero-padded),
    ``clens``/``isizes`` int32 ``[B]``.  Returns ``(out uint8 [B,
    max_isize], ok bool [B])``: row i holds member i's payload when
    ``ok[i]``, zeros otherwise.  A CUDA tensor launches the kernel (one
    block per member), a CPU tensor takes the plain version."""
    _check(comp, clens, isizes)
    if use_plain(comp, clens, isizes):
        return inflate_fixed_literal_plain(comp, clens, isizes)
    comp, out, ok, max_out = _prepare(comp, isizes)
    _launch(comp, clens, isizes, out, ok)
    return out[:, :max_out], ok


def _prepare(comp: torch.Tensor, isizes: torch.Tensor):
    """The launch's input rows (zero-padded to a multiple of ``ROW_ALIGN``
    bytes, 16-byte aligned) and its outputs, uninitialised: ``(comp, out
    [B, stride], ok [B], max_isize)``."""
    B, C = comp.shape
    max_out = int(isizes.max()) if B else 0
    stride_out = max(ROW_ALIGN, -(-max_out // ROW_ALIGN) * ROW_ALIGN)
    out = torch.empty((B, stride_out), dtype=torch.uint8, device=comp.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp.device)
    if C % ROW_ALIGN:
        comp = torch.nn.functional.pad(comp, (0, ROW_ALIGN - C % ROW_ALIGN))
    elif comp.data_ptr() % ROW_ALIGN:
        comp = comp.clone()
    if comp.shape[1] >= 1 << 28:
        raise ValueError("comp rows past 2**28 bytes")
    return comp, out, ok, max_out


def _launch(comp: torch.Tensor, clens: torch.Tensor, isizes: torch.Tensor, out: torch.Tensor,
            ok: torch.Tensor, seg: int = SEG, threads: int = THREADS,
            cycles: Optional[torch.Tensor] = None) -> None:
    """The kernel over ``_prepare``'s rows and outputs, on the card: ``seg``
    bits a segment (a power of two, 32-1024), ``threads`` (32, 64, 128 or
    256) a block; with ``cycles`` (int64 ``[len(PHASES)]`` on the card), each
    phase's clock cycles summed over the blocks are added to it.  Raises on
    a launch error."""
    B = comp.shape[0]
    if B == 0:
        return
    if cycles is not None and (cycles.dtype != torch.int64 or cycles.numel() != len(PHASES)):
        raise ValueError("cycles must be int64 with one entry a phase")
    lib = _build.load("inflate_fixed")
    rc = lib.hbt_inflate_fixed_literal(
        comp.data_ptr(), comp.shape[1], clens.data_ptr(), isizes.data_ptr(), B,
        out.data_ptr(), out.shape[1], ok.data_ptr(), seg, threads,
        cycles.data_ptr() if cycles is not None else None, stream_handle(comp),
    )
    _build.check(rc, "inflate_fixed_literal")
    LAUNCHES.add()


def inflate_fixed_literal_plain(
    comp: torch.Tensor, clens: torch.Tensor, isizes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the reference's lockstep walk, one token a wave
    across all members, as torch ops."""
    B, C = comp.shape
    dev = comp.device
    max_out = int(isizes.max()) if B else 0
    if B == 0:
        return (torch.zeros((0, max_out), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    data = torch.cat([comp, comp.new_zeros((B, 2))], dim=1).long()
    pairs = data[:, :-1] | (data[:, 1:] << 8)  # 16 stream bits from each byte
    tab = torch.as_tensor(_SYMBOLS, device=dev)
    nbits = clens.long() * 8
    isz = isizes.long()

    def window(cur: torch.Tensor) -> torch.Tensor:
        """The next 9 stream bits at each cursor; zeros past C."""
        w = torch.gather(pairs, 1, (cur >> 3).clamp(max=C)[:, None])[:, 0]
        return (w >> (cur & 7)) & 511

    out = torch.zeros((B, max_out + 1), dtype=torch.uint8, device=dev)  # + a discard column
    ok = (window(torch.zeros(B, dtype=torch.int64, device=dev)) & 7) == 3  # bfinal 1, btype 01
    cur = torch.full((B,), 3, dtype=torch.int64, device=dev)
    count = torch.zeros(B, dtype=torch.int64, device=dev)
    live = ok.clone()
    wave = 0
    while wave % 16 or bool(live.any()):
        e = tab[window(cur)]
        kind = e >> 12
        emits = live & (kind == 0) & (count < isz)  # past ISIZE the count cannot match
        ended = live & ~emits
        # Only an EOB that ends inside the member ends it well.
        ok &= ~ended | ((kind == 1) & (cur + 7 <= nbits))
        out.scatter_(1, torch.where(emits, count, max_out)[:, None], (e & 0xFF).to(torch.uint8)[:, None])
        count += emits
        cur += torch.where(emits, (e >> 8) & 15, 0)
        live = emits
        wave += 1
    ok &= count == isz
    out = out[:, :max_out]
    out[~ok] = 0
    return out, ok

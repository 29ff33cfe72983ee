"""CRAM encoding codecs: bit I/O, the encoding family, rANS 4x8.

Counterpart of ``hadoop_bam_tpu/spec/cram_codecs.py``, whole.  Encoding ids
0 NULL, 1 EXTERNAL, 3 HUFFMAN, 4 BYTE_ARRAY_LEN, 5 BYTE_ARRAY_STOP, 6 BETA,
7 SUBEXP, 9 GAMMA; block compression raw, gzip, bzip2, lzma and the rANS
4x8 order-0/1 codec of CRAM 3.0 (encode, the NumPy lockstep host tier, the
per-byte oracle).  :func:`decompress_batch` sends a container's rANS blocks
through the card's decode kernel (``ops/kernels/rans.py``) when its
stream's gate is armed.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cram import CramError, read_itf8


# ---------------------------------------------------------------------------
# Bit I/O over the core block (MSB first)
# ---------------------------------------------------------------------------


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read_bit(self) -> int:
        byte = self.data[self.pos >> 3]
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


# ---------------------------------------------------------------------------
# Block (de)compression
# ---------------------------------------------------------------------------

METHOD_RAW = 0
METHOD_GZIP = 1
METHOD_BZIP2 = 2
METHOD_LZMA = 3
METHOD_RANS = 4


class CramUnsupportedCodec(CramError):
    """A block names a compression method this reader does not implement
    (CRAM 3.1 rans-Nx16 / adaptive-arith / fqzcomp / name-tok, or an
    unknown id).  Distinguished from :class:`CramError` so the
    ``errors="salvage"`` policy can quarantine the block instead of
    killing the job (see :func:`decompress_batch`)."""


def decompress(method: int, data: bytes, raw_size: int) -> bytes:
    if method == METHOD_RAW:
        return data
    if method == METHOD_GZIP:
        return gzip.decompress(data)
    if method == METHOD_BZIP2:
        return bz2.decompress(data)
    if method == METHOD_LZMA:
        return lzma.decompress(data)
    if method == METHOD_RANS:
        return rans_decode(data, raw_size)
    raise CramUnsupportedCodec(
        f"unsupported CRAM block compression method {method}"
    )


def compress(method: int, data: bytes) -> bytes:
    if method == METHOD_RAW:
        return data
    if method == METHOD_GZIP:
        return gzip.compress(data, 6)
    if method == METHOD_BZIP2:
        return bz2.compress(data)
    if method == METHOD_LZMA:
        return lzma.compress(data)
    if method == METHOD_RANS:
        # The writer is host-side; pay both orders and keep the smaller
        # (order-1's per-context tables win on sequence/quality series,
        # order-0 on short or near-uniform ones).
        o0 = rans_encode(data, order=0)
        o1 = rans_encode(data, order=1)
        return o1 if len(o1) < len(o0) else o0
    raise CramUnsupportedCodec(f"unsupported write compression method {method}")


# ---------------------------------------------------------------------------
# rANS 4x8 (CRAM 3.0): order-0 and order-1 decode
# ---------------------------------------------------------------------------

_RANS_L = 1 << 23
_TF_SHIFT = 12
_TOTFREQ = 1 << _TF_SHIFT


def _read_freq(data: bytes, p: int) -> Tuple[int, int]:
    """Frequency: 1 byte, or 2 bytes when the first has the top bit set."""
    f = data[p]
    p += 1
    if f >= 0x80:
        f = ((f & 0x7F) << 8) | data[p]
        p += 1
    return f, p


def _read_freq_table0(data: bytes, p: int) -> Tuple[List[int], int]:
    """Order-0 table with the sym/RLE layout of rANS_static.c."""
    F = [0] * 256
    sym = data[p]
    p += 1
    rle = 0
    while True:
        F[sym], p = _read_freq(data, p)
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = data[p]
            p += 1
            if nxt == sym + 1:
                rle = data[p]
                p += 1
            sym = nxt
        if sym == 0:
            break
    return F, p


def _cum(F: List[int]) -> Tuple[List[int], bytes]:
    C = [0] * 257
    for i in range(256):
        C[i + 1] = C[i] + F[i]
    lookup = bytearray(_TOTFREQ)
    for s in range(256):
        if F[s]:
            lookup[C[s] : C[s] + F[s]] = bytes([s]) * F[s]
    return C, bytes(lookup)


def rans_decode(data: bytes, raw_size: int) -> bytes:
    """Decode one rANS 4x8 stream (NumPy lockstep tier, scalar-oracle
    rescue).  ``raw_size`` is advisory; the stream header's ``n_out``
    wins, exactly as the original per-byte decoder behaved."""
    if not data:
        if raw_size == 0:
            return b""
        raise CramError("empty rANS stream")
    order = data[0]
    (n_out,) = struct.unpack_from("<I", data, 5)
    p = 9
    if order == 0:
        return _rans_decode0(data, p, n_out)
    if order == 1:
        return _rans_decode1(data, p, n_out)
    raise CramError(f"unknown rANS order {order}")


def rans_decode_py(data: bytes, raw_size: int) -> bytes:
    """The original per-byte Python decoder, kept verbatim as the test
    oracle and the last rescue tier (rANS lanes → NumPy host →
    this)."""
    if not data:
        if raw_size == 0:
            return b""
        raise CramError("empty rANS stream")
    order = data[0]
    (n_out,) = struct.unpack_from("<I", data, 5)
    p = 9
    if order == 0:
        return _rans_decode0_py(data, p, n_out)
    if order == 1:
        return _rans_decode1_py(data, p, n_out)
    raise CramError(f"unknown rANS order {order}")


def _rans_decode0_py(data: bytes, p: int, n_out: int) -> bytes:
    F, p = _read_freq_table0(data, p)
    C, lookup = _cum(F)
    R = list(struct.unpack_from("<4I", data, p))
    p += 16
    out = bytearray(n_out)
    mask = _TOTFREQ - 1
    for i in range(n_out):
        j = i & 3
        m = R[j] & mask
        s = lookup[m]
        out[i] = s
        R[j] = F[s] * (R[j] >> _TF_SHIFT) + m - C[s]
        while R[j] < _RANS_L:
            R[j] = (R[j] << 8) | data[p]
            p += 1
    return bytes(out)


def _rans_decode1_py(data: bytes, p: int, n_out: int) -> bytes:
    # outer table: context symbols with the same RLE layout
    Fs: Dict[int, Tuple[List[int], List[int], bytes]] = {}
    ctx = data[p]
    p += 1
    rle = 0
    while True:
        F, p = _read_freq_table0(data, p)
        C, lookup = _cum(F)
        Fs[ctx] = (F, C, lookup)
        if rle > 0:
            rle -= 1
            ctx += 1
        else:
            nxt = data[p]
            p += 1
            if nxt == ctx + 1:
                rle = data[p]
                p += 1
            ctx = nxt
        if ctx == 0:
            break
    R = list(struct.unpack_from("<4I", data, p))
    p += 16
    out = bytearray(n_out)
    q4 = n_out >> 2
    idx = [0, q4, 2 * q4, 3 * q4]
    last = [0, 0, 0, 0]
    mask = _TOTFREQ - 1
    empty = ([0] * 256, [0] * 257, bytes(_TOTFREQ))
    # stream 3 also covers the remainder tail
    limits = [q4, q4, q4, n_out - 3 * q4]
    done = 0
    step = 0
    while done < 4:
        done = 0
        for j in range(4):
            if step >= limits[j]:
                done += 1
                continue
            F, C, lookup = Fs.get(last[j], empty)
            m = R[j] & mask
            s = lookup[m]
            out[idx[j] + step] = s
            R[j] = F[s] * (R[j] >> _TF_SHIFT) + m - C[s]
            while R[j] < _RANS_L:
                R[j] = (R[j] << 8) | data[p]
                p += 1
            last[j] = s
        step += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# rANS 4x8: stream plans + the NumPy lockstep decoder
# ---------------------------------------------------------------------------
#
# The card's kernel (ops/kernels/rans.py) and the NumPy host tier below
# share one wave model: a global wave counter ``t`` advances all slices in
# lockstep, each wave decoding exactly one byte per slice with state
#
#   j(t) = t & 3            while t < 4*q4v,
#        = 3                afterwards (the order-1 remainder tail),
#
# where ``q4v = n_out >> 2`` for order-1 and ``ceil(n_out/4)`` for
# order-0 (so order-0 never enters the tail and j cycles 0..3 forever).
# Wave order equals output order for order-0; order-1 output position is
# ``pos(t) = (t&3)*q4 + (t>>2)`` in the quarters and ``pos(t) = t`` in
# the tail — a pure host-side de-interleave after decode.  Renormalizing
# reads at most 2 bytes per wave for any stream the encoder invariants
# allow; a slice needing more (corrupt) flips its ok flag and falls to
# the oracle.  The card's kernel writes each byte at its output position
# directly.


class _RansPlan:
    """Host-parsed header of one rANS 4x8 stream: everything except the
    renorm byte payload (the only part the device kernel touches)."""

    __slots__ = ("order", "n_out", "states", "tables", "payload")

    def __init__(self, order, n_out, states, tables, payload):
        self.order = order
        self.n_out = n_out
        self.states = states  # (R0, R1, R2, R3)
        self.tables = tables  # {ctx: (F[256], C[257], lookup bytes)}
        self.payload = payload  # renorm byte stream

    @property
    def q4v(self) -> int:
        if self.order == 1:
            return self.n_out >> 2
        return (self.n_out + 3) >> 2


def _parse_rans_body(data: bytes, p: int, order: int, n_out: int) -> _RansPlan:
    tables: Dict[int, Tuple[List[int], List[int], bytes]] = {}
    if order == 0:
        F, p = _read_freq_table0(data, p)
        C, lookup = _cum(F)
        tables[0] = (F, C, lookup)
    else:
        ctx = data[p]
        p += 1
        rle = 0
        while True:
            F, p = _read_freq_table0(data, p)
            C, lookup = _cum(F)
            tables[ctx] = (F, C, lookup)
            if rle > 0:
                rle -= 1
                ctx += 1
            else:
                nxt = data[p]
                p += 1
                if nxt == ctx + 1:
                    rle = data[p]
                    p += 1
                ctx = nxt
            if ctx == 0:
                break
    states = struct.unpack_from("<4I", data, p)
    p += 16
    return _RansPlan(order, n_out, states, tables, data[p:])


def parse_rans_plan(data: bytes) -> _RansPlan:
    """Parse the header of one rANS 4x8 stream (order byte, sizes,
    frequency tables, initial states) into a :class:`_RansPlan`.  Raises
    :class:`CramError` on truncated or unknown-order streams."""
    if not data:
        return _RansPlan(0, 0, (_RANS_L,) * 4, {0: _EMPTY_TABLE}, b"")
    try:
        order = data[0]
        if order not in (0, 1):
            raise CramError(f"unknown rANS order {order}")
        (n_out,) = struct.unpack_from("<I", data, 5)
        return _parse_rans_body(data, 9, order, n_out)
    except (IndexError, struct.error):
        raise CramError("truncated rANS stream")


_EMPTY_TABLE = ([0] * 256, [0] * 257, bytes(_TOTFREQ))

#: Sub-batch cap for the NumPy tier: ``B * (NC+1)`` dense context slabs
#: of 4 KiB each; 8192 keeps the lookup bank under ~32 MiB.
_NP_BATCH_SLABS = 8192


def _decode_plans_numpy(plans: Sequence[_RansPlan]):
    """Lockstep-wave NumPy decode of many parsed streams at once.

    Returns ``(outs, ok)``: per-slice decoded bytes (wave-order already
    de-interleaved) and a bool vector — ``ok=False`` marks a slice whose
    stream violated the renorm/cursor invariants (corrupt, or a context
    missing from its table); the caller rescues those through the Python
    oracle so behavior stays bit-exact with it on *every* input.  The
    vectorization win scales with the batch width: all slices advance in
    one wave loop, so the per-wave Python overhead amortizes across the
    batch (the shape the tier-down rescue path actually sees)."""
    B = len(plans)
    outs: List[Optional[bytes]] = [None] * B
    ok_all = np.ones(B, dtype=bool)
    if B == 0:
        return outs, ok_all
    # Sub-batch so the dense per-context banks stay bounded.
    start = 0
    while start < B:
        end = start + 1
        slabs = len(plans[start].tables) + 1
        while end < B:
            nxt = max(slabs, len(plans[end].tables) + 1)
            if (end - start + 1) * nxt > _NP_BATCH_SLABS:
                break
            slabs = nxt
            end += 1
        _decode_plan_group(plans[start:end], outs, ok_all, start)
        start = end
    return outs, ok_all


def _decode_plan_group(plans, outs, ok_all, base):
    B = len(plans)
    n_out = np.array([pl.n_out for pl in plans], dtype=np.int64)
    T = int(n_out.max())
    fourq4 = np.array([4 * pl.q4v for pl in plans], dtype=np.int64)
    clen = np.array([len(pl.payload) for pl in plans], dtype=np.int64)
    maxc = int(clen.max()) if B else 0
    data = np.zeros((B, maxc + 1), dtype=np.int64)
    for b, pl in enumerate(plans):
        if pl.payload:
            data[b, : len(pl.payload)] = np.frombuffer(
                pl.payload, dtype=np.uint8
            )
    R = np.array([pl.states for pl in plans], dtype=np.int64)
    nc = max(len(pl.tables) for pl in plans)
    NC = nc + 1  # one zeroed slab for contexts missing from the table
    lookup = np.zeros((B, NC, _TOTFREQ), dtype=np.uint8)
    Fb = np.zeros((B, NC, 256), dtype=np.int64)
    Cb = np.zeros((B, NC, 256), dtype=np.int64)
    ctx_map = np.full((B, 256), NC - 1, dtype=np.int64)
    missing = np.zeros((B, 256), dtype=bool)
    for b, pl in enumerate(plans):
        # Order-0 ignores context: every prior symbol maps to slab 0.
        missing[b, :] = pl.order == 1
        for ci, (ctx, (F, C, lk)) in enumerate(sorted(pl.tables.items())):
            if pl.order == 1:
                ctx_map[b, ctx] = ci
                missing[b, ctx] = False
            else:
                ctx_map[b, :] = ci
            Fb[b, ci, :] = F
            Cb[b, ci, :] = C[:256]
            lookup[b, ci, :] = np.frombuffer(lk, dtype=np.uint8)
    wave = np.zeros((B, max(T, 1)), dtype=np.uint8)
    last = np.zeros((B, 4), dtype=np.int64)
    p = np.zeros(B, dtype=np.int64)
    ok = np.ones(B, dtype=bool)
    ar = np.arange(B)
    for t in range(T):
        active = t < n_out
        j = np.where(t < fourq4, t & 3, 3)
        Rj = R[ar, j]
        ctx_raw = last[ar, j]
        ok &= ~(active & missing[ar, ctx_raw])
        ci = ctx_map[ar, ctx_raw]
        m = Rj & (_TOTFREQ - 1)
        s = lookup[ar, ci, m].astype(np.int64)
        wave[:, t] = np.where(active, s, 0)
        Rn = Fb[ar, ci, s] * (Rj >> _TF_SHIFT) + m - Cb[ar, ci, s]
        for _ in range(2):
            need = active & (Rn < _RANS_L)
            if need.any():
                byte = data[ar, np.minimum(p, maxc)]
                ok &= ~(need & (p >= clen))
                Rn = np.where(need, (Rn << 8) | byte, Rn)
                p = p + need
        ok &= ~(active & (Rn < _RANS_L))
        R[ar, j] = np.where(active, Rn, Rj)
        last[ar, j] = np.where(active, s, ctx_raw)
    for b, pl in enumerate(plans):
        ok_all[base + b] = ok[b]
        if not ok[b]:
            continue
        outs[base + b] = rans_deinterleave(
            wave[b, : pl.n_out], pl.order, pl.n_out
        )


def rans_deinterleave(w: np.ndarray, order: int, n: int) -> bytes:
    """Wave-order bytes → output-order bytes (the NumPy tier's post-pass).
    Order-0 wave order *is* output order; order-1 interleaves the four
    quarters."""
    if order == 0 or n < 4:
        return w.tobytes()
    q4 = n >> 2
    t = np.arange(n)
    pos = np.where(t < 4 * q4, (t & 3) * q4 + (t >> 2), t)
    out = np.empty(n, dtype=np.uint8)
    out[pos] = w
    return out.tobytes()


def _rans_decode0(data: bytes, p: int, n_out: int) -> bytes:
    plan = _parse_rans_body(data, p, 0, n_out)
    outs, ok = _decode_plans_numpy([plan])
    if ok[0]:
        return outs[0]
    return _rans_decode0_py(data, p, n_out)


def _rans_decode1(data: bytes, p: int, n_out: int) -> bytes:
    plan = _parse_rans_body(data, p, 1, n_out)
    outs, ok = _decode_plans_numpy([plan])
    if ok[0]:
        return outs[0]
    return _rans_decode1_py(data, p, n_out)


def rans_decode_batch(
    datas: Sequence[bytes], strict: bool = True
) -> List[Optional[bytes]]:
    """Decode many rANS 4x8 streams through the NumPy lockstep tier,
    rescuing any slice it rejects through the Python oracle.  With
    ``strict=False`` a slice whose oracle decode also fails comes back
    ``None`` instead of raising (the salvage shape)."""
    outs: List[Optional[bytes]] = [None] * len(datas)
    plans = []
    idxs = []
    for i, d in enumerate(datas):
        try:
            plans.append(parse_rans_plan(d))
            idxs.append(i)
        except CramError:
            if strict:
                raise
    got, ok = _decode_plans_numpy(plans)
    for k, i in enumerate(idxs):
        if ok[k]:
            outs[i] = got[k]
    for i, d in enumerate(datas):
        if outs[i] is None:
            try:
                outs[i] = rans_decode_py(d, 0)
            except CORRUPT_ERRORS:
                if strict:
                    raise
    return outs


# ---------------------------------------------------------------------------
# rANS 4x8 encode (order-0 and order-1)
# ---------------------------------------------------------------------------


def _write_freq(f: int) -> bytes:
    if f >= 0x80:
        return bytes([0x80 | (f >> 8), f & 0xFF])
    return bytes([f])


def _norm_freqs(hist: List[int]) -> List[int]:
    """Scale a histogram to total exactly ``_TOTFREQ``; every occurring
    symbol keeps frequency ≥ 1 (a zero would make it undecodable)."""
    total = sum(hist)
    F = [0] * 256
    if total == 0:
        F[0] = _TOTFREQ
        return F
    acc = 0
    for s in range(256):
        if hist[s]:
            F[s] = max(1, (hist[s] * _TOTFREQ) // total)
            acc += F[s]
    # Settle the rounding drift: grow the most frequent symbol, or skim
    # the largest entries down (never below 1) when the min-clamps
    # overshot the budget.
    drift = _TOTFREQ - acc
    if drift >= 0:
        F[max(range(256), key=lambda s: F[s])] += drift
    else:
        while drift < 0:
            top = max(range(256), key=lambda s: F[s])
            take = min(-drift, F[top] - 1)
            if take <= 0:
                raise CramError("rANS frequency normalization failed")
            F[top] -= take
            drift += take
    return F


def _write_freq_table0(F: List[int]) -> bytes:
    """Order-0 table in the sym/RLE layout of :func:`_read_freq_table0`."""
    syms = [s for s in range(256) if F[s] > 0]
    out = bytearray([syms[0]])
    rle = 0
    for i, sym in enumerate(syms):
        out += _write_freq(F[sym])
        if rle > 0:
            rle -= 1
            continue
        nxt = syms[i + 1] if i + 1 < len(syms) else 0
        out.append(nxt)
        if nxt == sym + 1:
            run = 0
            k = i + 1
            while k + 1 < len(syms) and syms[k + 1] == syms[k] + 1:
                run += 1
                k += 1
            out.append(run)
            rle = run
    return bytes(out)


def _rans_enc_table(F: List[int]) -> Tuple[List[int], List[int]]:
    C = [0] * 257
    for i in range(256):
        C[i + 1] = C[i] + F[i]
    return F, C


def _rans_enc_step(R: int, f: int, c: int, emitted: bytearray) -> int:
    x_max = ((_RANS_L >> _TF_SHIFT) << 8) * f
    while R >= x_max:
        emitted.append(R & 0xFF)
        R >>= 8
    return ((R // f) << _TF_SHIFT) + c + (R % f)


def rans_encode(data: bytes, order: int = 0) -> bytes:
    """Encode ``data`` as one rANS 4x8 stream (CRAM 3.0 layout, the
    exact bitstream :func:`rans_decode` and the lanes kernel read).

    Symbols are pushed in reverse so the decoder pops them forward; the
    final four states land in the header.  Order-1 mirrors the decoder's
    quarter split: stream ``j`` owns quarter ``j`` (stream 3 plus the
    remainder tail), each byte conditioned on its predecessor, the four
    quarter-start bytes on context 0."""
    if order not in (0, 1):
        raise CramError(f"unknown rANS order {order}")
    n = len(data)
    if order == 0 or n == 0:
        hist = [0] * 256
        for b in data:
            hist[b] += 1
        F, C = _rans_enc_table(_norm_freqs(hist))
        table = _write_freq_table0(F)
        R = [_RANS_L] * 4
        emitted = bytearray()
        for i in range(n - 1, -1, -1):
            s = data[i]
            R[i & 3] = _rans_enc_step(R[i & 3], F[s], C[s], emitted)
        if order == 1 and n == 0:
            # An empty order-1 stream still carries an outer table with
            # the single context 0 so the shared parser accepts it.
            table = bytes([0]) + table + bytes([0])
        body = table + struct.pack("<4I", *R) + bytes(reversed(emitted))
        return bytes([order]) + struct.pack("<II", len(body), n) + body
    q4 = n >> 2
    idx = [0, q4, 2 * q4, 3 * q4]
    limits = [q4, q4, q4, n - 3 * q4]
    hists: Dict[int, List[int]] = {}
    for j in range(4):
        for step in range(limits[j]):
            pos = idx[j] + step
            ctx = data[pos - 1] if step > 0 else 0
            hists.setdefault(ctx, [0] * 256)[data[pos]] += 1
    tabs = {
        ctx: _rans_enc_table(_norm_freqs(h)) for ctx, h in hists.items()
    }
    # Outer table: contexts ascending, same RLE layout one level up.
    ctxs = sorted(tabs)
    table = bytearray([ctxs[0]])
    rle = 0
    for i, ctx in enumerate(ctxs):
        table += _write_freq_table0(tabs[ctx][0])
        if rle > 0:
            rle -= 1
            continue
        nxt = ctxs[i + 1] if i + 1 < len(ctxs) else 0
        table.append(nxt)
        if nxt == ctx + 1:
            run = 0
            k = i + 1
            while k + 1 < len(ctxs) and ctxs[k + 1] == ctxs[k] + 1:
                run += 1
                k += 1
            table.append(run)
            rle = run
    R = [_RANS_L] * 4
    emitted = bytearray()
    max_step = max(limits)
    for step in range(max_step - 1, -1, -1):
        for j in range(3, -1, -1):
            if step >= limits[j]:
                continue
            pos = idx[j] + step
            ctx = data[pos - 1] if step > 0 else 0
            F, C = tabs[ctx]
            s = data[pos]
            R[j] = _rans_enc_step(R[j], F[s], C[s], emitted)
    body = bytes(table) + struct.pack("<4I", *R) + bytes(reversed(emitted))
    return bytes([1]) + struct.pack("<II", len(body), n) + body


# ---------------------------------------------------------------------------
# Batched block decompression: the codec-tier seam
# ---------------------------------------------------------------------------


class RansTierStats:
    """Tier accounting of rANS blocks: on the card's kernel (``lanes``),
    on the host tiers (``host``), and why each host block left the card."""

    FIELDS = ("lanes", "host", "tierdown_size", "tierdown_vmem", "tierdown_ctx",
              "tierdown_format", "tierdown_ok0")

    def __init__(self):
        self.lanes = 0          # blocks decoded by the card's kernel
        self.host = 0           # blocks decoded by the host tiers
        self.tierdown_size = 0
        self.tierdown_vmem = 0
        self.tierdown_ctx = 0
        self.tierdown_format = 0
        self.tierdown_ok0 = 0

    def lanes_hit_rate(self) -> float:
        total = self.lanes + self.host
        return self.lanes / total if total else 0.0

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.FIELDS}


#: What a host codec raises on a corrupt payload (``errors="salvage"``
#: quarantines the block on these).
CORRUPT_ERRORS = (OSError, EOFError, ValueError, IndexError, struct.error, zlib.error,
                  lzma.LZMAError)


def decompress_batch(
    blocks: Sequence[Tuple[int, bytes, int]],
    *,
    errors: str = "strict",
    stream=None,
) -> List[Optional[bytes]]:
    """Decompress a container's blocks as one batch.

    ``blocks`` is a sequence of ``(method, payload, raw_size)`` triples.
    With a :class:`~hadoop_bam_tpu_torch.device_stream.DeviceStream` whose
    gate is armed (``stream.policy.use_rans_lanes``), the non-empty rANS 4x8
    blocks decode in one launch of the card's kernel on
    the stream's device; a block it declines or flags (``ok = 0``) is
    decoded again by the NumPy host tier, then the Python oracle.  Without
    a stream, or disarmed, they take the host tiers.  Other methods decode
    on the host.

    ``errors="strict"`` raises on the first undecodable block; ``"salvage"``
    returns ``None`` for it and counts ``cram.codec.unsupported`` /
    ``cram.codec.corrupt``.  ``cram.rans.*`` counters move only when the
    gate is armed (the tiers of :class:`RansTierStats`).  Counters go to the
    stream's metrics.  A kernel that fails to build or launch raises."""
    metrics = stream.metrics if stream is not None else None

    def count(name: str, n: int = 1) -> None:
        if metrics is not None and n:
            metrics.count(name, n)

    results: List[Optional[bytes]] = [None] * len(blocks)
    rans_idx = [
        i
        for i, (method, data, _raw) in enumerate(blocks)
        if method == METHOD_RANS and data
    ]
    rans_set = set(rans_idx)
    for i, (method, data, raw_size) in enumerate(blocks):
        if i in rans_set:
            continue
        try:
            results[i] = decompress(method, data, raw_size)
        except CramUnsupportedCodec:
            if errors != "salvage":
                raise
            count("cram.codec.unsupported")
        except CORRUPT_ERRORS:
            if errors != "salvage":
                raise
            count("cram.codec.corrupt")
    if not rans_idx:
        return results
    use_lanes = stream is not None and stream.policy.use_rans_lanes
    datas = [blocks[i][1] for i in rans_idx]
    outs: List[Optional[bytes]] = [None] * len(datas)
    if use_lanes:
        from ..ops.kernels import rans as _kr

        outs, stats = _kr.rans_lanes(datas, stream.device, metrics=metrics)
        stats.host = sum(1 for o in outs if o is None)
        count("cram.rans.lanes_slices", stats.lanes)
        count("cram.rans.host_slices", stats.host)
        for reason in ("size", "vmem", "ctx", "format", "ok0"):
            count(f"cram.rans.tierdown.{reason}", getattr(stats, f"tierdown_{reason}"))
    pend = [k for k, o in enumerate(outs) if o is None]
    if pend:
        rescued = rans_decode_batch(
            [datas[k] for k in pend], strict=(errors != "salvage")
        )
        for k, out in zip(pend, rescued):
            outs[k] = out
            if out is None:
                count("cram.codec.corrupt")
    for k, i in enumerate(rans_idx):
        results[i] = outs[k]
    return results


# ---------------------------------------------------------------------------
# Encoding family
# ---------------------------------------------------------------------------

ENC_NULL = 0
ENC_EXTERNAL = 1
ENC_GOLOMB = 2
ENC_HUFFMAN = 3
ENC_BYTE_ARRAY_LEN = 4
ENC_BYTE_ARRAY_STOP = 5
ENC_BETA = 6
ENC_SUBEXP = 7
ENC_GOLOMB_RICE = 8
ENC_GAMMA = 9


class ExternalStream:
    """One external block's payload with a read cursor."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read_bytes(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise CramError("external stream exhausted")
        self.pos += n
        return b

    def read_itf8(self) -> int:
        v, self.pos = read_itf8(self.data, self.pos)
        return v

    def read_until(self, stop: int) -> bytes:
        i = self.data.index(bytes([stop]), self.pos)
        out = self.data[self.pos : i]
        self.pos = i + 1
        return out


class DecodeContext:
    """Core bit stream + external streams for one slice."""

    def __init__(self, core: bytes, external: Dict[int, bytes]):
        self.core = BitReader(core)
        self.external = {k: ExternalStream(v) for k, v in external.items()}

    def stream(self, cid: int) -> ExternalStream:
        try:
            return self.external[cid]
        except KeyError:
            raise CramError(f"missing external block {cid}")


def parse_encoding(buf: bytes, pos: int) -> Tuple["Encoding", int]:
    codec, pos = read_itf8(buf, pos)
    nparams, pos = read_itf8(buf, pos)
    params = buf[pos : pos + nparams]
    pos += nparams
    return Encoding(codec, bytes(params)), pos


class Encoding:
    """One parsed encoding: decodes ints or byte arrays from a context."""

    def __init__(self, codec: int, params: bytes):
        self.codec = codec
        self.params = params
        self._parse()

    def _parse(self) -> None:
        p = self.params
        c = self.codec
        if c == ENC_EXTERNAL:
            self.content_id, _ = read_itf8(p, 0)
        elif c == ENC_HUFFMAN:
            n, q = read_itf8(p, 0)
            self.symbols = []
            for _ in range(n):
                v, q = read_itf8(p, q)
                self.symbols.append(v)
            m, q = read_itf8(p, q)
            self.lengths = []
            for _ in range(m):
                v, q = read_itf8(p, q)
                self.lengths.append(v)
            self._build_huffman()
        elif c == ENC_BYTE_ARRAY_LEN:
            self.len_enc, q = parse_encoding(p, 0)
            self.val_enc, _ = parse_encoding(p, q)
        elif c == ENC_BYTE_ARRAY_STOP:
            self.stop = p[0]
            self.content_id, _ = read_itf8(p, 1)
        elif c == ENC_BETA:
            self.offset, q = read_itf8(p, 0)
            self.nbits, _ = read_itf8(p, q)
        elif c == ENC_SUBEXP:
            self.offset, q = read_itf8(p, 0)
            self.k, _ = read_itf8(p, q)
        elif c == ENC_GAMMA:
            self.offset, _ = read_itf8(p, 0)
        elif c == ENC_GOLOMB or c == ENC_GOLOMB_RICE:
            self.offset, q = read_itf8(p, 0)
            self.m, _ = read_itf8(p, q)
        elif c == ENC_NULL:
            pass
        else:
            raise CramError(f"unsupported encoding id {c}")

    def _build_huffman(self) -> None:
        # canonical codes: sort by (length, symbol)
        pairs = sorted(zip(self.lengths, self.symbols))
        self._codes: Dict[Tuple[int, int], int] = {}
        code = 0
        prev_len = 0
        for ln, sym in pairs:
            code <<= ln - prev_len
            prev_len = ln
            self._codes[(ln, code)] = sym
            code += 1
        self._zero_bit = len(pairs) == 1 and pairs[0][0] == 0
        self._single = pairs[0][1] if self._zero_bit else None
        self._max_len = max(self.lengths) if self.lengths else 0

    # -- int decode ----------------------------------------------------------

    def read_int(self, ctx: DecodeContext) -> int:
        c = self.codec
        if c == ENC_EXTERNAL:
            return ctx.stream(self.content_id).read_itf8()
        if c == ENC_HUFFMAN:
            if self._zero_bit:
                return self._single  # type: ignore[return-value]
            code = 0
            ln = 0
            while ln <= self._max_len:
                code = (code << 1) | ctx.core.read_bit()
                ln += 1
                sym = self._codes.get((ln, code))
                if sym is not None:
                    return sym
            raise CramError("bad huffman code")
        if c == ENC_BETA:
            return ctx.core.read_bits(self.nbits) - self.offset
        if c == ENC_GAMMA:
            n = 0
            while ctx.core.read_bit() == 0:
                n += 1
            v = 1
            for _ in range(n):
                v = (v << 1) | ctx.core.read_bit()
            return v - self.offset
        if c == ENC_SUBEXP:
            n = 0
            while ctx.core.read_bit() == 1:
                n += 1
            if n == 0:
                v = ctx.core.read_bits(self.k)
            else:
                v = (1 << (self.k + n - 1)) | ctx.core.read_bits(
                    self.k + n - 1
                )
            return v - self.offset
        raise CramError(f"encoding {c} cannot decode ints")

    # -- byte decode ---------------------------------------------------------

    def read_byte(self, ctx: DecodeContext) -> int:
        c = self.codec
        if c == ENC_EXTERNAL:
            return ctx.stream(self.content_id).read_byte()
        if c in (ENC_HUFFMAN, ENC_BETA, ENC_GAMMA, ENC_SUBEXP):
            return self.read_int(ctx)
        raise CramError(f"encoding {c} cannot decode bytes")

    def read_byte_run(self, ctx: DecodeContext, n: int) -> bytes:
        """``n`` consecutive bytes of this series in one call.

        The hot byte series (QS qualities, BA bases) are EXTERNAL in
        practice — one stream slice instead of n Python calls; a
        zero-bit Huffman constant is one repeat.  Other codecs keep the
        per-byte loop (bit-level state)."""
        if n <= 0:
            return b""
        c = self.codec
        if c == ENC_EXTERNAL:
            return ctx.stream(self.content_id).read_bytes(n)
        if c == ENC_HUFFMAN and self._zero_bit:
            return bytes([self._single]) * n  # type: ignore[list-item]
        return bytes(self.read_byte(ctx) for _ in range(n))

    def read_bytes(self, ctx: DecodeContext, n: Optional[int] = None) -> bytes:
        c = self.codec
        if c == ENC_BYTE_ARRAY_STOP:
            return ctx.stream(self.content_id).read_until(self.stop)
        if c == ENC_BYTE_ARRAY_LEN:
            ln = self.len_enc.read_int(ctx)
            if self.val_enc.codec == ENC_EXTERNAL:
                return ctx.stream(self.val_enc.content_id).read_bytes(ln)
            return bytes(self.val_enc.read_byte(ctx) for _ in range(ln))
        if c == ENC_EXTERNAL:
            if n is None:
                raise CramError("EXTERNAL byte array needs explicit length")
            return ctx.stream(self.content_id).read_bytes(n)
        raise CramError(f"encoding {c} cannot decode byte arrays")


# ---------------------------------------------------------------------------
# Encoding builders (write side)
# ---------------------------------------------------------------------------


def encoding_external(content_id: int) -> bytes:
    from .cram import write_itf8

    params = write_itf8(content_id)
    return write_itf8(ENC_EXTERNAL) + write_itf8(len(params)) + params


def encoding_byte_array_stop(stop: int, content_id: int) -> bytes:
    from .cram import write_itf8

    params = bytes([stop]) + write_itf8(content_id)
    return write_itf8(ENC_BYTE_ARRAY_STOP) + write_itf8(len(params)) + params


def encoding_byte_array_len_external(len_id: int, val_id: int) -> bytes:
    from .cram import write_itf8

    nested_len = encoding_external(len_id)
    nested_val = encoding_external(val_id)
    params = nested_len + nested_val
    return write_itf8(ENC_BYTE_ARRAY_LEN) + write_itf8(len(params)) + params



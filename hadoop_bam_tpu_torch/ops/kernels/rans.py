"""rANS 4x8 decode: ``csrc/rans.cu`` and its plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/rans_lanes.py`` (``rans_lanes``,
``accepts``, ``stream_geometry``) with the host post-pass
``rans_deinterleave`` folded into the kernel: every stream of a batch is
decoded in one launch, straight into output order, beside a per-stream
``ok`` verdict.

The batch goes up as flat tensors (:func:`pack`): the streams' renorm
payloads, each at a 16-byte boundary and the last followed by
:data:`PAY_SLACK` zero bytes (the kernel copies them in 16-byte units and
reads ahead of its cursor), int64 ``meta`` rows (payload offset, clen, output
offset, n_out, order, the four initial states), the dense per-context
tables (a 4,096-byte slot -> symbol ``lookup`` row and a ``fc`` row of
``C << 16 | F`` per symbol, one slab per context) and an int32 ``cmap``
of context -> slab per stream (-1 for an absent order-1 context).

The tier taxonomy is the reference's (``RansTierStats``), but the card
has no VMEM: ``ctx`` and ``vmem`` never bind here (:func:`accepts` and
:func:`stream_geometry` are kept as the reference's functions, and the
tier does not consult them), ``size`` is only an ``n_out`` past the int32
output domain, ``format`` is a stream whose header does not parse or
whose frequencies pass 4,096, and ``ok0`` is the kernel's verdict.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import _build
from ...spec import cram_codecs as cc
from . import LaunchCounter, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("rans")

LANES = 128
_RANS_L = 1 << 23
_TF_SHIFT = 12
_TOTFREQ = 1 << _TF_SHIFT
#: The reference's VMEM-era gates (kept for :func:`accepts`).
_VMEM_BUDGET_BYTES = 14 << 20
_MAX_OSIZE = 1 << 20
_NC_CAP = 32
_DEFAULT_CHUNK = 1024
_ST_ROWS = 16
_META_ROWS = 8

#: The output domain of one stream: n_out past it tiers down as ``size``.
MAX_OUT = 2**31 - 1
META_COLS = 9  # pay_off, clen, out_off, n_out, order, R0..R3
_ALIGN = 16  # each stream's output region and payload start 16-aligned
#: Zero bytes past the last payload: what the kernel may read past a
#: stream's payload, rounded up to 16 (``kSlack`` in ``csrc/rans_core.cuh``).
PAY_SLACK = 256
#: Tables a block of the kernel keeps in shared memory, at most
#: (``kMaxStage``); an order-1 stream's further contexts spill to global memory.
MAX_STAGE = 9
#: 32-bit words of one table in the kernel's layout (``kTabWords``): a
#: 16-bit F, bias and symbol a slot.
TABLE_WORDS = _TOTFREQ * 6 // 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stream_geometry(max_clen: int, max_osize: int, n_ctx: int,
                    chunk_bytes: int = _DEFAULT_CHUNK) -> dict:
    """The reference's static launch geometry of its TPU kernel (pure host
    math); the card's tier does not consult it."""
    chunk_bytes = max(256, chunk_bytes)
    if chunk_bytes & (chunk_bytes - 1):
        raise ValueError("chunk_bytes must be a power of two")
    oc_words = chunk_bytes // 4
    r_words = _round_up(max(-(-max_clen // 4) + 2, 32), 512)
    ncb = 1
    while ncb < max(n_ctx, 1):
        ncb *= 2
    n_chunks = max(1, -(-max(max_osize, 1) // chunk_bytes))
    vmem = (r_words + 2 * ncb * 256 + 256 + oc_words + _ST_ROWS + _META_ROWS + 768) * LANES * 4
    return {"r_words": r_words, "ncb": ncb, "oc_words": oc_words,
            "n_chunks": n_chunks, "vmem_bytes": vmem}


def accepts(clen: int, osize: int, n_ctx: int,
            chunk_bytes: int = _DEFAULT_CHUNK) -> Tuple[bool, str]:
    """The reference's TPU gate: ``(True, "")`` or ``(False, reason)`` with
    reason in ``{"size", "vmem", "ctx"}``.  The card's tier does not
    consult it (see the module docstring)."""
    if osize > _MAX_OSIZE:
        return False, "size"
    if n_ctx > _NC_CAP:
        return False, "ctx"
    if stream_geometry(clen, osize, n_ctx, chunk_bytes)["vmem_bytes"] > _VMEM_BUDGET_BYTES:
        return False, "vmem"
    return True, ""


def pack(plans: Sequence["cc._RansPlan"]) -> dict:
    """The flat host arrays of one launch (see the module docstring), plus
    ``out_total`` (bytes of the output buffer).  Every plan has n_out > 0,
    n_out <= :data:`MAX_OUT` and tables whose frequencies sum to at most
    4,096."""
    b = len(plans)
    meta = np.zeros((b, META_COLS), dtype=np.int64)
    cmap = np.full((b, 256), -1, dtype=np.int32)
    pays, lookups, fcs = [], [], []
    pay_off = out_off = slabs = 0
    for i, pl in enumerate(plans):
        meta[i, :5] = (pay_off, len(pl.payload), out_off, pl.n_out, pl.order)
        meta[i, 5:] = pl.states
        pays.append(pl.payload + bytes(_round_up(len(pl.payload), _ALIGN) - len(pl.payload)))
        pay_off += len(pays[-1])
        out_off += _round_up(pl.n_out, _ALIGN)
        for ctx, (F, C, lk) in sorted(pl.tables.items()):
            if pl.order == 1:
                cmap[i, ctx] = slabs
            else:
                cmap[i, :] = slabs
            lookups.append(lk)
            fcs.append((np.asarray(C[:256], np.uint32) << 16) | np.asarray(F, np.uint32))
            slabs += 1
    return {
        "payload": np.frombuffer(bytearray(b"".join(pays) + bytes(PAY_SLACK)), dtype=np.uint8),
        "meta": meta,
        "lookup": np.frombuffer(bytearray(b"".join(lookups)), dtype=np.uint8).reshape(
            slabs, _TOTFREQ),
        "fc": np.stack(fcs).astype(np.uint32),
        "cmap": cmap,
        "out_total": max(out_off, 1),
    }


def rans_decode_device(payload: torch.Tensor, meta: torch.Tensor, lookup: torch.Tensor,
                       fc: torch.Tensor, cmap: torch.Tensor, out_total: int):
    """Decode every stream of a packed batch: ``(out, ok)``, ``out`` uint8
    ``[out_total]`` (stream i at ``meta[i, 2]``, ``meta[i, 3]`` bytes,
    meaningful where ``ok[i]``), ``ok`` int32 ``[n_streams]``.  CUDA tensors
    launch the kernel; CPU tensors take the plain version.  ``fc`` is int32
    (the bits of ``C << 16 | F``)."""
    for t, name, dt in ((payload, "payload", torch.uint8), (meta, "meta", torch.int64),
                        (lookup, "lookup", torch.uint8), (fc, "fc", torch.int32),
                        (cmap, "cmap", torch.int32)):
        check_tensor(t, name, dt)
    n = meta.shape[0]
    if meta.shape != (n, META_COLS) or cmap.shape != (n, 256):
        raise ValueError("meta must be [n, 9] and cmap [n, 256]")
    if lookup.dim() != 2 or lookup.shape[1] != _TOTFREQ or fc.shape != (lookup.shape[0], 256):
        raise ValueError("lookup must be [slabs, 4096] and fc [slabs, 256]")
    if use_plain(payload, meta, lookup, fc, cmap):
        return rans_decode_plain(payload, meta, lookup, fc, cmap, out_total)
    if payload.data_ptr() % _ALIGN:
        raise ValueError("payload must be 16-byte aligned (the kernel copies it in bulk)")
    # Shared memory for as many tables as a block can need: a launch has
    # far fewer streams than the card has SMs, so a block an SM costs nothing.
    stage = min(lookup.shape[0], MAX_STAGE)
    out = torch.empty(out_total, dtype=torch.uint8, device=payload.device)
    ok = torch.empty(n, dtype=torch.int32, device=payload.device)
    spill = torch.empty(lookup.shape[0] * TABLE_WORDS, dtype=torch.int32, device=payload.device)
    lib = _build.load("rans")
    rc = lib.hbt_rans_decode(
        payload.data_ptr(), meta.data_ptr(), lookup.data_ptr(), fc.data_ptr(),
        cmap.data_ptr(), spill.data_ptr(), out.data_ptr(), ok.data_ptr(), n, stage,
        stream_handle(payload),
    )
    _build.check(rc, "rans")
    LAUNCHES.add()
    return out, ok


def _decode_one(pay: bytes, clen: int, n: int, order: int, states, lookup: bytes,
                fc: List[int], cm: List[int], out: bytearray, base: int) -> bool:
    """The kernel's walk of one stream, byte for byte (see ``rans.cu``)."""
    r = list(states)
    p = 0
    last = [0, 0, 0, 0]
    fourq4 = 4 * (n >> 2) if order == 1 else 4 * ((n + 3) >> 2)
    q4 = n >> 2
    for t in range(n):
        j = t & 3 if t < fourq4 else 3
        slab = cm[last[j]] if order == 1 else cm[0]
        if slab < 0:
            return False
        m = r[j] & 4095
        s = lookup[slab * 4096 + m]
        e = fc[slab * 256 + s]
        rn = (e & 0xFFFF) * (r[j] >> 12) + m - (e >> 16)
        for _ in range(2):
            if rn < _RANS_L:
                if p >= clen:
                    return False
                rn = (rn << 8) | pay[p]
                p += 1
        if rn < _RANS_L:
            return False
        r[j] = rn
        last[j] = s
        out[base + ((t & 3) * q4 + (t >> 2) if order == 1 and t < fourq4 else t)] = s
    return True


def rans_decode_plain(payload: torch.Tensor, meta: torch.Tensor, lookup: torch.Tensor,
                      fc: torch.Tensor, cmap: torch.Tensor, out_total: int):
    """The plain version on CPU tensors: a scalar loop per stream with the
    kernel's output form and verdicts."""
    pay = payload.numpy().tobytes()
    mt = meta.numpy().tolist()
    lk = lookup.numpy().tobytes()
    fcl = fc.numpy().view(np.uint32).reshape(-1).tolist()
    cm = cmap.numpy()
    out = bytearray(out_total)
    ok = torch.zeros(len(mt), dtype=torch.int32)
    for i, (po, clen, oo, n, order, *states) in enumerate(mt):
        ok[i] = int(_decode_one(pay[po : po + clen], clen, n, order, states, lk, fcl,
                                cm[i].tolist(), out, oo))
    return torch.frombuffer(out, dtype=torch.uint8), ok


def rans_lanes(blocks: Sequence[bytes], device: torch.device,
               metrics=None) -> Tuple[List[Optional[bytes]], "cc.RansTierStats"]:
    """Decode rANS 4x8 streams on ``device``, all in one launch: ``(outs,
    stats)`` with ``None`` for every stream that tiered down (``format``,
    ``size``, or the kernel's ``ok = 0``), for the host tiers to decode.
    A stream with n_out 0 decodes to ``b""`` without a launch.  A kernel
    that fails to build or launch raises.  ``metrics`` (a
    :class:`~hadoop_bam_tpu_torch.utils.tracing.Metrics`) counts the
    transfers of a CUDA launch."""
    stats = cc.RansTierStats()
    outs: List[Optional[bytes]] = [None] * len(blocks)
    take, plans = [], []
    for i, data in enumerate(blocks):
        try:
            plan = cc.parse_rans_plan(data)
        except cc.CramError:
            stats.tierdown_format += 1
            continue
        if plan.n_out == 0:
            outs[i] = b""
            stats.lanes += 1
        elif any(C[256] > _TOTFREQ for _, C, _ in plan.tables.values()):
            stats.tierdown_format += 1
        elif plan.n_out > MAX_OUT:
            stats.tierdown_size += 1
        else:
            take.append(i)
            plans.append(plan)
    if not plans:
        return outs, stats
    h = pack(plans)
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (up(h["payload"]), up(h["meta"]), up(h["lookup"]), up(h["fc"].view(np.int32)),
            up(h["cmap"]))
    out, ok = rans_decode_device(*args, h["out_total"])
    out_h, ok_h = out.cpu().numpy(), ok.cpu().numpy()
    if on_card and metrics is not None:
        metrics.count_h2d(h["payload"].nbytes + h["meta"].nbytes, "rans_streams")
        metrics.count_h2d(h["lookup"].nbytes + h["fc"].nbytes + h["cmap"].nbytes, "rans_tables")
        metrics.count_d2h(out_h.nbytes + ok_h.nbytes, "rans_out")
    meta = h["meta"]
    for k, i in enumerate(take):
        if ok_h[k]:
            o, n = int(meta[k, 2]), int(meta[k, 3])
            outs[i] = out_h[o : o + n].tobytes()
            stats.lanes += 1
        else:
            stats.tierdown_ok0 += 1
    return outs, stats

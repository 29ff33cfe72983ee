"""Greedy LZ77 + fixed-Huffman DEFLATE of member payloads:
``csrc/deflate.cu`` and its plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/deflate_lanes.py``
(``accepts``, ``deflate_lanes``, ``deflate_lanes_stream``, with the token
compaction and bit pack that follow the kernel there).  The reference's
bytes are its own, not zlib's, and the part files pin them, so both
versions here make the reference's token decisions: 4-byte hash heads in
two generations of ``H`` slots, candidates at most 32 KiB back, matches
of 4..258 bytes extended at most 4 bytes per step, and RFC 1951 fixed
codes (see the notes at the top of ``csrc/deflate.cu`` and
``csrc/deflate_core.cuh``).

The reference's lockstep waves, input chunks and token tiles are TPU
geometry; the function they compute is sequential per member, and only
``chunk_bytes`` leaks into the result, through the hash width ``H`` and
the ``vmem`` decline rule, which are kept.  Its per-step wave budget
(``2 * chunk_bytes + 96``) cannot bind for ``chunk_bytes >= 162``; smaller
chunks are refused here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ... import _build
from . import LaunchCounter, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("deflate_members")

LANES = 128  # the reference's lockstep width; the plain version walks this many at once
MIN_MATCH = 4
MAX_MATCH = 258
MAX_DIST = 1 << 15
#: Largest member payload the lanes tier takes (the reference's _MAX_MEMBER).
MAX_MEMBER = 1 << 16
HASH_ROWS = 2048
#: The reference's VMEM budget rule, kept as a decline rule: members whose
#: TPU geometry would not fit come back ok = 0 before any launch.
VMEM_BUDGET_BYTES = 14 << 20
DEFAULT_CHUNK = 4096
MIN_CHUNK = 256
_ST_ROWS = 8

# RFC 1951 fixed-code tables (the same values as ``ops/flate.py`` and the
# constants in ``csrc/deflate_core.cuh``).
_LEN_BASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
                      43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258], dtype=np.int64)
_LEN_EXTRA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                       4, 4, 4, 4, 5, 5, 5, 5, 0], dtype=np.int64)
_DIST_BASE = np.array([1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
                       257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
                       12289, 16385, 24577], dtype=np.int64)
_DIST_EXTRA = np.array([0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8,
                        9, 9, 10, 10, 11, 11, 12, 12, 13, 13], dtype=np.int64)


def _rev_table(width: int) -> np.ndarray:
    v = np.arange(1 << width, dtype=np.int64)
    r = np.zeros_like(v)
    for k in range(width):
        r |= ((v >> k) & 1) << (width - 1 - k)
    return r


_REV9, _REV8, _REV5 = _rev_table(9), _rev_table(8), _rev_table(5)


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def hash_bits(P: int) -> int:
    """log2 of the hash slots in use for a batch of capacity ``P``: the
    reference's ``H = min(2048, max(256, P))``, ``HB = H.bit_length() - 1``."""
    return min(HASH_ROWS, max(256, P)).bit_length() - 1


def vmem_bytes(P: int, chunk: int = DEFAULT_CHUNK) -> int:
    """The reference's ``_vmem_bytes``: the TPU launch's VMEM for capacity
    ``P`` (streams + heads + one token tile + state rows)."""
    w = P // 4 + 8
    h = min(HASH_ROWS, max(256, P))
    return (w + 2 * h + chunk + 8 + _ST_ROWS + 512) * LANES * 4


def accepts(max_plen: int, chunk_bytes: int = DEFAULT_CHUNK) -> Tuple[bool, str]:
    """Would the lanes tier take members of this payload size?  ``(True,
    "")`` or ``(False, "size" | "vmem")``; pure host logic, as in the
    reference."""
    if max_plen > MAX_MEMBER:
        return False, "size"
    P = round_up(max(max_plen, 1), chunk_bytes)
    if vmem_bytes(P, chunk_bytes) > VMEM_BUDGET_BYTES:
        return False, "vmem"
    return True, ""


def out_bytes(P: int) -> int:
    """Row width of the compressed output: literals cost at most 9 bits a
    byte and copies less, plus header and end of block."""
    return (3 + 9 * P + 7 + 7) // 8 + 1


def stage_bytes(max_plen: int) -> int:
    """Shared memory that stages one member: its bytes from the 16-byte
    aligned base, plus slack that word reads past the end touch."""
    return 16 * (-(-(15 + max(int(max_plen), 0) + 16) // 16))


def deflate_members(
    stream: torch.Tensor,
    offs: torch.Tensor,
    lens: torch.Tensor,
    max_plen: int,
    hb: int,
    row_bytes: int,
    counts: Optional[torch.Tensor] = None,
):
    """Compress member i = ``stream[offs[i] : + lens[i]]`` into row i of a
    zeroed uint8 ``[n, row_bytes]`` tensor, one final fixed-Huffman DEFLATE
    block each.  ``max_plen`` is ``lens.max()`` (known on the host, so no
    sync); ``hb`` is the hash width (:func:`hash_bits`).  Returns ``(comp,
    clens int32, ok int32)``.  Dtypes: ``stream`` uint8, ``offs`` int64,
    ``lens`` int32.  ``counts``, an int32 ``[n, 3]`` tensor on the card,
    gets each member's literals, copies and 32-position scan windows from
    the kernel (the plain version has no windows, so the CPU refuses it)."""
    check_tensor(stream, "stream", torch.uint8)
    check_tensor(offs, "offs", torch.int64)
    check_tensor(lens, "lens", torch.int32)
    n = offs.numel()
    if lens.numel() != n:
        raise ValueError("offs and lens differ in length")
    if not 8 <= hb <= 11:
        raise ValueError(f"hash width {hb} outside 8..11")
    if max_plen > MAX_MEMBER or row_bytes < out_bytes(max(max_plen, 1)):
        raise ValueError("member geometry outside the kernel's range")
    if counts is not None:
        check_tensor(counts, "counts", torch.int32)
        if tuple(counts.shape) != (n, 3):
            raise ValueError(f"counts must be [{n}, 3]")
    if use_plain(stream, offs, lens, *([] if counts is None else [counts])):
        if counts is not None:
            raise ValueError("counts are the kernel's; the plain version has none")
        return deflate_members_plain(stream, offs, lens, hb, row_bytes)
    dev = stream.device
    comp = torch.zeros((n, row_bytes), dtype=torch.uint8, device=dev)
    clens = torch.empty(n, dtype=torch.int32, device=dev)
    ok = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return comp, clens, ok
    lib = _build.load("deflate")
    rc = lib.hbt_deflate_members(
        stream.data_ptr(), stream.numel(), offs.data_ptr(), lens.data_ptr(), n, hb,
        stage_bytes(max_plen), row_bytes, comp.data_ptr(), clens.data_ptr(), ok.data_ptr(),
        None if counts is None else counts.data_ptr(), stream_handle(stream),
    )
    _build.check(rc, "deflate_members")
    LAUNCHES.add()
    return comp, clens, ok


def deflate_members_plain(stream, offs, lens, hb: int, row_bytes: int):
    """The plain version on CPU tensors: the reference's lockstep waves
    over groups of :data:`LANES` members, then the fixed-Huffman pack."""
    a = stream.numpy()
    o = offs.numpy().astype(np.int64)
    ln = lens.numpy().astype(np.int64)
    n = len(o)
    comp = np.zeros((n, row_bytes), dtype=np.uint8)
    clens = np.zeros(n, dtype=np.int32)
    ok = np.zeros(n, dtype=np.int32)
    for g0 in range(0, n, LANES):
        g1 = min(n, g0 + LANES)
        tok, ntok, cur = _match_waves(a, o[g0:g1], ln[g0:g1], hb)
        ok[g0:g1] = cur == ln[g0:g1]
        clens[g0:g1] = _pack_fixed(tok, ntok, comp[g0:g1])
    return torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(ok)


def _match_waves(a: np.ndarray, o: np.ndarray, plen: np.ndarray, hb: int):
    """Greedy LZ77 over members ``a[o[j] : + plen[j]]`` in lockstep: every
    wave, each live member either scans (hash, probe, insert; literal or
    match start) or extends its match by up to 4 bytes.  Returns the token
    rows (literal: byte; copy: ``(1 << 30) | (len << 16) | dist``), their
    counts and the final cursors."""
    n = len(o)
    P = int(plen.max(initial=0))
    buf = np.zeros((n, P + 8), dtype=np.uint8)
    for j in range(n):
        buf[j, : plen[j]] = a[o[j] : o[j] + plen[j]]
    b32 = buf.astype(np.uint32)
    stride = P + 4
    # The little-endian word at every byte offset of every member.
    wf = (b32[:, 0:stride] | (b32[:, 1 : stride + 1] << 8) | (b32[:, 2 : stride + 2] << 16)
          | (b32[:, 3 : stride + 3] << 24)).reshape(-1)
    H = 1 << hb
    h1 = np.zeros(n * H, dtype=np.int64)
    h2 = np.zeros(n * H, dtype=np.int64)
    cur = np.zeros(n, dtype=np.int64)
    mode = np.zeros(n, dtype=bool)
    mpos = np.zeros(n, dtype=np.int64)
    mlen = np.zeros(n, dtype=np.int64)
    tok = np.zeros((n, P + 1), dtype=np.int64)
    ntok = np.zeros(n, dtype=np.int64)
    row = np.arange(n, dtype=np.int64) * stride
    while True:
        ids = np.nonzero(cur < plen)[0]
        if len(ids) == 0:
            break
        ext = mode[ids]
        s = ids[~ext]
        e = ids[ext]
        if len(s):
            cs = cur[s]
            wa = wf[row[s] + cs]
            start = np.zeros(len(s), dtype=bool)
            canh = cs + MIN_MATCH <= plen[s]
            if canh.any():
                hs, ch, wh = s[canh], cs[canh], wa[canh]
                h = ((wh.astype(np.uint64) * np.uint64(0x9E3779B1)) & np.uint64(0xFFFFFFFF)) >> np.uint64(32 - hb)
                slot = hs * H + h.astype(np.int64)
                s1 = h1[slot]
                s2 = h2[slot]
                h2[slot] = s1
                h1[slot] = ch + 1
                c1, c2 = s1 - 1, s2 - 1
                m1 = (c1 >= 0) & (ch - c1 <= MAX_DIST) & (wf[row[hs] + np.maximum(c1, 0)] == wh)
                m2 = (c2 >= 0) & (ch - c2 <= MAX_DIST) & (wf[row[hs] + np.maximum(c2, 0)] == wh)
                st = m1 | m2
                start[canh] = st
                begun = hs[st]
                mode[begun] = True
                mpos[begun] = np.where(m1, c1, c2)[st]
                mlen[begun] = MIN_MATCH
            lit = s[~start]
            tok[lit, ntok[lit]] = wa[~start] & 0xFF
            ntok[lit] += 1
            cur[lit] += 1
        if len(e):
            ce, ml, mp = cur[e], mlen[e], mpos[e]
            x = wf[row[e] + ce + ml] ^ wf[row[e] + mp + ml]
            nm = np.where(x & 0xFF, 0, np.where(x & 0xFF00, 1, np.where(x & 0xFF0000, 2,
                                                                          np.where(x >> 24, 3, 4))))
            add = np.maximum(np.minimum(nm, np.minimum(plen[e] - (ce + ml), MAX_MATCH - ml)), 0)
            ml = ml + add
            mlen[e] = ml
            done = add < 4
            d = e[done]
            tok[d, ntok[d]] = (1 << 30) | (ml[done] << 16) | (ce[done] - mp[done])
            ntok[d] += 1
            cur[d] += ml[done]
            mode[d] = False
    return tok, ntok, cur


def _pack_fixed(tok: np.ndarray, ntok: np.ndarray, comp: np.ndarray) -> np.ndarray:
    """Bit-pack token rows into ``comp`` (zeroed rows): header bits 1,1,0,
    fixed codes LSB first, end of block.  Returns the byte lengths.  Codes
    occupy disjoint bits, so summing each code's share of a 32-bit word
    equals ORing it."""
    n, T = tok.shape
    live = np.arange(T)[None, :] < ntok[:, None]
    is_cpy = ((tok >> 30) & 1) == 1
    v = tok & 0xFF
    hi_lit = v >= 144
    lit_n = np.where(hi_lit, 9, 8)
    pat_lit = _REV9[np.where(hi_lit, 0x190 + (v - 144), 0x30 + v)] >> (9 - lit_n)
    L = (tok >> 16) & 0x1FF
    D = tok & 0xFFFF
    li = np.clip(np.searchsorted(_LEN_BASE, L, side="right") - 1, 0, 28)
    len_n = np.where(li <= 22, 7, 8)
    pat_len = _REV8[np.where(li <= 22, li + 1, 0xC0 + (li - 23))] >> (8 - len_n)
    e1 = _LEN_EXTRA[li]
    di = np.clip(np.searchsorted(_DIST_BASE, D, side="right") - 1, 0, 29)
    e2 = _DIST_EXTRA[di]
    pat_cpy = (pat_len | (np.maximum(L - _LEN_BASE[li], 0) << len_n)
               | (_REV5[di] << (len_n + e1)) | (np.maximum(D - _DIST_BASE[di], 0) << (len_n + e1 + 5)))
    nbits = np.where(live, np.where(is_cpy, len_n + e1 + 5 + e2, lit_n), 0)
    pattern = np.where(live, np.where(is_cpy, pat_cpy, pat_lit), 0)
    ends = np.cumsum(nbits, axis=1) + 3
    total = ends[:, -1] + 7 if T else np.full(n, 10)
    off = ends - nbits
    words = (comp.shape[1] + 3) // 4 + 1
    r, t = np.nonzero(live)
    at = off[r, t]
    val = pattern[r, t].astype(np.uint64) << (at & 31).astype(np.uint64)
    idx = r * words + (at >> 5)
    acc = np.bincount(idx, weights=(val & np.uint64(0xFFFFFFFF)).astype(np.float64),
                      minlength=n * words)
    acc += np.bincount(idx + 1, weights=(val >> np.uint64(32)).astype(np.float64),
                       minlength=n * words + 1)[: n * words]
    acc[::words] += 3  # BFINAL = 1, BTYPE = 01
    packed = acc.astype(np.uint64).astype("<u4").view(np.uint8).reshape(n, words * 4)
    comp[:] = packed[:, : comp.shape[1]]
    return ((total + 7) // 8).astype(np.int32)


def deflate_lanes_stream(
    stream: torch.Tensor,
    lens,
    offs=None,
    max_clen: Optional[int] = None,
    chunk_bytes: int = DEFAULT_CHUNK,
):
    """Compress members ``stream[offs[i] : + lens[i]]`` (``offs`` defaults
    to back to back) on ``stream``'s device.

    Returns ``(comp uint8 [B, out_bytes], clens int32 [B], ok bool [B])``
    as tensors on that device — the reference's contract: every row with
    ``ok`` is a complete final DEFLATE member, zero past ``clens``.  Members
    past :data:`MAX_MEMBER` or the ``vmem`` rule, a stream past the int32
    domain, or a compressed size over ``max_clen`` come back ``ok = False``
    for the caller to send to host zlib."""
    check_tensor(stream, "stream", torch.uint8)
    if chunk_bytes < MIN_CHUNK:
        raise ValueError(f"chunk_bytes {chunk_bytes} < {MIN_CHUNK}")
    dev = stream.device
    lens = np.asarray(lens, dtype=np.int64)
    B = len(lens)
    if B == 0:
        return (torch.zeros((0, 0), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    offs = np.cumsum(lens) - lens if offs is None else np.asarray(offs, dtype=np.int64)
    max_len = int(lens.max())
    P = round_up(max(max_len, 1), chunk_bytes)
    row_bytes = out_bytes(P)
    if not accepts(max_len, chunk_bytes)[0] or int((offs + lens).max()) >= 2**31:
        return (torch.zeros((B, row_bytes), dtype=torch.uint8, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev))
    if int(offs.min()) < 0 or int((offs + lens).max()) > stream.numel():
        raise IndexError("deflate_lanes_stream: a member lies outside the stream")
    comp, clens, ok = deflate_members(
        stream, torch.from_numpy(offs).to(dev), torch.from_numpy(lens.astype(np.int32)).to(dev),
        max_len, hash_bits(P), row_bytes,
    )
    ok = ok != 0
    if max_clen is not None:
        ok &= clens <= max_clen
    return comp, clens, ok


def deflate_lanes(
    payload: torch.Tensor,
    lens,
    max_clen: Optional[int] = None,
    chunk_bytes: int = DEFAULT_CHUNK,
):
    """:func:`deflate_lanes_stream` over padded member rows: ``payload``
    uint8 ``[B, W]``, member i is ``payload[i, :lens[i]]``.  Same return
    contract."""
    if payload.dim() != 2:
        raise ValueError("payload must be [members, bytes]")
    B, W = payload.shape
    return deflate_lanes_stream(
        payload.contiguous().reshape(-1), lens, offs=np.arange(B, dtype=np.int64) * W,
        max_clen=max_clen, chunk_bytes=chunk_bytes,
    )

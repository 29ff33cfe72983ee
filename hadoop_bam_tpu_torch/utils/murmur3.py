"""MurmurHash3_x64_128 (first 64 bits) with the reference's exact semantics,
vectorized over ragged slices of one byte buffer.

Counterpart of ``hadoop_bam_tpu/utils/murmur3.py``
(``murmurhash3_int32_batch``, ``murmurhash3_chars`` for the contig keys
of VCF records, and the scalar ``murmurhash3_bytes`` / ``murmurhash3_int32``
of the duplicate-marking oracle).  The reference (util/MurmurHash3.java) keeps
one quirk in its mixing loop — the right-shift operand is h1 where canonical
murmur reads h2 — and this copy keeps it too, because the hashes become
the sort keys of unmapped reads (BAMRecordReader.java:97-110) and of
unknown VCF contigs (VCFRecordReader.java:200-204).
"""

from __future__ import annotations

import numpy as np

_M = (1 << 64) - 1
#: The x64_128 mixing constants.
C1 = 0x87C37B91114253D5
C2 = 0x4CF5AD432745937F

_C1_U = np.uint64(C1)
_C2_U = np.uint64(C2)


def _rotl_vec(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _fmix_vec(k: np.ndarray) -> np.ndarray:
    k = k ^ (k >> np.uint64(33))
    k = k * np.uint64(0xFF51AFD7ED558CCD)
    k = k ^ (k >> np.uint64(33))
    k = k * np.uint64(0xC4CEB9FE1A85EC53)
    return k ^ (k >> np.uint64(33))


def _mix_vec(h1, h2, k1, k2):
    k1 = _rotl_vec(k1 * _C1_U, 31) * _C2_U
    h1 = h1 ^ k1
    h1 = _rotl_vec(h1, 27) + h2
    h1 = h1 * np.uint64(5) + np.uint64(0x52DCE729)
    k2 = _rotl_vec(k2 * _C2_U, 33) * _C1_U
    h2 = h2 ^ k2
    # Reference quirk preserved: the right-shift operand is h1, not h2.
    h2 = ((h2 << np.uint64(31)) | (h1 >> np.uint64(33))) + h1
    h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)
    return h1, h2


def murmurhash3_int32_batch(
    data: np.ndarray, offs: np.ndarray, lens: np.ndarray, seed: int = 0
) -> np.ndarray:
    """Vectorized :func:`murmurhash3_int32` over ragged buffer slices.

    Hashes ``data[offs[i] : offs[i] + lens[i]]`` for every row in one
    numpy pass (uint64 wrap-around arithmetic; one ``_mix`` round per
    16-byte block index, rows masked once past their own length).
    Bit-exact with the scalar path, including the reference's h1/h2 mixing
    quirk and Java's implicit ``(int)`` truncation of the result.
    """
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    n = len(offs)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    maxlen = int(lens.max()) if n else 0
    # Pad to whole 16-byte blocks plus one spare block so a row whose
    # length is an exact multiple still has an (all-zero) tail window.
    W = ((max(maxlen, 0) + 15) // 16) * 16 + 16
    # Each row's W bytes are one row of a strided view of the buffer; the
    # rows that start within W bytes of its end read a zero-padded copy of
    # its last W bytes instead.
    buf = np.asarray(data, dtype=np.uint8).reshape(-1)
    if len(buf) < W:
        buf = np.concatenate([buf, np.zeros(W - len(buf), np.uint8)])
    base = len(buf) - W
    start = np.maximum(offs, 0)
    m = np.lib.stride_tricks.sliding_window_view(buf, W)[np.minimum(start, base)]
    late = start > base
    if late.any():
        tail = np.concatenate([buf[base:], np.zeros(W, np.uint8)])
        m[late] = np.lib.stride_tricks.sliding_window_view(tail, W)[
            np.minimum(start[late] - base, W)]
    m = np.where(np.arange(W)[None, :] < lens[:, None], m, 0).astype(np.uint8)
    # Little-endian 8-byte words per row: a view with an explicit byte
    # order reads them on any host.
    w64 = m.view("<u8").astype(np.uint64)
    nblocks = (lens // 16).astype(np.int64)
    h1 = np.full(n, np.uint64(seed & _M))
    h2 = np.full(n, np.uint64(seed & _M))
    for i in range(int(nblocks.max()) if n else 0):
        act = i < nblocks
        nh1, nh2 = _mix_vec(h1, h2, w64[:, 2 * i], w64[:, 2 * i + 1])
        h1 = np.where(act, nh1, h1)
        h2 = np.where(act, nh2, h2)
    # Tail (last <16 bytes): the padded matrix is zero past each row's
    # length, so the tail words need no per-byte masking.
    toff = (nblocks * 2).astype(np.int64)
    tk1 = np.take_along_axis(w64, toff[:, None], axis=1)[:, 0]
    tk2 = np.take_along_axis(w64, toff[:, None] + 1, axis=1)[:, 0]
    tn = lens & 15
    k2v = _rotl_vec(tk2 * _C2_U, 33) * _C1_U
    h2 = np.where(tn > 8, h2 ^ k2v, h2)
    # Rows with 0 < tn <= 8 must hash only tn bytes into k1; w64 already
    # zero-pads, so tk1 is exactly int.from_bytes(tail[:min(tn,8)], "le").
    k1v = _rotl_vec(tk1 * _C1_U, 31) * _C2_U
    h1 = np.where(tn > 0, h1 ^ k1v, h1)
    ulen = lens.astype(np.uint64)
    h1 = h1 ^ ulen
    h2 = h2 ^ ulen
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix_vec(h1)
    h2 = _fmix_vec(h2)
    h1 = h1 + h2
    return (h1 & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)


def _signed64(x: int) -> int:
    x &= _M
    return x - (1 << 64) if x >= 1 << 63 else x


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _fmix(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _M
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _M
    k ^= k >> 33
    return k


def _mix(h1: int, h2: int, k1: int, k2: int) -> tuple:
    k1 = _rotl((k1 * C1) & _M, 31)
    h1 ^= (k1 * C2) & _M
    h1 = (_rotl(h1, 27) + h2) & _M
    h1 = (h1 * 5 + 0x52DCE729) & _M
    k2 = _rotl((k2 * C2) & _M, 33)
    h2 ^= (k2 * C1) & _M
    # Reference quirk: the right-shift operand is h1, not h2.
    h2 = ((h2 << 31) | (h1 >> 33)) & _M
    h2 = (h2 + h1) & _M
    h2 = (h2 * 5 + 0x38495AB5) & _M
    return h1, h2


def murmurhash3_bytes(key: bytes, seed: int = 0) -> int:
    """Hash raw bytes one record at a time (MurmurHash3.java:32-103), as a
    Java-``long``-style signed 64-bit int."""
    h1 = h2 = seed & _M
    length = len(key)
    nblocks = length // 16
    for i in range(nblocks):
        off = i * 16
        h1, h2 = _mix(h1, h2, int.from_bytes(key[off : off + 8], "little"),
                      int.from_bytes(key[off + 8 : off + 16], "little"))
    tail = key[nblocks * 16 :]
    n = length & 15
    if n > 8:
        k2 = int.from_bytes(tail[8:n], "little")
        h2 ^= (_rotl((k2 * C2) & _M, 33) * C1) & _M
    if n > 0:
        k1 = int.from_bytes(tail[: min(n, 8)], "little")
        h1 ^= (_rotl((k1 * C1) & _M, 31) * C2) & _M
    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M
    h2 = (h2 + h1) & _M
    return _signed64(_fmix(h1) + _fmix(h2))


def murmurhash3_int32(key: bytes, seed: int = 0) -> int:
    """The low 32 bits of :func:`murmurhash3_bytes` as a signed int32 (Java's
    implicit ``(int)`` cast, BAMRecordReader.java:85-86)."""
    v = murmurhash3_bytes(key, seed) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def murmurhash3_chars(chars: str, seed: int = 0) -> int:
    """Hash the UTF-16 code units of a string (MurmurHash3.java:105-171), as
    a Java-``long``-style signed 64-bit int.  Astral characters become
    surrogate pairs, as Java's char-indexed loop sees them."""
    enc = chars.encode("utf-16-le", "surrogatepass")
    units = [int.from_bytes(enc[i : i + 2], "little") for i in range(0, len(enc), 2)]
    h1 = h2 = seed & _M
    length = len(units)
    nblocks = length // 8
    for i in range(nblocks):
        u = units[i * 8 : i * 8 + 8]
        k1 = u[0] | u[1] << 16 | u[2] << 32 | u[3] << 48
        k2 = u[4] | u[5] << 16 | u[6] << 32 | u[7] << 48
        h1, h2 = _mix(h1, h2, k1, k2)
    tail = units[nblocks * 8 :]
    n = length & 7
    if n > 4:
        k2 = 0
        for j in range(4, n):
            k2 |= tail[j] << (16 * (j - 4))
        h2 ^= (_rotl((k2 * C2) & _M, 33) * C1) & _M
    if n > 0:
        k1 = 0
        for j in range(min(n, 4)):
            k1 |= tail[j] << (16 * j)
        h1 ^= (_rotl((k1 * C1) & _M, 31) * C2) & _M
    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M
    h2 = (h2 + h1) & _M
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    return _signed64(h1 + h2)

"""Heuristic record-start guessing inside arbitrary byte ranges.

Counterpart of ``hadoop_bam_tpu/io/guesser.py`` (BAMSplitGuesser.java:
108-339): (1) scan the window for candidate BGZF block headers, (2) test
every offset of a block's payload against the record sanity rules,
vectorized, (3) verify a candidate by trial-decoding records across three
block boundaries.  The part count of a sort equals its split count, so
this planning must match the reference exactly.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..spec import bam, bgzf

MAX_BYTES_READ = 3 * 0xFFFF + 0xFFFE
BLOCKS_NEEDED_FOR_GUESS = 3
SHORTEST_POSSIBLE_BAM_RECORD = 4 * 9 + 1 + 1


class BamSplitGuesser:
    """Find the first real BAM record start in ``[beg, end)`` of a file."""

    def __init__(self, data: bytes, n_refs: int):
        """``data``: the whole BGZF file (or enough of it); ``n_refs``: the
        reference-sequence count from the header, used in the sanity range
        checks (BAMSplitGuesser.java:99-100)."""
        self.data = data
        self.n_refs = n_refs

    def guess_next_record_start(self, beg: int, end: int) -> int:
        """Virtual offset of the first verifiable record in ``[beg, end)``;
        returns ``end`` (as a *file* offset sentinel, like the reference) when
        none is found (BAMSplitGuesser.java:106-110)."""
        if beg == 0:
            # Skip the header with a real reader — it can exceed the window
            # (BAMSplitGuesser.java:115-123, the 100MB-header regression).
            # Malformed data falls through to the scan, which then reports
            # the clean "no record found" sentinel.
            try:
                r = bgzf.BgzfReader(self.data)
                bam.read_header_stream(r)
                return r.tell_voffset()
            except (bgzf.BgzfError, bam.BamError, struct.error):
                pass

        # The buffer extends MAX_BYTES_READ past beg regardless of ``end``:
        # ``end`` bounds where a record may *start*, not the verify window
        # (BAMSplitGuesser.java:127-140 reads the full buffer; only the
        # candidate-block search is clamped to min(end-beg, 0xffff)).
        window = self.data[beg : min(beg + MAX_BYTES_READ, len(self.data))]
        first_bgzf_end = min(end - beg, 0xFFFF)
        cp = 0
        while True:
            cp = bgzf.find_next_block(window, cp, first_bgzf_end)
            if cp < 0:
                return end
            up = self._guess_in_block(window, cp)
            if up is not None:
                return ((beg + cp) << 16) | up
            cp += 1

    # -- phase 2: vectorized candidate scan ---------------------------------

    def _candidate_offsets(self, payload: np.ndarray) -> np.ndarray:
        """All offsets in one block's payload passing the reference's sanity
        rules (BAMSplitGuesser.java:243-336), evaluated vectorized."""
        n = len(payload)
        limit = n - (SHORTEST_POSSIBLE_BAM_RECORD - 4)
        if limit <= 4:
            return np.empty(0, dtype=np.int64)

        # Candidate positions up ∈ [4, limit): the scan starts at offset 4
        # (BAMSplitGuesser.java:239-241) and checks fields *relative to the
        # record start* up-4.  Work in terms of s = up - 4 (record start).
        count = limit - 4
        s = np.arange(count, dtype=np.int64)  # record starts
        pad = np.zeros(40, dtype=np.uint8)  # allow vector reads near the end
        a = np.concatenate([payload, pad])

        def i32(off: int, cnt: int) -> np.ndarray:
            # little-endian signed i32 at record-relative offset `off` for
            # every candidate start
            return (
                a[off : off + cnt].astype(np.uint32)
                | (a[off + 1 : off + cnt + 1].astype(np.uint32) << 8)
                | (a[off + 2 : off + cnt + 2].astype(np.uint32) << 16)
                | (a[off + 3 : off + cnt + 3].astype(np.uint32) << 24)
            ).astype(np.int32)

        refid = i32(4, count)
        pos = i32(8, count)
        ok = (refid >= -1) & (refid <= self.n_refs) & (pos >= -1)

        nrefid = i32(24, count)
        npos = i32(28, count)
        ok &= (nrefid >= -1) & (nrefid <= self.n_refs) & (npos >= -1)

        name_len = a[12 : 12 + count].astype(np.int64)
        ok &= name_len >= 1
        nul_pos = s + 36 + name_len - 1
        # The NUL must sit inside this block's payload
        # (BAMSplitGuesser.java:296-301).
        ok &= nul_pos < n
        ok &= a[np.minimum(nul_pos, n - 1)] == 0

        n_cigar = (
            a[16 : 16 + count].astype(np.int64)
            | (a[17 : 17 + count].astype(np.int64) << 8)
        )
        l_seq = i32(20, count).astype(np.int64)
        zero_min = 32 + name_len + 4 * n_cigar + l_seq + (l_seq + 1) // 2
        block_size = i32(0, count).astype(np.int64)
        ok &= block_size >= zero_min

        return s[ok] + 4  # back to "up" space (offset of refID field)

    def _guess_in_block(self, window: bytes, cp: int) -> Optional[int]:
        try:
            payload, _ = bgzf.inflate_block(window, cp)
        except bgzf.BgzfError:
            return None
        cands = self._candidate_offsets(np.frombuffer(payload, dtype=np.uint8))
        for up in cands:
            up0 = int(up) - 4  # record start (block_size word)
            if self._verify(window, cp, up0):
                return up0
        return None

    # -- phase 3: trial decode of 3 blocks ----------------------------------

    def _verify(self, window: bytes, cp: int, up0: int) -> bool:
        """Decode records from (cp, up0) until BLOCKS_NEEDED_FOR_GUESS block
        boundaries were crossed (BAMSplitGuesser.java:177-231).  Running out
        of buffered data mid-record is acceptable iff ≥1 record decoded."""
        # Inflate up to BLOCKS_NEEDED_FOR_GUESS+1 consecutive blocks from cp.
        co, cs, us = [], [], []
        pos = cp
        while len(co) < BLOCKS_NEEDED_FOR_GUESS + 1 and pos < len(window):
            try:
                csize, usize = bgzf.read_block_at(window, pos)
            except bgzf.BgzfError:
                break  # chain ends, truncates, or lies inside the window
            co.append(pos)
            cs.append(csize)
            us.append(usize)
            pos += csize
        if not co:
            return False
        try:
            out, offs = bgzf.inflate_blocks(window, co, cs, us, threads=1)
        except bgzf.BgzfError:
            return False
        data = out.tobytes()
        block_starts = [int(x) for x in offs[:-1]]
        truncated = pos < len(window)  # more blocks exist beyond the buffer

        p = up0
        blocks_crossed = 0
        decoded_any = False
        while blocks_crossed < BLOCKS_NEEDED_FOR_GUESS:
            if p + 4 > len(data):
                break
            (bs,) = struct.unpack_from("<I", data, p)
            if p + 4 + bs > len(data):
                # Partial record at the end of the buffered window: EOF is
                # legitimate iff we already decoded something
                # (BAMSplitGuesser.java:218-230).
                return decoded_any and truncated
            if not self._sane_record(data, p, bs):
                return False
            decoded_any = True
            new_p = p + 4 + bs
            # Count crossed block boundaries like the reference's
            # getFilePointer tracking (:195-201).
            for b in block_starts:
                if p < b <= new_p:
                    blocks_crossed += 1
            p = new_p
            if p >= len(data) and blocks_crossed < BLOCKS_NEEDED_FOR_GUESS:
                # Clean EOF at a record boundary: codec returns null → accept
                # if anything decoded (BAMSplitGuesser.java:186-212).
                return decoded_any
        return decoded_any

    def _sane_record(self, data: bytes, p: int, bs: int) -> bool:
        """The eager-decode stand-in: strict field validation equivalent to
        ``record.setHeaderStrict`` + ``eagerDecode``
        (BAMSplitGuesser.java:190-193)."""
        if bs < 32:
            return False
        body = memoryview(data)[p + 4 : p + 4 + bs]
        refid, pos_ = struct.unpack_from("<ii", body, 0)
        name_len = body[8]
        n_cigar = struct.unpack_from("<H", body, 12)[0]
        l_seq = struct.unpack_from("<I", body, 16)[0]
        nrefid, npos = struct.unpack_from("<ii", body, 20)
        # setHeaderStrict resolves refIDs against the real header: strict
        # upper bound, unlike the scan's lenient `<= n_refs`.
        if not (-1 <= refid < self.n_refs) or not (-1 <= nrefid < self.n_refs):
            return False
        if pos_ < -1 or npos < -1:
            return False
        if name_len < 1:
            return False
        need = 32 + name_len + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
        if bs < need:
            return False
        if body[32 + name_len - 1] != 0:
            return False
        # eagerDecode validates CIGAR operator codes (0..8).
        for k in range(n_cigar):
            (c,) = struct.unpack_from("<I", body, 32 + name_len + 4 * k)
            if (c & 0xF) > 8:
                return False
        return True


#: The first window of the salvage re-sync's candidate scan; it doubles
#: until a candidate verifies or the payload is covered.
RESYNC_WINDOW = 1 << 16
#: Bytes past a candidate that its sanity rules read (the 36-byte fixed
#: part and up to 255 name bytes).
_CANDIDATE_REACH = 36 + 255


def find_record_start_in_payload(
    payload, n_refs: int, start: int = 0, verify_records: int = 4
) -> Optional[int]:
    """The first verifiable BAM record start at or after ``start`` in an
    inflated payload: the salvage reader's chain re-sync after a
    quarantined member.  Candidates from the sanity rules (vectorized) are
    verified by walking the chain with the strict per-record validation for
    up to ``verify_records`` records (a record cut by the payload's end is
    fine once one decoded).  Returns the offset of the record's size word,
    or None.

    The candidates are scanned in windows from ``start``, doubling, and a
    window trusts only the candidates whose rules read inside it, so the
    answer is the one a scan of the whole payload gives, without its
    temporaries for every byte of a split."""
    arr = payload if isinstance(payload, np.ndarray) else np.frombuffer(payload, dtype=np.uint8)
    if start:
        arr = arr[start:]
    n = len(arr)
    if n < SHORTEST_POSSIBLE_BAM_RECORD:
        return None
    g = BamSplitGuesser(b"", n_refs)
    data = np.ascontiguousarray(arr)
    lo = 0  # candidates below lo were tried by an earlier window
    w = RESYNC_WINDOW
    while True:
        whole = w >= n
        cands = g._candidate_offsets(data[: min(w, n)])
        if not whole:
            cands = cands[cands - 4 < w - _CANDIDATE_REACH]
        for up in cands[cands - 4 >= lo]:
            p = int(up) - 4
            ok = True
            decoded = 0
            while decoded < verify_records and p + 4 <= n:
                (bs,) = struct.unpack_from("<I", data, p)
                if p + 4 + bs > n:
                    break
                if not g._sane_record(data, p, bs):
                    ok = False
                    break
                decoded += 1
                p += 4 + bs
            if ok and decoded:
                return start + int(up) - 4
        if whole:
            return None
        lo = w - _CANDIDATE_REACH
        w *= 2


def guess_bgzf_block_start(data: bytes, beg: int, end: int) -> Optional[int]:
    """The plain BGZF guesser (util/BGZFSplitGuesser.java:64-112): the first
    block start in ``[beg, end)`` whose block inflates with a good CRC, or
    None."""
    window_end = min(len(data), end + 2 * 0xFFFF - 1)
    pos = beg
    while True:
        pos = bgzf.find_next_block(data, pos, min(end, window_end))
        if pos < 0 or pos >= end:
            return None
        try:
            bgzf.inflate_block(data, pos, check_crc=True)
            return pos
        except bgzf.BgzfError:
            pos += 1

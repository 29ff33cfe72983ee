"""FASTQ record-boundary scan: ``csrc/record_scan.cu`` and its plain
version, with the host tiers beneath both.

Counterpart of ``hadoop_bam_tpu/ops/pallas/record_scan.py``.  A chunk is a
window of decoded FASTQ (its claim region ``[0, chunk_len)`` plus an
overlap) and flags ``aligned`` (the window starts at a record start) and
``final`` (the window ends the run).  The scan returns per chunk ``[n, ok]``
and the ``n`` claimed records as rows of 8 int32s ``[id_start, id_len,
seq_start, seq_len, plus_start, plus_len, qual_start, qual_len]``: offsets
window-relative, lengths CR-stripped; a record is claimed when it *starts*
before ``chunk_len``.  Sync is two back-to-back verified frames ``(@, seq,
+, qual)`` with ``len(seq) == len(qual)``.

The verdicts are the Pallas kernel's: a bad frame, a record past the
chunk's cap, a claimed frame left partial, dangling claimed text and a
window that never synced over content give ``ok = 0``, and such a chunk
tiers down to :func:`scan_window_host` (the NumPy reference) and, beneath
it, :func:`scan_window_py` (the walker, which also carries the salvage
semantics).  The launch gate is the reference's too (``size`` past
:data:`_MAX_WINDOW`, ``vmem`` past its TPU budget, caps taken per group of
128 chunks in order), so the same chunks tier down for the same reasons;
the one difference is :func:`default_rec_cap`, see there.  One launch
takes every chunk of a call, each with its own cap, reading the windows in
place from one flat byte tensor.
"""

from __future__ import annotations

import sys
import types
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import _build
from ...spec.fragment import FormatException
from ...utils.tracing import Metrics
from . import LaunchCounter, check_tensor, on_device, stream_handle, use_plain

LAUNCHES = LaunchCounter("record_scan")

#: Chunks per launch group of the reference (its 128 vector lanes); the
#: caps and the ``vmem`` gate are taken per group.
LANES = 128

#: The reference's VMEM budget for one launch; it gates launch groups.
_VMEM_BUDGET_BYTES = 14 << 20

#: Window cap per chunk (bytes).
_MAX_WINDOW = 1 << 17

_AT = 0x40     # '@'
_PLUS = 0x2B   # '+'
_NL = 0x0A
_CR = 0x0D

#: Rows of the reference's per-lane register file (part of its VMEM rule).
_ST_ROWS = 40

_REC_W = 8


class WindowOverrun(Exception):
    """A claimed record does not finish inside the scan window; the caller
    rescans the whole run serially."""


@dataclass
class RecordScanStats:
    """Where each chunk of a scan went, and why the fallen fell."""

    lanes: int = 0            # chunks scanned by the kernel (or its plain version)
    host: int = 0             # chunks left to the host tiers
    launches: int = 0
    reasons: Dict[str, int] = field(default_factory=dict)

    def tier_down(self, reason: str) -> None:
        self.host += 1
        self.reasons[reason] = self.reasons.get(reason, 0) + 1


def scan_geometry(max_window: int, rec_cap: int) -> Tuple[int, int]:
    """The reference's launch geometry: input words per lane (4 bytes per
    int32, padded to a 256-word step) and its record-tile row count."""
    n_words = max(256, -(-max_window // 4))
    n_words = -(-n_words // 256) * 256
    return n_words, _REC_W * rec_cap


def accepts(max_window: int, rec_cap: int) -> Tuple[bool, str]:
    """The reference's gate for one launch group: ``(True, "")`` or
    ``(False, "size" | "vmem")``."""
    if max_window > _MAX_WINDOW:
        return False, "size"
    n_words, rec_rows = scan_geometry(max_window, rec_cap)
    vmem = (n_words + rec_rows + _ST_ROWS + 8) * LANES * 4
    if vmem > _VMEM_BUDGET_BYTES:
        return False, "vmem"
    return True, ""


def default_rec_cap(max_window: int) -> int:
    """Record capacity for a window: the 6-byte minimum record bounds the
    count, rounded up to a multiple of 64 and clamped to the largest
    multiple of 64 that :func:`accepts` takes.

    The reference rounds up *after* its clamp, so from windows of about
    18 KB up its cap fails its own gate and every group tiers down
    ``vmem``: at the default 57,088 + 2,048-byte windows its scan never
    launches.  The port clamps after rounding.  Where the reference's cap
    passes its gate the two caps are equal (ROADMAP C)."""
    cap = -(-(max_window // 6 + 2) // 64) * 64
    n_words, _ = scan_geometry(max_window, 1)
    budget_rows = _VMEM_BUDGET_BYTES // (LANES * 4) - n_words - _ST_ROWS - 8
    return min(cap, max(64, (budget_rows // _REC_W) // 64 * 64))


# ---------------------------------------------------------------------------
# The kernel and its plain version


#: The card's geometry: bytes a shared-memory tile and threads a block
#: (``csrc/record_scan.cu``; tuned at the ingest's R1 windows on an H100,
#: PERF.md).
TILE = 6144
THREADS = 128

#: The kernel's phases, in the order of its cycle counts (``_launch``'s
#: ``cycles``): the tile loads' wait, the newline count and block scan, the
#: line table, the decisions and emit, the synthetic final line and verdicts.
PHASES = ("wait", "count", "lines", "decide", "tail")


def _columns(data: torch.Tensor, win_off, win_len, chunk_len, aligned, final, caps,
             metrics: Optional[Metrics] = None):
    """The launch's columns on ``data``'s device (win_off, win_len,
    chunk_len, flags, caps, row_base: the rows of one int64 ``[6, n]``
    tensor, one upload) and its outputs ``rows`` and ``meta``,
    uninitialised."""
    check_tensor(data, "data", torch.uint8)
    off = np.asarray(win_off, np.int64)
    wl = np.asarray(win_len, np.int64)
    n = len(off)
    if n and (int(wl.max()) > _MAX_WINDOW or int(off.min()) < 0
              or int((off + wl).max()) > data.numel()):
        raise IndexError("scan_windows: a window lies outside the data or the window cap")
    cap = np.asarray(caps, np.int64)
    base = np.zeros(n, np.int64)
    if n:
        np.cumsum(cap[:-1], out=base[1:])
    flags = np.asarray(aligned, np.int64) | (np.asarray(final, np.int64) << 1)
    bank = np.stack([off, wl, np.asarray(chunk_len, np.int64), flags, cap, base])
    dev = data.device
    cols = list(torch.from_numpy(bank).to(dev))
    if dev.type == "cuda" and metrics is not None:
        metrics.count_h2d(bank.nbytes, "scan_cols")
    rows = torch.empty((int(cap.sum()), _REC_W), dtype=torch.int32, device=dev)
    meta = torch.empty((n, 2), dtype=torch.int32, device=dev)
    return cols, rows, meta


def _launch(data: torch.Tensor, cols, rows: torch.Tensor, meta: torch.Tensor,
            tile: int = TILE, threads: int = THREADS,
            cycles: Optional[torch.Tensor] = None) -> None:
    """The kernel over ``_columns``' outputs, on the card: ``tile`` bytes a
    tile (a multiple of 16), ``threads`` (128 or 256) a block; with
    ``cycles`` (int64 ``[len(PHASES)]`` on the card), each phase's clock
    cycles summed over the blocks are added to it.  Raises on a launch
    error."""
    n = meta.shape[0]
    if n == 0:
        return
    if cycles is not None and (cycles.dtype != torch.int64 or cycles.numel() != len(PHASES)):
        raise ValueError("cycles must be int64 with one entry a phase")
    lib = _build.load("record_scan")
    rc = lib.hbt_record_scan(
        data.data_ptr(), *(c.data_ptr() for c in cols), rows.data_ptr(), meta.data_ptr(),
        n, tile, threads, cycles.data_ptr() if cycles is not None else None,
        stream_handle(data),
    )
    _build.check(rc, "record_scan")
    LAUNCHES.add()


def scan_windows(data: torch.Tensor, win_off, win_len, chunk_len, aligned, final, caps,
                 metrics: Optional[Metrics] = None):
    """Scan windows ``data[win_off[k] : + win_len[k]]`` of a flat uint8
    tensor, each under its own cap, in one launch.

    Columns are host arrays.  Returns ``(rows, meta, row_base)`` on
    ``data``'s device: ``rows`` int32 ``[sum(caps), 8]`` (chunk k's records
    from row ``row_base[k]``; rows past its ``n`` are undefined), ``meta``
    int32 ``[n_chunks, 2]`` = ``[n, ok]`` and ``row_base`` int64."""
    cols, rows, meta = _columns(data, win_off, win_len, chunk_len, aligned, final, caps,
                                metrics)
    if use_plain(data, *cols):
        record_scan_plain(data, *cols, rows, meta)
    else:
        _launch(data, cols, rows, meta)
    return rows, meta, cols[5]


def _scan_one(w: np.ndarray, chunk_len: int, aligned: bool, final: bool, cap: int,
              out: np.ndarray) -> Tuple[int, int]:
    """One chunk through the kernel's line machine; records go to ``out``.
    Returns ``[n, ok]``."""
    n = len(w)
    fc = [-1] * 8
    ln = [0] * 8
    st = [0] * 8
    lc = base = nrec = done = 0
    ok = 1
    synced = 1 if aligned else 0

    def line(first: int, eff: int, start: int) -> bool:
        nonlocal lc, synced, base, nrec, ok, done
        del fc[0], ln[0], st[0]
        fc.append(first)
        ln.append(eff)
        st.append(start)
        lc += 1
        frame_a = fc[0] == _AT and fc[2] == _PLUS and ln[1] == ln[3]
        frame_b = fc[4] == _AT and fc[6] == _PLUS and ln[5] == ln[7]
        can_sync = not synced and lc >= 8 and frame_a and frame_b
        sync_claim = can_sync and st[0] < chunk_len
        sync_beyond = can_sync and st[0] >= chunk_len
        bnd = synced and ((lc - base) & 3) == 0
        claim_b = st[4] < chunk_len
        emit2 = (bnd or sync_claim) and claim_b and frame_b
        bad = bnd and claim_b and not frame_b
        done_now = ((bnd or sync_claim) and not claim_b) or sync_beyond
        over = nrec + int(sync_claim) + int(emit2) > cap
        if not over:
            for h, go in ((0, sync_claim), (4, emit2)):
                if go:
                    out[nrec] = (st[h], ln[h], st[h + 1], ln[h + 1],
                                 st[h + 2], ln[h + 2], st[h + 3], ln[h + 3])
                    nrec += 1
        if bad or over:
            ok = 0
        if done_now:
            done = 1
        if sync_claim:
            synced = 1
            base = lc - 8
        return not ok or done

    cur_start = 0
    stopped = False
    for p in np.flatnonzero(w == _NL).tolist():
        raw = p - cur_start
        first, eff = (int(w[cur_start]), raw - int(w[p - 1] == _CR)) if raw else (-1, 0)
        start, cur_start = cur_start, p + 1
        if line(first, eff, start):
            stopped = True
            break
    cur_len = 0 if stopped else n - cur_start
    if not stopped and final and cur_len > 0:
        line(int(w[cur_start]), cur_len - int(w[n - 1] == _CR), cur_start)
        cur_len, cur_start = 0, n
    pend = (lc - base) & 3
    part_start = st[8 - pend] if pend else 0
    bad_tail = synced and not done and pend != 0 and part_start < chunk_len
    bad_text = not done and cur_len > 0 and cur_start < chunk_len
    bad_sync = not synced and not done and (lc > 0 or cur_len > 0)
    if bad_tail or bad_text or bad_sync:
        ok = 0
    return nrec, ok


def record_scan_plain(data, win_off, win_len, chunk_len, flags, caps, row_base, rows, meta):
    """The plain version on CPU tensors: the kernel's line machine, one
    chunk at a time over the window's newline table; fills ``rows`` and
    ``meta`` as the kernel does."""
    a = data.numpy()
    r = rows.numpy()
    m = meta.numpy()
    off, wl, cl = win_off.numpy(), win_len.numpy(), chunk_len.numpy()
    fl, cap, rb = flags.numpy(), caps.numpy(), row_base.numpy()
    for k in range(len(off)):
        o, b = int(off[k]), int(rb[k])
        m[k] = _scan_one(a[o : o + int(wl[k])], int(cl[k]), bool(fl[k] & 1), bool(fl[k] & 2),
                         int(cap[k]), r[b : b + int(cap[k])])


def compact_rows(rows: torch.Tensor, meta: torch.Tensor, row_base: torch.Tensor,
                 metrics: Optional[Metrics] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The records of every chunk with ``ok = 1``, back to back, on the host.

    A prefix sum over ``n * ok`` gathers the used rows on the device, so
    only they and ``meta`` come back.  Returns ``(meta, rows)`` as numpy."""
    meta_h = meta.cpu().numpy()
    on_card = rows.device.type == "cuda" and metrics is not None
    if on_card:
        metrics.count_d2h(meta_h.nbytes, "scan_meta")
    used = (meta_h[:, 0] * meta_h[:, 1]).astype(np.int64)
    total = int(used.sum())
    if total == 0:
        return meta_h, np.zeros((0, _REC_W), np.int32)
    n_ok = (meta[:, 0] * meta[:, 1]).to(torch.int64)
    first = torch.cumsum(n_ok, 0) - n_ok
    chunk = torch.repeat_interleave(torch.arange(len(n_ok), device=rows.device), n_ok,
                                    output_size=total)
    src = row_base[chunk] + torch.arange(total, device=rows.device) - first[chunk]
    out = rows[src].cpu().numpy()
    if on_card:
        metrics.count_d2h(out.nbytes, "scan_rows")
    return meta_h, out


# ---------------------------------------------------------------------------
# The tier ladder over one flat byte tensor


def record_scan_windows(
    data: torch.Tensor, starts, lens, chunk_lens, aligned, final,
    rec_cap: Optional[int] = None, metrics: Optional[Metrics] = None,
) -> Tuple[List[Optional[np.ndarray]], RecordScanStats]:
    """The reference's ``record_scan`` over windows read in place from
    ``data`` (on the card: the kernel; on the CPU: the plain version).

    Returns ``(tables, stats)``: per chunk an ``[n, 8]`` int32 record table,
    or None for a chunk that tiered down (``size`` or ``vmem`` before the
    launch, ``scan`` for ok = 0), plus the tier taxonomy."""
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    stats = RecordScanStats()
    outs: List[Optional[np.ndarray]] = [None] * len(starts)
    accepted = []
    for i, ln in enumerate(lens.tolist()):
        if ln > _MAX_WINDOW:
            stats.tier_down("size")
        else:
            accepted.append(i)
    launch: List[int] = []
    caps: List[int] = []
    for g0 in range(0, len(accepted), LANES):
        group = accepted[g0 : g0 + LANES]
        max_win = int(lens[group].max())
        cap = rec_cap if rec_cap is not None else default_rec_cap(max_win)
        okg, reason = accepts(max_win, cap)
        if not okg:
            for _ in group:
                stats.tier_down(reason)
            continue
        launch += group
        caps += [cap] * len(group)
    if not launch:
        return outs, stats
    idx = np.asarray(launch, np.int64)
    rows, meta, base = scan_windows(
        data, starts[idx], lens[idx], np.asarray(chunk_lens, np.int64)[idx],
        np.asarray(aligned, bool)[idx], np.asarray(final, bool)[idx], caps, metrics=metrics,
    )
    stats.launches += 1
    meta_h, table = compact_rows(rows, meta, base, metrics)
    pos = 0
    for j, i in enumerate(launch):
        n, ok = int(meta_h[j, 0]), int(meta_h[j, 1])
        if not ok:
            stats.tier_down("scan")
            continue
        stats.lanes += 1
        outs[i] = table[pos : pos + n].copy()
        pos += n
    return outs, stats


def record_scan(chunks, rec_cap: Optional[int] = None, device=None,
                metrics: Optional[Metrics] = None,
                ) -> Tuple[List[Optional[np.ndarray]], RecordScanStats]:
    """The reference's ``record_scan``: ``chunks`` of ``(window,
    chunk_len, aligned, final)``, packed back to back into one upload (to
    the card unless ``device="cpu"``) and scanned by
    :func:`record_scan_windows`, one launch a call.  Returns ``(tables,
    stats)`` as that does."""
    wins = [bytes(c[0]) for c in chunks]
    lens = np.array([len(w) for w in wins], np.int64)
    data = on_device(np.frombuffer(bytearray(b"".join(wins)), np.uint8), torch.uint8, device)
    return record_scan_windows(data, np.cumsum(lens) - lens, lens, [c[1] for c in chunks],
                               [c[2] for c in chunks], [c[3] for c in chunks],
                               rec_cap=rec_cap, metrics=metrics)


# ---------------------------------------------------------------------------
# Host tiers: the NumPy scan is the reference for every chunk the kernel
# reports ok; the walker beneath it carries the salvage semantics.  Both
# are the reference's, unchanged.


def _line_table_np(win: np.ndarray, final: bool):
    """Completed lines of a window: (starts, first raw byte or -1,
    CR-stripped lengths, unterminated tail start or -1).  On a final
    window the unterminated tail counts as a last line, exactly as the
    kernel's synthetic final newline."""
    nl = np.flatnonzero(win == _NL)
    starts = np.concatenate(([0], nl + 1)).astype(np.int64)
    tail_start = int(starts[-1]) if starts[-1] < len(win) else -1
    if final and tail_start >= 0:
        ends = np.concatenate((nl, [len(win)])).astype(np.int64)
        tail_start = -1
    else:
        ends = nl.astype(np.int64)
    starts = starts[: len(ends)]
    raw = ends - starts
    eff = raw.copy()
    if len(ends):
        has_cr = (raw > 0) & (win[np.maximum(ends - 1, 0)] == _CR)
        eff = raw - has_cr.astype(np.int64)
    fc = np.full(len(starts), -1, np.int64)
    if len(starts):
        nonempty = raw > 0
        fc[nonempty] = win[starts[nonempty]]
    return starts, fc, eff, tail_start


def scan_window_host(win, chunk_len: int, aligned: bool, final: bool) -> np.ndarray:
    """Vectorized NumPy record scan of one window.  Raises
    :class:`FormatException` on a frame violation or a truncated claimed
    record, and :class:`WindowOverrun` when a claimed record runs past a
    non-final window."""
    win = np.frombuffer(bytes(win), np.uint8)
    if len(win) == 0:
        return np.zeros((0, _REC_W), np.int32)
    starts, fc, eff, tail_start = _line_table_np(win, final)
    nlines = len(starts)

    # frame[i]: lines i..i+3 form one (@, seq, +, qual) frame.
    frame = np.zeros(nlines, bool)
    if nlines >= 4:
        frame[: nlines - 3] = (
            (fc[: nlines - 3] == _AT) & (fc[2: nlines - 1] == _PLUS)
            & (eff[1: nlines - 2] == eff[3: nlines])
        )

    if aligned:
        l0 = 0
    else:
        # Two-consecutive-verified-records rule, with the end-of-data
        # relaxation (a final window trusts a lone trailing frame).
        ver = np.zeros(nlines, bool)
        if nlines >= 8:
            ver[: nlines - 7] = frame[: nlines - 7] & frame[4: nlines - 3]
        if final and nlines >= 4:
            lo = max(0, nlines - 7)
            ver[lo: nlines - 3] |= frame[lo: nlines - 3]
        cand = np.flatnonzero(ver)
        if len(cand) == 0 or starts[int(cand[0])] >= chunk_len:
            # No trusted record start inside the claim: the tail of the
            # previous chunk's record, or garbage; the caller's run-tiling
            # reconciliation tells the two apart.
            return np.zeros((0, _REC_W), np.int32)
        l0 = int(cand[0])

    recs = []
    li = l0
    while li < nlines and starts[li] < chunk_len:
        if li + 3 >= nlines:
            if final:
                raise FormatException("fastq: truncated record at end of input")
            raise WindowOverrun("fastq: claimed record overruns window")
        if not frame[li]:
            raise FormatException("fastq: frame violation at offset %d" % starts[li])
        recs.append([
            starts[li], eff[li], starts[li + 1], eff[li + 1],
            starts[li + 2], eff[li + 2], starts[li + 3], eff[li + 3],
        ])
        li += 4
    if tail_start >= 0 and tail_start < chunk_len and li >= nlines:
        raise WindowOverrun("fastq: claimed record overruns window")
    return np.asarray(recs, np.int32).reshape(len(recs), _REC_W)


def scan_window_py(
    win, chunk_len: int, aligned: bool, final: bool, salvage: bool = False
) -> Tuple[np.ndarray, int]:
    """Plain-Python walker, one line at a time.  With ``salvage=True`` a
    frame violation or truncated claimed tail quarantines whole 4-line
    frames (never tearing one) and resyncs with the two-record rule;
    returns ``(records, n_quarantine_events)``."""
    win = bytes(win)
    lines = []       # (start, first byte or -1, eff len)
    pos = 0
    while pos < len(win):
        nl = win.find(b"\n", pos)
        if nl < 0:
            if not final:
                break
            nl = len(win)
        raw = nl - pos
        eff = raw - (1 if raw and win[nl - 1: nl] == b"\r" else 0)
        lines.append((pos, win[pos] if raw else -1, eff))
        pos = nl + 1
    tail_start = pos if pos < len(win) else -1
    n_quar = 0

    def frame_at(i):
        """True/False for a complete 4-line frame at ``i``; None when fewer
        than 4 lines remain."""
        if i + 3 >= len(lines):
            return None
        return (lines[i][1] == _AT and lines[i + 2][1] == _PLUS
                and lines[i + 1][2] == lines[i + 3][2])

    def sync_from(i0):
        for i in range(i0, len(lines)):
            fa = frame_at(i)
            if fa is None:
                break
            if not fa:
                continue
            fb = frame_at(i + 4)
            if not (fb or (fb is None and final)):
                continue
            if lines[i][0] >= chunk_len:
                return None   # the first trusted start belongs to the next chunk
            return i
        return None   # no trusted start: the previous chunk's tail, or garbage

    recs = []
    li = 0 if aligned else sync_from(0)
    while li is not None and li < len(lines) and lines[li][0] < chunk_len:
        fr = frame_at(li)
        if fr:
            s = lines[li: li + 4]
            recs.append([s[0][0], s[0][2], s[1][0], s[1][2],
                         s[2][0], s[2][2], s[3][0], s[3][2]])
            li += 4
            continue
        if fr is None and not final:
            raise WindowOverrun("fastq: claimed record overruns window")
        if not salvage:
            raise FormatException(
                "fastq: %s at offset %d" % (
                    "truncated record" if fr is None else "frame violation",
                    lines[li][0],
                )
            )
        n_quar += 1
        if fr is None:
            li = None
            break
        try:
            li = sync_from(li + 1)
        except (FormatException, WindowOverrun):
            li = None
    if tail_start >= 0 and tail_start < chunk_len \
            and li is not None and li >= len(lines):
        raise WindowOverrun("fastq: claimed record overruns window")
    return (np.asarray(recs, np.int32).reshape(len(recs), _REC_W), n_quar)


class _ScanModule(types.ModuleType):
    """The package exports :func:`record_scan` under this module's name, as
    the reference's does; calling the module calls the function, so that
    ``kernels.record_scan`` is both the module and the entry point."""

    def __call__(self, *args, **kwargs):
        return record_scan(*args, **kwargs)


sys.modules[__name__].__class__ = _ScanModule

"""Daemon flight recorder and access log: bounded JSONL rings on disk.

Counterpart of ``hadoop_bam_tpu/serve/flightrec.py``.
:class:`FlightRecorder` snapshots the daemon's gauges (queue depth,
admission tokens, arena and cache occupancy) and its degradation counters
(sheds, out-of-memory tier-downs, journal events, SLO alerts) at a
cadence into a two-segment ring (``<base>.0`` / ``<base>.1``, flushed a
line at a time, the older half reclaimed when the active one passes half
the budget); a graceful drain writes one ``"final": true`` snapshot, so a
ring without one is evidence of an unclean death.  :class:`AccessLog`
writes one line a completed request through the same ring.  The loaders
read both segments back, torn lines tolerated, as the reference's
stdlib-only ``tools/flightrec_report.py`` does.  Counters go to
``metrics``, the daemon's registry.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.tracing import MetricsRegistry

DEFAULT_CADENCE_MS = 500
DEFAULT_RING_BYTES = 1 << 20
DEFAULT_ACCESS_LOG_BYTES = 4 << 20

#: Counter prefixes worth replaying after a crash: the degradation story.
SNAPSHOT_COUNTER_PREFIXES = (
    "serve.admission.shed",
    "serve.admission.admitted",
    "serve.oom.",
    "serve.deadline.",
    "serve.journal.",
    "serve.jobs_",
    "serve.request_errors",
    "serve.slo.",
    "serve.trace.",
    "hbm.leaked",
    "hbm.double_copy",
)


def default_source(metrics: MetricsRegistry) -> Dict[str, dict]:
    """Fallback snapshot source: registry gauges + degradation counters
    (the daemon passes a richer closure over its live context)."""
    counters = metrics.counters()
    return {
        "gauges": metrics.gauges(),
        "counters": {
            k: v
            for k, v in counters.items()
            if k.startswith(SNAPSHOT_COUNTER_PREFIXES)
        },
    }


def segment_paths(base: str) -> Tuple[str, str]:
    return base + ".0", base + ".1"


class JsonlRing:
    """The two-segment JSONL ring writer, factored out so the flight
    recorder and the per-request access log share one rotation scheme:
    append to the active segment (flushed per line), and when it crosses
    half the byte budget, truncate the other segment and switch —
    bounded disk, at least half the budget of survivable history.

    Not itself thread-safe: callers serialize appends (both owners
    already hold their own locks)."""

    def __init__(
        self, base: str, max_bytes: int, rotate_metric: str, metrics=None
    ) -> None:
        self.base = base
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.max_bytes = max(8 << 10, int(max_bytes))
        self._rotate_metric = rotate_metric
        self._f = None
        self._active = 0

    def prepare(self, active: int = 0) -> None:
        d = os.path.dirname(os.path.abspath(self.base))
        if d:
            os.makedirs(d, exist_ok=True)
        self._active = active

    def append(self, rec: dict) -> None:
        """One record as a flushed JSONL line (a SIGKILL after return
        loses at most a torn tail on a *later* line)."""
        if self._f is None:
            self._f = open(segment_paths(self.base)[self._active], "ab")
        self._f.write(json.dumps(rec, sort_keys=True).encode() + b"\n")
        self._f.flush()
        if self._f.tell() > self.max_bytes // 2:
            self._f.close()
            self._active ^= 1
            # Truncate the segment we are rotating onto: the ring
            # reclaims the oldest half.
            self._f = open(segment_paths(self.base)[self._active], "wb")
            self.metrics.count(self._rotate_metric, 1)

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            finally:
                self._f = None


class FlightRecorder:
    """Bounded JSONL ring writer with a periodic snapshot thread."""

    def __init__(
        self,
        base_path: str,
        cadence_s: float = DEFAULT_CADENCE_MS / 1e3,
        max_bytes: int = DEFAULT_RING_BYTES,
        source: Optional[Callable[[], dict]] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.base = base_path
        self.cadence = max(0.02, float(cadence_s))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._ring = JsonlRing(
            base_path, max_bytes, "serve.flightrec.rotations", self.metrics
        )
        self._source = source or (lambda: default_source(self.metrics))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self._finalized = False

    # -- segment management -------------------------------------------------

    def _scan_existing(self) -> None:
        """Resume numbering after the highest surviving seq (a restarted
        daemon extends the ring; pre-death history stays replayable until
        rotation naturally reclaims it)."""
        best_seq, best_idx = -1, 0
        for idx, p in enumerate(segment_paths(self.base)):
            try:
                with open(p, "rb") as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                            if int(rec.get("seq", -1)) > best_seq:
                                best_seq = int(rec["seq"])
                                best_idx = idx
                        except (ValueError, TypeError):
                            continue  # torn line
            except OSError:
                continue
        self._seq = best_seq + 1
        self._ring.prepare(active=best_idx)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._scan_existing()
        self.snapshot()  # an immediate baseline record
        self._thread = threading.Thread(
            target=self._run, name="hbam-flightrec", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.cadence):
            try:
                self.snapshot()
            except Exception:  # noqa: BLE001 - the recorder never kills
                self.metrics.count("serve.flightrec.errors", 1)

    def snapshot(self, final: bool = False) -> dict:
        """Write one snapshot record (thread-safe; flushed so a SIGKILL
        after return cannot lose it)."""
        rec = {
            "seq": 0,  # patched under the lock
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
            "final": bool(final),
        }
        try:
            rec.update(self._source() or {})
        except Exception:  # noqa: BLE001 - snapshot beats perfection
            self.metrics.count("serve.flightrec.source_errors", 1)
        with self._lock:
            if self._finalized:
                return rec
            rec["seq"] = self._seq
            self._seq += 1
            self._ring.append(rec)
            if final:
                self._finalized = True
        self.metrics.count("serve.flightrec.snapshots", 1)
        return rec

    def stop(self, final: bool = True) -> None:
        """Finalize the ring (SIGTERM drain / shutdown op): one last
        snapshot flagged ``final`` so replay can tell a clean drain from
        a kill, then close.  Idempotent."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final:
            try:
                self.snapshot(final=True)
            except Exception:  # noqa: BLE001
                self.metrics.count("serve.flightrec.errors", 1)
        with self._lock:
            self._ring.close()


class AccessLog:
    """One structured JSONL line per completed request (trace id, op,
    outcome, duration, queue/batch waits, tier decisions, shed/OOM
    flags), rotated with the same two-segment scheme as the flight
    recorder, so the per-request history is bounded on disk and joins
    with the exemplar store on ``trace_id``."""

    def __init__(
        self, base_path: str, max_bytes: int = DEFAULT_ACCESS_LOG_BYTES,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.base = base_path
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._ring = JsonlRing(
            base_path, max_bytes, "serve.accesslog.rotations", self.metrics
        )
        self._lock = threading.Lock()
        self._ring.prepare()

    def log(self, record: dict) -> None:
        try:
            with self._lock:
                self._ring.append(record)
            self.metrics.count("serve.accesslog.lines", 1)
        except OSError:
            # Logging must never fail a request; the error is counted.
            self.metrics.count("serve.accesslog.errors", 1)

    def close(self) -> None:
        with self._lock:
            self._ring.close()


def load_jsonl_segments(base: str) -> Tuple[List[dict], int]:
    """Read both segments of a two-segment ring back, in file order:
    ``(records, torn_line_count)``.  Accepts the base path or either
    segment path; tolerant of torn final lines and missing segments.
    Ordering across segments is the caller's (flight-recorder rings
    sort by ``seq``; access logs by ``t_wall``)."""
    if base.endswith((".0", ".1")) and not os.path.exists(base + ".0"):
        base = base[:-2]
    recs: List[dict] = []
    torn = 0
    for p in segment_paths(base):
        try:
            with open(p, "rb") as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        recs.append(json.loads(line))
                    except (ValueError, TypeError):
                        torn += 1
        except OSError:
            continue
    return recs, torn


def load_access_log(base: str) -> Tuple[List[dict], int]:
    """An access log's records ordered by wall time, plus torn count."""
    recs, torn = load_jsonl_segments(base)
    recs.sort(key=lambda r: r.get("t_wall", 0.0))
    return recs, torn


def load_ring(base: str) -> Tuple[List[dict], int]:
    """Read a ring back: ``(snapshots ordered by seq, torn_line_count)``.
    Accepts the base path or either segment path; tolerant of torn final
    lines (the kill -9 case) and missing segments."""
    recs, torn = load_jsonl_segments(base)
    snaps: Dict[int, dict] = {}
    for rec in recs:
        try:
            snaps[int(rec["seq"])] = rec
        except (KeyError, ValueError, TypeError):
            torn += 1
    return [snaps[k] for k in sorted(snaps)], torn

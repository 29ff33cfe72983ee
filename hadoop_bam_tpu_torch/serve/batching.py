"""Cross-request lane batching: many small requests, one inflate launch.

Counterpart of ``hadoop_bam_tpu/serve/batching.py``.  A daemon answering
many concurrent small ``view`` requests would pay one launch of kernel
row 1 (``csrc/inflate.cu``) per request for a handful of members each.
:class:`LaneBatcher` is the queue that coalesces them: requests submit
their members and block; a worker holds the first arrival for a short
window, drains what accumulated (up to :data:`MAX_LANES` members),
concatenates the members into one back-to-back stream (BGZF members are
self-contained, so members of different files share a launch), decodes
it once and hands each request its slice.

The decode function is pluggable.  :func:`default_decode_fn` with the
daemon's stream is the stream's own seam: with the inflate gate on (the
default on a card) every coalesced launch is one
:meth:`~..device_stream.DeviceStream.decode_members`, i.e. one row-1
launch; with it off, the host's member inflate.  Counters
(``serve.batch.launches``, ``.members``, ``.requests``,
``.coalesced_requests``) go to ``metrics``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .. import faults
from ..spec import bgzf
from ..utils.deadline import Deadline, DeadlineExceeded
from ..utils.tracing import TRACER, MetricsRegistry, current_request

#: Members coalesced into one launch: the reference's lane capacity, kept
#: so that the ``serve.batch.*`` counts equal the reference's.  Kernel row
#: 1 on the card has no lane cap (one warp a member, as many CTAs as
#: members).
MAX_LANES = 128


def default_decode_fn(stream=None) -> Callable:
    """The batcher's decode: ``decode(raw, co, cs, us) -> (out, offsets,
    window)``.  With a ``stream`` whose inflate gate is on, its
    :meth:`~..device_stream.DeviceStream.decode_members` (device errors
    propagate, so the serve out-of-memory ladder stays in charge a layer
    up; ``window`` is the payload on the device, or None); otherwise the
    host's member inflate (``window`` None)."""
    if stream is not None and stream.policy.inflate_lanes:
        return stream.decode_members

    def decode(raw, co, cs, us):
        out, offs = bgzf.inflate_blocks(raw, co, cs, us)
        return out, offs, None

    return decode


class _Pending:
    __slots__ = ("raw", "co", "cs", "us", "out", "offs", "window", "err", "done", "deadline",
                 "rctx", "t_submit", "t_launch", "coalesced")

    def __init__(self, raw, co, cs, us, deadline=None):
        self.raw = raw
        self.co = co
        self.cs = cs
        self.us = us
        self.out = None
        self.offs = None
        self.window = None
        self.err: Optional[BaseException] = None
        self.done = threading.Event()
        self.deadline: Optional[Deadline] = deadline
        # Captured at submit: the worker thread has no ambient request.
        self.rctx = current_request()
        self.t_submit = time.perf_counter()
        self.t_launch: Optional[float] = None
        self.coalesced = 1

    @property
    def n_members(self) -> int:
        return len(self.co)


class LaneBatcher:
    """The queue that coalesces member inflates into shared launches.

    ``window_s`` is how long the first submission of a batch waits for
    company (0: every submission launches alone).  A launch takes whole
    requests up to ``max_lanes`` members (a request larger than that
    launches alone)."""

    def __init__(self, window_s: float = 0.002, decode_fn: Optional[Callable] = None,
                 max_lanes: int = MAX_LANES, stream=None,
                 metrics: Optional[MetricsRegistry] = None):
        self.window_s = max(0.0, float(window_s))
        self.max_lanes = max(1, int(max_lanes))
        self._decode = decode_fn or default_decode_fn(stream)
        if metrics is None:
            metrics = stream.metrics if stream is not None else MetricsRegistry()
        self.metrics = metrics
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._wake = threading.Event()
        self._closed = False
        self._worker = threading.Thread(target=self._run, name="hbam-lane-batcher", daemon=True)
        self._worker.start()

    # -- request side ---------------------------------------------------------

    def submit(self, raw, coffsets, csizes, usizes,
               deadline: Optional[Deadline] = None) -> Tuple[np.ndarray, np.ndarray, object]:
        """Decode one request's members, blocking: ``(out, out_offsets,
        window)`` with member i's payload at ``out[out_offsets[i] :
        out_offsets[i + 1]]`` and ``window`` the same bytes on the device
        (or None).  ``deadline`` is checked at submission and again when
        the worker drains the queue: a request that expired while queued
        fails with ``DeadlineExceeded`` and takes no lane."""
        if self._closed:
            raise RuntimeError("LaneBatcher is closed")
        if deadline is not None:
            deadline.check("batcher", self.metrics)
        raw_a = raw if isinstance(raw, np.ndarray) else np.frombuffer(raw, dtype=np.uint8)
        p = _Pending(raw_a, np.asarray(coffsets, dtype=np.int64),
                     np.asarray(csizes, dtype=np.int32), np.asarray(usizes, dtype=np.int32),
                     deadline=deadline)
        with self._lock:
            self._queue.append(p)
        self._wake.set()
        p.done.wait()
        if p.rctx is not None:
            # Split at the launch: "batch.wait" is the window and the lane
            # contention, "batch.decode" the shared launch, which has
            # finished (its bytes are on the host) when the waiter wakes.
            t_end = time.perf_counter()
            t_launch = p.t_launch if p.t_launch is not None else t_end
            p.rctx.annotate("batch.wait", ms=(t_launch - p.t_submit) * 1e3,
                            members=p.n_members, coalesced=p.coalesced)
            if p.t_launch is not None:
                p.rctx.annotate("batch.decode", ms=(t_end - t_launch) * 1e3)
        if p.err is not None:
            raise p.err
        return p.out, p.offs, p.window

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        self._worker.join(timeout=5.0)

    # -- worker side ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            self._wake.wait()
            if self._closed and not self._queue:
                return
            if self.window_s:
                time.sleep(self.window_s)
            expired: List[_Pending] = []
            with self._lock:
                if not self._queue:
                    self._wake.clear()
                    continue
                batch: List[_Pending] = []
                lanes = 0
                while self._queue:
                    nxt = self._queue[0]
                    if nxt.deadline is not None and nxt.deadline.expired:
                        expired.append(self._queue.pop(0))
                        continue
                    if batch and lanes + nxt.n_members > self.max_lanes:
                        break
                    batch.append(self._queue.pop(0))
                    lanes += nxt.n_members
                if not self._queue:
                    self._wake.clear()
            for p in expired:
                try:
                    p.deadline.check("batcher", self.metrics)
                except DeadlineExceeded as e:
                    p.err = e
                p.done.set()
            if batch:
                self._launch(batch)

    def _launch(self, batch: List[_Pending]) -> None:
        t0 = time.perf_counter()
        for p in batch:
            p.t_launch = t0
            p.coalesced = len(batch)
        try:
            if faults.ACTIVE is not None and faults.ACTIVE.arena_oom("lane_batcher",
                                                                     self.metrics):
                # Reaches every waiter as a real out-of-memory would.
                raise faults.InjectedResourceExhausted("lane_batcher")
            parts: List[np.ndarray] = []
            co_l: List[int] = []
            cs_l: List[int] = []
            us_l: List[int] = []
            pos = 0
            for p in batch:
                for k in range(p.n_members):
                    c0 = int(p.co[k])
                    cs = int(p.cs[k])
                    parts.append(p.raw[c0 : c0 + cs])
                    co_l.append(pos)
                    cs_l.append(cs)
                    us_l.append(int(p.us[k]))
                    pos += cs
            cat = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
            out, offs, window = self._decode(cat, np.asarray(co_l, dtype=np.int64),
                                             np.asarray(cs_l, dtype=np.int32),
                                             np.asarray(us_l, dtype=np.int32))
            m = self.metrics
            m.count("serve.batch.launches", 1)
            m.count("serve.batch.members", len(co_l))
            m.count("serve.batch.requests", len(batch))
            if len(batch) > 1:
                m.count("serve.batch.coalesced_requests", len(batch))
            if TRACER.armed:
                # One event a shared launch, carrying every rider's trace.
                traces = sorted({p.rctx.trace_id for p in batch if p.rctx is not None})
                TRACER.emit("serve.batch.launch", "stage", t0, time.perf_counter(),
                            {"members": len(co_l), "requests": len(batch), "traces": traces},
                            merge_ctx=False)
            m0 = 0
            for p in batch:
                m1 = m0 + p.n_members
                lo, hi = int(offs[m0]), int(offs[m1])
                p.out = out[lo:hi]
                p.offs = np.asarray(offs[m0 : m1 + 1], dtype=np.int64) - lo
                # Each request owns its own copy of its window: the launch's
                # buffer frees once every request has taken its slice.
                p.window = window[lo:hi].clone() if window is not None else None
                m0 = m1
        except BaseException as e:  # noqa: BLE001 - delivered to the waiters
            for p in batch:
                p.err = e
        finally:
            for p in batch:
                p.done.set()

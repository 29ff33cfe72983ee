"""Admission control: bounded queueing, cost classes, typed load shedding.

Counterpart of ``hadoop_bam_tpu/serve/admission.py``.  Every data-plane op
charges a token cost (``view`` 1, ``flagstat`` 2, ``sort`` 4, ...) against
a shared budget; control-plane ops (``ping``, ``job``, ``stats``, ...)
are never gated, so the daemon stays observable and drainable at any
load.  A request that cannot start at once waits only while the queue is
shallow and fast: a queue deeper than ``hadoopbam.serve.max-queue`` sheds
with code ``SHED``, a recent queue-wait p95 over
``hadoopbam.serve.max-queue-ms`` sheds with ``RETRY_AFTER``, both with a
``retry_after_ms`` hint; a queued request whose deadline expires fails
with ``DEADLINE_EXCEEDED`` in the queue.  A ``sort`` holds its tokens for
its job's lifetime.  :class:`FleetLedger` is the router's fleet-wide pool
and per-file cap (:mod:`.router`).
Counters and the ``serve.admission.queue_wait.ms`` histogram go to
``metrics``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Optional

from ..utils.deadline import Deadline
from ..utils.tracing import TRACER, MetricsRegistry, current_request

# -- the serve protocol's typed error codes ---------------------------------
#: Admission refused the request outright: the queue is full.  Retryable
#: after the reply's ``retry_after_ms``.
SHED = "SHED"
#: Admission refused the request softly: queueing is too slow right now
#: (queue-wait p95 over budget).  Retryable after ``retry_after_ms``.
RETRY_AFTER = "RETRY_AFTER"
#: The request's end-to-end deadline expired at a seam.  NOT retryable —
#: the client's budget is spent.
DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"
#: The daemon does not know this job id (it restarted and the journal
#: could not account for it, or the id never existed).  NOT retryable.
JOB_LOST = "JOB_LOST"

#: Every code the server can put in a reply's ``code`` field.  The
#: client maps each to a typed exception; tests/test_torch_serve.py asserts
#: the mapping round-trips.
ERROR_CODES = (SHED, RETRY_AFTER, DEADLINE_EXCEEDED, JOB_LOST)

#: Token cost per data-plane op.  Ops absent here are control plane and
#: bypass admission entirely (the daemon must answer ping/stats/drain
#: even — especially — while shedding everything else).
DEFAULT_COSTS: Dict[str, int] = {
    "view": 1, "flagstat": 2, "variants": 1, "depth": 2,
    "sort": 4, "ingest": 4,
}

DEFAULT_TOKENS = 8
DEFAULT_MAX_QUEUE = 64
#: 0 disables the queue-wait p95 shed rule (depth still bounds).
DEFAULT_MAX_QUEUE_MS = 0


class ShedError(RuntimeError):
    """The daemon refused to admit a request (overload).

    ``code`` is :data:`SHED` (queue depth) or :data:`RETRY_AFTER`
    (queue-wait p95); ``retry_after_ms`` is the server-computed backoff
    hint the reply carries.
    """

    def __init__(self, code: str, retry_after_ms: int, why: str):
        self.code = code
        self.retry_after_ms = int(retry_after_ms)
        super().__init__(
            f"request shed ({why}); retry after ~{retry_after_ms} ms"
        )


class Ticket:
    """Held admission tokens; release exactly once (idempotent)."""

    __slots__ = ("_ctrl", "cost", "_released")

    def __init__(self, ctrl: "AdmissionController", cost: int):
        self._ctrl = ctrl
        self.cost = cost
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._ctrl._release(self.cost)

    def __enter__(self) -> "Ticket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _NullTicket:
    """Control-plane ops: nothing held, nothing to release."""

    cost = 0

    def release(self) -> None:
        pass

    def __enter__(self) -> "_NullTicket":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_TICKET = _NullTicket()

#: Recent queue waits kept for the p95 shed rule and the backoff hint —
#: a small sliding window, deliberately not the lifetime histogram (an
#: hour-old fast quantile must not mask a fresh stall).
_RECENT_WINDOW = 64


class AdmissionController:
    """Token-budget admission with a bounded, shed-on-overload queue."""

    def __init__(
        self,
        tokens: int = DEFAULT_TOKENS,
        max_queue: int = DEFAULT_MAX_QUEUE,
        max_queue_ms: float = DEFAULT_MAX_QUEUE_MS,
        costs: Optional[Dict[str, int]] = None,
        name: str = "serve.admission",
        metrics: Optional[MetricsRegistry] = None,
    ):
        if tokens < 1:
            raise ValueError("tokens must be >= 1")
        self.tokens = int(tokens)
        self.max_queue = max(0, int(max_queue))
        self.max_queue_ms = float(max_queue_ms)
        self.costs = dict(DEFAULT_COSTS if costs is None else costs)
        self.name = name
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._cond = threading.Condition()
        self._in_use = 0
        self._queued = 0
        self._recent_wait_ms: Deque[float] = collections.deque(
            maxlen=_RECENT_WINDOW
        )

    # -- introspection ------------------------------------------------------

    def gauges(self) -> Dict[str, float]:
        with self._cond:
            return {
                f"{self.name}.tokens": self.tokens,
                f"{self.name}.tokens_in_use": self._in_use,
                f"{self.name}.queue_depth": self._queued,
            }

    def _recent_p95_ms(self) -> float:
        waits = sorted(self._recent_wait_ms)
        if not waits:
            return 0.0
        return waits[min(len(waits) - 1, int(0.95 * len(waits)))]

    def _hint_ms(self) -> int:
        """The ``retry_after_ms`` backoff hint: roughly how long until a
        queue slot should free — recent mean service-side wait scaled by
        the backlog, clamped to a sane band.  A hint, not a promise."""
        waits = self._recent_wait_ms
        base = (sum(waits) / len(waits)) if waits else 50.0
        backlog = self._queued + max(1, self._in_use // max(1, self.tokens))
        return int(min(5000, max(10, base * backlog + 10)))

    # -- acquire / release --------------------------------------------------

    def acquire(
        self, op: str, deadline: Optional[Deadline] = None
    ):
        """Admit ``op`` or raise (:class:`ShedError` /
        :class:`~..utils.deadline.DeadlineExceeded`).

        Returns a :class:`Ticket` (release when the work — for ``sort``,
        the *job* — finishes) or :data:`NULL_TICKET` for control-plane
        ops.  Use as a context manager for inline ops.
        """
        cost = self.costs.get(op)
        if cost is None:
            return NULL_TICKET
        # A cost above the whole budget would never fit; clamp so a heavy
        # op can still run alone (the single-oversized-entry cache rule).
        cost = min(int(cost), self.tokens)
        t0 = time.perf_counter()
        with self._cond:
            if self._in_use + cost > self.tokens:
                # Cannot start now: shed or queue — decided at arrival,
                # so a shed reply is immediate (overload must not slow
                # down saying "no").
                if self._queued >= self.max_queue:
                    hint = self._hint_ms()
                    self.metrics.count(f"{self.name}.shed", 1)
                    self.metrics.count(f"{self.name}.shed.queue_full", 1)
                    rctx = current_request()
                    if rctx is not None:
                        rctx.annotate(
                            "queue.shed", reason="queue_full", op=op
                        )
                    raise ShedError(
                        SHED, hint,
                        f"admission queue full ({self._queued} >= "
                        f"max-queue {self.max_queue})",
                    )
                if (
                    self.max_queue_ms > 0
                    and self._recent_p95_ms() > self.max_queue_ms
                ):
                    hint = self._hint_ms()
                    self.metrics.count(f"{self.name}.shed", 1)
                    self.metrics.count(f"{self.name}.shed.slow_queue", 1)
                    rctx = current_request()
                    if rctx is not None:
                        rctx.annotate(
                            "queue.shed", reason="slow_queue", op=op
                        )
                    raise ShedError(
                        RETRY_AFTER, hint,
                        f"queue-wait p95 {self._recent_p95_ms():.0f} ms "
                        f"over max-queue-ms {self.max_queue_ms:.0f}",
                    )
                self._queued += 1
                try:
                    while self._in_use + cost > self.tokens:
                        timeout = None
                        if deadline is not None:
                            rem = deadline.remaining_ms() / 1e3
                            if rem <= 0:
                                deadline.check("admission", self.metrics)  # raises
                            timeout = rem
                        self._cond.wait(timeout)
                finally:
                    self._queued -= 1
            self._in_use += cost
        wait_ms = (time.perf_counter() - t0) * 1e3
        self._recent_wait_ms.append(wait_ms)
        self.metrics.count(f"{self.name}.admitted", 1)
        self.metrics.observe(f"{self.name}.queue_wait.ms", wait_ms)
        rctx = current_request()
        if rctx is not None:
            # The waterfall's "queue wait" hop — always on (the tracer
            # ring may be cold; the summary path never is).
            rctx.annotate("queue.wait", ms=wait_ms, op=op, cost=cost)
        if TRACER.armed:
            t1 = time.perf_counter()
            TRACER.emit(
                f"{self.name}.wait", "queue", t1 - wait_ms / 1e3, t1,
                {"op": op, "cost": cost},
            )
        return Ticket(self, cost)

    def _release(self, cost: int) -> None:
        with self._cond:
            self._in_use = max(0, self._in_use - cost)
            self._cond.notify_all()


# -- fleet ledger -----------------------------------------------------------


class FleetLedger:
    """Router-side federated admission: a fleet-wide token pool plus a
    per-file cap, accounted at the routing hop.

    Each member daemon still runs its own :class:`AdmissionController`
    (its bounded queue is the only queue — the router never queues, so
    overload answers stay immediate).  What the members *cannot* see is
    cross-daemon skew: a zipfian workload pins one hot file's warmth on
    its ring owner, and without a fleet view that one daemon's clients
    consume every retry slot while the rest of the fleet idles.  The
    ledger therefore sheds at the front door on two rules:

    - **fleet pool** — at most ``tokens`` cost-units in flight across
      all members (sized ~N × a member's budget; a safety net, not the
      primary gate);
    - **per-file cap** — at most ``file_tokens`` cost-units in flight
      for any single routing key, so one hot file saturates its owner
      at a bounded rate and everyone else's files stay servable
      (``fleet.admission.shed.file_hot``).

    Sheds raise :class:`ShedError` with code :data:`SHED` and a backoff
    hint proportional to the contention, which the client's typed-retry
    path already honors.
    """

    def __init__(
        self,
        tokens: int,
        file_tokens: int,
        costs: Optional[Dict[str, int]] = None,
        name: str = "fleet.admission",
        metrics: Optional[MetricsRegistry] = None,
    ):
        if tokens < 1:
            raise ValueError("tokens must be >= 1")
        if file_tokens < 1:
            raise ValueError("file_tokens must be >= 1")
        self.tokens = int(tokens)
        self.file_tokens = int(file_tokens)
        self.costs = dict(DEFAULT_COSTS if costs is None else costs)
        self.name = name
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._in_use = 0
        self._by_key: Dict[str, int] = {}

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return {
                f"{self.name}.tokens": self.tokens,
                f"{self.name}.tokens_in_use": self._in_use,
                f"{self.name}.hot_files": sum(
                    1 for v in self._by_key.values()
                    if v >= self.file_tokens
                ),
            }

    def acquire(self, op: str, key: Optional[str]):
        """Admit ``op`` against routing key ``key`` or raise
        :class:`ShedError`; returns a release callable (idempotent).
        Control-plane ops (no cost entry) pass untouched."""
        cost = self.costs.get(op)
        if cost is None or key is None:
            return lambda: None
        cost = min(int(cost), self.tokens)
        with self._lock:
            held = self._by_key.get(key, 0)
            if held + cost > self.file_tokens:
                self.metrics.count(f"{self.name}.shed", 1)
                self.metrics.count(f"{self.name}.shed.file_hot", 1)
                raise ShedError(
                    SHED, 25 * (1 + held),
                    f"file over fleet per-file cap ({held} + {cost} > "
                    f"{self.file_tokens})",
                )
            if self._in_use + cost > self.tokens:
                self.metrics.count(f"{self.name}.shed", 1)
                self.metrics.count(f"{self.name}.shed.pool_full", 1)
                raise ShedError(
                    SHED, 25 * (1 + self._in_use // max(1, self.tokens)),
                    f"fleet token pool exhausted ({self._in_use} + {cost} "
                    f"> {self.tokens})",
                )
            self._by_key[key] = held + cost
            self._in_use += cost
        self.metrics.count(f"{self.name}.admitted", 1)
        released = [False]

        def _release() -> None:
            if released[0]:
                return
            released[0] = True
            with self._lock:
                self._in_use = max(0, self._in_use - cost)
                left = self._by_key.get(key, 0) - cost
                if left > 0:
                    self._by_key[key] = left
                else:
                    self._by_key.pop(key, None)

        return _release

"""Elastic per-part execution: the Hadoop task-retry contract, in-process.

Counterpart of ``hadoop_bam_tpu/parallel/executor.py``.  The reference
leaves failures to Hadoop: a failed task is re-executed up to
``mapreduce.{map,reduce}.maxattempts`` times, the restart unit is the part
file, and a completed job is marked by the ``_SUCCESS`` file the mergers
require (util/SAMFileMerger.java:50-54).  ``ElasticExecutor`` keeps that
contract for the part writers:

- one attempt runs ``work_fn(item, tmp_path)``; the part appears under its
  final name only by an atomic rename of the attempt-unique
  ``_temporary.<part>.<attempt>``, so readers never see torn output;
- bounded retries per item with a failure log, exponential backoff between
  attempts (``retry_backoff`` doubled per attempt, with deterministic
  per-item jitter) and an optional per-attempt wall-clock bound
  (``attempt_timeout``: an attempt past it counts failed and is retried;
  its thread is abandoned, never joined, and can never rename its tmp);
- resume: an existing final part is trusted and skipped, after
  ``validate_part`` (:func:`bgzf_part_valid` for BAM parts) accepts it; a
  torn final name is redone (``executor.invalid_part_redone``);
- ``_SUCCESS`` written only when the run does not raise;
- quarantine (salvage): an item that exhausts its attempts is recorded in
  ``ExecutionReport.quarantined`` (``salvage.parts_quarantined``) instead
  of failing the job; the merger's part glob skips the missing name;
- two fault seams: ``fault_hook(item, attempt)`` and the armed
  :mod:`~hadoop_bam_tpu_torch.faults` plan, both no-ops when absent.

Counters (``executor.attempts``, ``retried``, ``skipped_existing``,
``failed_parts``, ``attempt_timeouts``, ``invalid_part_redone``,
``deadline_exceeded``, ``salvage.parts_quarantined`` and the plan's
``faults.fired.*``) go to the job's ``metrics``.  A serve job's
:class:`~..utils.tracing.RequestContext` (``request_ctx``, else the
constructing thread's ambient one) is re-entered on every pool thread and
gets one ``executor.part`` hop a written part and one
``executor.attempt_failed`` hop a failed attempt, retries included.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from .. import faults
from ..utils import nio
from ..utils.deadline import Deadline, DeadlineExceeded
from ..utils.tracing import Metrics, RequestContext, current_request, request_scope


class PartFailedError(RuntimeError):
    """An item exhausted its attempts; carries the per-attempt error log."""

    def __init__(self, failures: Dict[int, List[str]]):
        self.failures = failures
        msgs = "; ".join(f"item {i}: {errs[-1]}" for i, errs in sorted(failures.items()))
        super().__init__(f"{len(failures)} part(s) failed permanently: {msgs}")


class AttemptTimeout(RuntimeError):
    """An attempt exceeded the executor's per-attempt deadline."""


def bgzf_part_valid(path: str) -> bool:
    """The BAM part validator: non-empty and starting with the BGZF magic.
    A torn BGZF chain deeper in is caught by the readers' CRC gates."""
    from ..spec import bgzf

    try:
        if os.path.getsize(path) == 0:
            return False
        with open(path, "rb") as f:
            return f.read(4) == bgzf.MAGIC
    except OSError:
        return False


@dataclass
class ExecutionReport:
    parts: List[str]
    attempts: int
    retried: int
    skipped_existing: int
    failure_log: Dict[int, List[str]] = field(default_factory=dict)
    quarantined: List[int] = field(default_factory=list)


class ElasticExecutor:
    def __init__(
        self,
        out_dir: str,
        max_attempts: int = 3,
        max_workers: Optional[int] = None,
        fault_hook: Optional[Callable[[int, int], None]] = None,
        attempt_timeout: Optional[float] = None,
        retry_backoff: float = 0.0,
        quarantine: bool = False,
        validate_part: Optional[Callable[[str], bool]] = None,
        deadline: Optional[Deadline] = None,
        metrics: Optional[Metrics] = None,
        request_ctx: Optional[RequestContext] = None,
    ) -> None:
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.out_dir = out_dir
        self.max_attempts = max_attempts
        # Each work_fn is itself parallel and holds a part in memory.
        self.max_workers = max_workers or min(4, (os.cpu_count() or 4))
        self.fault_hook = fault_hook
        self.attempt_timeout = attempt_timeout
        self.retry_backoff = retry_backoff
        self.quarantine = quarantine
        self.validate_part = validate_part
        # Checked before every attempt and composed with attempt_timeout:
        # an expired deadline is terminal, not retried.
        self.deadline = deadline
        self.metrics = metrics if metrics is not None else Metrics()
        # Attempts run on pool threads, where the ambient request does not
        # follow: it is captured here and re-entered around each attempt.
        self.request_ctx = request_ctx if request_ctx is not None else current_request()

    def _backoff(self, item: int, attempt: int) -> None:
        """Exponential backoff before retry ``attempt`` (>= 1) of ``item``,
        with deterministic jitter so concurrent retries spread out."""
        if self.retry_backoff <= 0 or attempt == 0:
            return
        base = self.retry_backoff * (2 ** (attempt - 1))
        jitter = 0.75 + ((item * 2654435761 + attempt * 40503) % 512) / 1024.0
        time.sleep(base * jitter)

    def _deadline_check(self) -> None:
        self.metrics.count("executor.deadline_exceeded", 1)
        self.deadline.check("executor", self.metrics)  # raises

    def _run_attempt(self, work_fn, item, tmp: str) -> None:
        """One attempt under the optional wall-clock bounds.  With a bound
        the work runs in a watchdog thread; on expiry the attempt is
        recorded failed and the thread abandoned (its tmp name is
        attempt-unique, and only this thread renames).  The deadline's
        expiry is terminal (``DeadlineExceeded``), the attempt timeout's
        is retried."""
        timeout = self.attempt_timeout
        if self.deadline is not None:
            if self.deadline.expired:
                self._deadline_check()
            remaining = max(self.deadline.remaining_ms() / 1e3, 0.001)
            timeout = remaining if timeout is None else min(timeout, remaining)
        if timeout is None:
            work_fn(item, tmp)
            return
        box: List = [None]

        def target() -> None:
            try:
                work_fn(item, tmp)
            except BaseException as e:  # noqa: BLE001 - relayed below
                box[0] = e

        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join(timeout)
        if t.is_alive():
            if self.deadline is not None and self.deadline.expired:
                self._deadline_check()
            self.metrics.count("executor.attempt_timeouts", 1)
            raise AttemptTimeout(f"attempt exceeded deadline of {self.attempt_timeout}s")
        if box[0] is not None:
            raise box[0]

    def run(
        self,
        items: Sequence,
        work_fn: Callable[[object, str], None],
        part_name: Callable[[int], str] = lambda i: f"part-r-{i:05d}",
        mark_success: bool = True,
    ) -> ExecutionReport:
        """Run ``work_fn(item, tmp_path)`` per item; the final part paths
        come back in item order.  Raises :class:`PartFailedError` if an
        item exhausts its attempts (unless ``quarantine``: then the item
        is skipped and reported).  ``_SUCCESS`` is withheld only on a
        raise."""
        os.makedirs(self.out_dir, exist_ok=True)
        n = len(items)
        parts = [os.path.join(self.out_dir, part_name(i)) for i in range(n)]
        attempts = 0
        retried = 0
        skipped = 0
        failures: Dict[int, List[str]] = {}
        lock = threading.Lock()

        def run_one(i: int) -> None:
            nonlocal attempts, retried, skipped
            final = parts[i]
            if os.path.exists(final):
                if self.validate_part is None or self.validate_part(final):
                    with lock:
                        skipped += 1
                    return
                # A torn final name (a crashed os.replace race): redo it.
                self.metrics.count("executor.invalid_part_redone", 1)
                try:
                    os.remove(final)
                except OSError:
                    pass
            errs: List[str] = []
            for attempt in range(self.max_attempts):
                if self.deadline is not None and self.deadline.expired:
                    self._deadline_check()
                # Hadoop's _temporary convention: the underscore keeps an
                # attempt out of the mergers' part glob.
                tmp = os.path.join(self.out_dir,
                                   f"_temporary.{os.path.basename(final)}.{attempt}")
                try:
                    with lock:
                        attempts += 1
                        if attempt > 0:
                            retried += 1
                    self._backoff(i, attempt)
                    if self.fault_hook is not None:
                        self.fault_hook(i, attempt)
                    if faults.ACTIVE is not None:
                        faults.ACTIVE.exec_attempt(i, attempt, tmp, self.metrics)
                    t_att = time.perf_counter()
                    self._run_attempt(work_fn, items[i], tmp)
                    os.replace(tmp, final)
                    if self.request_ctx is not None:
                        self.request_ctx.annotate("executor.part",
                                                  ms=(time.perf_counter() - t_att) * 1e3,
                                                  part=i, attempt=attempt)
                    return
                except Exception as e:  # noqa: BLE001 - the retry boundary
                    errs.append(f"attempt {attempt}: {type(e).__name__}: {e}")
                    if self.request_ctx is not None:
                        self.request_ctx.annotate("executor.attempt_failed", part=i,
                                                  attempt=attempt, error=type(e).__name__)
                    # Sweep the tmp file and the side files derived from it
                    # (the part writer's tmp + ".sb" index).
                    base = os.path.basename(tmp)
                    for fn in os.listdir(self.out_dir):
                        if fn.startswith(base):
                            try:
                                os.remove(os.path.join(self.out_dir, fn))
                            except OSError:
                                pass
                    if isinstance(e, DeadlineExceeded):
                        raise
            with lock:
                failures[i] = errs

        def run_one_scoped(i: int) -> None:
            with request_scope(self.request_ctx):
                run_one(i)

        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            list(pool.map(run_one_scoped, range(n)))

        self.metrics.count("executor.attempts", attempts)
        self.metrics.count("executor.retried", retried)
        self.metrics.count("executor.skipped_existing", skipped)
        quarantined: List[int] = []
        if failures:
            self.metrics.count("executor.failed_parts", len(failures))
            if not self.quarantine:
                raise PartFailedError(failures)
            # Salvage: degraded output beats a dead job; the part name is
            # absent, which the mergers' glob tolerates.
            quarantined = sorted(failures)
            self.metrics.count("salvage.parts_quarantined", len(quarantined))
        if mark_success:
            nio.write_success(self.out_dir)
        return ExecutionReport(parts=parts, attempts=attempts, retried=retried,
                               skipped_existing=skipped, failure_log=failures,
                               quarantined=quarantined)

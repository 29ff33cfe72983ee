"""End-to-end deadlines: one budget carried through the seams that burn time.

Counterpart of ``hadoop_bam_tpu/utils/deadline.py``: :class:`Deadline`,
:class:`DeadlineExceeded`, and the thread-ambient
:func:`current_deadline` / :func:`deadline_scope`.  A deadline is an
absolute monotonic expiry, checked (never polled) at a seam, which raises
instead of doing work nobody will read: the daemon's dispatch, admission,
the lane batcher, the endpoints' window loops, the stream's stages and
the part executor.  The port has no process-wide metrics: an expiry
counts ``serve.deadline.exceeded`` (and ``...<seam>``) into the
deadline's own ``metrics`` when it has one (the daemon gives the
request's deadline its registry), else into the ``metrics`` the seam
passes.  With no deadline set a seam is one ``is None`` branch.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional

from .tracing import current_request


class DeadlineExceeded(RuntimeError):
    """A deadline expired at ``seam``; retrying cannot help."""

    def __init__(self, seam: str, remaining_ms: float = 0.0):
        self.seam = seam
        super().__init__(
            f"deadline exceeded at the {seam} seam ({abs(remaining_ms):.1f} ms over)"
        )


class Deadline:
    """An absolute monotonic expiry.  Seam names are metric-name
    components (lowercase, no dots): ``dispatch``, ``admission``,
    ``batcher``, ``endpoint``, ``stream_read``, ``executor``, ..."""

    __slots__ = ("expires_at", "metrics")

    def __init__(self, expires_at: float, metrics=None):
        self.expires_at = float(expires_at)
        self.metrics = metrics

    @classmethod
    def after_ms(cls, ms: float, metrics=None) -> "Deadline":
        return cls(time.monotonic() + float(ms) / 1e3, metrics)

    @classmethod
    def from_request(cls, req: dict, metrics=None) -> Optional["Deadline"]:
        """The request's ``deadline_ms`` budget, or None; a malformed
        value is treated as absent."""
        ms = req.get("deadline_ms")
        if ms is None:
            return None
        try:
            return cls.after_ms(float(ms), metrics)
        except (TypeError, ValueError):
            return None

    def remaining_ms(self) -> float:
        return (self.expires_at - time.monotonic()) * 1e3

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def check(self, seam: str, metrics=None) -> None:
        """Raise if expired (counted, and annotated on the ambient
        request); free otherwise."""
        rem = self.remaining_ms()
        if rem <= 0.0:
            sink = self.metrics if self.metrics is not None else metrics
            if sink is not None:
                sink.count("serve.deadline.exceeded", 1)
                sink.count(f"serve.deadline.exceeded.{seam}", 1)
            rctx = current_request()
            if rctx is not None:
                rctx.annotate(f"deadline.{seam}", over_ms=abs(rem))
            raise DeadlineExceeded(seam, rem)


# The serve handler thread sets the ambient deadline once; the seams it
# calls synchronously (read_split -> inflate_fn -> the lane batcher) pick
# it up.  Work handed to other threads gets the deadline explicitly.
_TLS = threading.local()


def current_deadline() -> Optional[Deadline]:
    return getattr(_TLS, "deadline", None)


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]) -> Iterator[None]:
    """Ambient deadline for the current thread (None: leave it)."""
    if deadline is None:
        yield
        return
    old = getattr(_TLS, "deadline", None)
    _TLS.deadline = deadline
    try:
        yield
    finally:
        _TLS.deadline = old

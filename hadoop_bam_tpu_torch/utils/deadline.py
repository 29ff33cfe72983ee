"""End-to-end deadlines: one budget carried through the seams that burn time.

Counterpart of ``hadoop_bam_tpu/utils/deadline.py``'s :class:`Deadline` and
:class:`DeadlineExceeded`: an absolute monotonic expiry, checked (never
polled) at a seam, which raises instead of doing work nobody will read.  The
part executor is its one seam until the serve layer (ROADMAP A.11).  The port
has no process-wide metrics: :meth:`Deadline.check` counts
``serve.deadline.exceeded`` into the ``metrics`` it is given.  With no
deadline set a seam is one ``is None`` branch.
"""

from __future__ import annotations

import time


class DeadlineExceeded(RuntimeError):
    """A deadline expired at ``seam``; retrying cannot help."""

    def __init__(self, seam: str, remaining_ms: float = 0.0):
        self.seam = seam
        super().__init__(
            f"deadline exceeded at the {seam} seam ({abs(remaining_ms):.1f} ms over)"
        )


class Deadline:
    """An absolute monotonic expiry.  Seam names are metric-name
    components (lowercase, no dots): ``executor``, ``pipeline``, ..."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float):
        self.expires_at = float(expires_at)

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(time.monotonic() + float(ms) / 1e3)

    def remaining_ms(self) -> float:
        return (self.expires_at - time.monotonic()) * 1e3

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def check(self, seam: str, metrics=None) -> None:
        """Raise (and count into ``metrics``) if expired; free otherwise."""
        rem = self.remaining_ms()
        if rem <= 0.0:
            if metrics is not None:
                metrics.count("serve.deadline.exceeded", 1)
                metrics.count(f"serve.deadline.exceeded.{seam}", 1)
            raise DeadlineExceeded(seam, rem)

"""Counters of one run: tier-downs, residency, host↔device bytes.

Counterpart of the counter half of ``hadoop_bam_tpu/utils/tracing.py``;
counter names are the reference's, so the two packages' counts can be
compared.  A :class:`Metrics` belongs to the job that creates it.
"""

from __future__ import annotations

import threading
from typing import Dict


class Metrics:
    def __init__(self) -> None:
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def get(self, name: str) -> int:
        return self._counters.get(name, 0)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def count_h2d(self, nbytes: int, what: str) -> None:
        self.count("transfers.h2d_bytes", nbytes)
        self.count(f"transfers.h2d.{what}", nbytes)

    def count_d2h(self, nbytes: int, what: str) -> None:
        self.count("transfers.d2h_bytes", nbytes)
        self.count(f"transfers.d2h.{what}", nbytes)

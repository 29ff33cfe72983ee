"""Warm residency arena: decoded split windows kept across requests.

Counterpart of ``hadoop_bam_tpu/serve/arena.py``'s :class:`HbmArena`: an
LRU of decoded :class:`~..io.bam.RecordBatch` windows (and the variant
plane's batches) under a byte budget, keyed by ``(kind, file identity,
span)``.  A window keeps its ``device_data``, the inflate kernel's copy
on the card, when it has one; dropping an entry drops the arena's
reference, and the card memory frees when the last reference goes, so the
budget bounds the card's residency too.  A hit skips the read, the
inflate, the record walk and the SoA decode.  Counters and gauges
(``serve.arena.{hit,miss,evict,device_resident}``,
``serve.oom.evictions``, ``serve.cache.stale_evict``;
``serve.arena.{budget_bytes,used_bytes,entries}``) go to ``metrics``.
The reference's HBM ledger calls are not ported (ROADMAP A.14).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Hashable, Optional

from ..utils.tracing import MetricsRegistry


def _batch_nbytes(batch) -> int:
    """A held batch's charge: payload + SoA columns + keys (the device
    copy mirrors the payload and is charged once)."""
    n = len(batch.data)
    for col in batch.soa.values():
        n += getattr(col, "nbytes", 0)
    keys = getattr(batch, "keys", None)
    if keys is not None:
        n += getattr(keys, "nbytes", 0)
    return n


class HbmArena:
    """LRU residency arena under a byte budget (thread-safe)."""

    def __init__(self, budget_bytes: int = 1 << 30, name: str = "serve.arena",
                 metrics: Optional[MetricsRegistry] = None):
        if budget_bytes < 1:
            raise ValueError("budget_bytes must be >= 1")
        self.budget = budget_bytes
        self.name = name
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, tuple]" = OrderedDict()
        self.used_bytes = 0
        self.metrics.set_gauge(f"{self.name}.budget_bytes", budget_bytes)
        self._publish_gauges()

    def __len__(self) -> int:
        return len(self._entries)

    def _publish_gauges(self) -> None:
        self.metrics.set_gauge(f"{self.name}.used_bytes", self.used_bytes)
        self.metrics.set_gauge(f"{self.name}.entries", len(self._entries))

    def get(self, key: Hashable):
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.metrics.count(f"{self.name}.miss", 1)
                return None
            self._entries.move_to_end(key)
            self.metrics.count(f"{self.name}.hit", 1)
            return e[1]

    def hold(self, key: Hashable, batch, nbytes: Optional[int] = None) -> None:
        """Adopt a decoded window (replacing any entry under the key); the
        least recently used entries go until the budget holds, the new one
        always stays."""
        nb = int(nbytes if nbytes is not None else _batch_nbytes(batch))
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.used_bytes -= old[0]
            self._entries[key] = (nb, batch)
            self.used_bytes += nb
            if getattr(batch, "device_data", None) is not None:
                self.metrics.count(f"{self.name}.device_resident", 1)
            while self.used_bytes > self.budget and len(self._entries) > 1:
                _, (nb_old, _) = self._entries.popitem(last=False)
                self.used_bytes -= nb_old
                self.metrics.count(f"{self.name}.evict", 1)
            self._publish_gauges()

    def evict_stale(self, path: str, current_identity: tuple) -> int:
        """Drop every window of ``path`` decoded under another identity (a
        file rewritten in place); counts ``serve.cache.stale_evict``."""
        dropped = 0
        with self._lock:
            stale = [k for k in self._entries
                     if isinstance(k, tuple) and len(k) >= 2 and isinstance(k[1], tuple)
                     and len(k[1]) == 3 and k[1][0] == path and k[1] != current_identity]
            for k in stale:
                nb, _ = self._entries.pop(k)
                self.used_bytes -= nb
                dropped += 1
            if dropped:
                self._publish_gauges()
        if dropped:
            self.metrics.count("serve.cache.stale_evict", dropped)
        return dropped

    def evict_lru(self, n: int = 1) -> int:
        """Drop the ``n`` least recently used entries: the first rung of
        the out-of-memory ladder.  Counts ``serve.oom.evictions``."""
        dropped = 0
        with self._lock:
            while self._entries and dropped < n:
                _, (nb, _) = self._entries.popitem(last=False)
                self.used_bytes -= nb
                dropped += 1
            self._publish_gauges()
        if dropped:
            self.metrics.count("serve.oom.evictions", dropped)
        return dropped

    def release_all(self) -> None:
        """Drop everything (the daemon's drain)."""
        with self._lock:
            self._entries.clear()
            self.used_bytes = 0
            self._publish_gauges()

    def stats(self) -> dict:
        with self._lock:
            device_resident = sum(1 for _, b in self._entries.values()
                                  if getattr(b, "device_data", None) is not None)
            return {"entries": len(self._entries), "used_bytes": self.used_bytes,
                    "budget_bytes": self.budget, "device_resident": device_resident}

"""Header and index cache of the resident daemon, keyed by file identity.

Counterpart of ``hadoop_bam_tpu/serve/cache.py``.  Entries are keyed by
``(path, size, mtime_ns)``: a rewritten or touched file is a different
key, so staleness shows at lookup (the entry is dropped and reloaded).
The cache is an LRU under a byte budget, a miss is loaded once however
many requests wait on it (single flight), and every lookup counts
``serve.cache.{hit,miss,stale,evict,stampede_wait}`` (hits and misses
also per kind) into the ``metrics`` it is given.  Files are read through
the port's :mod:`~..io.fs`.
"""

from __future__ import annotations

import io
import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional, Tuple

from ..utils.tracing import Metrics

#: ``(path, size, mtime_ns)``: the staleness key.
FileIdentity = Tuple[str, int, int]


def file_identity(path: str) -> FileIdentity:
    st = os.stat(path)
    return (path, st.st_size, st.st_mtime_ns)


class _Flight:
    """One in-flight load: waiters block on ``done`` and share
    ``value``/``err``."""

    __slots__ = ("done", "value", "err")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.value: Any = None
        self.err: Optional[BaseException] = None


class LruByteCache:
    """Thread-safe identity-validating LRU cache under a byte budget."""

    def __init__(self, budget_bytes: int = 256 << 20, name: str = "serve.cache",
                 metrics: Optional[Metrics] = None):
        if budget_bytes < 1:
            raise ValueError("budget_bytes must be >= 1")
        self.budget = budget_bytes
        self.name = name
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = threading.Lock()
        # (kind, path) -> (identity, nbytes, value); insertion order = LRU.
        self._entries: "OrderedDict[Tuple[str, str], Tuple[FileIdentity, int, Any]]" = OrderedDict()
        self.used_bytes = 0
        self._inflight_lock = threading.Lock()
        self._inflight: dict = {}

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, kind: str, path: str, identity: Optional[FileIdentity] = None):
        """The cached value, or None.  A changed identity drops the entry
        (counted ``stale`` on top of the miss)."""
        if identity is None:
            try:
                identity = file_identity(path)
            except OSError:
                identity = None
        key = (kind, path)
        m = self.metrics
        with self._lock:
            e = self._entries.get(key)
            if e is not None and identity is not None and e[0] == identity:
                self._entries.move_to_end(key)
                m.count(f"{self.name}.hit", 1)
                m.count(f"{self.name}.hit.{kind}", 1)
                return e[2]
            if e is not None:
                self.used_bytes -= e[1]
                del self._entries[key]
                m.count(f"{self.name}.stale", 1)
        m.count(f"{self.name}.miss", 1)
        m.count(f"{self.name}.miss.{kind}", 1)
        return None

    def put(self, kind: str, path: str, value: Any, nbytes: int,
            identity: Optional[FileIdentity] = None) -> None:
        if identity is None:
            identity = file_identity(path)
        key = (kind, path)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.used_bytes -= old[1]
            self._entries[key] = (identity, int(nbytes), value)
            self.used_bytes += int(nbytes)
            # The entry just put survives even when it alone is over budget.
            while self.used_bytes > self.budget and len(self._entries) > 1:
                _, (_, nb, _) = self._entries.popitem(last=False)
                self.used_bytes -= nb
                self.metrics.count(f"{self.name}.evict", 1)

    def get_or_load(self, kind: str, path: str, loader: Callable[[str], Any],
                    sizer: Callable[[Any], int]):
        """:meth:`get`, else ``loader(path)`` and :meth:`put`, outside the
        lock and once per key: concurrent misses wait on the first
        (``serve.cache.stampede_wait``) and share its value or its
        exception."""
        ident = file_identity(path)
        v = self.get(kind, path, identity=ident)
        if v is not None:
            return v
        key = (kind, path)
        with self._inflight_lock:
            flight = self._inflight.get(key)
            leader = flight is None
            if leader:
                flight = self._inflight[key] = _Flight()
        if not leader:
            self.metrics.count(f"{self.name}.stampede_wait", 1)
            flight.done.wait()
            if flight.err is not None:
                raise flight.err
            return flight.value
        try:
            ident = file_identity(path)
            v = loader(path)
            self.put(kind, path, v, sizer(v), identity=ident)
            flight.value = v
            return v
        except BaseException as e:
            flight.err = e
            raise
        finally:
            with self._inflight_lock:
                self._inflight.pop(key, None)
            flight.done.set()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "used_bytes": self.used_bytes,
                    "budget_bytes": self.budget}


def _sizeof_saveable(obj) -> int:
    """The serialized size of an index with ``save(stream)``."""
    buf = io.BytesIO()
    obj.save(buf)
    return buf.tell()


class ResourceCache:
    """The daemon's header and index cache: BAM and CRAM headers, ``.bai``,
    ``.splitting-bai``, ``.tbi`` and BCF split plans, each validated by
    file identity on every lookup.  A warm ``view`` reads no header or
    index: its ``serve.cache.miss`` delta is zero."""

    def __init__(self, budget_bytes: int = 256 << 20, metrics: Optional[Metrics] = None):
        self.lru = LruByteCache(budget_bytes, name="serve.cache", metrics=metrics)

    def identity(self, path: str) -> FileIdentity:
        return file_identity(path)

    def header(self, path: str):
        """``(BamHeader, first-record virtual offset)`` of a BAM, or of a
        CRAM (its file-header container; offset 0)."""
        from ..io.anysam import infer_from_file_path
        from ..io.bam import read_header_voffset

        def load(p: str):
            if infer_from_file_path(p) == "cram":
                from ..io.cram import read_cram_header

                return read_cram_header(p), 0
            return read_header_voffset(p)

        def size(v) -> int:
            hdr = v[0]
            return len(hdr.text) + sum(len(n) + 16 for n, _ in hdr.refs) + 64

        return self.lru.get_or_load("header", path, load, size)

    def bai(self, path: str):
        """The ``.bai`` of a BAM: the companion file when there is one,
        else built from the BAM.  The key follows the file read."""
        from ..io import fs
        from ..io.bam import _find_bai
        from ..spec import indices

        bai_path = _find_bai(path)
        if bai_path is not None:
            return self.lru.get_or_load(
                "bai", bai_path, lambda p: indices.Bai.load(fs.get_fs(p).read_all(p)),
                _sizeof_saveable)
        return self.lru.get_or_load(
            "bai-derived", path, lambda p: indices.build_bai(fs.get_fs(p).read_all(p)),
            _sizeof_saveable)

    def splitting_bai(self, path: str):
        """The ``.splitting-bai`` companion, or None."""
        from ..io import fs
        from ..spec import indices

        idx_path = path + indices.SPLITTING_BAI_EXT
        if not fs.get_fs(idx_path).exists(idx_path):
            return None
        return self.lru.get_or_load(
            "splitting-bai", idx_path,
            lambda p: indices.SplittingBai.load(fs.get_fs(p).read_all(p)),
            lambda v: 8 * v.size())

    def tabix(self, path: str):
        """The ``.tbi`` companion of a tabix-indexed file, or None."""
        from ..io import fs
        from ..spec import indices

        tbi_path = path + ".tbi"
        if not fs.get_fs(tbi_path).exists(tbi_path):
            return None
        return self.lru.get_or_load(
            "tbi", tbi_path, lambda p: indices.Tabix.load(fs.get_fs(p).read_all(p)),
            lambda v: sum(16 * sum(len(c) for c in r.bins.values()) + 8 * len(r.linear)
                          for r in v.refs) + 64)

    def bcf_plan(self, path: str):
        """``(BcfHeader, record-start splits)`` of a BCF: the variant
        plane's index (the guesser walks the file once; warm queries plan
        nothing)."""
        from ..conf import Configuration
        from ..io.bcf import BcfInputFormat, _read_bcf_header_prefix

        def load(p: str):
            hdr, _ = _read_bcf_header_prefix(p)
            return hdr, BcfInputFormat(Configuration(), metrics=self.lru.metrics).get_splits([p])

        def size(v) -> int:
            hdr, splits = v
            return 4096 + sum(len(c) + 16 for c in hdr.contigs) + 80 * len(splits)

        return self.lru.get_or_load("bcf-plan", path, load, size)

    def stats(self) -> dict:
        return self.lru.stats()

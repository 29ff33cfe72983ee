"""The fleet's substrate: the ring, membership, death forensics, warmth.

Counterpart of ``hadoop_bam_tpu/serve/fleet.py``; the router
(:mod:`.router`) and the daemons (:mod:`.server`) stand on it, and either
package's router places either package's daemons:

- :class:`HashRing`: consistent hashing with virtual nodes over
  :func:`file_key`, the serve cache's ``(path, size, mtime_ns)`` identity
  flattened.  Positions are 64-bit ``blake2b`` digests (:func:`stable_hash`;
  never Python's salted ``hash()``), the vnode labels are ``name#v`` and a
  key's owner is the first point past its hash, wrapping: the reference's
  bytes, so both packages name the same owner, successor and shares.
- membership: each daemon publishes one JSON record in the shared fleet
  directory (:func:`write_member`, tmp + rename) and refreshes it every
  heartbeat (:class:`Heartbeater`); the record names the endpoint, the
  journal, the flight recorder's base and the pid, and a draining daemon's
  last record says ``draining``.
- :func:`classify_death`: the flight recorder's verdict on a silent
  member.  A ring whose last snapshot is ``final`` is a clean drain (no
  adoption); snapshots without a final one (a torn final line included)
  are an unclean death; no ring is unknown.  Unclean and unknown adopt
  (:func:`should_adopt`): the journal's resume is identity-checked and
  idempotent, so adopting too often costs little and too rarely loses jobs.
- warmth: :func:`pack_windows` ships a path's decoded arena windows as
  BGZF members (each window's records gathered into one dense stream,
  deflated on the host by :func:`~..spec.bgzf.deflate_blocks`, the
  reference's bytes); :func:`unpack_windows` inflates them through the
  receiving daemon's stream (kernel row 1 on the card, its plain version
  on the CPU), walks the record chain and gathers the SoA on the host, the
  read path's decode, so an imported window answers as a locally read one.

Counters (``fleet.heartbeats``, ``fleet.heartbeat_errors``,
``fleet.members.unreadable``, ``fleet.migrate.*``) go to the ``metrics``
each call is handed, the daemon's or the router's registry.
"""

from __future__ import annotations

import base64
import binascii
import bisect
import hashlib
import json
import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..io.bam import RecordBatch, gather_record_array
from ..spec import bam, bgzf
from ..utils.intervals import FormatError
from ..utils.tracing import Metrics
from . import flightrec as flightrec_mod
from .cache import file_identity
from .endpoints import FLAGSTAT_FIELDS, VIEW_FIELDS

DEFAULT_VNODES = 64
DEFAULT_HEARTBEAT_MS = 500
#: A member whose record is older than this is presumed dead (the router
#: then reads its flight recorder before adopting).
DEFAULT_HEARTBEAT_TIMEOUT_MS = 3000
#: Windows one ``warmth`` export ships at most.
DEFAULT_MAX_WINDOWS = 64

#: Death verdicts, in decreasing order of certainty.
CLEAN = "clean"
UNCLEAN = "unclean"
UNKNOWN = "unknown"

#: The data errors a shipped window can carry: it is dropped and counted.
#: A kernel that fails to build or launch is none of these, and raises.
WINDOW_ERRORS = (bgzf.BgzfError, bam.BamError, FormatError, zlib.error, binascii.Error,
                 KeyError, TypeError, ValueError)


def stable_hash(key: str) -> int:
    """A key's 64-bit position on the ring (``blake2b``, unsalted)."""
    return int.from_bytes(hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


def file_key(path: str) -> str:
    """The routing key: ``path|size|mtime_ns``, the cache identity.  A
    rewritten file is another key; an unstatable path is the path alone."""
    try:
        ident = file_identity(path)
    except OSError:
        return path
    return f"{ident[0]}|{ident[1]}|{ident[2]}"


class HashRing:
    """Consistent-hash ring with ``vnodes`` points a member (thread-safe).
    Removing a member hands each of its ranges to the next point; no other
    key moves."""

    def __init__(self, members: Tuple[str, ...] = (), vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = int(vnodes)
        self._lock = threading.Lock()
        self._points: List[int] = []
        self._owners: List[str] = []
        self._members: set = set()
        for m in members:
            self.add(m)

    def __len__(self) -> int:
        return len(self._members)

    @property
    def members(self) -> List[str]:
        with self._lock:
            return sorted(self._members)

    def add(self, name: str) -> None:
        with self._lock:
            if name in self._members:
                return
            self._members.add(name)
            for v in range(self.vnodes):
                h = stable_hash(f"{name}#{v}")
                i = bisect.bisect_left(self._points, h)
                self._points.insert(i, h)
                self._owners.insert(i, name)

    def remove(self, name: str) -> None:
        with self._lock:
            if name not in self._members:
                return
            self._members.discard(name)
            keep = [(p, o) for p, o in zip(self._points, self._owners) if o != name]
            self._points = [p for p, _ in keep]
            self._owners = [o for _, o in keep]

    def owner(self, key: str) -> Optional[str]:
        """The member owning ``key``, or None on an empty ring."""
        with self._lock:
            if not self._points:
                return None
            i = bisect.bisect_right(self._points, stable_hash(key))
            return self._owners[i % len(self._owners)]

    def owners(self, key: str, n: int = 2) -> List[str]:
        """The owner, then the next ``n - 1`` distinct members clockwise:
        the router's retry order."""
        with self._lock:
            if not self._points:
                return []
            out: List[str] = []
            i = bisect.bisect_right(self._points, stable_hash(key))
            for k in range(len(self._owners)):
                o = self._owners[(i + k) % len(self._owners)]
                if o not in out:
                    out.append(o)
                    if len(out) >= n:
                        break
            return out

    def successor(self, name: str) -> Optional[str]:
        """The member that inherits ``name``'s first vnode's range: the
        adopter of its journal when it dies."""
        with self._lock:
            if name not in self._members or len(self._members) < 2:
                return None
            i = bisect.bisect_right(self._points, stable_hash(f"{name}#0"))
            for k in range(len(self._owners)):
                o = self._owners[(i + k) % len(self._owners)]
                if o != name:
                    return o
            return None

    def shares(self) -> Dict[str, float]:
        """Fraction of the hash space each member owns."""
        with self._lock:
            if not self._points:
                return {}
            total = 1 << 64
            out: Dict[str, float] = {m: 0.0 for m in self._members}
            for i, p in enumerate(self._points):
                prev = self._points[i - 1] if i else self._points[-1] - total
                out[self._owners[i]] += (p - prev) / total
            return out


# -- membership ----------------------------------------------------------------


def member_path(fleet_dir: str, name: str) -> str:
    return os.path.join(fleet_dir, f"{name}.json")


def write_member(fleet_dir: str, rec: dict) -> None:
    """Publish one member record atomically (tmp + rename)."""
    os.makedirs(fleet_dir, exist_ok=True)
    path = member_path(fleet_dir, rec["name"])
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(rec, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def remove_member(fleet_dir: str, name: str) -> None:
    try:
        os.unlink(member_path(fleet_dir, name))
    except OSError:
        pass


def read_members(fleet_dir: str, metrics: Optional[Metrics] = None) -> Dict[str, dict]:
    """Every parseable member record of the fleet directory; a torn or
    foreign ``.json`` is skipped and counted ``fleet.members.unreadable``."""
    out: Dict[str, dict] = {}
    try:
        names = sorted(os.listdir(fleet_dir))
    except OSError:
        return out
    for fn in names:
        if not fn.endswith(".json"):
            continue
        try:
            with open(os.path.join(fleet_dir, fn), "r", encoding="utf-8") as f:
                rec = json.load(f)
            if isinstance(rec, dict) and rec.get("name"):
                out[rec["name"]] = rec
        except (OSError, ValueError):
            if metrics is not None:
                metrics.count("fleet.members.unreadable", 1)
    return out


def heartbeat_age_s(rec: dict, now: Optional[float] = None) -> float:
    """Seconds since the member's last heartbeat (inf for a garbled record)."""
    now = time.time() if now is None else now
    try:
        return max(0.0, now - float(rec["t_wall"]))
    except (KeyError, TypeError, ValueError):
        return float("inf")


class Heartbeater:
    """Re-publish ``source()``'s record every ``period_s`` until stopped;
    the final write on :meth:`stop` carries what the source then says (a
    draining daemon's ``draining: true``)."""

    def __init__(self, fleet_dir: str, source: Callable[[], dict],
                 period_s: float = DEFAULT_HEARTBEAT_MS / 1e3,
                 metrics: Optional[Metrics] = None):
        self.fleet_dir = fleet_dir
        self.period = max(0.02, float(period_s))
        self.metrics = metrics if metrics is not None else Metrics()
        self._source = source
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0

    def beat(self) -> None:
        rec = dict(self._source() or {})
        rec["t_wall"] = time.time()
        rec["seq"] = self._seq
        self._seq += 1
        write_member(self.fleet_dir, rec)
        self.metrics.count("fleet.heartbeats", 1)

    def start(self) -> None:
        if self._thread is not None:
            return
        self.beat()  # registered before the first request can route here
        self._thread = threading.Thread(target=self._run, name="hbam-fleet-heartbeat",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            try:
                self.beat()
            except Exception:  # noqa: BLE001 - the pulse never dies; it launches no kernel
                self.metrics.count("fleet.heartbeat_errors", 1)

    def stop(self, unregister: bool = False) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            if unregister:
                remove_member(self.fleet_dir, (self._source() or {}).get("name", ""))
            else:
                self.beat()  # the final record, drain state included
        except Exception:  # noqa: BLE001 - as in _run
            self.metrics.count("fleet.heartbeat_errors", 1)


# -- death forensics -------------------------------------------------------------


def classify_death(flightrec_base: Optional[str]) -> dict:
    """``{"verdict": clean|unclean|unknown, "reason", "snapshots", "torn"}``
    from a silent member's flight-recorder ring."""
    if not flightrec_base:
        return {"verdict": UNKNOWN, "reason": "no flight recorder configured",
                "snapshots": 0, "torn": 0}
    seg0, seg1 = flightrec_mod.segment_paths(flightrec_base)
    if not (os.path.exists(seg0) or os.path.exists(seg1)):
        return {"verdict": UNKNOWN, "reason": "flight-recorder ring missing",
                "snapshots": 0, "torn": 0}
    snaps, torn = flightrec_mod.load_ring(flightrec_base)
    if not snaps:
        return {"verdict": UNCLEAN, "snapshots": 0, "torn": torn,
                "reason": "ring exists but holds no parseable snapshot "
                          "(died before/while writing the baseline)"}
    last = snaps[-1]
    if last.get("final"):
        return {"verdict": CLEAN, "snapshots": len(snaps), "torn": torn,
                "reason": f"final snapshot present (seq {last.get('seq')})"}
    return {"verdict": UNCLEAN, "snapshots": len(snaps), "torn": torn,
            "reason": (f"{len(snaps)} snapshots, none final"
                       + (f" ({torn} torn line(s) dropped)" if torn else ""))}


def should_adopt(verdict: str) -> bool:
    """Adopt on anything but a proven clean drain."""
    return verdict != CLEAN


# -- warmth packing --------------------------------------------------------------

#: Arena key kinds a migration carries, with the SoA columns each was
#: decoded with (the endpoints').
_KIND_FIELDS = {"view": VIEW_FIELDS, "flagstat": FLAGSTAT_FIELDS}


def _arena_keys_for(arena, path: str) -> List[tuple]:
    """The arena keys holding windows of ``path``, any identity vintage:
    ``(kind, (path, size, mtime_ns), a, b)``."""
    return [key for key in arena.keys()
            if isinstance(key, tuple) and len(key) == 4 and key[0] in _KIND_FIELDS
            and isinstance(key[1], tuple) and len(key[1]) == 3 and key[1][0] == path]


def pack_windows(arena, path: str, level: int = 1, max_windows: int = DEFAULT_MAX_WINDOWS,
                 metrics: Optional[Metrics] = None) -> List[dict]:
    """Export ``path``'s windows decoded under its current identity: each
    window's records as one dense stream (size word + body) in BGZF
    members at ``level``, base64 (``members_b64``), with its kind, span,
    record count and payload bytes; at most ``max_windows``."""
    m = metrics if metrics is not None else Metrics()
    try:
        ident = file_identity(path)
    except OSError:
        return []
    windows: List[dict] = []
    for key in _arena_keys_for(arena, path):
        if key[1] != ident:
            continue  # a stale vintage is not worth shipping
        batch = arena.get(key)
        if batch is None or getattr(batch, "data", None) is None:
            continue
        try:
            payload = gather_record_array(batch)
        except (KeyError, TypeError, ValueError, IndexError):
            m.count("fleet.migrate.export_errors", 1)
            continue
        if len(payload) == 0:
            continue
        blob = bgzf.deflate_blocks(payload, level=level)[0]
        windows.append({
            "kind": key[0],
            "span": [int(key[2]), int(key[3])],
            "n_records": int(batch.n_records),
            "nbytes": int(len(payload)),
            "members_b64": base64.b64encode(blob).decode("ascii"),
        })
        m.count("fleet.migrate.windows", 1)
        m.count("fleet.migrate.bytes", len(blob))
        if len(windows) >= max_windows:
            break
    return windows


def unpack_windows(arena, path: str, windows: List[dict], stream,
                   metrics: Optional[Metrics] = None) -> int:
    """Install shipped windows into ``arena`` under ``path``'s current
    identity: the members inflated by ``stream.decode_members`` (kernel row
    1 on a card), the record chain walked and the SoA gathered on the host.
    Returns how many were installed; a window with a data error is dropped
    and counted ``fleet.migrate.import_errors`` (a kernel failure raises)."""
    m = metrics if metrics is not None else Metrics()
    try:
        ident = file_identity(path)
    except OSError:
        m.count("fleet.migrate.stale_drop", len(windows))
        return 0
    installed = 0
    for w in windows:
        try:
            kind = w.get("kind")
            fields = _KIND_FIELDS[kind]
            span = w.get("span") or [0, 0]
            blob = base64.b64decode(w["members_b64"])
            co, cs, us = bgzf.scan_blocks(blob)
            out, offs, dev = stream.decode_members(blob, co, cs, us)
            payload = np.asarray(out, dtype=np.uint8)
            offsets = bam.record_offsets(payload)
            soa = bam.soa_decode(payload, offsets, fields=fields)
            batch = RecordBatch(soa=soa, data=payload, keys=np.empty(0, np.int64),
                                device_data=(stream.attach_window(dev) if dev is not None
                                             else None))
            if w.get("n_records") not in (None, batch.n_records):
                raise ValueError(f"window re-decode mismatch: {batch.n_records} records "
                                 f"!= shipped {w.get('n_records')}")
            key = (kind, ident, int(span[0]), int(span[1]))
        except WINDOW_ERRORS:
            m.count("fleet.migrate.import_errors", 1)
            continue
        arena.hold(key, batch)
        installed += 1
        m.count("fleet.migrate.imported", 1)
    return installed

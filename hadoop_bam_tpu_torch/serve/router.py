"""The fleet's front router: one address over N daemons.

Counterpart of ``hadoop_bam_tpu/serve/router.py``'s :class:`FleetRouter`,
on the daemon's transport (:mod:`.server`'s framing over a UNIX socket or
a 127.0.0.1 port), so a :class:`~.client.ServeClient` talks to a router as
to a daemon, and either package's router fronts either package's daemons:

- placement: ``view``, ``flagstat``, ``sort`` and ``warmth`` go to the
  ring owner of their file's :func:`~.fleet.file_key`, so a file's header,
  index and windows stay warm on one member; a transport failure of a read
  retries once on the ring successor (``router.retry``); a job submit is
  never resubmitted blind (the adoption recovers it).  A connection refused
  by a member whose heartbeat is fresh buries it at once.
- admission: a :class:`~.admission.FleetLedger` (the fleet's tokens, a
  per-file cap) sheds at the front door; the router never queues.
- membership and recovery: a monitor thread reads the fleet directory
  (:meth:`FleetRouter.scan_members`).  A stale heartbeat is classified by
  the member's flight recorder (:func:`~.fleet.classify_death`); a death
  that is not a proven clean drain has the ring successor ``adopt`` the
  member's journal, and the dead member's job ids alias to their new home.
  A draining member leaves the ring; with ``hadoopbam.fleet.migrate-warmth``
  its recently routed files' windows go to their new owners first.
- observability: the request's trace continues across the hop
  (``router.route``); ``stats`` folds the members' SLO blocks
  (:func:`~.slo.fold_slo`); ``fleet`` answers the ring, the members, the
  deaths and the hand-offs.

Job ids through the router are ``<member>:<local id>``.  The router owns
one :class:`~..utils.tracing.MetricsRegistry` (``fleet.*`` counters);
the members count into their own.  It launches no kernel.
"""

from __future__ import annotations

import os
import socket
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..conf import (
    FLEET_DIR,
    FLEET_FILE_TOKENS,
    FLEET_HEARTBEAT_TIMEOUT_MS,
    FLEET_MIGRATE_WARMTH,
    FLEET_PORT,
    FLEET_SOCKET,
    FLEET_TOKENS,
    FLEET_VNODES,
    SERVE_REQUEST_TRACING,
    Configuration,
)
from ..utils.tracing import (
    MetricsRegistry,
    RequestContext,
    prometheus_text,
    request_scope,
    snapshot,
)
from . import fleet as fleet_mod
from . import slo as slo_mod
from .admission import JOB_LOST, FleetLedger, ShedError
from .client import ServeClient, ServeConnectionError, ServeError
from .server import KNOWN_OPS, recv_msg, send_msg

DEFAULT_FLEET_TOKENS = 32
DEFAULT_FILE_TOKENS = 8
#: Ops the router forwards to a file's ring owner.
ROUTED_OPS = ("view", "flagstat", "sort", "warmth")
#: Recently routed paths remembered a member (warmth-migration candidates).
_RECENT_PATHS = 32


def default_router_socket_path() -> str:
    """The per-user default UNIX socket of the router."""
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"hbam-fleet-{uid}.sock")


class FleetRouter:
    """Accept loop, ring routing and the death monitor (stdlib only)."""

    def __init__(
        self,
        conf: Optional[Configuration] = None,
        fleet_dir: Optional[str] = None,
        socket_path: Optional[str] = None,
        port: Optional[int] = None,
        host: str = "127.0.0.1",
        heartbeat_timeout_ms: Optional[float] = None,
        member_timeout: float = 300.0,
    ):
        self.conf = conf or Configuration()
        self.fleet_dir = fleet_dir or self.conf.get(FLEET_DIR)
        if not self.fleet_dir:
            raise ValueError(f"the fleet router needs a fleet directory ({FLEET_DIR})")
        self.socket_path = socket_path or self.conf.get(FLEET_SOCKET)
        self.port = port if port is not None else (self.conf.get_int(FLEET_PORT, 0) or None)
        self.host = host
        if self.socket_path is None and self.port is None:
            self.socket_path = default_router_socket_path()
        self.heartbeat_timeout_ms = float(
            heartbeat_timeout_ms if heartbeat_timeout_ms is not None
            else self.conf.get_int(FLEET_HEARTBEAT_TIMEOUT_MS,
                                   fleet_mod.DEFAULT_HEARTBEAT_TIMEOUT_MS))
        self.member_timeout = member_timeout
        self.migrate_warmth = self.conf.get_boolean(FLEET_MIGRATE_WARMTH, False)
        self.request_tracing = self.conf.get_boolean(SERVE_REQUEST_TRACING, True)
        self.metrics = MetricsRegistry()
        self.ring = fleet_mod.HashRing(
            vnodes=self.conf.get_int(FLEET_VNODES, fleet_mod.DEFAULT_VNODES))
        self.ledger = FleetLedger(
            tokens=self.conf.get_int(FLEET_TOKENS, DEFAULT_FLEET_TOKENS),
            file_tokens=self.conf.get_int(FLEET_FILE_TOKENS, DEFAULT_FILE_TOKENS),
            metrics=self.metrics,
        )
        # One lock guards the maps below and the ring's membership changes;
        # the scan lock makes membership passes one at a time (the monitor's
        # and a caller's), hand-offs included.
        self._lock = threading.Lock()
        self._scan_lock = threading.Lock()
        #: name -> latest member record (ring members only).
        self._members: Dict[str, dict] = {}
        #: name -> death record (verdict, adoption, timestamps).
        self._dead: Dict[str, dict] = {}
        #: router job id -> router job id (a dead member's id -> its new
        #: home; chased transitively by ``job``).
        self._job_alias: Dict[str, str] = {}
        #: hand-off history, oldest first.
        self._handoffs: List[dict] = []
        #: member -> recently routed paths.
        self._recent_paths: Dict[str, List[str]] = {}
        self._clients: Dict[str, ServeClient] = {}
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        self._handlers: List[threading.Thread] = []

    # -- membership -------------------------------------------------------------

    @property
    def endpoint(self) -> dict:
        if self.socket_path is not None:
            return {"socket": self.socket_path}
        return {"host": self.host, "port": self.port}

    def _client_for(self, name: str) -> Optional[ServeClient]:
        """A cached client of a member's published endpoint.  It never
        retries: the router's one retry is the successor hop."""
        with self._lock:
            c = self._clients.get(name)
            if c is not None:
                return c
            rec = self._members.get(name) or self._dead.get(name, {}).get("record")
            ep = (rec or {}).get("endpoint") or {}
            if not ep:
                return None
            c = ServeClient(socket_path=ep.get("socket"), host=ep.get("host", "127.0.0.1"),
                            port=ep.get("port"), timeout=self.member_timeout, retries=0)
            self._clients[name] = c
            return c

    def scan_members(self) -> None:
        """One membership pass: admit fresh records, refresh known ones,
        then (outside the lock: they talk to member sockets) drop the
        unregistered and the draining and classify the silent.  The monitor
        thread loops it; tests call it directly, and a call returns once
        any pass under way and its own have finished their hand-offs."""
        with self._scan_lock:
            self._scan()

    def _scan(self) -> None:
        recs = fleet_mod.read_members(self.fleet_dir, self.metrics)
        now = time.time()
        timeout_s = self.heartbeat_timeout_ms / 1e3
        with self._lock:
            for name, rec in recs.items():
                fresh = fleet_mod.heartbeat_age_s(rec, now) <= timeout_s
                if name in self._dead:
                    if not fresh:
                        continue
                    # A restarted daemon under its old name rejoins empty-handed
                    # (its journal was adopted).
                    self._dead.pop(name, None)
                    self._clients.pop(name, None)
                if name not in self._members:
                    if not fresh or rec.get("draining"):
                        continue
                    self._members[name] = rec
                    self.ring.add(name)
                    self.metrics.count("fleet.member_joins", 1)
                else:
                    if self._members[name].get("endpoint") != rec.get("endpoint"):
                        self._clients.pop(name, None)
                    self._members[name] = rec
            names = list(self._members)
        for name in names:
            rec = recs.get(name)
            if rec is None:
                self._leave(name, reason="unregistered")
            elif rec.get("draining"):
                self._leave(name, reason="draining")
            elif fleet_mod.heartbeat_age_s(rec, now) > timeout_s:
                self._on_death(name, rec)

    def _leave(self, name: str, reason: str) -> None:
        """A planned exit: with warmth migration on, a draining member's
        recently routed paths' windows go to their new owners first (its
        control plane still answers); then it leaves the ring."""
        with self._lock:
            if name not in self._members:
                return
            paths = list(self._recent_paths.get(name, ()))
        if self.migrate_warmth and reason == "draining":
            self._migrate_warmth_from(name, paths)
        with self._lock:
            self._members.pop(name, None)
            self.ring.remove(name)
            self._clients.pop(name, None)
            self._recent_paths.pop(name, None)
            self._handoffs.append({"t_wall": time.time(), "member": name, "kind": "leave",
                                   "reason": reason})
        self.metrics.count("fleet.member_leaves", 1)

    def _migrate_warmth_from(self, name: str, paths: List[str]) -> None:
        src = self._client_for(name)
        if src is None:
            return
        with self._lock:
            # Ownership after the leave, on a copy: the live ring keeps serving.
            probe = fleet_mod.HashRing(tuple(m for m in self.ring.members if m != name),
                                       vnodes=self.ring.vnodes)
        for path in paths:
            dst_name = probe.owner(fleet_mod.file_key(path))
            if dst_name is None or dst_name == name:
                continue
            dst = self._client_for(dst_name)
            if dst is None:
                continue
            try:
                windows = src.warmth(path, export=True).get("windows", [])
                if windows:
                    dst.warmth(path, windows=windows)
                    self.metrics.count("fleet.migrations", 1)
            except (ServeError, OSError):
                self.metrics.count("fleet.migration_errors", 1)

    def _on_death(self, name: str, rec: dict) -> None:
        """A missed heartbeat: forensics, ring surgery, adoption."""
        forensics = fleet_mod.classify_death(rec.get("flightrec"))
        adopt = fleet_mod.should_adopt(forensics["verdict"])
        with self._lock:
            if name not in self._members:
                return  # a concurrent pass buried it already
            adopter = self.ring.successor(name)
            self._members.pop(name, None)
            self.ring.remove(name)
            self._clients.pop(name, None)
            self._recent_paths.pop(name, None)
            dead = {"record": rec, "t_detected": time.time(), "forensics": forensics,
                    "adopter": adopter if adopt else None}
            self._dead[name] = dead
        self.metrics.count("fleet.deaths", 1)
        self.metrics.count(f"fleet.deaths.{forensics['verdict']}", 1)
        handoff = {"t_wall": time.time(), "member": name, "kind": "death",
                   "verdict": forensics["verdict"], "reason": forensics.get("reason"),
                   "adopter": adopter if adopt else None}
        if adopt and adopter and rec.get("journal"):
            client = self._client_for(adopter)
            try:
                r = client.adopt(rec["journal"], source=name) if client is not None else {}
                adopted = r.get("adopted", {})
                with self._lock:
                    for old, new in adopted.items():
                        self._job_alias[f"{name}:{old}"] = f"{adopter}:{new}"
                handoff["adopted"] = adopted
                handoff["lost"] = r.get("lost", [])
                dead["adopted"] = adopted
                self.metrics.count("fleet.adoptions", 1)
                self.metrics.count("fleet.jobs_adopted", len(adopted))
            except (ServeError, OSError) as e:
                handoff["adopt_error"] = f"{type(e).__name__}: {e}"
                self.metrics.count("fleet.adoption_errors", 1)
        with self._lock:
            self._handoffs.append(handoff)

    # -- lifecycle ----------------------------------------------------------------

    def start(self) -> None:
        """Scan once, bind, start the monitor (idempotent)."""
        if self._listener is not None:
            return
        self.scan_members()
        if self.socket_path is not None:
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)
            lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            lst.bind(self.socket_path)
        else:
            lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lst.bind((self.host, self.port or 0))
            self.port = lst.getsockname()[1]
        lst.listen(64)
        lst.settimeout(0.1)
        self._listener = lst
        self._monitor_thread = threading.Thread(target=self._monitor, name="hbam-fleet-monitor",
                                                daemon=True)
        self._monitor_thread.start()
        self.metrics.count("fleet.router_starts", 1)

    def _monitor(self) -> None:
        # A few passes a timeout: detection takes a fraction of it more.
        period = min(1.0, max(0.05, self.heartbeat_timeout_ms / 1e3 / 4))
        while not self._stop.wait(period):
            try:
                self.scan_members()
            except Exception:  # noqa: BLE001 - the monitor never dies; it launches no kernel
                self.metrics.count("fleet.monitor_errors", 1)

    def serve_forever(self, ready: Optional[threading.Event] = None) -> None:
        """The accept loop, until ``shutdown`` or :meth:`stop`; ``ready``
        is set once requests can connect."""
        self.start()
        if ready is not None:
            ready.set()
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                t = threading.Thread(target=self._handle, args=(conn,), daemon=True)
                t.start()
                self._handlers.append(t)
                self._handlers = [h for h in self._handlers if h.is_alive()]
        finally:
            self._shutdown_cleanup()

    def stop(self) -> None:
        self._stop.set()

    def _shutdown_cleanup(self) -> None:
        for h in list(self._handlers):
            h.join(timeout=5.0)
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)
            self._monitor_thread = None
        if self._listener is not None:
            try:
                self._listener.close()
            finally:
                self._listener = None
        if self.socket_path and os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    # -- request handling -----------------------------------------------------------

    def _handle(self, conn: socket.socket) -> None:
        stop_after = False
        try:
            with conn:
                req = recv_msg(conn)
                if req is None:
                    return
                op = req.get("op")
                rctx = None
                if self.request_tracing:
                    rctx = (RequestContext.from_wire(req.get("trace"), op=op, metrics=self.metrics)
                            or RequestContext.new(op=op, metrics=self.metrics))
                with request_scope(rctx):
                    try:
                        reply, stop_after = self._dispatch(req, rctx)
                    except ShedError as e:
                        reply = {"ok": False, "code": e.code, "error": str(e),
                                 "retry_after_ms": e.retry_after_ms}
                    except ServeError as e:
                        reply = {"ok": False, "error": str(e)}
                        if e.code is not None:
                            reply["code"] = e.code
                        if getattr(e, "retry_after_ms", None) is not None:
                            reply["retry_after_ms"] = e.retry_after_ms
                    except Exception as e:  # noqa: BLE001 - reply, don't die; no kernel here
                        self.metrics.count("fleet.router.request_errors", 1)
                        reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                if rctx is not None:
                    reply.setdefault("trace_id", rctx.trace_id)
                send_msg(conn, reply)
        except Exception:  # noqa: BLE001 - a broken connection never kills the router
            self.metrics.count("fleet.router.connection_errors", 1)
        finally:
            if stop_after:
                self._stop.set()

    @staticmethod
    def _routing_path(req: dict) -> Optional[str]:
        op = req.get("op")
        if op in ("sort", "ingest"):
            paths = req.get("bam") if op == "sort" else req.get("fastq")
            if isinstance(paths, str):
                return paths
            return paths[0] if paths else None
        return req.get("path")

    def _forward(self, name: str, req: dict, rctx: Optional[RequestContext]) -> dict:
        """One exchange with a member inside the request's scope: the
        member's trace is a child span of the client's trace id."""
        client = self._client_for(name)
        if client is None:
            raise ServeConnectionError(f"no endpoint for member {name!r}")
        fwd = {k: v for k, v in req.items() if k != "trace"}
        with request_scope(rctx):
            return client._request(fwd, idempotent=False)

    def _route_data(self, req: dict, rctx: Optional[RequestContext]) -> dict:
        """Route a data-plane op to its ring owner; a transport failure of
        a read retries once on the ring successor (``router.retry``)."""
        op = req.get("op")
        path = self._routing_path(req)
        if path is None:
            raise ServeError(f"op {op!r} carries no routable path")
        key = fleet_mod.file_key(path)
        owners = self.ring.owners(key, n=2)
        if not owners:
            raise ServeConnectionError("fleet has no live members")
        release = self.ledger.acquire(op, key)
        try:
            member = owners[0]
            with self._lock:
                recent = self._recent_paths.setdefault(member, [])
                if path in recent:
                    recent.remove(path)
                recent.append(path)
                del recent[:-_RECENT_PATHS]
            if rctx is not None:
                rctx.annotate("router.route", member=member, op=op)
            self.metrics.count("fleet.router.routed", 1)
            try:
                reply = self._forward(member, req, rctx)
            except (ServeConnectionError, ConnectionError, OSError) as e:
                self._maybe_eager_death(member, e, rctx)
                if len(owners) < 2 or op in ("sort", "ingest"):
                    raise  # a resubmitted job would be a second job
                retry_to = owners[1]
                if rctx is not None:
                    rctx.annotate("router.retry", member=retry_to, error=type(e).__name__)
                self.metrics.count("fleet.router.retries", 1)
                member = retry_to
                reply = self._forward(member, req, rctx)
            if op in ("sort", "ingest") and "job" in reply:
                reply["job"] = f"{member}:{reply['job']}"
            reply.setdefault("member", member)
            return reply
        finally:
            release()

    def _maybe_eager_death(self, member: str, err: BaseException,
                           rctx: Optional[RequestContext]) -> None:
        """A connection refused by a member whose heartbeat is fresh: its
        listener is gone, so it is buried now, not a heartbeat timeout
        later (a timeout may be load, and waits for the monitor)."""
        if not (isinstance(err, ConnectionRefusedError) or "refused" in str(err).lower()):
            return
        with self._lock:
            rec = self._members.get(member)
        if rec is None:
            return
        if fleet_mod.heartbeat_age_s(rec, time.time()) > self.heartbeat_timeout_ms / 1e3:
            return
        self.metrics.count("fleet.eager_refused", 1)
        if rctx is not None:
            rctx.annotate("router.eager_death", member=member)
        self._on_death(member, rec)

    def _job_status(self, req: dict) -> dict:
        rid = req.get("id") or ""
        with self._lock:
            seen = set()
            while rid in self._job_alias and rid not in seen:
                seen.add(rid)
                rid = self._job_alias[rid]
        member, _, local = rid.partition(":")
        if not local:
            return {"ok": False, "code": JOB_LOST,
                    "error": f"job id {req.get('id')!r} is not a fleet id "
                             "(expected member:job-nnnn)"}
        with self._lock:
            known = member in self._members
        if not known:
            return {"ok": False, "code": JOB_LOST,
                    "error": f"job {rid!r}: member {member!r} is gone and no adoption "
                             "re-homed the job"}
        reply = self._forward(member, {"op": "job", "id": local}, None)
        reply["id"] = rid
        reply.setdefault("member", member)
        return reply

    def _fan_out(self, req: dict) -> Dict[str, dict]:
        """Every member queried; a member's transport failure is an error
        entry, not a failed answer."""
        with self._lock:
            names = sorted(self._members)
        out: Dict[str, dict] = {}
        for name in names:
            try:
                out[name] = self._forward(name, dict(req), None)
            except (ServeError, OSError) as e:
                out[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        return out

    def fleet_view(self) -> dict:
        """The ``fleet`` op's payload: ring, members, deaths, hand-offs."""
        now = time.time()
        with self._lock:
            members = {
                name: {
                    "endpoint": rec.get("endpoint"),
                    "pid": rec.get("pid"),
                    "journal": rec.get("journal"),
                    "flightrec": rec.get("flightrec"),
                    "heartbeat_age_ms": round(fleet_mod.heartbeat_age_s(rec, now) * 1e3, 1),
                    "draining": bool(rec.get("draining")),
                }
                for name, rec in self._members.items()
            }
            dead = {name: {k: v for k, v in d.items() if k != "record"}
                    for name, d in self._dead.items()}
            handoffs = list(self._handoffs)
            aliases = dict(self._job_alias)
        return {
            "ok": True,
            "router": {"endpoint": self.endpoint, "pid": os.getpid()},
            "fleet_dir": self.fleet_dir,
            "members": members,
            "ring": {"vnodes": self.ring.vnodes,
                     "shares": {m: round(s, 4) for m, s in self.ring.shares().items()}},
            "dead": dead,
            "handoffs": handoffs,
            "job_aliases": aliases,
            "admission": self.ledger.gauges(),
            "heartbeat_timeout_ms": self.heartbeat_timeout_ms,
        }

    def _dispatch(self, req: dict, rctx: Optional[RequestContext]) -> Tuple[dict, bool]:
        op = req.get("op")
        self.metrics.count(f"fleet.router.op.{op}", 1)
        if op == "ping":
            with self._lock:
                n = len(self._members)
            return ({"ok": True, "pid": os.getpid(), "router": True, "endpoint": self.endpoint,
                     "members": n}, False)
        if op == "fleet":
            return (self.fleet_view(), False)
        if op in ROUTED_OPS:
            return (self._route_data(req, rctx), False)
        if op == "adopt":
            # A manual hand-off: the operator names the adopter.
            member = req.get("member")
            if not member:
                return ({"ok": False, "error": "router adopt needs a member name"}, False)
            return (self._forward(member, req, rctx), False)
        if op == "job":
            return (self._job_status(req), False)
        if op == "stats":
            per_member = self._fan_out({"op": "stats"})
            fold = slo_mod.fold_slo([r.get("slo") for r in per_member.values() if r.get("ok")])
            return ({"ok": True, "router": self.fleet_view(), "members": per_member,
                     "slo": fold}, False)
        if op == "metrics":
            texts = [f"# fleet member: {name}\n{r.get('text', '')}"
                     for name, r in sorted(self._fan_out({"op": "metrics"}).items())
                     if r.get("ok")]
            texts.append("# fleet router\n" + prometheus_text(snapshot(self.metrics)))
            return ({"ok": True, "content_type": "text/plain; version=0.0.4",
                     "text": "\n".join(texts)}, False)
        if op == "exemplars":
            tid = req.get("trace_id")
            if tid:
                for name, r in self._fan_out(dict(req)).items():
                    if r.get("ok"):
                        ex = r["exemplar"]
                        ex.setdefault("member", name)
                        return ({"ok": True, "exemplar": ex}, False)
                return ({"ok": False, "error": f"no member holds an exemplar for {tid!r}"},
                        False)
            merged = []
            for name, r in sorted(self._fan_out({"op": "exemplars"}).items()):
                for ex in r.get("exemplars", []) if r.get("ok") else []:
                    merged.append({**ex, "member": name})
            return ({"ok": True, "exemplars": merged}, False)
        if op == "shutdown":
            # Stops the router only: the members keep serving their sockets.
            return ({"ok": True, "drained": True, "router": True}, True)
        return ({"ok": False, "error": f"unknown op {op!r} (router knows "
                 f"{sorted(set(KNOWN_OPS) | {'fleet'})})"}, False)

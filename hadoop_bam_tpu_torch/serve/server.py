"""The resident daemon: a long-lived process that owns the card.

Counterpart of ``hadoop_bam_tpu/serve/server.py``'s :class:`BamDaemon`.
The transport is stdlib only: a UNIX socket (or a 127.0.0.1 TCP port)
carrying length-prefixed JSON, four bytes big-endian length and a UTF-8
JSON object, one request a connection; binary replies (``view`` and
``variants``, small BAM and BCF files) ride base64.

Ops (:data:`KNOWN_OPS`): ``ping``; ``view`` {path, region, level};
``flagstat`` {path}; ``variants`` {path, region}; ``depth`` {path, region,
bin_size, per_base}; ``sort`` {bam, output, ...} and ``ingest`` {fastq,
output, ...}, which return a job id (the job runs
:func:`~..pipeline.sort_bam` / :func:`~..ingest.ingest_fastq` on the
daemon's device with the daemon's resource cache and the request's
deadline, in a bounded pool); ``job`` {id}; ``stats`` (the registry's
delta since start, per-op latency histograms, gauges, the SLO judgment);
``metrics`` (Prometheus text); ``exemplars`` [trace_id]; ``shutdown``
(drain: refuse new jobs, finish the running ones, reply, stop);
``adopt`` {journal, source} (resume a dead peer's journaled jobs here) and
``warmth`` {path, export, windows, level} (list, export or install
decoded windows), the fleet's hand-offs.  With ``hadoopbam.fleet.dir`` set
the daemon is a fleet member: it heartbeats its record there
(:class:`~.fleet.Heartbeater`) for the router (:mod:`.router`).

The daemon's warm state is one :class:`~.endpoints.ServeContext` on the
card (``device``, default cuda): the kernels warmed before the socket
accepts, the header/index cache, the decoded-window arena and the lane
batcher.  Every data-plane op passes admission (typed ``SHED`` /
``RETRY_AFTER`` refusals with ``retry_after_ms``); a request's
``deadline_ms`` is checked at every seam down to the part executor
(``DEADLINE_EXCEEDED``); a card out of memory degrades (arena evict,
retry, host inflate) rather than killing the daemon; with a journal, jobs
survive a crash (terminal states restored, ``part_dir`` jobs resumed,
unknown ids ``JOB_LOST``).  Every request runs under a
:class:`~..utils.tracing.RequestContext`.  The daemon owns one
:class:`~..utils.tracing.MetricsRegistry` (the context's) and hands it
down as ``metrics=``; a job counts into its own stream's metrics, folded
into the registry when it ends.  SIGTERM/SIGINT drain like ``shutdown``.
"""

from __future__ import annotations

import base64
import json
import os
import signal
import socket
import struct
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from .. import faults
from ..conf import (
    FLEET_DIR,
    FLEET_HEARTBEAT_MS,
    FLEET_NAME,
    SERVE_ACCESS_LOG,
    SERVE_ACCESS_LOG_BYTES,
    SERVE_ADMISSION_TOKENS,
    SERVE_EXEMPLAR_DIR,
    SERVE_EXEMPLAR_THRESHOLD_MS,
    SERVE_EXEMPLARS_MAX,
    SERVE_FLIGHTREC,
    SERVE_FLIGHTREC_BYTES,
    SERVE_FLIGHTREC_CADENCE_MS,
    SERVE_JOURNAL,
    SERVE_MAX_INFLIGHT,
    SERVE_MAX_QUEUE,
    SERVE_MAX_QUEUE_MS,
    SERVE_PORT,
    SERVE_REQUEST_TRACING,
    SERVE_SOCKET,
    SERVE_WARMUP,
    TRACE_EVENTS,
    Configuration,
)
from ..utils.deadline import Deadline, DeadlineExceeded, deadline_scope
from ..utils.tracing import (
    DEFAULT_TRACE_EVENTS,
    TRACER,
    RequestContext,
    current_request,
    delta,
    prometheus_text,
    request_scope,
    snapshot,
    transfers_report,
)
from . import exemplars as exemplars_mod
from . import fleet as fleet_mod
from . import flightrec as flightrec_mod
from . import journal as journal_mod
from . import slo as slo_mod
from .admission import (
    DEADLINE_EXCEEDED,
    DEFAULT_MAX_QUEUE,
    DEFAULT_MAX_QUEUE_MS,
    DEFAULT_TOKENS,
    JOB_LOST,
    AdmissionController,
    ShedError,
)
from .endpoints import ServeContext, depth_stat, flagstat, variants_blob, view_blob

_LEN = struct.Struct(">I")
MAX_MESSAGE = 1 << 30
DEFAULT_MAX_INFLIGHT = 2

#: Every op the dispatcher understands; ``_dispatch`` has one arm each.
KNOWN_OPS = (
    "ping", "view", "flagstat", "variants", "depth", "sort", "ingest",
    "job", "stats", "metrics", "exemplars", "adopt", "warmth", "shutdown",
)

#: Data-plane ops whose completions feed the tail sampler and the access
#: log (control-plane ops run under a RequestContext too, unrecorded).
TRACED_OPS = ("view", "flagstat", "variants", "depth", "sort", "ingest")


def default_socket_path() -> str:
    """The per-user default UNIX socket."""
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"hbam-serve-{uid}.sock")


def send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_msg(sock: socket.socket) -> Optional[dict]:
    """One length-prefixed JSON message, or None on a clean EOF."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_MESSAGE:
        raise ValueError(f"message of {n} bytes exceeds cap {MAX_MESSAGE}")
    body = _recv_exact(sock, n)
    if body is None:
        raise ConnectionError("truncated message")
    return json.loads(body.decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise ConnectionError("truncated message")
        buf.extend(chunk)
    return bytes(buf)


class BamDaemon:
    """Accept loop, request dispatch, bounded job pool, drain."""

    def __init__(
        self,
        conf: Optional[Configuration] = None,
        socket_path: Optional[str] = None,
        port: Optional[int] = None,
        host: str = "127.0.0.1",
        max_inflight: Optional[int] = None,
        warmup: Optional[bool] = None,
        warmup_kwargs: Optional[dict] = None,
        journal_path: Optional[str] = None,
        flightrec_path: Optional[str] = None,
        device=None,
    ):
        self.conf = conf or Configuration()
        faults.arm_from_conf(self.conf)
        self.socket_path = socket_path or self.conf.get(SERVE_SOCKET)
        self.port = port if port is not None else (self.conf.get_int(SERVE_PORT, 0) or None)
        self.host = host
        if self.socket_path is None and self.port is None:
            self.socket_path = default_socket_path()
        self.max_inflight = max_inflight or self.conf.get_int(SERVE_MAX_INFLIGHT,
                                                              DEFAULT_MAX_INFLIGHT)
        self.warmup = warmup if warmup is not None else self.conf.get_boolean(SERVE_WARMUP, True)
        self.warmup_kwargs = warmup_kwargs or {}
        self.warmup_report: Optional[dict] = None
        self.ctx = ServeContext.from_conf(self.conf, device=device)
        self.metrics = self.ctx.metrics
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._handlers: List[threading.Thread] = []
        self._jobs: Dict[str, dict] = {}
        self._jobs_lock = threading.Lock()
        self._job_seq = 0
        self._job_pool = ThreadPoolExecutor(max_workers=self.max_inflight,
                                            thread_name_prefix="hbam-serve-job")
        self.admission = AdmissionController(
            tokens=self.conf.get_int(SERVE_ADMISSION_TOKENS, DEFAULT_TOKENS),
            max_queue=self.conf.get_int(SERVE_MAX_QUEUE, DEFAULT_MAX_QUEUE),
            max_queue_ms=self.conf.get_int(SERVE_MAX_QUEUE_MS, DEFAULT_MAX_QUEUE_MS),
            metrics=self.metrics,
        )
        self.journal_path = journal_path or self.conf.get(SERVE_JOURNAL)
        self._journal = (journal_mod.JobJournal(self.journal_path, metrics=self.metrics)
                         if self.journal_path else None)
        self.flightrec_path = flightrec_path or self.conf.get(SERVE_FLIGHTREC)
        self._flightrec = (
            flightrec_mod.FlightRecorder(
                self.flightrec_path,
                cadence_s=self.conf.get_int(SERVE_FLIGHTREC_CADENCE_MS,
                                            flightrec_mod.DEFAULT_CADENCE_MS) / 1e3,
                max_bytes=self.conf.get_int(SERVE_FLIGHTREC_BYTES,
                                            flightrec_mod.DEFAULT_RING_BYTES),
                source=self._flight_snapshot,
                metrics=self.metrics,
            )
            if self.flightrec_path else None
        )
        self.request_tracing = self.conf.get_boolean(SERVE_REQUEST_TRACING, True)
        self._owns_tracer = False
        self.exemplars = exemplars_mod.ExemplarStore(
            max_exemplars=self.conf.get_int(SERVE_EXEMPLARS_MAX,
                                            exemplars_mod.DEFAULT_MAX_EXEMPLARS),
            spill_dir=self.conf.get(SERVE_EXEMPLAR_DIR),
            metrics=self.metrics,
        )
        self.sampler = exemplars_mod.TailSampler(
            self.exemplars,
            threshold_ms=float(self.conf.get_int(SERVE_EXEMPLAR_THRESHOLD_MS,
                                                 int(exemplars_mod.DEFAULT_THRESHOLD_MS))),
            # A sort job's duration is expected: only its failures sample.
            per_op_threshold_ms={"sort.job": 0.0},
        )
        self.slo = slo_mod.SloMonitor.from_conf(self.conf, registry=self.metrics)
        access_log_path = self.conf.get(SERVE_ACCESS_LOG)
        self._access_log = (
            flightrec_mod.AccessLog(
                access_log_path,
                max_bytes=self.conf.get_int(SERVE_ACCESS_LOG_BYTES,
                                            flightrec_mod.DEFAULT_ACCESS_LOG_BYTES),
                metrics=self.metrics,
            )
            if access_log_path else None
        )
        self.fleet_dir = self.conf.get(FLEET_DIR)
        self.fleet_name = self.conf.get(FLEET_NAME) or f"daemon-{os.getpid()}"
        self._heartbeater: Optional[fleet_mod.Heartbeater] = None
        self._drain_requested = threading.Event()
        self._started_snapshot = snapshot(self.metrics)

    # -- lifecycle ------------------------------------------------------------

    @property
    def endpoint(self) -> dict:
        if self.socket_path is not None:
            return {"socket": self.socket_path}
        return {"host": self.host, "port": self.port}

    def start(self) -> None:
        """Replay the journal, warm the kernels, then bind (idempotent):
        the first accepted connection finds the kernels loaded and the
        recovered jobs answerable."""
        if self._listener is not None:
            return
        if self.request_tracing and not TRACER.armed:
            TRACER.start(capacity=self.conf.get_int(TRACE_EVENTS, DEFAULT_TRACE_EVENTS))
            self._owns_tracer = True
        if self._journal is not None:
            self._recover_journal()
        if self.warmup and self.warmup_report is None:
            from .warmup import warm_kernels

            self.warmup_report = warm_kernels(self.conf, device=self.ctx.stream.device,
                                              **self.warmup_kwargs)
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
        if self._flightrec is not None:
            self._flightrec.start()
        if self.fleet_dir:
            # After the bind: the first record the router reads is routable.
            self._heartbeater = fleet_mod.Heartbeater(
                self.fleet_dir, self._fleet_member_record,
                period_s=self.conf.get_int(FLEET_HEARTBEAT_MS,
                                           fleet_mod.DEFAULT_HEARTBEAT_MS) / 1e3,
                metrics=self.metrics,
            )
            self._heartbeater.start()
        self.metrics.count("serve.daemon_starts", 1)

    def _fleet_member_record(self) -> dict:
        """The heartbeat's record: what a router needs to route here or
        to recover this daemon's jobs."""
        return {"name": self.fleet_name, "endpoint": self.endpoint,
                "journal": self.journal_path, "flightrec": self.flightrec_path,
                "pid": os.getpid(), "draining": self._draining.is_set()}

    def _recover_journal(self) -> None:
        """Replay the journal: terminal states restored, ``part_dir`` jobs
        whose inputs are unchanged resumed, the rest lost.  Never raises: a
        corrupt journal leaves an empty job table."""
        try:
            jobs = journal_mod.replay(self.journal_path, self.metrics)
        except ValueError:
            self.metrics.count("serve.journal.corrupt", 1)
            return
        plan = journal_mod.recovery_plan(jobs, self.metrics)
        seq = 0
        with self._jobs_lock:
            for jid, job in jobs.items():
                try:
                    seq = max(seq, int(jid.rsplit("-", 1)[-1]))
                except ValueError:
                    pass
                entry = {"status": job["status"], "output": (job.get("req") or {}).get("output")}
                for k in ("stats", "error"):
                    if k in job:
                        entry[k] = job[k]
                action = plan.get(jid)
                if action == "lost":
                    entry["status"] = "lost"
                    entry["error"] = ("job interrupted by a daemon crash and not resumable "
                                      "(no part_dir checkpoint, or the input files changed)")
                    self.metrics.count("serve.journal.lost", 1)
                elif action == "resume":
                    entry["status"] = "queued"
                else:
                    self.metrics.count("serve.journal.replayed", 1)
                self._jobs[jid] = entry
            self._job_seq = max(self._job_seq, seq)
        for jid, action in sorted(plan.items()):
            if action != "resume":
                continue
            self.metrics.count("serve.journal.resumed", 1)
            self._journal.state(jid, "resumed")
            self._job_pool.submit(self._run_job, jid, dict(jobs[jid]["req"]))

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT drain like the ``shutdown`` op (main thread only;
        elsewhere a no-op)."""

        def _handler(signum, frame):
            self.metrics.count("serve.signal_drains", 1)
            self._drain_requested.set()

        try:
            signal.signal(signal.SIGTERM, _handler)
            signal.signal(signal.SIGINT, _handler)
        except ValueError:
            pass

    def serve_forever(self, ready: Optional[threading.Event] = None) -> None:
        """The accept loop, until ``shutdown``, a signal drain or
        :meth:`stop`; ``ready`` is set once requests can connect."""
        self.start()
        if ready is not None:
            ready.set()
        try:
            while not self._stop.is_set():
                if self._drain_requested.is_set():
                    self._drain()
                    break
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
        """Stop out of band (the ``shutdown`` op drains first)."""
        self._stop.set()

    def _shutdown_cleanup(self) -> None:
        if self._heartbeater is not None:
            # The final beat carries the drain flag: the router reads a
            # drained daemon's silence as a planned exit.
            self._heartbeater.stop()
            self._heartbeater = None
        for h in list(self._handlers):
            h.join(timeout=5.0)
        self._job_pool.shutdown(wait=True)
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
        if self._flightrec is not None:
            self._flightrec.stop(final=True)
        if self._journal is not None:
            self._journal.close()
        if self._access_log is not None:
            self._access_log.close()
        if self._owns_tracer:
            TRACER.stop()
            self._owns_tracer = False
        self.ctx.close()

    # -- request handling -------------------------------------------------------

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
                t0 = time.perf_counter()
                with request_scope(rctx):
                    try:
                        reply, stop_after = self._dispatch(req)
                    except ShedError as e:
                        reply = {"ok": False, "code": e.code, "error": str(e),
                                 "retry_after_ms": e.retry_after_ms}
                    except DeadlineExceeded as e:
                        reply = {"ok": False, "code": DEADLINE_EXCEEDED, "error": str(e),
                                 "seam": e.seam}
                    except Exception as e:  # noqa: BLE001 - reply, don't die
                        self.metrics.count("serve.request_errors", 1)
                        reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    self.metrics.observe(f"serve.op.{op}.ms", (time.perf_counter() - t0) * 1e3)
                    if not reply.get("ok"):
                        self.metrics.count(f"serve.op.{op}.errors", 1)
                    dropped_reply = False
                    if faults.ACTIVE is not None:
                        # The serve-socket seam, between dispatch and send:
                        # the request has run; the reply is dropped or late.
                        act = faults.ACTIVE.serve_action(op, self.metrics)
                        if act is not None and act["action"] == "drop":
                            dropped_reply = True
                        elif act is not None and act["action"] == "stall":
                            ts = time.perf_counter()
                            time.sleep(act["ms"] / 1e3)
                            if rctx is not None:
                                rctx.annotate("reply.stall", ms=(time.perf_counter() - ts) * 1e3,
                                              injected=True)
                    if rctx is not None:
                        reply.setdefault("trace_id", rctx.trace_id)
                        self._finish_request(rctx, op, reply, dropped_reply)
                    if dropped_reply:
                        return
                send_msg(conn, reply)
        except Exception:  # noqa: BLE001 - a broken connection never kills the daemon
            self.metrics.count("serve.connection_errors", 1)
        finally:
            if stop_after:
                self._stop.set()

    def _finish_request(self, rctx: RequestContext, op: Optional[str], reply: dict,
                        dropped_reply: bool = False) -> None:
        """A data-plane request's summary: the tail sampler and the access
        log."""
        if op not in TRACED_OPS:
            return
        outcome = "OK" if reply.get("ok") else (reply.get("code") or "ERROR")
        duration_ms = rctx.elapsed_ms()
        if self._access_log is None and not self.sampler.would_sample(op, outcome, duration_ms,
                                                                      rctx.hops):
            self.metrics.count("serve.trace.requests", 1)
            return
        extra = {"dropped_reply": True} if dropped_reply else None
        summary = exemplars_mod.request_summary(rctx, outcome, duration_ms, op=op, extra=extra)
        self.sampler.observe(summary)
        if self._access_log is not None:
            self._access_log.log(exemplars_mod.access_record(summary))

    def _dispatch(self, req: dict) -> Tuple[dict, bool]:
        op = req.get("op")
        self.metrics.count(f"serve.op.{op}", 1)
        deadline = Deadline.from_request(req, metrics=self.metrics)
        if deadline is not None:
            deadline.check("dispatch")
        if op == "ping":
            return ({"ok": True, "pid": os.getpid(), "endpoint": self.endpoint,
                     "draining": self._draining.is_set()}, False)
        if op == "view":
            with self.admission.acquire(op, deadline=deadline), deadline_scope(deadline):
                blob = view_blob(self.ctx, req["path"], req["region"],
                                 level=int(req.get("level", 6)), deadline=deadline)
            return ({"ok": True, "data_b64": base64.b64encode(blob).decode("ascii")}, False)
        if op == "flagstat":
            with self.admission.acquire(op, deadline=deadline), deadline_scope(deadline):
                counts = flagstat(self.ctx, req["path"], deadline=deadline)
            return ({"ok": True, "counts": counts}, False)
        if op == "variants":
            with self.admission.acquire(op, deadline=deadline), deadline_scope(deadline):
                blob = variants_blob(self.ctx, req["path"], req["region"], deadline=deadline)
            return ({"ok": True, "data_b64": base64.b64encode(blob).decode("ascii")}, False)
        if op == "depth":
            with self.admission.acquire(op, deadline=deadline), deadline_scope(deadline):
                stat = depth_stat(self.ctx, req["path"], req["region"],
                                  bin_size=int(req.get("bin_size", 1 << 12)),
                                  per_base=bool(req.get("per_base", False)), deadline=deadline)
            return ({"ok": True, "depth": stat}, False)
        if op == "sort":
            return self._job_op(op, req, deadline)
        if op == "ingest":
            return self._job_op(op, req, deadline)
        if op == "job":
            with self._jobs_lock:
                job = self._jobs.get(req.get("id"))
            if job is None:
                return ({"ok": False, "code": JOB_LOST,
                         "error": f"unknown job id {req.get('id')!r}"}, False)
            return ({"ok": True, **job}, False)
        if op == "stats":
            return ({"ok": True, **self._stats()}, False)
        if op == "exemplars":
            tid = req.get("trace_id")
            if tid:
                ex = self.exemplars.get(tid)
                if ex is None:
                    return ({"ok": False, "error": f"no exemplar for trace {tid!r} "
                             "(not sampled, or evicted from the store)"}, False)
                return ({"ok": True, "exemplar": ex}, False)
            return ({"ok": True, "exemplars": self.exemplars.summaries()}, False)
        if op == "metrics":
            return ({"ok": True, "content_type": "text/plain; version=0.0.4",
                     "text": prometheus_text(snapshot(self.metrics), gauges=self._gauges())},
                    False)
        if op == "adopt":
            return (self._adopt(req), False)
        if op == "warmth":
            return (self._warmth(req), False)
        if op == "shutdown":
            return (self._drain(), True)
        return ({"ok": False, "error": f"unknown op {op!r}"}, False)

    # -- fleet hand-offs ------------------------------------------------------------

    def _adopt(self, req: dict) -> dict:
        """Adopt a dead peer's journal: replay it, plan recovery as the
        peer's restart would, and resubmit each resumable job under a fresh
        local id, journaled here before the pool sees it.  Returns
        ``{"adopted": {peer id: local id}, "lost": [...], "jobs_seen"}``."""
        jpath = req.get("journal")
        if not jpath:
            return {"ok": False, "error": "adopt needs a journal path"}
        try:
            jobs = journal_mod.replay(jpath, self.metrics)
        except (ValueError, OSError) as e:
            self.metrics.count("serve.adopt.journal_errors", 1)
            return {"ok": False, "error": f"peer journal {jpath!r} unreadable: {e}"}
        plan = journal_mod.recovery_plan(jobs, self.metrics)
        adopted: Dict[str, str] = {}
        lost: List[str] = []
        for peer_jid, action in sorted(plan.items()):
            if action != "resume":
                lost.append(peer_jid)
                self.metrics.count("serve.adopt.lost", 1)
                continue
            peer_req = dict(jobs[peer_jid]["req"])
            with self._jobs_lock:
                self._job_seq += 1
                jid = f"job-{self._job_seq:04d}"
                self._jobs[jid] = {"status": "queued", "output": peer_req.get("output"),
                                   "adopted_from": {"job": peer_jid, "source": req.get("source")}}
            if self._journal is not None:
                # Durable here first: the adopter's own crash is recoverable.
                self._journal.submit(jid, peer_req, jobs[peer_jid].get("inputs"))
                self._journal.state(jid, "adopted", source=req.get("source"))
            self._job_pool.submit(self._run_job, jid, peer_req)
            adopted[peer_jid] = jid
            self.metrics.count("serve.adopt.resumed", 1)
        self.metrics.count("serve.adoptions", 1)
        return {"ok": True, "adopted": adopted, "lost": lost, "jobs_seen": len(jobs)}

    def _warmth(self, req: dict) -> dict:
        """List this daemon's windows of a path, export them as BGZF
        members, or install windows a peer shipped (inflated on the card)."""
        path = req.get("path")
        if not path:
            return {"ok": False, "error": "warmth needs a path"}
        arena = self.ctx.arena
        if req.get("windows") is not None:
            installed = fleet_mod.unpack_windows(arena, path, req["windows"], self.ctx.stream,
                                                 metrics=self.metrics)
            return {"ok": True, "installed": installed}
        if not req.get("export"):
            return {"ok": True, "windows": [{"kind": k[0], "span": [int(k[2]), int(k[3])]}
                                            for k in fleet_mod._arena_keys_for(arena, path)]}
        return {"ok": True, "windows": fleet_mod.pack_windows(
            arena, path, level=int(req.get("level", 1)), metrics=self.metrics)}

    # -- sort / ingest jobs -------------------------------------------------------

    def _job_op(self, op: str, req: dict, deadline: Optional[Deadline]) -> Tuple[dict, bool]:
        """Submit a job; it holds its admission tokens until it ends."""
        if self._draining.is_set():
            return ({"ok": False, "error": "daemon is draining"}, False)
        ticket = self.admission.acquire(op, deadline=deadline)
        try:
            jid = self._submit_job(req, ticket, deadline)
        except BaseException:
            ticket.release()
            raise
        return ({"ok": True, "job": jid}, False)

    @staticmethod
    def _job_kind(req: dict) -> str:
        """From the payload, not ``op``: replayed requests carry no op."""
        return "ingest" if "fastq" in req else "sort"

    @staticmethod
    def _job_inputs(req: dict) -> List[str]:
        paths = req.get("fastq") if "fastq" in req else req.get("bam")
        if isinstance(paths, str):
            paths = [paths]
        return list(paths or [])

    def _submit_job(self, req: dict, ticket=None, deadline: Optional[Deadline] = None) -> str:
        rctx = current_request()
        kind = self._job_kind(req)
        job_ctx = rctx.child(op=f"{kind}.job") if rctx is not None else None
        with self._jobs_lock:
            self._job_seq += 1
            jid = f"job-{self._job_seq:04d}"
            self._jobs[jid] = {"status": "queued", "output": req.get("output")}
            if job_ctx is not None:
                self._jobs[jid]["trace_id"] = job_ctx.trace_id
        if self._journal is not None:
            # Durable before the pool sees it.
            self._journal.submit(jid, {k: v for k, v in req.items() if k != "op"},
                                 journal_mod.input_identity(self._job_inputs(req)))
        self._job_pool.submit(self._run_job, jid, dict(req), ticket, deadline, job_ctx)
        self.metrics.count("serve.jobs_submitted", 1)
        return jid

    def _journal_state(self, jid: str, status: str, **extra) -> None:
        if self._journal is not None:
            try:
                self._journal.state(jid, status, **extra)
            except OSError:
                self.metrics.count("serve.journal.append_errors", 1)
        rctx = current_request()
        if rctx is not None:
            rctx.annotate("journal.state", job=jid, status=status)

    def _run_job(self, jid: str, req: dict, ticket=None, deadline: Optional[Deadline] = None,
                 rctx: Optional[RequestContext] = None) -> None:
        kind = self._job_kind(req)
        with self._jobs_lock:
            self._jobs[jid]["status"] = "running"
        outcome = "OK"
        device = self.ctx.stream.device
        with request_scope(rctx):
            self._journal_state(jid, "running")
            try:
                if kind == "ingest":
                    from ..ingest import ingest_fastq

                    stats = ingest_fastq(
                        self._job_inputs(req), req["output"], conf=self.conf,
                        level=int(req.get("level", 6)), memory_budget=req.get("memory_budget"),
                        part_dir=req.get("part_dir"), errors=req.get("errors"),
                        deadline=deadline, resource_cache=self.ctx.cache, device=device,
                    )
                    stats_d = {"n_records": stats.n_records, "n_pairs": stats.n_pairs,
                               "n_members": stats.n_members, "out_bytes": stats.out_bytes}
                else:
                    from ..pipeline import sort_bam

                    stats = sort_bam(
                        self._job_inputs(req), req["output"], conf=self.conf,
                        level=int(req.get("level", 6)), memory_budget=req.get("memory_budget"),
                        part_dir=req.get("part_dir"),
                        write_splitting_bai=bool(req.get("write_splitting_bai")),
                        mark_duplicates=bool(req.get("mark_duplicates")),
                        sort_order=req.get("sort_order"), resource_cache=self.ctx.cache,
                        deadline=deadline, device=device,
                    )
                    stats_d = {"n_records": stats.n_records, "n_splits": stats.n_splits,
                               "backend": stats.backend, "n_duplicates": stats.n_duplicates}
                # The job's own counters join the daemon's registry.
                for k, v in stats.counters.items():
                    self.metrics.count(k, v)
                with self._jobs_lock:
                    self._jobs[jid].update(status="done", stats=stats_d)
                self._journal_state(jid, "done", stats=stats_d)
            except DeadlineExceeded as e:
                outcome = DEADLINE_EXCEEDED
                self.metrics.count("serve.jobs_failed", 1)
                with self._jobs_lock:
                    self._jobs[jid].update(status="failed", code=DEADLINE_EXCEEDED, error=str(e))
                self._journal_state(jid, "failed", error=str(e))
            except Exception as e:  # noqa: BLE001 - the job's status carries it
                outcome = "ERROR"
                self.metrics.count("serve.jobs_failed", 1)
                err = f"{type(e).__name__}: {e}"
                with self._jobs_lock:
                    self._jobs[jid].update(status="failed", error=err)
                self._journal_state(jid, "failed", error=err)
            finally:
                if ticket is not None:
                    ticket.release()
                if rctx is not None:
                    summary = exemplars_mod.request_summary(rctx, outcome, rctx.elapsed_ms(),
                                                            op=f"{kind}.job", extra={"job": jid})
                    self.sampler.observe(summary)
                    if self._access_log is not None:
                        self._access_log.log(exemplars_mod.access_record(summary))

    # -- stats / drain ------------------------------------------------------------

    def _gauges(self) -> Dict[str, float]:
        """Point-in-time gauges: the registry's, arena and cache occupancy,
        jobs, admission, the batcher's queue."""
        arena = self.ctx.arena.stats()
        cache = self.ctx.cache.stats()
        with self._jobs_lock:
            statuses = [j["status"] for j in self._jobs.values()]
        g = self.metrics.gauges()
        g.update({
            "serve.arena.used_bytes": arena["used_bytes"],
            "serve.arena.budget_bytes": arena["budget_bytes"],
            "serve.arena.entries": arena["entries"],
            "serve.arena.device_resident": arena["device_resident"],
            "serve.cache.used_bytes": cache["used_bytes"],
            "serve.cache.budget_bytes": cache["budget_bytes"],
            "serve.cache.entries": cache["entries"],
            "serve.jobs.queued": sum(1 for s in statuses if s == "queued"),
            "serve.jobs.running": sum(1 for s in statuses if s == "running"),
            "serve.jobs.max_inflight": self.max_inflight,
            "serve.draining": int(self._draining.is_set()),
        })
        g.update(self.admission.gauges())
        if self.ctx.batcher is not None:
            g["serve.batch.queue_depth"] = self.ctx.batcher.queue_depth()
        g["serve.trace.exemplar_count"] = len(self.exemplars)
        return g

    def _flight_snapshot(self) -> dict:
        """The flight recorder's source: gauges, degradation counters, SLO."""
        counters = self.metrics.counters()
        rec = {
            "gauges": self._gauges(),
            "counters": {k: v for k, v in counters.items()
                         if k.startswith(flightrec_mod.SNAPSHOT_COUNTER_PREFIXES)},
        }
        try:
            rec["slo"] = self.slo.brief()
        except Exception:  # noqa: BLE001 - the recorder never kills
            self.metrics.count("serve.flightrec.source_errors", 1)
        return rec

    def _stats(self) -> dict:
        report = delta(self._started_snapshot, registry=self.metrics)
        report["histograms"] = snapshot(self.metrics)["histograms"]
        report["transfers"] = transfers_report(report["counters"])
        with self._jobs_lock:
            jobs = {k: dict(v) for k, v in self._jobs.items()}
        return {
            "metrics": report,
            "gauges": self._gauges(),
            "cache": self.ctx.cache.stats(),
            "arena": self.ctx.arena.stats(),
            "jobs": jobs,
            "warmup": self.warmup_report,
            "draining": self._draining.is_set(),
            "slo": self.slo.evaluate(),
        }

    def _drain(self) -> dict:
        """Refuse new jobs, finish the running ones, report; the stop flag
        is set after the reply is sent."""
        self._draining.set()
        self._job_pool.shutdown(wait=True)
        if self._flightrec is not None:
            self._flightrec.stop(final=True)
        with self._jobs_lock:
            statuses = [j["status"] for j in self._jobs.values()]
        self.metrics.count("serve.drains", 1)
        return {
            "ok": True,
            "drained": True,
            "jobs_total": len(statuses),
            "jobs_done": sum(1 for s in statuses if s == "done"),
            "jobs_failed": sum(1 for s in statuses if s == "failed"),
        }

"""Thin stdlib client of the resident daemon (:mod:`.server`'s framing).

Counterpart of ``hadoop_bam_tpu/serve/client.py``: one connection a
request; an ``ok: false`` reply raises the typed exception of its
``code`` (:func:`error_from_reply`: ``SHED``/``RETRY_AFTER`` ->
:class:`ServeShedError` with ``retry_after_ms``, ``DEADLINE_EXCEEDED`` ->
:class:`DeadlineExceededError`, ``JOB_LOST`` -> :class:`JobLostError`).
Transport failures raise :class:`ServeConnectionError`; idempotent
requests (ping, view, flagstat, variants, depth, job, stats, metrics,
exemplars) retry them and shed replies with jittered exponential backoff,
and never past a client deadline; ``sort``/``ingest`` submissions are
never retried.  Every request carries a ``trace`` field: the client
originates the trace id (:attr:`ServeClient.last_trace_id`), the daemon
continues it.  :meth:`ServeClient.wait` polls a job with jittered backoff
and raises :class:`JobLostError` for a job the daemon cannot account for.
The wire format is the reference's: either package's client talks to
either package's daemon.
"""

from __future__ import annotations

import base64
import random
import socket
import time
from typing import Optional

from ..utils.deadline import Deadline
from ..utils.tracing import RequestContext, current_request
from .admission import DEADLINE_EXCEEDED, JOB_LOST, RETRY_AFTER, SHED
from .server import recv_msg, send_msg


class ServeError(RuntimeError):
    """The daemon replied ok=false (the error string is the message).
    ``code`` carries the protocol error code when the reply had one."""

    code: Optional[str] = None


class ServeConnectionError(ServeError, ConnectionError):
    """A transport-level failure (refused/reset/dropped/stalled) — the
    retryable class; the daemon may be fine and merely mid-drain.  Also a
    ``ConnectionError`` so pre-existing callers catching ``OSError`` for
    connection trouble keep working."""


class ServeShedError(ServeError):
    """The daemon refused to admit the request (codes ``SHED`` /
    ``RETRY_AFTER``).  ``retry_after_ms`` is the server-computed backoff
    hint; idempotent requests honor it automatically."""

    def __init__(self, message: str, code: str = SHED, retry_after_ms: int = 50):
        super().__init__(message)
        self.code = code
        self.retry_after_ms = int(retry_after_ms)


class DeadlineExceededError(ServeError):
    """The request's end-to-end deadline expired (server- or client-side
    detected).  Never auto-retried — the budget is spent."""

    code = DEADLINE_EXCEEDED


class JobLostError(ServeError):
    """The daemon does not know this job id (code ``JOB_LOST``): it
    restarted and the journal could not account for the job, or the id
    never existed.  Terminal — ``wait`` raises it instead of polling an
    id that can never resolve."""

    code = JOB_LOST


#: code → typed exception; tests assert this map covers every code the
#: server can emit (``admission.ERROR_CODES``), so new codes cannot
#: silently degrade to the untyped ServeError.
_CODE_ERRORS = {
    SHED: ServeShedError,
    RETRY_AFTER: ServeShedError,
    DEADLINE_EXCEEDED: DeadlineExceededError,
    JOB_LOST: JobLostError,
}


def error_from_reply(reply: dict) -> ServeError:
    """The typed exception for an ``ok: false`` reply (the client half of
    the error-code round trip)."""
    msg = reply.get("error", "unknown daemon error")
    code = reply.get("code")
    cls = _CODE_ERRORS.get(code)
    if cls is ServeShedError:
        return ServeShedError(
            msg, code=code, retry_after_ms=reply.get("retry_after_ms", 50)
        )
    if cls is not None:
        return cls(msg)
    return ServeError(msg)


#: Exceptions worth retrying at the transport layer.  ``socket.timeout``
#: and the ``Connection*`` family are OSError subclasses, but transient
#: non-OSError paths (json of a half frame) surface as ServeConnectionError.
_RETRYABLE = (ServeConnectionError, socket.timeout, ConnectionError, OSError)


class ServeClient:
    def __init__(
        self,
        socket_path: Optional[str] = None,
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        timeout: float = 300.0,
        retries: int = 2,
        retry_backoff: float = 0.05,
    ):
        if socket_path is None and port is None:
            from .server import default_socket_path

            socket_path = default_socket_path()
        self.socket_path = socket_path
        self.host = host
        self.port = port
        self.timeout = timeout
        self.retries = retries
        self.retry_backoff = retry_backoff
        #: Trace id of the most recent request this client originated —
        #: the handle a caller joins against the daemon's exemplar
        #: store, access log, and ``tools/request_report.py``.
        self.last_trace_id: Optional[str] = None

    def _request_once(self, obj: dict) -> dict:
        if self.socket_path is not None:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            addr = self.socket_path
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            addr = (self.host, self.port)
        sock.settimeout(self.timeout)
        try:
            sock.connect(addr)
            send_msg(sock, obj)
            reply = recv_msg(sock)
        finally:
            sock.close()
        if reply is None:
            raise ServeConnectionError(
                "daemon closed the connection without a reply"
            )
        if not reply.get("ok"):
            raise error_from_reply(reply)
        return reply

    def _request(
        self,
        obj: dict,
        idempotent: bool = False,
        deadline: Optional[Deadline] = None,
    ) -> dict:
        """One request; idempotent ones retry transport failures with
        exponential backoff (``retries`` attempts beyond the first) and
        shed replies by the server's ``retry_after_ms`` hint.

        ``DEADLINE_EXCEEDED`` and ``JOB_LOST`` replies are never retried
        (terminal by definition).  With a ``deadline``, each attempt
        sends the *remaining* budget as ``deadline_ms`` and the retry
        loop itself stops — with :class:`DeadlineExceededError` — once
        the budget is spent, so a client deadline bounds the whole
        exchange, retries included.

        Every request carries a ``trace`` field: the client *originates*
        the 128-bit trace id (continuing any ambient
        :func:`~..utils.tracing.request_scope` as a child
        span), the daemon continues it, and retries reuse it — one
        logical request is one trace whatever the transport did.  The
        id is kept in :attr:`last_trace_id`.

        Connection-reset/refused on an idempotent op — the signature of
        a daemon restart or a fleet hand-off — is retried with
        *jittered* backoff (±50%, so a fleet of clients bounced off the
        same dying daemon does not re-stampede it in lockstep), and the
        retry is a first-class ``client.retry`` hop on the request's
        trace: the waterfall names the transport failure and the pause
        instead of showing an unexplained gap.
        """
        ambient = current_request()
        rctx = (
            ambient.child(op=obj.get("op", ""))
            if ambient is not None
            else RequestContext.new(op=obj.get("op", ""))
        )
        obj["trace"] = rctx.to_wire()  # callers pass fresh dicts
        self.last_trace_id = rctx.trace_id
        attempts = (self.retries + 1) if idempotent else 1
        last: Optional[Exception] = None
        for attempt in range(attempts):
            if deadline is not None:
                rem = deadline.remaining_ms()
                if rem <= 0:
                    raise DeadlineExceededError(
                        "client deadline expired "
                        + ("before the request" if attempt == 0
                           else "between retries")
                    )
                obj = {**obj, "deadline_ms": rem}
            pause = self.retry_backoff * (2 ** attempt) * random.uniform(
                0.5, 1.5
            )
            try:
                return self._request_once(obj)
            except ServeShedError as e:
                if not idempotent:
                    raise  # a shed sort must stay the caller's decision
                last = e
                pause = max(pause, e.retry_after_ms / 1e3)
            except ServeError as e:
                if not isinstance(e, ServeConnectionError):
                    raise  # a real daemon reply: never retry
                last = e
            except _RETRYABLE as e:
                last = e
            if attempt + 1 < attempts:
                rctx.annotate(
                    "client.retry",
                    attempt=attempt + 1,
                    error=type(last).__name__,
                    pause_ms=pause * 1e3,
                )
                time.sleep(pause)
        assert last is not None
        raise (
            last
            if isinstance(last, ServeError)
            else ServeConnectionError(f"{type(last).__name__}: {last}")
        )

    # -- ops ----------------------------------------------------------------

    @staticmethod
    def _deadline(deadline_ms: Optional[float]) -> Optional[Deadline]:
        return None if deadline_ms is None else Deadline.after_ms(deadline_ms)

    def ping(self) -> dict:
        return self._request({"op": "ping"}, idempotent=True)

    def view(
        self,
        path: str,
        region: str,
        level: int = 6,
        deadline_ms: Optional[float] = None,
    ) -> bytes:
        """The region's records as a complete small BAM (bytes).
        ``deadline_ms`` is the end-to-end budget: the daemon cancels the
        work at its next seam once it expires (``DeadlineExceededError``)
        instead of finishing an answer nobody will read."""
        r = self._request(
            {"op": "view", "path": path, "region": region, "level": level},
            idempotent=True,
            deadline=self._deadline(deadline_ms),
        )
        return base64.b64decode(r["data_b64"])

    def flagstat(
        self, path: str, deadline_ms: Optional[float] = None
    ) -> dict:
        return self._request(
            {"op": "flagstat", "path": path},
            idempotent=True,
            deadline=self._deadline(deadline_ms),
        )["counts"]

    def variants(
        self,
        path: str,
        region: str,
        deadline_ms: Optional[float] = None,
    ) -> bytes:
        """The region's variant records as a complete small BCF (bytes),
        same reply contract as :meth:`view` for the variant plane."""
        r = self._request(
            {"op": "variants", "path": path, "region": region},
            idempotent=True,
            deadline=self._deadline(deadline_ms),
        )
        return base64.b64decode(r["data_b64"])

    def depth(
        self,
        path: str,
        region: str,
        bin_size: int = 1 << 12,
        per_base: bool = False,
        deadline_ms: Optional[float] = None,
    ) -> dict:
        """Pileup depth summary for an alignment region (dict: binned
        depth vector, max/mean, covered bases; ``per_base`` adds the
        exact vector under the server's span cap)."""
        r = self._request(
            {
                "op": "depth",
                "path": path,
                "region": region,
                "bin_size": bin_size,
                "per_base": per_base,
            },
            idempotent=True,
            deadline=self._deadline(deadline_ms),
        )
        return r["depth"]

    def sort(
        self, bam, output: str, deadline_ms: Optional[float] = None, **kwargs
    ) -> str:
        """Submit a sort; returns the job id (poll with :meth:`job` or
        block with :meth:`wait`).  Deliberately not auto-retried — a
        resubmitted request is a *second* job.  ``deadline_ms`` bounds
        the whole *job* server-side (the pipeline checks it down to the
        part-write attempt loop)."""
        req = {"op": "sort", "bam": bam, "output": output}
        req.update(kwargs)
        return self._request(req, deadline=self._deadline(deadline_ms))[
            "job"
        ]

    def ingest(
        self,
        fastq,
        output: str,
        r2: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        **kwargs,
    ) -> str:
        """Submit a FASTQ → collated-uBAM ingest job; returns the job id
        (poll with :meth:`job` or block with :meth:`wait`).  ``fastq``
        is the R1 (or sole) input path, or a [r1, r2] list; same job
        lifecycle as :meth:`sort` — not auto-retried, journaled, resumed
        from ``part_dir`` checkpoints on daemon restart."""
        paths = list(fastq) if isinstance(fastq, (list, tuple)) else [fastq]
        if r2 is not None:
            paths.append(r2)
        req = {"op": "ingest", "fastq": paths, "output": output}
        req.update(kwargs)
        return self._request(req, deadline=self._deadline(deadline_ms))[
            "job"
        ]

    def job(self, job_id: str) -> dict:
        return self._request({"op": "job", "id": job_id}, idempotent=True)

    def wait(
        self,
        job_id: str,
        timeout: float = 600.0,
        poll_s: float = 0.05,
        poll_max: float = 1.0,
        max_poll_errors: int = 5,
        deadline_ms: Optional[float] = None,
    ) -> dict:
        """Poll a submitted job to completion; raises on job failure.

        Polling backs off exponentially from ``poll_s`` to ``poll_max``
        with ±20% jitter (a fleet of waiters must not stampede the
        daemon in lockstep), and a streak of up to ``max_poll_errors``
        retryable transport errors — reset connections, stalled reads —
        is ridden out with the same backoff instead of aborting a job
        that is still running server-side.

        Two loss bounds (the old loop could poll a dead id forever at
        1 Hz): a ``JOB_LOST`` reply — or a journal-replayed ``lost``
        status — raises the typed :class:`JobLostError` immediately, and
        ``deadline_ms`` (the client's own end-to-end budget) caps the
        polling wall clock with :class:`DeadlineExceededError` on top of
        ``timeout``'s plain :class:`TimeoutError`.
        """
        client_dl = self._deadline(deadline_ms)
        deadline = time.monotonic() + timeout
        delay = poll_s
        errors_in_a_row = 0
        while True:
            try:
                st = self.job(job_id)
                errors_in_a_row = 0
            except JobLostError:
                raise  # terminal: the daemon does not know this job
            except _RETRYABLE as e:
                errors_in_a_row += 1
                if errors_in_a_row > max_poll_errors:
                    raise ServeConnectionError(
                        f"job {job_id}: {errors_in_a_row} consecutive "
                        f"polling failures (last: {type(e).__name__}: {e})"
                    ) from e
                st = None
            if st is not None:
                if st["status"] == "done":
                    return st
                if st["status"] == "lost":
                    raise JobLostError(
                        st.get("error", f"job {job_id} lost by the daemon")
                    )
                if st["status"] == "failed":
                    raise error_from_reply(
                        {"code": st.get("code"),
                         "error": st.get("error", "job failed")}
                    )
            if client_dl is not None and client_dl.expired:
                raise DeadlineExceededError(
                    f"job {job_id} not done within the client deadline "
                    f"({deadline_ms:.0f} ms)"
                )
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"job {job_id} not done after {timeout}s"
                )
            time.sleep(
                min(delay, max(deadline - time.monotonic(), 0.0))
                * random.uniform(0.8, 1.2)
            )
            delay = min(delay * 1.6, poll_max)

    def stats(self) -> dict:
        return self._request({"op": "stats"}, idempotent=True)

    def exemplars(self, trace_id: Optional[str] = None):
        """The daemon's tail-latency exemplars: without ``trace_id``,
        the compact listing (newest last); with one, the full exemplar —
        summary + the request's trace events + the completeness verdict
        (``incomplete: true`` when ring overflow ate part of the tree).
        """
        req = {"op": "exemplars"}
        if trace_id is not None:
            req["trace_id"] = trace_id
            return self._request(req, idempotent=True)["exemplar"]
        return self._request(req, idempotent=True)["exemplars"]

    def adopt(self, journal: str, source: Optional[str] = None) -> dict:
        """Direct this daemon to adopt a dead peer's journal: replay it,
        resume what the checkpoints can reproduce byte-identically under
        fresh local job ids, report the rest lost.  Returns the reply
        with ``adopted`` ({peer job id → local job id}) and ``lost``.
        Deliberately NOT idempotent-retried: a re-sent adopt would
        double-submit the resumable jobs (the fleet router, the normal
        caller, sends it exactly once per death)."""
        req = {"op": "adopt", "journal": journal}
        if source is not None:
            req["source"] = source
        return self._request(req)

    def warmth(
        self,
        path: str,
        export: bool = False,
        windows: Optional[list] = None,
        level: int = 1,
    ) -> dict:
        """The daemon's warm arena windows for ``path``: list (default),
        export as compressed members (``export=True``), or install
        shipped ``windows`` into the local arena.  Listing/export are
        idempotent reads; an import is applied once."""
        req = {"op": "warmth", "path": path}
        if windows is not None:
            req["windows"] = windows
            return self._request(req)
        if export:
            req["export"] = True
            req["level"] = level
        return self._request(req, idempotent=True)

    def fleet(self) -> dict:
        """The router's fleet view: ring shares, members and their
        liveness, deaths, hand-offs and job aliases.  Only a router answers
        it; a daemon replies unknown-op."""
        return self._request({"op": "fleet"}, idempotent=True)

    def metrics(self) -> str:
        """The daemon's metrics in Prometheus text exposition format
        (cumulative counters/histograms + live gauges) — what a scraping
        sidecar would relay."""
        return self._request({"op": "metrics"}, idempotent=True)["text"]

    def shutdown(self) -> dict:
        """Graceful drain: the daemon finishes in-flight jobs, replies,
        then exits its accept loop."""
        return self._request({"op": "shutdown"})

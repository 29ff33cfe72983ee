"""Crash-safe job journal: append-only JSONL of submissions and transitions.

Counterpart of ``hadoop_bam_tpu/serve/journal.py``.  Every job submission
and state change is one JSON line, appended with flush and ``fsync``
before the daemon acts on it.  On restart, :func:`replay` rebuilds the job
table (a torn final line, a crash mid-append, is dropped and counted
``serve.journal.torn_tail``) and :func:`recovery_plan` decides each
interrupted job: ``resume`` when its inputs' ``(path, size, mtime_ns)``
still match and the request named a persistent ``part_dir`` (the part
executor's resume then reproduces the output byte for byte), else
``lost`` (``serve.journal.stale`` when the inputs changed).  Counters go
to the ``metrics`` given.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

from ..utils.tracing import Metrics

#: Journal format version; replay rejects lines from a different one.
VERSION = 1

#: Job states that need no recovery action on replay.
TERMINAL_STATES = frozenset(("done", "failed", "lost"))


def input_identity(paths: List[str]) -> Optional[List[Dict]]:
    """``(path, size, mtime_ns)`` fingerprints of a job's inputs, or
    None when any cannot be stat'd (non-local inputs: no resume)."""
    out: List[Dict] = []
    try:
        for p in paths:
            st = os.stat(p)
            out.append(
                {"path": p, "size": st.st_size, "mtime_ns": st.st_mtime_ns}
            )
    except OSError:
        return None
    return out


def identity_current(inputs: Optional[List[Dict]]) -> bool:
    """Do the recorded input fingerprints still match the files on disk?
    A journal recorded against different bytes must never seed a resume
    (the spill manifest applies the same rule independently)."""
    if not inputs:
        return False
    try:
        for e in inputs:
            st = os.stat(e["path"])
            if (
                st.st_size != e["size"]
                or st.st_mtime_ns != e["mtime_ns"]
            ):
                return False
    except OSError:
        return False
    return True


class JobJournal:
    """Append-only JSONL journal with fsync'd appends (thread-safe)."""

    def __init__(self, path: str, metrics: Optional[Metrics] = None):
        self.path = path
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = threading.Lock()
        self._f = None

    def open(self) -> None:
        if self._f is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "ab")

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                finally:
                    self._f = None

    def append(self, event: dict) -> None:
        """One journal line, durable before return: a state the daemon
        acts on is on disk first (write + flush + fsync — the same
        torn-write stance as the spill manifest's atomic replace)."""
        self.open()
        line = (
            json.dumps(
                {"v": VERSION, **event}, separators=(",", ":")
            ).encode("utf-8")
            + b"\n"
        )
        with self._lock:
            self._f.write(line)
            self._f.flush()
            os.fsync(self._f.fileno())
        self.metrics.count("serve.journal.appends", 1)

    def submit(self, jid: str, req: dict, inputs: Optional[List[Dict]]) -> None:
        self.append(
            {"event": "submit", "job": jid, "req": req, "inputs": inputs}
        )

    def state(self, jid: str, status: str, **extra) -> None:
        self.append({"event": "state", "job": jid, "status": status, **extra})


def replay(path: str, metrics: Optional[Metrics] = None) -> Dict[str, dict]:
    """Reconstruct job states from a journal file.

    Returns ``{jid: {"status", "req", "inputs", ...}}`` where ``status``
    is the last recorded one (``submitted`` if only the submission ever
    landed).  Unparseable *trailing* data — the torn final append of a
    crash — is dropped and counted; an unparseable line in the middle
    fails the whole replay (that is corruption, not a torn tail).
    """
    jobs: Dict[str, dict] = {}
    if not os.path.exists(path):
        return jobs
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    # A well-formed journal ends with a newline → last element is empty.
    torn = lines[-1] != b""
    body = lines[:-1]
    for i, line in enumerate(body):
        if not line:
            continue
        try:
            ev = json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            if i == len(body) - 1 and not torn:
                torn = True  # torn mid-line then truncated at a newline
                break
            raise ValueError(
                f"corrupt journal line {i} in {path!r}"
            ) from None
        if ev.get("v") != VERSION:
            raise ValueError(
                f"journal {path!r} has version {ev.get('v')!r}, "
                f"expected {VERSION}"
            )
        jid = ev.get("job")
        if ev.get("event") == "submit":
            jobs[jid] = {
                "status": "submitted",
                "req": ev.get("req") or {},
                "inputs": ev.get("inputs"),
            }
        elif ev.get("event") == "state" and jid in jobs:
            jobs[jid]["status"] = ev.get("status")
            for k in ("stats", "error", "output"):
                if k in ev:
                    jobs[jid][k] = ev[k]
    if torn and metrics is not None:
        metrics.count("serve.journal.torn_tail", 1)
    return jobs


def recovery_plan(jobs: Dict[str, dict], metrics: Optional[Metrics] = None) -> Dict[str, str]:
    """Per interrupted job, the recovery action: ``resume`` (inputs
    identity still matches and the request carries a persistent
    ``part_dir`` — the part checkpoints make the rerun byte-identical)
    or ``lost`` (anything the daemon cannot honestly re-run).  Terminal
    jobs need no action and are absent."""
    plan: Dict[str, str] = {}
    for jid, job in jobs.items():
        if job["status"] in TERMINAL_STATES:
            continue
        req = job.get("req") or {}
        if not identity_current(job.get("inputs")):
            plan[jid] = "lost"
            if metrics is not None:
                metrics.count("serve.journal.stale", 1)
        elif req.get("part_dir"):
            plan[jid] = "resume"
        else:
            plan[jid] = "lost"
    return plan

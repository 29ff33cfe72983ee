"""Deterministic fault-injection plans for the robustness seams.

Counterpart of ``hadoop_bam_tpu/faults/plan.py``: a seeded, declarative
:class:`FaultPlan` that fires where real failures enter the pipeline: byte
I/O, the codec tiers, the part-write executor, the mesh shuffle and the
serve socket.  Every site parses; the port arms the executor's
(``exec.*``), the CRC gate's (``flate.corrupt``) and the codec's
(``flate.inflate.tierdown``, ``flate.deflate.tierdown``) seams, and the
other methods are reached only from tests until their modules are ported.

A plan is a ``;``-separated list of directives, each
``site[:key=value[,key=value...]]``, e.g.::

    HBAM_FAULTS="seed=7;exec.crash:items=1,attempts=0"

Every directive carries ``n`` (how many times it fires, default 1; ``*``
is unlimited; an offset-pinned ``io.read.bitflip`` is persistent by
default) and site-specific filters.  Match sets: ``*``, ``3``, ``0-2``,
``1,4,7``.  Firing is deterministic: budgets are consumed in call order and
any randomness (bit positions) comes from the plan's seeded RNG.

Sites: ``io.read.bitflip`` (``offset``, ``bit``, ``path``), ``io.read.short``
(``drop``, ``path``), ``io.read.error`` (``path``),
``flate.inflate.tierdown`` / ``flate.deflate.tierdown`` (``members``),
``flate.corrupt`` (a byte of a host-inflated payload flipped before the CRC
gate), ``mh.corrupt`` (``members``), ``mh.speculate.lose`` (``ms``),
``exec.crash`` / ``exec.torn`` / ``exec.delay`` (``ms``) / ``exec.die``
(``items``, ``attempts``), ``serve.drop`` / ``serve.stall`` (``op``,
``ms``), ``arena.oom``.

The port has no process-wide metrics: a fired directive counts into
:attr:`FaultPlan.fired` and, as ``faults.fired`` and
``faults.fired.<site>``, into the ``metrics`` of the job whose seam fired
it, where the seam has one.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional

_SITES = frozenset(
    (
        "io.read.bitflip",
        "io.read.short",
        "io.read.error",
        "flate.inflate.tierdown",
        "flate.deflate.tierdown",
        "flate.corrupt",
        "mh.corrupt",
        "mh.speculate.lose",
        "exec.crash",
        "exec.torn",
        "exec.delay",
        "exec.die",
        "serve.drop",
        "serve.stall",
        "arena.oom",
    )
)
_UNLIMITED = -1


class InjectedResourceExhausted(MemoryError):
    """The ``arena.oom`` directive's device-OOM stand-in: its message
    carries ``RESOURCE_EXHAUSTED``, the shape of a real device
    exhaustion."""

    def __init__(self, site: str = "device"):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected device allocation failure "
            f"at {site} (arena.oom fault directive)"
        )


def _match(spec: Optional[str], value) -> bool:
    """Does ``value`` satisfy a match set (``*`` | n | a-b | a,b,c)?"""
    if spec is None or spec == "*":
        return True
    if value is None:
        return False
    v = int(value)
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part[1:]:  # allow negative singletons like -1
            lo, hi = part.split("-", 1) if not part.startswith("-") else (
                part[: part.index("-", 1)], part[part.index("-", 1) + 1:]
            )
            if int(lo) <= v <= int(hi):
                return True
        elif v == int(part):
            return True
    return False


class Directive:
    """One armed fault: a site, its filters, and a firing budget."""

    def __init__(self, site: str, params: Dict[str, str]):
        if site not in _SITES:
            raise ValueError(f"unknown fault site {site!r}")
        self.site = site
        self.params = params
        n = params.get("n")
        if n is None:
            # Offset-pinned bit-flips model a bad disk byte: persistent.
            persistent = site == "io.read.bitflip" and "offset" in params
            self.remaining = _UNLIMITED if persistent else 1
        else:
            self.remaining = _UNLIMITED if n == "*" else int(n)

    def int_param(self, key: str, default: int) -> int:
        raw = self.params.get(key)
        return default if raw is None else int(raw)

    def __repr__(self) -> str:  # readable failure logs
        return f"Directive({self.site}, {self.params}, n={self.remaining})"


class FaultPlan:
    """A seeded set of :class:`Directive`\\ s, consumed thread-safely."""

    def __init__(
        self, directives: List[Directive], seed: int = 0, spec: str = ""
    ):
        self.directives = directives
        self.seed = seed
        self.spec = spec
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self.fired: Dict[str, int] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        seed = 0
        directives: List[Directive] = []
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                seed = int(raw[5:])
                continue
            site, _, rest = raw.partition(":")
            params: Dict[str, str] = {}
            last_key: Optional[str] = None
            for kv in rest.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" in kv:
                    k, _, v = kv.partition("=")
                    last_key = k.strip()
                    params[last_key] = v.strip()
                elif last_key is not None:
                    # Continuation of a comma-holding match set, e.g.
                    # ``items=1,3,7`` — bare tokens extend the last value.
                    params[last_key] += "," + kv
                else:
                    raise ValueError(
                        f"bad fault directive parameter {kv!r} in {raw!r}"
                    )
            directives.append(Directive(site.strip(), params))
        return cls(directives, seed=seed, spec=spec)

    # -- firing core --------------------------------------------------------

    def _fire(self, site: str, metrics=None, **ctx) -> Optional[Directive]:
        """The first matching directive with budget left, consumed; counts
        ``faults.fired`` / ``faults.fired.<site>`` into :attr:`fired` and,
        when given, the job's ``metrics`` on a hit."""
        with self._lock:
            for d in self.directives:
                if d.site != site or d.remaining == 0:
                    continue
                if not self._matches(d, ctx):
                    continue
                if d.remaining != _UNLIMITED:
                    d.remaining -= 1
                self.fired[site] = self.fired.get(site, 0) + 1
                if metrics is not None:
                    metrics.count("faults.fired", 1)
                    metrics.count(f"faults.fired.{site}", 1)
                return d
        return None

    @staticmethod
    def _matches(d: Directive, ctx: Dict) -> bool:
        p = d.params
        if "path" in p and p["path"] not in str(ctx.get("path", "")):
            return False
        if "op" in p and p["op"] != "*" and ctx.get("op") != p["op"]:
            return False
        for key in ("items", "attempts", "members"):
            if key in p and not _match(p[key], ctx.get(key[:-1])):
                return False
        if "offset" in p:
            off = int(p["offset"])
            start = int(ctx.get("start", 0))
            if not (start <= off < start + int(ctx.get("length", 0))):
                return False
        return True

    # -- seam entry points --------------------------------------------------

    def io_read(self, path: str, start: int, data: bytes, metrics=None) -> bytes:
        """The byte-I/O seam: may raise a transient ``IOError`` or return
        corrupted/truncated bytes."""
        if self._fire("io.read.error", metrics, path=path, start=start,
                      length=len(data)) is not None:
            raise IOError(f"injected transient I/O error reading {path}")
        d = self._fire("io.read.short", metrics, path=path, start=start,
                       length=len(data))
        if d is not None and len(data):
            drop = min(d.int_param("drop", len(data) // 2), len(data))
            data = data[: len(data) - drop]
        d = self._fire("io.read.bitflip", metrics, path=path, start=start,
                       length=len(data))
        if d is not None and len(data):
            if "offset" in d.params:
                pos = int(d.params["offset"]) - start
            else:
                pos = self.rng.randrange(len(data))
            if 0 <= pos < len(data):
                bit = d.int_param("bit", 0) & 7
                flipped = bytearray(data)
                flipped[pos] ^= 1 << bit
                data = bytes(flipped)
        return data

    def flate_tierdown(self, kind: str, member: int, metrics=None) -> bool:
        """Force member ``member`` off the device ``kind`` ('inflate' /
        'deflate') tier, down to host zlib."""
        return self._fire(f"flate.{kind}.tierdown", metrics, member=member) is not None

    def corrupt_payload(self, payload: bytes, metrics=None) -> bytes:
        """Detected host-inflate corruption: flip one byte *before* the
        CRC gate, so the framing check — not luck — catches it."""
        if self._fire("flate.corrupt", metrics) is None or not payload:
            return payload
        pos = self.rng.randrange(len(payload))
        out = bytearray(payload)
        out[pos] ^= 0xFF
        return bytes(out)

    def mh_corrupt(self, member: int, metrics=None) -> bool:
        """The mesh-shuffle data-plane seam: should fetched shuffle
        member ``member`` be corrupted in flight?  The caller flips one
        byte of the member's *compressed* payload, so the BGZF CRC gate
        — not luck — catches it at inflate time (strict raises; salvage
        quarantines exactly that member)."""
        return self._fire("mh.corrupt", metrics, member=member) is not None

    def mh_speculate_lose(self, metrics=None) -> None:
        """The speculation-race seam: stall the speculative copy of a
        straggler's parts stage just before its first-wins promotion so
        the original wins the ``os.link`` race and the speculative
        output is discarded — the loser path exercised deterministically
        instead of by timing luck."""
        d = self._fire("mh.speculate.lose", metrics)
        if d is not None:
            time.sleep(d.int_param("ms", 500) / 1e3)

    def exec_attempt(self, item: int, attempt: int, tmp_path: str, metrics=None) -> None:
        """The executor seam: latency, torn tmp files, crashes, or hard
        process death, per (item, attempt)."""
        d = self._fire("exec.delay", metrics, item=item, attempt=attempt)
        if d is not None:
            time.sleep(d.int_param("ms", 100) / 1e3)
        if self._fire("exec.die", metrics, item=item, attempt=attempt) is not None:
            os._exit(137)  # SIGKILL's exit code: the kill -9 stand-in
        d = self._fire("exec.torn", metrics, item=item, attempt=attempt)
        if d is not None:
            with open(tmp_path, "wb") as f:
                f.write(b"\x00TORN\x00" * 64)
            raise IOError(
                f"injected torn write for item {item} attempt {attempt}"
            )
        if self._fire("exec.crash", metrics, item=item, attempt=attempt) is not None:
            raise RuntimeError(
                f"injected crash for item {item} attempt {attempt}"
            )

    def arena_oom(self, site: str = "device", metrics=None) -> bool:
        """The device-allocation seam: fire = raise-an-OOM-now.  Callers
        raise :class:`InjectedResourceExhausted` so the failure travels
        the exact path a real ``RESOURCE_EXHAUSTED`` would."""
        return self._fire("arena.oom", metrics, where=site) is not None

    def serve_action(self, op: Optional[str], metrics=None) -> Optional[Dict]:
        """The serve-socket seam: ``{"action": "drop"}`` (close without a
        reply) or ``{"action": "stall", "ms": …}``, or None."""
        d = self._fire("serve.drop", metrics, op=op)
        if d is not None:
            return {"action": "drop"}
        d = self._fire("serve.stall", metrics, op=op)
        if d is not None:
            return {"action": "stall", "ms": d.int_param("ms", 200)}
        return None

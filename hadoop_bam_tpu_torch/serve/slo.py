"""SLO monitor: declared objectives, sliding windows, burn-rate alerts.

Counterpart of ``hadoop_bam_tpu/serve/slo.py``.  Objectives are declared
per op (``hadoopbam.serve.slo``: ``view:latency=100@0.999``,
``sort:availability=0.99``) and judged from the registry's own
``serve.op.<op>.ms`` histograms and ``serve.op.<op>.errors`` counters,
over a fast and a slow sliding window: ``burn = bad_fraction / (1 -
target)``, and an alert needs both windows over their thresholds.  The
judgment rides the ``stats`` op, the flight recorder and the Prometheus
text (``slo.*`` gauges, ``serve.slo.alerts``).  Latency thresholds land on
the histograms' log2 bucket bounds.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict, List, Optional, Tuple

from ..utils.tracing import MetricsRegistry

DEFAULT_TARGET = 0.99
DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 600.0
#: Multiwindow burn thresholds (Google SRE workbook's 1h/5m page pair
#: rescaled to our two windows): the fast window must burn hard AND the
#: slow window must confirm it is not a blip.
DEFAULT_FAST_BURN = 10.0
DEFAULT_SLOW_BURN = 2.0

#: Default objectives when ``hadoopbam.serve.slo`` is unset: lenient
#: enough that a healthy daemon is compliant, present enough that the
#: SLO surface is never empty.
DEFAULT_OBJECTIVES = (
    "view:latency=250;view:availability=0.999;"
    "flagstat:availability=0.999;sort:availability=0.99;"
    "variants:latency=250;variants:availability=0.999;"
    "depth:availability=0.999"
)


class SloObjective:
    """One declared objective: ``op`` + kind (latency|availability) +
    target fraction (+ threshold_ms for latency)."""

    __slots__ = ("op", "kind", "target", "threshold_ms")

    def __init__(
        self,
        op: str,
        kind: str,
        target: float = DEFAULT_TARGET,
        threshold_ms: Optional[float] = None,
    ) -> None:
        if kind not in ("latency", "availability"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if not (0.0 < target < 1.0):
            raise ValueError(f"SLO target must be in (0, 1), got {target}")
        if kind == "latency" and not threshold_ms:
            raise ValueError("latency objective needs a threshold")
        self.op = op
        self.kind = kind
        self.target = float(target)
        self.threshold_ms = (
            float(threshold_ms) if threshold_ms is not None else None
        )

    @property
    def name(self) -> str:
        if self.kind == "latency":
            return f"{self.op}:latency<{self.threshold_ms:g}ms"
        return f"{self.op}:availability"

    def as_dict(self) -> dict:
        d = {"op": self.op, "kind": self.kind, "target": self.target}
        if self.threshold_ms is not None:
            d["threshold_ms"] = self.threshold_ms
        return d


def parse_objectives(spec: str) -> List[SloObjective]:
    """Parse the conf grammar; raises ValueError with the offending
    clause named (a garbled SLO declaration must fail loudly at daemon
    start, not silently monitor nothing)."""
    out: List[SloObjective] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        try:
            op, rest = clause.split(":", 1)
            kind, value = rest.split("=", 1)
            kind = kind.strip()
            target = DEFAULT_TARGET
            if "@" in value:
                value, tgt = value.split("@", 1)
                target = float(tgt)
            if kind == "latency":
                out.append(
                    SloObjective(
                        op.strip(), "latency", target,
                        threshold_ms=float(value),
                    )
                )
            elif kind == "availability":
                out.append(
                    SloObjective(op.strip(), "availability", float(value))
                )
            else:
                raise ValueError(f"unknown kind {kind!r}")
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"bad SLO clause {clause!r}: {e}"
            ) from None
    return out


def _good_total(
    obj: SloObjective, registry: MetricsRegistry
) -> Tuple[float, float]:
    """Cumulative ``(good, total)`` for one objective, read from the
    live registry — the monotone series the sliding windows diff."""
    h = registry.histogram(f"serve.op.{obj.op}.ms")
    total = float(h.n) if h is not None else 0.0
    if obj.kind == "latency":
        if h is None:
            return 0.0, 0.0
        good = 0.0
        for i, c in enumerate(h.counts):
            if h.bucket_upper(i) <= obj.threshold_ms:
                good += c
        return good, total
    errors = float(
        registry.get(f"serve.op.{obj.op}.errors")
    )
    return max(0.0, total - errors), total


class SloMonitor:
    """Sliding-window compliance + burn rates over cumulative samples.

    Sampling is lazy: every :meth:`evaluate` (the ``stats`` op, the
    flight-recorder tick) appends one cumulative sample per objective
    and diffs against the sample nearest the window start — no thread,
    no timer, bounded memory (samples older than the slow window are
    dropped).  ``now`` is injectable for the synthetic-window unit
    tests.
    """

    def __init__(
        self,
        objectives: List[SloObjective],
        fast_s: float = DEFAULT_FAST_S,
        slow_s: float = DEFAULT_SLOW_S,
        fast_burn: float = DEFAULT_FAST_BURN,
        slow_burn: float = DEFAULT_SLOW_BURN,
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        self.objectives = list(objectives)
        self.fast_s = float(fast_s)
        self.slow_s = max(float(slow_s), self.fast_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.registry = registry if registry is not None else MetricsRegistry()
        # Per-objective deque of (t, good, total) cumulative samples.
        self._samples: Dict[str, Deque[Tuple[float, float, float]]] = {
            o.name: collections.deque() for o in self.objectives
        }
        self._alerting: Dict[str, bool] = {}

    @classmethod
    def from_conf(cls, conf, registry: Optional[MetricsRegistry] = None) -> "SloMonitor":
        from ..conf import SERVE_SLO, SERVE_SLO_WINDOWS

        spec = conf.get(SERVE_SLO) or DEFAULT_OBJECTIVES
        fast, slow = DEFAULT_FAST_S, DEFAULT_SLOW_S
        win = conf.get(SERVE_SLO_WINDOWS)
        if win:
            try:
                parts = [float(w) for w in win.split(",")]
                fast, slow = parts[0], parts[-1]
            except (ValueError, IndexError):
                raise ValueError(
                    f"bad {SERVE_SLO_WINDOWS} value {win!r} "
                    "(expected 'fast_s,slow_s')"
                ) from None
        return cls(parse_objectives(spec), fast_s=fast, slow_s=slow, registry=registry)

    # -- windows ------------------------------------------------------------

    def _sample(self, now: float) -> None:
        for o in self.objectives:
            good, total = _good_total(o, self.registry)
            dq = self._samples[o.name]
            dq.append((now, good, total))
            # Keep one sample beyond the slow window so the window diff
            # always has an anchor at-or-before its start.
            while len(dq) > 2 and dq[1][0] <= now - self.slow_s:
                dq.popleft()

    def _window(
        self, name: str, window_s: float, now: float
    ) -> Tuple[float, float]:
        """``(good, total)`` deltas over the trailing window."""
        dq = self._samples[name]
        if not dq:
            return 0.0, 0.0
        newest = dq[-1]
        cutoff = now - window_s
        anchor = dq[0]
        for s in dq:
            if s[0] <= cutoff:
                anchor = s
            else:
                break
        return newest[1] - anchor[1], newest[2] - anchor[2]

    @staticmethod
    def _burn(good: float, total: float, target: float) -> float:
        if total <= 0:
            return 0.0
        bad_frac = 1.0 - good / total
        return bad_frac / max(1e-9, 1.0 - target)

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> dict:
        """Sample + judge every objective; the ``stats`` op's ``slo``
        block.  Publishes ``slo.*`` burn gauges and counts alert
        *transitions* (``serve.slo.alerts``) so a sustained breach is
        one alert, not one per scrape."""
        now = time.monotonic() if now is None else now
        self._sample(now)
        objectives = []
        worst = None
        alerting: List[str] = []
        for o in self.objectives:
            fg, ft = self._window(o.name, self.fast_s, now)
            sg, st = self._window(o.name, self.slow_s, now)
            fb = self._burn(fg, ft, o.target)
            sb = self._burn(sg, st, o.target)
            is_alerting = fb >= self.fast_burn and sb >= self.slow_burn
            compliant = fb <= 1.0
            rec = {
                **o.as_dict(),
                "name": o.name,
                "windows": {
                    "fast": {
                        "seconds": self.fast_s, "total": ft,
                        "bad": round(ft - fg, 3), "burn": round(fb, 4),
                        "compliant": compliant,
                    },
                    "slow": {
                        "seconds": self.slow_s, "total": st,
                        "bad": round(st - sg, 3), "burn": round(sb, 4),
                        "compliant": sb <= 1.0,
                    },
                },
                "alerting": is_alerting,
            }
            objectives.append(rec)
            gkey = f"slo.{o.op}.{o.kind}"
            self.registry.set_gauge(f"{gkey}.burn_fast", round(fb, 4))
            self.registry.set_gauge(f"{gkey}.burn_slow", round(sb, 4))
            self.registry.set_gauge(f"{gkey}.alerting", float(is_alerting))
            if is_alerting:
                alerting.append(o.name)
                if not self._alerting.get(o.name):
                    self.registry.count("serve.slo.alerts", 1)
                    self.registry.count(f"serve.slo.alerts.{o.op}", 1)
            self._alerting[o.name] = is_alerting
            if worst is None or fb > worst["burn_fast"]:
                worst = {
                    "name": o.name, "op": o.op,
                    "burn_fast": round(fb, 4), "burn_slow": round(sb, 4),
                }
        return {
            "objectives": objectives,
            "alerting": alerting,
            "compliant": not alerting and all(
                ob["windows"]["fast"]["compliant"] for ob in objectives
            ),
            "worst": worst,
        }

    def brief(self, now: Optional[float] = None) -> dict:
        """The flight recorder's per-tick SLO line: burn rates and the
        alert set only (full windows ride the stats op)."""
        ev = self.evaluate(now)
        return {
            "alerting": ev["alerting"],
            "compliant": ev["compliant"],
            "burns": {
                o["name"]: o["windows"]["fast"]["burn"]
                for o in ev["objectives"]
            },
        }


def fold_slo(blocks: List[dict]) -> dict:
    """Fold per-member ``evaluate()`` blocks into one fleet-wide SLO
    judgment (the router's ``stats`` op).

    An objective's error budget is a property of the *service*, not of
    any one daemon, so the fold sums each window's request and bad
    counts across members (same objective name → same window lengths,
    since every member parses the same conf grammar) and recomputes the
    burn from the summed fractions: ``burn = (Σbad/Σtotal) / (1-target)``
    — a member serving 1% of the traffic cannot dominate the fleet burn,
    and one fully-burning hot member shows up exactly in proportion to
    its share.  ``alerting`` is the union (any member's confirmed
    multiwindow breach is a fleet breach: the affected keys route only
    to it); ``compliant`` requires the folded fast burn ≤ 1 for every
    objective and no member alerting."""
    folded: Dict[str, dict] = {}
    alerting: List[str] = []
    for block in blocks:
        if not block:
            continue
        for name in block.get("alerting") or []:
            if name not in alerting:
                alerting.append(name)
        for o in block.get("objectives", []):
            f = folded.get(o["name"])
            if f is None:
                f = {
                    k: o[k]
                    for k in ("name", "op", "kind", "target", "threshold_ms")
                    if k in o
                }
                f["windows"] = {
                    w: {
                        "seconds": o["windows"][w]["seconds"],
                        "total": 0.0,
                        "bad": 0.0,
                    }
                    for w in ("fast", "slow")
                }
                f["members"] = 0
                folded[o["name"]] = f
            f["members"] += 1
            for w in ("fast", "slow"):
                f["windows"][w]["total"] += o["windows"][w]["total"]
                f["windows"][w]["bad"] += o["windows"][w]["bad"]
    objectives = []
    worst = None
    for f in folded.values():
        for w in ("fast", "slow"):
            win = f["windows"][w]
            good = win["total"] - win["bad"]
            burn = SloMonitor._burn(good, win["total"], f["target"])
            win["burn"] = round(burn, 4)
            win["compliant"] = burn <= 1.0
            win["bad"] = round(win["bad"], 3)
        f["alerting"] = f["name"] in alerting
        objectives.append(f)
        fb = f["windows"]["fast"]["burn"]
        if worst is None or fb > worst["burn_fast"]:
            worst = {
                "name": f["name"], "op": f["op"],
                "burn_fast": fb,
                "burn_slow": f["windows"]["slow"]["burn"],
            }
    return {
        "objectives": objectives,
        "alerting": alerting,
        "compliant": not alerting and all(
            o["windows"]["fast"]["compliant"] for o in objectives
        ),
        "worst": worst,
        "members": len([b for b in blocks if b]),
    }


def format_slo_block(slo: dict) -> str:
    """Human rendering of the ``stats`` op's ``slo`` block (the CLI
    ``stats`` subcommand and post-mortem replays share it)."""
    if not slo:
        return "slo: (no monitor)"
    lines = [
        "slo: " + (
            "COMPLIANT" if slo.get("compliant")
            else "ALERTING: " + ", ".join(slo.get("alerting") or ["?"])
        )
    ]
    for o in slo.get("objectives", []):
        w = o["windows"]
        lines.append(
            f"  {o['name']:<28} target {o['target']:.3%}  "
            f"burn fast {w['fast']['burn']:>7.2f} "
            f"({w['fast']['total']:.0f} reqs, {w['fast']['bad']:.0f} bad)"
            f"  slow {w['slow']['burn']:>7.2f}"
            + ("  ALERT" if o["alerting"] else "")
        )
    if slo.get("worst"):
        lines.append(
            f"  worst: {slo['worst']['name']} "
            f"(burn {slo['worst']['burn_fast']:.2f})"
        )
    return "\n".join(lines)

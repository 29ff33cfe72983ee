#!/usr/bin/env python3
"""Render a serve fleet of the PyTorch port: the ring, member liveness,
warmth, hand-offs.

The port's counterpart of ``tools/fleet_report.py``, with the same modes,
flags and output; it imports the port's ``serve.fleet`` and
``serve.client`` and nothing of the reference.  Two modes:

- **live** (``--socket``/``--port``): query a running fleet router's
  ``fleet`` op and render its view — ring ownership shares, per-member
  heartbeat age and warmth (arena entries/bytes via each member's
  ``stats`` op when ``--warmth`` is given), the dead list with the
  flight-recorder verdict that drove each adopt/no-adopt decision, and
  the hand-off history (who adopted whose jobs, what was lost).
- **offline** (``--fleet-dir``): no router needed — read the member
  records daemons heartbeat into the shared fleet directory, rebuild
  the consistent-hash ring exactly as the router would (same blake2b
  hash, same vnodes), classify every stale member's death from its
  flight-recorder ring, and print the same report.  This is the
  post-mortem path: it works when the router itself is gone.

Usage:
    python tools/torch_fleet_report.py --socket /tmp/hbam-fleet-0.sock [--warmth]
    python tools/torch_fleet_report.py --fleet-dir /var/run/hbam-fleet [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hadoop_bam_tpu_torch.serve import fleet as fleet_mod  # noqa: E402
from hadoop_bam_tpu_torch.serve.client import ServeClient, ServeError  # noqa: E402


def offline_view(fleet_dir: str, vnodes: int, timeout_ms: float) -> dict:
    """Rebuild the router's fleet view from the shared directory alone:
    fresh members form the ring; stale ones get the same forensics the
    router runs (classify_death on their flight-recorder ring)."""
    recs = fleet_mod.read_members(fleet_dir)
    now = time.time()
    members, dead = {}, {}
    live_names = []
    for name, rec in sorted(recs.items()):
        age_ms = fleet_mod.heartbeat_age_s(rec, now) * 1e3
        entry = {
            "endpoint": rec.get("endpoint"),
            "pid": rec.get("pid"),
            "journal": rec.get("journal"),
            "flightrec": rec.get("flightrec"),
            "heartbeat_age_ms": round(age_ms, 1),
            "draining": bool(rec.get("draining")),
        }
        if age_ms <= timeout_ms and not rec.get("draining"):
            members[name] = entry
            live_names.append(name)
        else:
            forensics = fleet_mod.classify_death(rec.get("flightrec"))
            dead[name] = {
                **entry,
                "forensics": forensics,
                "would_adopt": fleet_mod.should_adopt(forensics["verdict"]),
            }
    ring = fleet_mod.HashRing(tuple(live_names), vnodes=vnodes)
    return {
        "ok": True,
        "fleet_dir": fleet_dir,
        "members": members,
        "ring": {
            "vnodes": vnodes,
            "shares": {m: round(s, 4) for m, s in ring.shares().items()},
        },
        "dead": dead,
        "handoffs": [],
        "heartbeat_timeout_ms": timeout_ms,
        "offline": True,
    }


def member_warmth(view: dict) -> dict:
    """Per-member arena/cache occupancy via each member's stats op —
    the "where does the warmth live" column (live members only)."""
    out = {}
    for name, m in (view.get("members") or {}).items():
        ep = m.get("endpoint") or {}
        try:
            c = ServeClient(
                socket_path=ep.get("socket"),
                host=ep.get("host", "127.0.0.1"),
                port=ep.get("port"),
                timeout=10.0,
                retries=0,
            )
            st = c.stats()
            out[name] = {
                "arena_entries": (st.get("arena") or {}).get("entries", 0),
                "arena_bytes": (st.get("arena") or {}).get("used_bytes", 0),
                "cache_entries": (st.get("cache") or {}).get("entries", 0),
                "jobs": len(st.get("jobs") or {}),
            }
        except (ServeError, OSError) as e:
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


def render(view: dict, warmth: dict) -> str:
    lines = []
    src = view.get("fleet_dir") or "?"
    mode = "offline scan" if view.get("offline") else "router view"
    lines.append(f"fleet: {src} ({mode})")
    shares = (view.get("ring") or {}).get("shares") or {}
    members = view.get("members") or {}
    lines.append(
        f"  members: {len(members)} live, {len(view.get('dead') or {})} "
        f"dead, vnodes {(view.get('ring') or {}).get('vnodes')}"
    )
    if members:
        lines.append("")
        lines.append(
            f"  {'member':<20} {'ring share':>10} {'heartbeat':>10} "
            f"{'state':>9}  endpoint"
        )
        for name in sorted(members):
            m = members[name]
            ep = m.get("endpoint") or {}
            ep_s = ep.get("socket") or f"{ep.get('host')}:{ep.get('port')}"
            state = "draining" if m.get("draining") else "live"
            lines.append(
                f"  {name:<20} {shares.get(name, 0.0):>9.1%} "
                f"{m.get('heartbeat_age_ms', 0):>8.0f}ms {state:>9}  {ep_s}"
            )
            w = warmth.get(name)
            if w and "error" not in w:
                lines.append(
                    f"  {'':<20}   warmth: {w['arena_entries']} windows "
                    f"({w['arena_bytes']} B), {w['cache_entries']} "
                    f"cached resources, {w['jobs']} jobs"
                )
            elif w:
                lines.append(f"  {'':<20}   warmth: {w['error']}")
    dead = view.get("dead") or {}
    if dead:
        lines.append("")
        lines.append("  dead members:")
        for name in sorted(dead):
            d = dead[name]
            forensics = d.get("forensics") or {}
            verdict = forensics.get("verdict", "?")
            adopter = d.get("adopter")
            decision = (
                f"adopted by {adopter}" if adopter
                else ("would adopt" if d.get("would_adopt")
                      else "no adopt (clean drain)")
            )
            lines.append(
                f"    {name:<18} verdict={verdict:<8} {decision}"
                f"  ({forensics.get('reason', '')})"
            )
            if d.get("adopted"):
                for old, new in sorted(d["adopted"].items()):
                    lines.append(f"      job {old} -> {new}")
    handoffs = view.get("handoffs") or []
    if handoffs:
        lines.append("")
        lines.append("  hand-off history:")
        for h in handoffs:
            t = time.strftime(
                "%H:%M:%S", time.localtime(h.get("t_wall", 0))
            )
            if h.get("kind") == "death":
                what = (
                    f"death ({h.get('verdict')}), adopter "
                    f"{h.get('adopter')}, "
                    f"{len(h.get('adopted') or {})} adopted, "
                    f"{len(h.get('lost') or [])} lost"
                )
            else:
                what = f"leave ({h.get('reason')})"
            lines.append(f"    {t} {h.get('member'):<18} {what}")
    adm = view.get("admission") or {}
    if adm:
        lines.append("")
        lines.append(
            "  federated admission: "
            + ", ".join(f"{k.split('.')[-1]}={v:g}" for k, v in
                        sorted(adm.items()))
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--socket", help="fleet router UDS socket (live mode)")
    src.add_argument(
        "--port", type=int, help="fleet router 127.0.0.1 TCP port"
    )
    src.add_argument(
        "--fleet-dir",
        help="shared fleet directory (offline mode — no router needed)",
    )
    ap.add_argument(
        "--vnodes", type=int, default=fleet_mod.DEFAULT_VNODES,
        help="ring vnodes for the offline rebuild (must match the "
             "router's to reproduce its ownership)")
    ap.add_argument(
        "--heartbeat-timeout-ms", type=float,
        default=float(fleet_mod.DEFAULT_HEARTBEAT_TIMEOUT_MS),
        help="staleness bound for the offline liveness judgment")
    ap.add_argument(
        "--warmth", action="store_true",
        help="also query each live member's stats op for arena/cache "
             "occupancy (the per-daemon warmth column)")
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    if args.fleet_dir:
        view = offline_view(
            args.fleet_dir, args.vnodes, args.heartbeat_timeout_ms
        )
    else:
        client = ServeClient(socket_path=args.socket, port=args.port)
        view = client.fleet()
    warmth = member_warmth(view) if args.warmth else {}
    if args.json:
        out = dict(view)
        if warmth:
            out["warmth"] = warmth
        print(json.dumps(out, indent=2, sort_keys=True, default=str))
        return 0
    print(render(view, warmth))
    return 0


if __name__ == "__main__":
    sys.exit(main())

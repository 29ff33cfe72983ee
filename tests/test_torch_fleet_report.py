"""``tools/torch_fleet_report.py``, the port's fleet report, against the
reference's ``tools/fleet_report.py``: the offline mode of both tools over
one fleet directory (fresh, draining and stale members, flight-recorder
rings that end clean, unclean, torn or not at all) gives the same
``--json`` and the same text, exactly, with the clock held still; the live
mode renders a port router's view, with each member's warmth."""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import pytest

from hadoop_bam_tpu_torch.serve import fleet as fleet_mod
from test_torch_fleet import _daemons, _router, _snap, _write_ring

REPO = Path(__file__).resolve().parents[1]
NOW = 1_700_000_000.0


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT_TOOL = _tool("torch_fleet_report")
REF_TOOL = _tool("fleet_report")


def _run(tool, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tool.main(argv) == 0
    return out.getvalue()


@pytest.fixture
def fleet_dir(tmp_path):
    d = str(tmp_path / "fleet")
    rings = {
        "unclean": [_snap(0), _snap(1)],
        "clean": [_snap(0), _snap(1, final=True)],
        "torn": [_snap(0), '{"seq": 1, "fin'],
        "empty": [],
    }
    for name, lines in rings.items():
        _write_ring(str(tmp_path / f"{name}-flight"), lines)
    members = [
        {"name": "live-a", "t_wall": NOW - 0.5, "pid": 11},
        {"name": "live-b", "t_wall": NOW - 1.2, "pid": 12,
         "endpoint": {"host": "127.0.0.1", "port": 4711}},
        {"name": "drain-c", "t_wall": NOW - 0.1, "draining": True},
        {"name": "dead-unclean", "t_wall": NOW - 3600, "pid": 999_999},
        {"name": "dead-clean", "t_wall": NOW - 60},
        {"name": "dead-torn", "t_wall": NOW - 60},
        {"name": "dead-empty", "t_wall": NOW - 60},
        {"name": "dead-no-ring", "t_wall": NOW - 60},
        {"name": "dead-missing-ring", "t_wall": NOW - 60,
         "flightrec": str(tmp_path / "nowhere")},
    ]
    for rec in members:
        kind = rec["name"].split("-", 1)[-1]
        if rec["name"].startswith("dead-") and kind in rings:
            rec["flightrec"] = str(tmp_path / f"{kind}-flight")
        rec.setdefault("endpoint", {"socket": f"/tmp/{rec['name']}.sock"})
        rec.setdefault("journal", str(tmp_path / f"{rec['name']}.jsonl"))
        fleet_mod.write_member(d, {"seq": 1, **rec})
    return d


@pytest.mark.parametrize("argv", [[], ["--json"], ["--json", "--vnodes", "16"],
                                  ["--json", "--heartbeat-timeout-ms", "100000"]],
                         ids=["text", "json", "vnodes", "timeout"])
def test_offline_report_equals_the_reference(fleet_dir, monkeypatch, argv):
    monkeypatch.setattr(time, "time", lambda: NOW)
    got = _run(PORT_TOOL, ["--fleet-dir", fleet_dir, *argv])
    want = _run(REF_TOOL, ["--fleet-dir", fleet_dir, *argv])
    assert got == want
    if "--json" in argv and len(argv) == 1:
        view = json.loads(got)
        assert sorted(view["members"]) == ["live-a", "live-b"]
        verdicts = {n: d["forensics"]["verdict"] for n, d in view["dead"].items()}
        assert verdicts == {"drain-c": "unknown", "dead-unclean": "unclean", "dead-clean": "clean",
                            "dead-torn": "unclean", "dead-empty": "unclean",
                            "dead-no-ring": "unknown", "dead-missing-ring": "unknown"}
        assert not view["dead"]["dead-clean"]["would_adopt"]
        assert sum(view["ring"]["shares"].values()) == pytest.approx(1.0, abs=1e-3)


def test_offline_report_of_an_empty_directory_equals_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    for argv in ([], ["--json"]):
        d = str(tmp_path / "none")
        assert _run(PORT_TOOL, ["--fleet-dir", d, *argv]) == _run(REF_TOOL, ["--fleet-dir", d,
                                                                          *argv])


def test_live_report_renders_the_router_view_with_warmth(tmp_path):
    sock_dir = tempfile.mkdtemp(prefix="hfr")
    fdir = str(tmp_path / "fleet")
    try:
        with _daemons(sock_dir, tmp_path, ["w-a", "w-b"], fdir), \
                _router(sock_dir, fdir, heartbeat_timeout_ms=60_000) as (router, client):
            router.scan_members()
            view = json.loads(_run(PORT_TOOL, ["--socket", router.socket_path, "--json",
                                               "--warmth"]))
            assert sorted(view["members"]) == ["w-a", "w-b"] == sorted(client.fleet()["members"])
            assert set(view["warmth"]) == {"w-a", "w-b"}
            assert all(w["arena_entries"] == 0 and w["jobs"] == 0 for w in view["warmth"].values())
            text = _run(PORT_TOOL, ["--socket", router.socket_path])
            assert "router view" in text and "2 live" in text
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert not os.path.exists(sock_dir)

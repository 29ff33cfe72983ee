"""The port's public surface against the reference's, read with ``ast``
(nothing of JAX is imported): every top-level public name of every module
of ``hadoop_bam_tpu/`` (a ``def``, a ``class``, a module-level assignment,
and in an ``__init__.py`` the names it imports) is defined or exported by
the port's counterpart module, or stands in :data:`EXEMPT` with its reason.
``ops/pallas/`` maps to ``ops/kernels/`` (four files under the port's
names) and ``native/`` is skipped: the port replaces it by its NumPy tiers
(ROADMAP C, "The text tokenizers have the NumPy tier only")."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "hadoop_bam_tpu"
PORT = REPO / "hadoop_bam_tpu_torch"

#: Reference kernel files whose port counterpart has another name.
RENAMED = {"deflate_lanes": "deflate", "inflate_lanes": "inflate",
           "gather_stream": "gather", "rans_lanes": "rans"}

_PROBES = "TPU plumbing: the reference's probes of the TPU and its round trip"
_TIERS = ("TPU plumbing: a codec tier's auto gate, which probes the TPU's round trip; "
          "the port's gates are conf.gate in DeviceStream, on by default on a card")
_CHUNK = ("TPU plumbing: the Pallas walk's chunk geometry; the port walks segments of "
          "SEG bytes in slabs of SLAB")
_GLOBAL_STATS = ("ROADMAP C, 'Codec stats are passed, not global': the caller passes "
                 "stats= and metrics=")

#: ``(reference module, name) -> reason``: names the port has no counterpart
#: for, each for a reason ROADMAP C records or because it is TPU plumbing.
EXEMPT = {
    ("conf.py", "BACKEND"): _PROBES + " (the backend the probe picked)",
    ("conf.py", "DEVICE_AUTO_RTT_MS"): _PROBES + " (the auto rule's round-trip bound key)",
    ("device_stream.py", "donating_concat"): (
        "ROADMAP C, 'The HBM ledger owns its registry': buffer donation is bookkeeping "
        "in torch (A.14)"),
    ("ops/flate.py", "LAST_INFLATE_STATS"): _GLOBAL_STATS,
    ("ops/flate.py", "LAST_DEFLATE_STATS"): _GLOBAL_STATS,
    ("ops/flate.py", "lanes_tier_enabled"): _TIERS,
    ("ops/flate.py", "deflate_lanes_tier_enabled"): _TIERS,
    ("ops/flate.py", "bcf_chain_tier_enabled"): _TIERS,
    ("ops/flate.py", "rans_lanes_tier_enabled"): _TIERS,
    ("ops/flate.py", "device_write_enabled"): _TIERS,
    ("ops/flate.py", "device_auto_rtt_ms"): _PROBES,
    ("ops/flate.py", "inflate_lanes_accepts"): (
        "ROADMAP C, 'A split window keeps no 128-member cap (A.15)': row 1 on the "
        "card has no lane or VMEM gate"),
    ("ops/pallas/inflate_lanes.py", "accepts"): (
        "ROADMAP C, 'A split window keeps no 128-member cap (A.15)': row 1 on the "
        "card has no lane or VMEM gate"),
    ("ops/pallas/inflate_lanes.py", "stream_geometry"): (
        "TPU plumbing: the lanes decoder's VMEM geometry"),
    ("ops/pallas/inflate_lanes.py", "LANES"): "TPU plumbing: the 128-lane launch width",
    ("ops/pallas/inflate_fixed.py", "LANES"): "TPU plumbing: the 128-lane launch width",
    ("ops/pallas/chain.py", "CHUNK"): _CHUNK,
    ("ops/pallas/chain.py", "MAX_REC_PER_CHUNK"): _CHUNK,
    ("ops/pallas/bcf_chain.py", "CHUNK"): _CHUNK,
    ("ops/pallas/bcf_chain.py", "MAX_REC_PER_CHUNK"): _CHUNK,
    ("serve/warmup.py", "TPU_CODEC_BUCKETS"): (
        "TPU plumbing: XLA's compile buckets of the codec programs"),
    ("spec/cram_codecs.py", "LAST_RANS_STATS"): (
        "ROADMAP C, 'Catch-alls not ported (PRs 2–5)': the rANS stats are passed"),
    ("utils/tracing.py", "METRICS"): (
        "ROADMAP C, '--metrics reports the job, not a global delta': every registry is "
        "a job's, a daemon's or a router's"),
    ("utils/tracing.py", "count_h2d"): (
        "ROADMAP C, '--metrics reports the job, not a global delta': transfers count "
        "into the job's Metrics.count_h2d"),
    ("utils/tracing.py", "count_d2h"): (
        "ROADMAP C, '--metrics reports the job, not a global delta': transfers count "
        "into the job's Metrics.count_d2h"),
}
for _name in ("backend_initialized", "device_roundtrip_ms", "donation_supported", "force_cpu",
              "local_tpu_ready", "probe_platform", "probe_platform_ex"):
    EXEMPT[("utils/backend.py", _name)] = _PROBES


def public_names(path: Path, with_imports: bool) -> set:
    """Top-level public names of a module: defs, classes, assigned names
    (also under a top-level ``if`` or ``try``) and, ``with_imports``, the
    names its imports bind."""
    out = set()

    def walk(body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                out.add(n.name)
            elif isinstance(n, ast.Assign):
                for t in n.targets:
                    out.update(x.id for x in ast.walk(t) if isinstance(x, ast.Name))
            elif isinstance(n, (ast.AnnAssign, ast.AugAssign)) and isinstance(n.target, ast.Name):
                out.add(n.target.id)
            elif isinstance(n, (ast.Import, ast.ImportFrom)) and with_imports:
                out.update((a.asname or a.name).split(".")[0] for a in n.names)
            elif isinstance(n, (ast.If, ast.Try)):
                walk(n.body)
                walk(n.orelse)
                for h in getattr(n, "handlers", []):
                    walk(h.body)
                walk(getattr(n, "finalbody", []))

    walk(ast.parse(path.read_text()).body)
    return {n for n in out if not n.startswith("_")}


def counterpart(rel: Path) -> Path:
    parts = list(rel.parts)
    if parts[:2] == ["ops", "pallas"]:
        stem = parts[-1][: -len(".py")]
        parts = ["ops", "kernels", *parts[2:-1], RENAMED.get(stem, stem) + ".py"]
    return PORT.joinpath(*parts)


def reference_modules():
    return sorted(p.relative_to(REF) for p in REF.rglob("*.py") if p.relative_to(REF).parts[0]
                  != "native")


def test_every_reference_module_has_a_counterpart():
    missing = [str(rel) for rel in reference_modules() if not counterpart(rel).exists()]
    assert not missing, missing


@pytest.mark.parametrize("rel", reference_modules(), ids=str)
def test_every_public_name_has_a_counterpart_or_a_reasoned_exemption(rel):
    want = public_names(REF / rel, with_imports=rel.name == "__init__.py")
    have = public_names(counterpart(rel), with_imports=True)
    gaps = sorted(n for n in want - have if (rel.as_posix(), n) not in EXEMPT)
    assert not gaps, f"{rel}: no port counterpart for {gaps}"


def test_no_exemption_names_a_name_the_reference_lacks_or_the_port_has():
    for (mod, name), reason in EXEMPT.items():
        rel = Path(mod)
        assert (REF / rel).exists(), mod
        assert name in public_names(REF / rel, rel.name == "__init__.py"), (mod, name)
        assert name not in public_names(counterpart(rel), True), (mod, name, "ported: drop it")
        assert reason.startswith(("ROADMAP C", "TPU plumbing")), (mod, name)


def test_each_cited_roadmap_entry_exists():
    roadmap = (REPO / "ROADMAP.md").read_text()
    for reason in set(EXEMPT.values()):
        if reason.startswith("ROADMAP C, '"):
            title = reason.split("'")[1]
            assert title in roadmap.replace("`", ""), title

"""The operator CLI: ``python -m hadoop_bam_tpu_torch <subcommand>``.

Counterpart of ``hadoop_bam_tpu/cli.py``: the same 18 subcommands with the
reference's arguments, defaults, printed lines and exit codes, each calling
the port's counterpart.  The indexers and guessers
(``SplittingBAMIndexer.main``, ``SplittingBAMIndex.main``,
``BGZFBlockIndexer.main``, ``BAMSplitGuesser.main``,
``BCFSplitGuesser.main``, ``GetSortedBAMHeader.main`` and ``bai-index``) run
on the host; the jobs (``sort``, ``markdup``, ``fixmate``, ``ingest``), the
one-shot endpoints (``view``, ``flagstat``, ``variants``, ``depth``) and
the daemon (``serve``) run on the card.  ``fleet`` runs the router and
``stats`` asks a running daemon.

Where the port differs:

- ``--device {cuda,cpu}`` on every subcommand that touches a device: the
  default is the card, and a machine without one raises; ``cpu`` runs
  every kernel's plain version.
- ``sort`` and ``markdup --devices n`` (n > 0) sort on
  ``make_mesh(n, device=--device)``: the visible cards, or n shards of
  the host with ``--device cpu``.
- ``--metrics`` reports the job's own counters (``SortStats.counters``)
  plus the HBM ledger's delta over the run, not the delta of a global
  registry; its ``seconds`` are the job's phase seconds, and
  ``codec_tiers`` is the job's member counts per tier from the counters
  the job's stats published (``flate.inflate.*``, ``flate.deflate.*``),
  not the last call's.
- The run manifest names the device the job ran on: a CPU run is
  reported as the CPU, never as the card.

Every run ends with the HBM ledger's leak check (:func:`_check_drained`)
before the trace and metrics exports.  Status lines of the trace export
go to stderr: ``view -o -`` carries a BAM on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import List, Optional


def _cmd_splitting_index(args) -> int:
    from .spec import indices

    for path in args.bam:
        idx = indices.build_splitting_bai(path, granularity=args.granularity)
        out = path + indices.SPLITTING_BAI_EXT
        with open(out, "wb") as f:
            idx.save(f)
        print(f"{out}: {idx.size()} offsets (granularity {args.granularity})")
    return 0


def _cmd_splitting_index_dump(args) -> int:
    from .spec import indices

    idx = indices.SplittingBai.load(args.index)
    print(f"{args.index}: {idx.size()} offsets, bam size {idx.bam_size()}")
    for v in idx.voffsets:
        print(f"{v >> 16}:{v & 0xFFFF}")
    return 0


def _cmd_bgzf_index(args) -> int:
    from .spec.indices import BGZFI_EXT, BgzfBlockIndex

    for path in args.file:
        with open(path, "rb") as f:
            data = f.read()
        idx = BgzfBlockIndex.build(data, granularity=args.granularity)
        out = path + BGZFI_EXT
        with open(out, "wb") as f:
            idx.save(f)
        print(f"{out}: {idx.size()} offsets (granularity {args.granularity})")
    return 0


def _cmd_bai_index(args) -> int:
    from .spec import indices

    for path in args.bam:
        bai = indices.build_bai(path)
        out = path + ".bai"
        with open(out, "wb") as f:
            bai.save(f)
        print(f"{out}: {len(bai.refs)} references")
    return 0


def _cmd_bam_guess(args) -> int:
    from .io.bam import read_header
    from .io.guesser import BamSplitGuesser

    with open(args.bam, "rb") as f:
        data = f.read()
    hdr = read_header(args.bam)
    end = args.end if args.end is not None else len(data)
    v = BamSplitGuesser(data, hdr.n_refs).guess_next_record_start(args.pos, end)
    if v == end:
        print(f"no BAM record found in [{args.pos},{end})")
        return 1
    print(f"{v >> 16}:{v & 0xFFFF}")
    return 0


def _cmd_bcf_guess(args) -> int:
    from .io.bcf import BcfSplitGuesser, read_bcf_header

    with open(args.bcf, "rb") as f:
        data = f.read()
    hdr, _ = read_bcf_header(data)
    end = args.end if args.end is not None else len(data)
    g = BcfSplitGuesser(data, hdr)
    v = g.guess_next_record_start(args.pos, end)
    if v is None:
        print(f"no BCF record found in [{args.pos},{end})")
        return 1
    if g.compressed:
        print(f"{v >> 16}:{v & 0xFFFF}")
    else:
        # An uncompressed file's guess is ``offset << 16``: print the offset.
        print(v >> 16)
    return 0


def _cmd_sorted_header(args) -> int:
    from .io.bam import read_header
    from .io.merger import prepare_bam_header_block

    block = prepare_bam_header_block(read_header(args.bam).with_sort_order("coordinate"))
    if args.out == "-":
        sys.stdout.buffer.write(block)
    else:
        with open(args.out, "wb") as f:
            f.write(block)
        print(f"{args.out}: {len(block)} bytes (BGZF header block)")
    return 0


def _parse_size(text: str) -> int:
    """'512m'/'2g'-style byte counts (plain ints pass through)."""
    s = text.strip().lower()
    mult = 1
    for suffix, m in (("k", 1 << 10), ("m", 1 << 20), ("g", 1 << 30)):
        if s.endswith(suffix):
            s, mult = s[: -len(suffix)], m
            break
    try:
        return int(s) * mult
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid size {text!r} (expected bytes or k/m/g suffix)")


def _apply_robustness_args(conf, args) -> None:
    """``--errors`` / ``--faults`` into the conf (``--faults`` also arms
    the process's fault plan)."""
    from . import faults
    from .conf import ERRORS_MODE, FAULTS_PLAN

    if getattr(args, "errors", None):
        conf.set(ERRORS_MODE, args.errors)
    if getattr(args, "faults", None):
        conf.set(FAULTS_PLAN, args.faults)
        faults.arm(args.faults)


def _arm_trace(args, conf=None) -> bool:
    """Arm the timeline tracer for a ``--trace`` run (ring capacity
    ``hadoopbam.trace.events``; the oldest events drop on overflow)."""
    if not getattr(args, "trace", None):
        return False
    from .conf import TRACE_EVENTS
    from .utils.tracing import DEFAULT_TRACE_EVENTS, TRACER

    cap = conf.get_int(TRACE_EVENTS, DEFAULT_TRACE_EVENTS) if conf is not None \
        else DEFAULT_TRACE_EVENTS
    TRACER.start(capacity=cap)
    return True


@contextlib.contextmanager
def _disarm_on_error(traced: bool):
    """A job that raises leaves no armed ring behind it (the process may
    go on: a test, a script); its trace is not exported."""
    try:
        yield
    except BaseException:
        if traced:
            from .utils.tracing import TRACER

            TRACER.stop()
        raise


def _check_drained() -> None:
    """The end-of-run HBM leak check: a device allocation still held
    outside the serve arena is closed as a leak (``hbm.leaked_bytes``, its
    holder named, the run manifest degraded, an ``hbm.leak`` instant on the
    trace).  Runs before the exports, so the verdict lands in both."""
    from .utils.hbm import LEDGER

    rep = LEDGER.assert_drained()
    if rep["leaked_bytes"]:
        holders = ", ".join(f"{h}={n}B" for h, n in sorted(rep["holders"].items()))
        print(f"warning: {rep['leaked_bytes']} HBM bytes leaked ({holders}); run flagged degraded",
              file=sys.stderr)


def _export_trace(args) -> None:
    """Write the Chrome trace-event JSON and disarm (status on stderr)."""
    from .utils.tracing import TRACER

    n = TRACER.export_chrome(args.trace)
    dropped = TRACER.dropped_events
    TRACER.stop()
    msg = f"{args.trace}: {n} trace events"
    if dropped:
        msg += f" ({dropped} oldest dropped; raise hadoopbam.trace.events)"
    print(msg, file=sys.stderr)


def _ledger_snapshot() -> dict:
    from .utils.hbm import LEDGER
    from .utils.tracing import snapshot

    return snapshot(LEDGER.metrics)


def _with_ledger(counters: dict, before: dict) -> dict:
    """A job's counters plus the HBM ledger's counter delta since
    ``before``: the ledger counts into its own registry."""
    from .utils.hbm import LEDGER
    from .utils.tracing import delta

    out = dict(counters)
    for k, v in delta(before, registry=LEDGER.metrics)["counters"].items():
        out[k] = out.get(k, 0) + v
    return out


def _job_report(counters: dict, seconds: dict) -> dict:
    """The ``--metrics`` report's common part: counters, phase seconds,
    the ledger's gauges and the transfers block."""
    from .utils.hbm import LEDGER
    from .utils.tracing import transfers_report

    return {"counters": counters, "seconds": dict(seconds), "gauges": LEDGER.gauges(),
            "transfers": transfers_report(counters)}


def _cmd_sort(args, mark_duplicates: bool = False) -> int:
    from .conf import (
        BAM_MARK_DUPLICATES,
        BAM_SORT_ORDER,
        BAM_WRITE_SPLITTING_BAI,
        DEFLATE_LANES,
        INFLATE_LANES,
        WRITE_DEVICE,
        Configuration,
    )
    from .pipeline import sort_bam
    from .utils.tracing import device_trace, run_manifest

    conf = Configuration()
    _apply_robustness_args(conf, args)
    sort_order = "queryname" if getattr(args, "queryname", False) else "coordinate"
    conf.set(BAM_SORT_ORDER, sort_order)
    if args.write_splitting_bai:
        conf.set_boolean(BAM_WRITE_SPLITTING_BAI, True)
    # Unset flags leave the keys absent: the HBAM_* env vars and the
    # device's auto rule decide, as for a library call.
    if args.inflate_lanes is not None:
        conf.set_boolean(INFLATE_LANES, args.inflate_lanes == "on")
    if args.deflate_lanes is not None:
        conf.set_boolean(DEFLATE_LANES, args.deflate_lanes == "on")
    if getattr(args, "device_write", None) is not None:
        conf.set_boolean(WRITE_DEVICE, args.device_write == "on")
    mark_duplicates = mark_duplicates or getattr(args, "mark_duplicates", False)
    if mark_duplicates:
        conf.set_boolean(BAM_MARK_DUPLICATES, True)
    mesh = None
    if args.devices:
        from .parallel.mesh import make_mesh

        mesh = make_mesh(args.devices, device=args.device)
    ctx = device_trace(args.trace_dir) if args.trace_dir else contextlib.nullcontext()
    traced = _arm_trace(args, conf)
    before = _ledger_snapshot()
    with ctx, _disarm_on_error(traced):
        stats = sort_bam(
            list(args.bam),
            args.output,
            conf=conf,
            split_size=args.split_size,
            mesh=mesh,
            level=args.level,
            write_splitting_bai=args.write_splitting_bai,
            memory_budget=args.memory_budget,
            part_dir=args.part_dir,
            sort_order=sort_order,
            device=args.device,
        )
    _check_drained()
    if traced:
        _export_trace(args)
    dup = f", {stats.n_duplicates} duplicates flagged" if mark_duplicates else ""
    print(f"{args.output}: {stats.n_records} records from {stats.n_splits} "
          f"splits via {stats.backend}{dup}")
    if args.metrics:
        from .ops.flate import CodecTierStats

        counters = _with_ledger(stats.counters, before)
        report = _job_report(counters, stats.seconds)
        # The job's members per codec tier, every field explicit.
        report["codec_tiers"] = {
            side: {k: counters.get(f"flate.{side}.{k}", 0) for k in CodecTierStats.__slots__}
            for side in ("inflate", "deflate")
        }
        report["run_manifest"] = run_manifest(
            backend=stats.backend, conf=conf, counters=counters, device=stats.device).as_dict()
        with_cluster_manifest(report)
        print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def with_cluster_manifest(report: dict) -> dict:
    """Add ``cluster_manifest`` to a ``--metrics`` report when a
    mesh-traced multi-process sort folded one in this process (process 0
    of it): the cluster's verdict and byte matrix beside the run
    manifest."""
    mh = sys.modules.get("hadoop_bam_tpu_torch.parallel.multihost")
    if mh is not None and mh.LAST_CLUSTER_MANIFEST:
        report["cluster_manifest"] = mh.LAST_CLUSTER_MANIFEST
    return report


def _cmd_markdup(args) -> int:
    return _cmd_sort(args, mark_duplicates=True)


def _cmd_fixmate(args) -> int:
    """Mate coordinates, flags, TLEN and MC tags from the collated pairs,
    keeping the record order (samtools fixmate on any input order)."""
    from .conf import Configuration
    from .pipeline import fixmate_bam
    from .utils.backend import resolve_device
    from .utils.tracing import run_manifest

    conf = Configuration()
    _apply_robustness_args(conf, args)
    dev = resolve_device(args.device)
    traced = _arm_trace(args, conf)
    before = _ledger_snapshot()
    with _disarm_on_error(traced):
        stats = fixmate_bam(
            list(args.bam),
            args.output,
            conf=conf,
            split_size=args.split_size,
            level=args.level,
            memory_budget=args.memory_budget,
            part_dir=args.part_dir,
            device=dev,
        )
    _check_drained()
    if traced:
        _export_trace(args)
    print(f"{args.output}: {stats.n_records} records from {stats.n_splits} "
          f"splits via {stats.backend}: {stats.n_pairs} pairs fixed, "
          f"{stats.n_singletons} singletons, {stats.n_orphans} orphans")
    if args.metrics:
        counters = _with_ledger(stats.counters, before)
        report = _job_report(counters, stats.seconds)
        report["run_manifest"] = run_manifest(
            backend=stats.backend, conf=conf, counters=counters, device=dev).as_dict()
        print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _cmd_ingest(args) -> int:
    from .conf import (
        DEFLATE_LANES,
        FASTQ_BASE_QUALITY_ENCODING,
        FASTQ_FILTER_FAILED_QC,
        INFLATE_LANES,
        INGEST_DEVICE_SCAN,
        Configuration,
    )
    from .ingest import ingest_fastq
    from .utils.backend import resolve_device
    from .utils.tracing import run_manifest

    conf = Configuration()
    _apply_robustness_args(conf, args)
    if args.inflate_lanes is not None:
        conf.set_boolean(INFLATE_LANES, args.inflate_lanes == "on")
    if args.deflate_lanes is not None:
        conf.set_boolean(DEFLATE_LANES, args.deflate_lanes == "on")
    if args.device_scan is not None:
        conf.set(INGEST_DEVICE_SCAN, "true" if args.device_scan == "on" else "false")
    if args.quality_encoding:
        conf.set(FASTQ_BASE_QUALITY_ENCODING, args.quality_encoding)
    if args.filter_failed_qc:
        conf.set_boolean(FASTQ_FILTER_FAILED_QC, True)
    dev = resolve_device(args.device)
    traced = _arm_trace(args, conf)
    before = _ledger_snapshot()
    with _disarm_on_error(traced):
        stats = ingest_fastq(
            args.fastq,
            args.output,
            r2=args.r2,
            conf=conf,
            level=args.level,
            memory_budget=args.memory_budget,
            part_dir=args.part_dir,
            device=dev,
        )
    _check_drained()
    if traced:
        _export_trace(args)
    paired = f", {stats.n_pairs} pairs" if stats.n_pairs else ""
    lost = (f", {stats.n_quarantined_members} members quarantined"
            if stats.n_quarantined_members else "")
    print(f"{args.output}: {stats.n_records} records from "
          f"{stats.n_members or 1} members{paired}{lost}")
    if args.metrics:
        counters = _with_ledger(stats.counters, before)
        report = _job_report(counters, stats.seconds)
        report["run_manifest"] = run_manifest(
            backend="ingest", conf=conf, counters=counters, device=dev).as_dict()
        print(json.dumps(report, indent=2, sort_keys=True))
    return 0


@contextlib.contextmanager
def _one_shot(args):
    """A one-shot serve context on ``--device`` (no batcher), closed (its
    arena released) and leak-checked at the end, the trace exported."""
    from .conf import Configuration
    from .serve.endpoints import ServeContext

    conf = Configuration()
    _apply_robustness_args(conf, args)
    ctx = ServeContext.from_conf(conf, with_batcher=False, device=args.device)
    traced = _arm_trace(args, conf)
    try:
        yield ctx
    finally:
        ctx.close()
        _check_drained()
        if traced:
            _export_trace(args)


def _write_blob(blob: bytes, output: str) -> None:
    if output == "-":
        sys.stdout.buffer.write(blob)
    else:
        with open(output, "wb") as f:
            f.write(blob)
        print(f"{output}: {len(blob)} bytes")


def _endpoint_metrics(ctx, before: dict, ledger_before: dict) -> None:
    """The context's counter delta (plus the ledger's) to stderr: stdout
    may carry the blob."""
    from .utils.tracing import delta

    d = delta(before, registry=ctx.metrics)
    d["counters"] = _with_ledger(d["counters"], ledger_before)
    print(json.dumps(d, indent=2, sort_keys=True), file=sys.stderr)


def _cmd_view(args) -> int:
    """One-shot ranged view: the daemon's ``view`` endpoint without a
    daemon (``serve.endpoints.view_blob``), so the output is the bytes a
    served response carries for the same file and region."""
    from .serve.endpoints import view_blob

    with _one_shot(args) as ctx:
        blob = view_blob(ctx, args.bam, args.region, level=args.level)
    _write_blob(blob, args.output)
    return 0


def _cmd_flagstat(args) -> int:
    """One-shot flag census (the daemon's ``flagstat`` endpoint)."""
    from .serve.endpoints import flagstat

    with _one_shot(args) as ctx:
        counts = flagstat(ctx, args.bam)
    print(json.dumps(counts, indent=2, sort_keys=True))
    return 0


def _cmd_variants(args) -> int:
    """One-shot ranged variant query: the daemon's ``variants`` endpoint
    without a daemon (``serve.endpoints.variants_blob``)."""
    from .serve.endpoints import variants_blob
    from .utils.tracing import snapshot

    ledger_before = _ledger_snapshot()
    with _one_shot(args) as ctx:
        before = snapshot(ctx.metrics)
        blob = variants_blob(ctx, args.bcf, args.region)
    _write_blob(blob, args.output)
    if args.metrics:
        _endpoint_metrics(ctx, before, ledger_before)
    return 0


def _cmd_depth(args) -> int:
    """One-shot pileup depth summary (the daemon's ``depth`` endpoint)."""
    from .serve.endpoints import depth_stat
    from .utils.tracing import snapshot

    ledger_before = _ledger_snapshot()
    with _one_shot(args) as ctx:
        before = snapshot(ctx.metrics)
        stat = depth_stat(ctx, args.bam, args.region, bin_size=args.bin_size,
                          per_base=args.per_base)
    print(json.dumps(stat, indent=2, sort_keys=True))
    if args.metrics:
        _endpoint_metrics(ctx, before, ledger_before)
    return 0


def _cmd_serve(args) -> int:
    """Run the resident daemon until a ``shutdown`` request (or a signal)."""
    from .conf import (
        FLEET_DIR,
        FLEET_HEARTBEAT_MS,
        FLEET_NAME,
        SERVE_ACCESS_LOG,
        SERVE_ACCESS_LOG_BYTES,
        SERVE_ADMISSION_TOKENS,
        SERVE_ARENA_BYTES,
        SERVE_BATCH_WINDOW_MS,
        SERVE_CACHE_BYTES,
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
        SERVE_REQUEST_TRACING,
        SERVE_SLO,
        SERVE_SLO_WINDOWS,
        Configuration,
    )
    from .serve.server import BamDaemon

    conf = Configuration()
    _apply_robustness_args(conf, args)
    for value, key, setter in (
        (args.cache_bytes, SERVE_CACHE_BYTES, conf.set_int),
        (args.arena_bytes, SERVE_ARENA_BYTES, conf.set_int),
        (args.batch_window_ms, SERVE_BATCH_WINDOW_MS, conf.set_int),
        (args.max_inflight, SERVE_MAX_INFLIGHT, conf.set_int),
        (args.admission_tokens, SERVE_ADMISSION_TOKENS, conf.set_int),
        (args.max_queue, SERVE_MAX_QUEUE, conf.set_int),
        (args.max_queue_ms, SERVE_MAX_QUEUE_MS, conf.set_int),
        (args.journal, SERVE_JOURNAL, conf.set),
        (args.flightrec, SERVE_FLIGHTREC, conf.set),
        (args.flightrec_cadence_ms, SERVE_FLIGHTREC_CADENCE_MS, conf.set_int),
        (args.flightrec_bytes, SERVE_FLIGHTREC_BYTES, conf.set_int),
        (args.exemplar_threshold_ms, SERVE_EXEMPLAR_THRESHOLD_MS, conf.set_int),
        (args.exemplars_max, SERVE_EXEMPLARS_MAX, conf.set_int),
        (args.exemplar_dir, SERVE_EXEMPLAR_DIR, conf.set),
        (args.access_log, SERVE_ACCESS_LOG, conf.set),
        (args.access_log_bytes, SERVE_ACCESS_LOG_BYTES, conf.set_int),
        (args.slo, SERVE_SLO, conf.set),
        (args.slo_windows, SERVE_SLO_WINDOWS, conf.set),
        (args.fleet_dir, FLEET_DIR, conf.set),
        (args.fleet_name, FLEET_NAME, conf.set),
        (args.heartbeat_ms, FLEET_HEARTBEAT_MS, conf.set_int),
    ):
        if value is not None:
            setter(key, value)
    if args.no_request_tracing:
        conf.set_boolean(SERVE_REQUEST_TRACING, False)
    daemon = BamDaemon(conf=conf, socket_path=args.socket, port=args.port,
                       warmup=not args.no_warmup, device=args.device)
    # SIGTERM/SIGINT drain like the shutdown op.
    daemon.install_signal_handlers()
    daemon.start()
    if daemon.warmup_report is not None:
        w = daemon.warmup_report
        errors = w.get("errors")
        print(f"warm-up: {w['compiles']} compiles over {sum(w['warmed'].values())} geometries"
              + (f", errors: {errors}" if errors else ""))
    print(f"serving on {daemon.endpoint}", flush=True)
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        daemon.stop()
    return 0


def _cmd_fleet(args) -> int:
    """Run the fleet's front router: one address for N serve daemons."""
    from .conf import (
        FLEET_DIR,
        FLEET_FILE_TOKENS,
        FLEET_HEARTBEAT_TIMEOUT_MS,
        FLEET_MIGRATE_WARMTH,
        FLEET_TOKENS,
        FLEET_VNODES,
        Configuration,
    )
    from .serve.router import FleetRouter

    conf = Configuration()
    conf.set(FLEET_DIR, args.fleet_dir)
    if args.heartbeat_timeout_ms is not None:
        conf.set_int(FLEET_HEARTBEAT_TIMEOUT_MS, args.heartbeat_timeout_ms)
    if args.vnodes is not None:
        conf.set_int(FLEET_VNODES, args.vnodes)
    if args.fleet_tokens is not None:
        conf.set_int(FLEET_TOKENS, args.fleet_tokens)
    if args.file_tokens is not None:
        conf.set_int(FLEET_FILE_TOKENS, args.file_tokens)
    if args.migrate_warmth:
        conf.set_boolean(FLEET_MIGRATE_WARMTH, True)
    router = FleetRouter(conf=conf, socket_path=args.socket, port=args.port)
    router.start()
    print(f"fleet router on {router.endpoint} "
          f"(dir {router.fleet_dir}, {len(router.ring)} member(s))", flush=True)
    try:
        router.serve_forever()
    except KeyboardInterrupt:
        router.stop()
    return 0


def _cmd_stats(args) -> int:
    """One stats snapshot from a running daemon, the SLO block
    pretty-printed."""
    from .serve.client import ServeClient
    from .serve.slo import format_slo_block

    st = ServeClient(socket_path=args.socket, port=args.port).stats()
    if args.json:
        print(json.dumps(st, indent=2, sort_keys=True, default=str))
        return 0
    print(format_slo_block(st.get("slo") or {}))
    hists = (st.get("metrics") or {}).get("histograms") or {}
    lat = {k: v for k, v in hists.items() if k.startswith("serve.op.") and k.endswith(".ms")}
    if lat:
        print("\nper-op latency (log2-bucket percentiles, ms):")
        for k in sorted(lat):
            h = lat[k]
            print(f"  {k:<28} n={h.get('count', 0):<8.0f} "
                  f"p50≤{h.get('p50', 0):g} p95≤{h.get('p95', 0):g} "
                  f"p99≤{h.get('p99', 0):g}")
    jobs = st.get("jobs") or {}
    if jobs:
        by_status: dict = {}
        for j in jobs.values():
            by_status[j["status"]] = by_status.get(j["status"], 0) + 1
        print("\njobs: " + ", ".join(f"{k}={v}" for k, v in sorted(by_status.items())))
    ex_count = (st.get("gauges") or {}).get("serve.trace.exemplar_count")
    if ex_count:
        print(f"\nexemplars held: {ex_count:.0f} (list with the `exemplars` op; render one "
              "with tools/request_report.py)")
    return 0


def _add_trace_arg(s) -> None:
    s.add_argument(
        "--trace", default=None, metavar="OUT.json",
        help="record a per-event timeline (bounded ring; hadoopbam.trace.events caps it) and "
             "export Chrome trace-event JSON here: load it in Perfetto, reduce it with "
             "tools/trace_report.py for per-stage busy/idle/overlap, the top stall and the "
             "HBM track")


def _add_robustness_args(s) -> None:
    s.add_argument(
        "--errors", choices=("strict", "salvage"), default=None,
        help="corrupt-input policy (hadoopbam.errors): strict aborts on the first bad "
             "member or torn record (default); salvage quarantines them and finishes "
             "(salvage.* counters in --metrics)")
    s.add_argument(
        "--faults", default=None, metavar="PLAN",
        help="arm a deterministic fault-injection plan (hadoopbam.faults.plan / HBAM_FAULTS; "
             "grammar in hadoop_bam_tpu_torch/faults/plan.py, e.g. "
             "'seed=7;io.read.error:n=2;exec.crash:items=0,attempts=0')")


def _add_device_arg(s) -> None:
    s.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="where the job runs: the card (default; raises without one) or the CPU, "
             "through every kernel's plain version")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hadoop_bam_tpu_torch",
        description="splittable bioinformatics formats on a CUDA card",
    )
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("splitting-index",
                       help="build .splitting-bai record index(es) for BAM file(s)")
    s.add_argument("bam", nargs="+")
    s.add_argument("-g", "--granularity", type=int, default=4096)
    s.set_defaults(func=_cmd_splitting_index)

    s = sub.add_parser("splitting-index-dump", help="print a .splitting-bai's offsets")
    s.add_argument("index")
    s.set_defaults(func=_cmd_splitting_index_dump)

    s = sub.add_parser("bgzf-index", help="build .bgzfi block index(es) for BGZF file(s)")
    s.add_argument("file", nargs="+")
    s.add_argument("-g", "--granularity", type=int, default=1024)
    s.set_defaults(func=_cmd_bgzf_index)

    s = sub.add_parser("bai-index", help="build a standard .bai for a coordinate-sorted BAM")
    s.add_argument("bam", nargs="+")
    s.set_defaults(func=_cmd_bai_index)

    s = sub.add_parser("bam-guess",
                       help="find the first BAM record start at/after a byte position")
    s.add_argument("bam")
    s.add_argument("pos", type=int)
    s.add_argument("--end", type=int, default=None)
    s.set_defaults(func=_cmd_bam_guess)

    s = sub.add_parser("bcf-guess",
                       help="find the first BCF record start at/after a byte position")
    s.add_argument("bcf")
    s.add_argument("pos", type=int)
    s.add_argument("--end", type=int, default=None)
    s.set_defaults(func=_cmd_bcf_guess)

    s = sub.add_parser("sorted-header",
                       help="extract a BAM header, set SO:coordinate, emit as a BGZF block")
    s.add_argument("bam")
    s.add_argument("out", nargs="?", default="-")
    s.set_defaults(func=_cmd_sorted_header)

    def add_sort_args(s, markdup: bool) -> None:
        s.add_argument("bam", nargs="+")
        s.add_argument("-o", "--output", required=True)
        s.add_argument("--split-size", type=int, default=32 << 20)
        s.add_argument("--level", type=int, default=6)
        s.add_argument("--devices", type=int, default=0,
                       help="sort over an n-device mesh (0 = single device; with --device "
                            "cpu, n shards of the host)")
        s.add_argument("--write-splitting-bai", action="store_true")
        s.add_argument(
            "--memory-budget", type=_parse_size, default=None, metavar="BYTES",
            help="bounded-memory out-of-core sort: cap materialized record bytes "
                 "(k/m/g suffixes, e.g. 512m)")
        s.add_argument(
            "--part-dir", default=None, metavar="DIR",
            help="persistent part/spill directory: finished parts (and, with "
                 "--memory-budget, the manifest-certified spill runs) are restart "
                 "checkpoints")
        s.add_argument("--inflate-lanes", choices=("on", "off"), default=None,
                       help="force the device inflate tier (hadoopbam.inflate.lanes; "
                            "default: on for the card)")
        s.add_argument("--deflate-lanes", choices=("on", "off"), default=None,
                       help="force the device deflate tier (hadoopbam.deflate.lanes; "
                            "default: on for the card)")
        s.add_argument("--device-write", choices=("on", "off"), default=None,
                       help="force the device-resident part writes (gather, flag patch, "
                            "CRC32 and deflate on the card; hadoopbam.write.device, "
                            "default: on for the card)")
        if not markdup:
            s.add_argument(
                "-n", "--queryname", action="store_true",
                help="sort by read name (samtools natural order): the collation groups "
                     "records by name hash on the device and ranks the verified buckets; "
                     "the header says SO:queryname")
            s.add_argument(
                "--mark-duplicates", action="store_true",
                help="mark duplicates in the same job (OR 0x400 into their flags at "
                     "write time)")
        s.add_argument("--metrics", action="store_true",
                       help="print the job's counter report after the run: codec tiers, "
                            "transfers, the HBM ledger and the run manifest")
        s.add_argument("--trace-dir", default=None,
                       help="capture a torch.profiler Chrome trace of the run here (the "
                            "card's timeline; composes with --trace's host timeline)")
        _add_device_arg(s)
        _add_trace_arg(s)
        _add_robustness_args(s)

    s = sub.add_parser("sort", help="coordinate-sort BAM file(s) end to end")
    add_sort_args(s, markdup=False)
    s.set_defaults(func=_cmd_sort)

    s = sub.add_parser("markdup",
                       help="coordinate-sort + mark PCR/optical duplicates (0x400) in one "
                            "pass (a no-op reorder for already-sorted input)")
    add_sort_args(s, markdup=True)
    s.set_defaults(func=_cmd_markdup)

    s = sub.add_parser("fixmate",
                       help="fill mate coordinates, mate flags, TLEN and MC tags from "
                            "collated pairs, keeping the record order")
    s.add_argument("bam", nargs="+")
    s.add_argument("-o", "--output", required=True)
    s.add_argument("--split-size", type=int, default=32 << 20)
    s.add_argument("--level", type=int, default=6)
    s.add_argument("--memory-budget", type=_parse_size, default=None, metavar="BYTES",
                   help="bounded-memory fixmate: pass B reads the splits again "
                        "(k/m/g suffixes)")
    s.add_argument("--part-dir", default=None, metavar="DIR",
                   help="persistent part directory: finished parts are restart checkpoints")
    s.add_argument("--metrics", action="store_true",
                   help="print the job's counter report after the run (collate.*, "
                        "fixmate.*, the run manifest)")
    _add_device_arg(s)
    _add_trace_arg(s)
    _add_robustness_args(s)
    s.set_defaults(func=_cmd_fixmate)

    s = sub.add_parser("ingest",
                       help="FASTQ (plain or gzip, single or paired R1/R2) to a "
                            "queryname-collated unaligned BAM")
    s.add_argument("fastq", help="R1 (or sole) FASTQ input, plain or gzip")
    s.add_argument("--r2", default=None, metavar="FASTQ", help="R2 mate file")
    s.add_argument("-o", "--output", required=True)
    s.add_argument("--level", type=int, default=6)
    s.add_argument("--memory-budget", type=_parse_size, default=None, metavar="BYTES",
                   help="bounded-memory ingest: encoded records spill in runs and merge "
                        "(k/m/g suffixes)")
    s.add_argument("--part-dir", default=None, metavar="DIR",
                   help="spill directory for --memory-budget runs")
    s.add_argument("--quality-encoding", choices=("sanger", "illumina"), default=None,
                   help="input base quality encoding "
                        "(hbam.fastq-input.base-quality-encoding)")
    s.add_argument("--filter-failed-qc", action="store_true",
                   help="drop records whose CASAVA 1.8 filter field says Y")
    s.add_argument("--inflate-lanes", choices=("on", "off"), default=None,
                   help="force the device inflate tier for compressed members")
    s.add_argument("--deflate-lanes", choices=("on", "off"), default=None,
                   help="force the device deflate tier for the uBAM output")
    s.add_argument("--device-scan", choices=("on", "off"), default=None,
                   help="force the device record-boundary scan "
                        "(hadoopbam.ingest.device-scan)")
    s.add_argument("--metrics", action="store_true",
                   help="print the job's counter report after the run (ingest.*, "
                        "fastq.scan.*, salvage.ingest_*, the run manifest)")
    _add_device_arg(s)
    _add_trace_arg(s)
    _add_robustness_args(s)
    s.set_defaults(func=_cmd_ingest)

    s = sub.add_parser("view",
                       help="index-backed ranged read: records overlapping a region as a "
                            "small BAM (the serve daemon's view endpoint)")
    s.add_argument("bam")
    s.add_argument("region", help="contig | contig:pos | contig:start-end")
    s.add_argument("-o", "--output", default="-")
    s.add_argument("--level", type=int, default=6)
    _add_device_arg(s)
    _add_trace_arg(s)
    _add_robustness_args(s)
    s.set_defaults(func=_cmd_view)

    s = sub.add_parser("flagstat",
                       help="whole-file flag census as JSON (the daemon's flagstat "
                            "endpoint)")
    s.add_argument("bam")
    _add_device_arg(s)
    _add_trace_arg(s)
    _add_robustness_args(s)
    s.set_defaults(func=_cmd_flagstat)

    s = sub.add_parser("variants",
                       help="ranged BCF query: records overlapping a region as a small BCF "
                            "(the daemon's variants endpoint)")
    s.add_argument("bcf")
    s.add_argument("region", help="contig | contig:pos | contig:start-end")
    s.add_argument("-o", "--output", default="-")
    s.add_argument("--metrics", action="store_true",
                   help="print the counter delta to stderr after the run")
    _add_device_arg(s)
    _add_trace_arg(s)
    _add_robustness_args(s)
    s.set_defaults(func=_cmd_variants)

    s = sub.add_parser("depth",
                       help="pileup depth summary over a region as JSON (the daemon's "
                            "depth endpoint)")
    s.add_argument("bam")
    s.add_argument("region", help="contig | contig:pos | contig:start-end")
    s.add_argument("--bin-size", type=int, default=1 << 12)
    s.add_argument("--per-base", action="store_true",
                   help="include the exact per-base vector")
    s.add_argument("--metrics", action="store_true",
                   help="print the counter delta to stderr after the run")
    _add_device_arg(s)
    _add_trace_arg(s)
    _add_robustness_args(s)
    s.set_defaults(func=_cmd_depth)

    s = sub.add_parser("serve",
                       help="resident service: a daemon owning the card (warm kernels and "
                            "indices, the residency arena, lane batching) behind a "
                            "localhost/UDS JSON socket")
    s.add_argument("--socket", default=None, help="UDS socket path (hadoopbam.serve.socket)")
    s.add_argument("--port", type=int, default=None,
                   help="serve on 127.0.0.1:PORT instead of a UDS socket")
    s.add_argument("--cache-bytes", type=_parse_size, default=None, metavar="BYTES",
                   help="header/index cache budget (hadoopbam.serve.cache-bytes)")
    s.add_argument("--arena-bytes", type=_parse_size, default=None, metavar="BYTES",
                   help="residency arena budget (hadoopbam.serve.arena-bytes)")
    s.add_argument("--batch-window-ms", type=int, default=None,
                   help="lane batcher window (hadoopbam.serve.batch-window-ms; 0 disables)")
    s.add_argument("--max-inflight", type=int, default=None,
                   help="max concurrently-running jobs (hadoopbam.serve.max-inflight)")
    s.add_argument("--no-warmup", action="store_true",
                   help="skip the startup kernel warm-up (hadoopbam.serve.warmup)")
    s.add_argument("--admission-tokens", type=int, default=None,
                   help="admission budget in cost units (hadoopbam.serve.admission-tokens)")
    s.add_argument("--max-queue", type=int, default=None,
                   help="admission queue bound; beyond it requests shed "
                        "(hadoopbam.serve.max-queue)")
    s.add_argument("--max-queue-ms", type=int, default=None,
                   help="queue-wait p95 bound in ms (hadoopbam.serve.max-queue-ms)")
    s.add_argument("--journal", default=None, metavar="FILE",
                   help="crash-safe job journal (hadoopbam.serve.journal)")
    s.add_argument("--flightrec", default=None, metavar="BASE",
                   help="flight recorder ring base path (hadoopbam.serve.flightrec)")
    s.add_argument("--flightrec-cadence-ms", type=int, default=None,
                   help="flight recorder cadence (hadoopbam.serve.flightrec-cadence-ms)")
    s.add_argument("--flightrec-bytes", type=_parse_size, default=None, metavar="BYTES",
                   help="flight recorder ring budget (hadoopbam.serve.flightrec-bytes)")
    s.add_argument("--no-request-tracing", action="store_true",
                   help="turn request tracing off (hadoopbam.serve.request-tracing)")
    s.add_argument("--exemplar-threshold-ms", type=int, default=None,
                   help="tail sampler latency threshold "
                        "(hadoopbam.serve.exemplar-threshold-ms)")
    s.add_argument("--exemplars-max", type=int, default=None,
                   help="exemplar store bound (hadoopbam.serve.exemplars-max)")
    s.add_argument("--exemplar-dir", default=None, metavar="DIR",
                   help="also spill each exemplar as DIR/<trace_id>.json")
    s.add_argument("--access-log", default=None, metavar="BASE",
                   help="JSONL access log base path (hadoopbam.serve.access-log)")
    s.add_argument("--access-log-bytes", type=_parse_size, default=None, metavar="BYTES",
                   help="access-log ring budget (hadoopbam.serve.access-log-bytes)")
    s.add_argument("--slo", default=None, metavar="SPEC",
                   help="declared SLO objectives (hadoopbam.serve.slo), e.g. "
                        "'view:latency=100@0.999;sort:availability=0.99'")
    s.add_argument("--slo-windows", default=None, metavar="FAST,SLOW",
                   help="SLO windows in seconds (hadoopbam.serve.slo-windows)")
    s.add_argument("--fleet-dir", default=None, metavar="DIR",
                   help="join a fleet: heartbeat a member record in DIR "
                        "(hadoopbam.fleet.dir)")
    s.add_argument("--fleet-name", default=None,
                   help="this member's fleet name (hadoopbam.fleet.member-name)")
    s.add_argument("--heartbeat-ms", type=int, default=None,
                   help="fleet heartbeat cadence (hadoopbam.fleet.heartbeat-ms)")
    _add_device_arg(s)
    _add_robustness_args(s)
    s.set_defaults(func=_cmd_serve)

    s = sub.add_parser("fleet",
                       help="fleet front router: one UDS/TCP address for N serve daemons")
    s.add_argument("--fleet-dir", required=True, metavar="DIR",
                   help="the shared fleet directory (hadoopbam.fleet.dir)")
    s.add_argument("--socket", default=None, help="router UDS socket path")
    s.add_argument("--port", type=int, default=None,
                   help="route on 127.0.0.1:PORT instead of a UDS socket")
    s.add_argument("--heartbeat-timeout-ms", type=int, default=None,
                   help="declare a member dead after this much silence "
                        "(hadoopbam.fleet.heartbeat-timeout-ms)")
    s.add_argument("--vnodes", type=int, default=None,
                   help="virtual nodes per member (hadoopbam.fleet.vnodes)")
    s.add_argument("--fleet-tokens", type=int, default=None,
                   help="fleet-wide admission pool (hadoopbam.fleet.tokens)")
    s.add_argument("--file-tokens", type=int, default=None,
                   help="per-file in-flight cap (hadoopbam.fleet.file-tokens)")
    s.add_argument("--migrate-warmth", action="store_true",
                   help="on a planned leave, ship warm arena windows to the new owners "
                        "(hadoopbam.fleet.migrate-warmth)")
    s.set_defaults(func=_cmd_fleet)

    s = sub.add_parser("stats",
                       help="one stats snapshot from a running daemon, the SLO block "
                            "pretty-printed")
    s.add_argument("--socket", default=None, help="daemon UDS socket path")
    s.add_argument("--port", type=int, default=None, help="daemon 127.0.0.1 TCP port")
    s.add_argument("--json", action="store_true", help="the raw stats reply as JSON")
    s.set_defaults(func=_cmd_stats)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)

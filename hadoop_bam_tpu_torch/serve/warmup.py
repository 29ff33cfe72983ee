"""Startup warm-up: bring up the kernel working set, count kernel compiles.

Counterpart of ``hadoop_bam_tpu/serve/warmup.py``.  ``warm_kernels``
drives the real wrappers (the ``ops.flate`` codec tiers, kernel row 6's
view cut ``ops.kernels.overlap.overlap_rows``, the key sort) at the pow2 bucket sizes
requests produce, so a daemon's first request finds every kernel it will
launch already built and loaded.

A "compile" in the port is a ``csrc`` library that ``_build`` builds or
loads for the first time in the process (the reference counts XLA backend
compiles).  :class:`CompileWatcher` hooks ``_build.load`` and counts each
into ``serve.jit_compiles``, so a warm second call reporting ``compiles ==
0`` is an asserted counter, not a hope.  On the CPU the plain versions run
and no library loads.

A family that fails raises: the reference records the error and carries
on (``serve.warmup_errors``); here a kernel that cannot build or launch is
never hidden.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from .. import _build
from ..utils.backend import resolve_device
from ..utils.tracing import Metrics

_WATCHER: Optional["CompileWatcher"] = None
_WATCHER_LOCK = threading.Lock()

#: Warmable kernel families (the ``kinds`` vocabulary of warm_kernels).
ALL_KINDS = ("overlap", "keys", "codec")

#: Payload buckets of the codec warm-up on a card (the reference's
#: accelerator buckets): a small member, a mid member and the part
#: writer's full-size blocking.
CUDA_CODEC_BUCKETS = (4096, 16384, 57088)
#: One small member on the CPU, where the plain versions run.
CPU_CODEC_BUCKETS = (1024,)

#: Row-count buckets of the overlap and key families: the endpoints pad
#: record counts to pow2 >= OVERLAP_PAD_MIN.
OVERLAP_PAD_MIN = 64
DEFAULT_ROW_BUCKETS = (64, 256, 1024, 4096)


class CompileWatcher:
    """Counts first loads of the kernel libraries (``_build.load``) into
    its ``metrics`` as ``serve.jit_compiles``."""

    def __init__(self) -> None:
        self.count = 0
        self.metrics = Metrics()
        self._lock = threading.Lock()
        _build.add_load_hook(self._on_load)

    def _on_load(self, name: str) -> None:
        with self._lock:
            self.count += 1
        self.metrics.count("serve.jit_compiles")


def ensure_compile_watcher() -> CompileWatcher:
    """The process-global watcher, registered once."""
    global _WATCHER
    with _WATCHER_LOCK:
        if _WATCHER is None:
            _WATCHER = CompileWatcher()
        return _WATCHER


def compile_count() -> int:
    """Kernel libraries loaded since the watcher exists (0 before)."""
    w = _WATCHER
    return w.count if w is not None else 0


def pow2_at_least(n: int, lo: int = OVERLAP_PAD_MIN) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _warm_overlap(row_buckets: Sequence[int], dev: torch.device) -> int:
    """Kernel row 6, the view's cut, at every request pad shape, one
    interval (a view queries one region at a time)."""
    from ..ops.kernels.overlap import overlap_rows

    iv = torch.tensor([[0, 0, 1]], dtype=torch.int32, device=dev)
    for n in row_buckets:
        z = torch.zeros(n, dtype=torch.int32, device=dev)
        overlap_rows(iv, z - 1, z, z)  # refid -1: padding rows
    _sync(dev)
    return len(row_buckets)


def _warm_keys(row_buckets: Sequence[int], dev: torch.device) -> int:
    """The key sort at the same row buckets."""
    from ..ops.sort import sort_keys

    for n in row_buckets:
        sort_keys(torch.zeros(n, dtype=torch.int64, device=dev))
    _sync(dev)
    return len(row_buckets)


def _warm_codec(buckets: Sequence[int], conf, dev: torch.device) -> int:
    """Round one payload per bucket through both codec entry points, on
    whichever tiers the gates select."""
    from ..ops import flate

    rng = np.random.default_rng(0)
    for b in buckets:
        # Compressible but not trivial: real match and Huffman paths.
        payload = rng.integers(0, 8, size=b, dtype=np.uint8)
        blob = flate.bgzf_compress_device(payload, level=1, use_lanes=None, conf=conf,
                                          block_payload=min(b, flate.DEV_MAX_PAYLOAD),
                                          device=dev)
        flate.bgzf_decompress_device(blob, conf=conf, device=dev)
    return len(buckets)


def warm_kernels(
    conf=None,
    kinds: Optional[Iterable[str]] = None,
    codec_buckets: Optional[Sequence[int]] = None,
    row_buckets: Sequence[int] = DEFAULT_ROW_BUCKETS,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, object]:
    """Bring up the daemon's kernel working set on ``device`` (default
    cuda); returns a report: ``kinds``, ``codec_buckets``, ``row_buckets``,
    ``warmed`` (calls per family) and ``compiles`` (kernel libraries loaded
    by this call).  ``kinds`` defaults to every family; the codec buckets
    default to :data:`CUDA_CODEC_BUCKETS` on a card and
    :data:`CPU_CODEC_BUCKETS` on the CPU.  A family that fails raises."""
    watcher = ensure_compile_watcher()
    kinds = tuple(kinds) if kinds is not None else ALL_KINDS
    unknown = set(kinds) - set(ALL_KINDS)
    if unknown:
        raise ValueError(f"unknown warm-up kinds: {sorted(unknown)}")
    dev = resolve_device(device)
    if codec_buckets is None:
        codec_buckets = CUDA_CODEC_BUCKETS if dev.type == "cuda" else CPU_CODEC_BUCKETS
    c0 = compile_count()
    steps = {
        "overlap": lambda: _warm_overlap(row_buckets, dev),
        "keys": lambda: _warm_keys(row_buckets, dev),
        "codec": lambda: _warm_codec(codec_buckets, conf, dev),
    }
    warmed = {kind: steps[kind]() for kind in kinds}
    watcher.metrics.count("serve.warmup_runs")
    return {
        "kinds": list(kinds),
        "codec_buckets": list(codec_buckets),
        "row_buckets": list(row_buckets),
        "warmed": warmed,
        "compiles": compile_count() - c0,
    }

"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on first use into a shared library with a plain C
interface under ``_build/`` (listed in ``.gitignore``) and is bound with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

No PyTorch headers are involved, so a build takes seconds.  Every C entry
point takes raw device pointers (``tensor.data_ptr()``) and the CUDA stream
as integers and returns ``cudaGetLastError()`` of its launch; the wrappers
raise when that is not 0.  A failed build raises too: nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
#: C signature of every entry point, by source name.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "inflate": {
        "hbt_inflate_members": [_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _P],
    },
    "chain": {
        "hbt_chain_plan": [_I64, _I64, _I64, _P],
        "hbt_chain_walk": [_P, _I64, _P, _P, _P, _I64, _I64, _P, _P, _I64, _P, _P],
        "hbt_stream_keys": [_P, _I64, _P, _P, _I64, _P, _P, _P],
    },
    "deflate": {
        "hbt_deflate_members": [_P, _I64, _P, _P, _I64, _I32, _I32, _I64, _P, _P, _P, _P, _P],
    },
    "write": {
        "hbt_gather_stream": [_P, _I64, _P, _P, _P, _P, _I64, _I32, _P, _I64, _P, _I32, _I32,
                              _P],
        "hbt_gather_check": [_P, _P, _I64, _P, _P, _P],
        "hbt_crc32_members": [_P, _I64, _P, _P, _I64, _P, _P, _I32, _I32, _P],
    },
    "record_scan": {
        "hbt_record_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _P, _P],
    },
    "bcf_chain": {
        "hbt_bcf_chain_plan": [_I64, _I64, _I64, _I64, _I64, _P],
        "hbt_bcf_chain_walk": [_P, _I64, _I64, _I64, _P, _I64, _P, _P, _I64, _I64, _P, _P],
    },
    "rans": {
        "hbt_rans_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _P],
    },
    "inflate_fixed": {
        "hbt_inflate_fixed_literal": [_P, _I64, _P, _P, _I64, _P, _I64, _P, _I32, _I32,
                                      _P, _P],
    },
    "inflate_probe": {
        "hbt_inflate_probe_walk": [_P, _I32, _P, _I32, _P, _P, _P],
    },
    "region": {
        "hbt_overlap_mask": [_P, _I32, _P, _P, _P, _I64, _P, _P],
        "hbt_overlap_rows": [_P, _I32, _P, _P, _P, _I64, _P, _P, _I32, _P],
        "hbt_quality_histogram": [_P, _P, _I64, _I32, _P, _P],
        "hbt_unpack_nibbles_u8": [_P, _I64, _P, _P],
        "hbt_unpack_nibbles_i32": [_P, _I64, _P, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_load_hooks: List[Callable[[str], None]] = []


def add_load_hook(fn: Callable[[str], None]) -> None:
    """Call ``fn(name)`` whenever a library is built or loaded for the
    first time in this process: the port's kernel "compile"."""
    with _lock:
        _load_hooks.append(fn)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    first ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _compile_cmd(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(SRC_DIR / f"{name}.cu")]


def build(
    names: Optional[Iterable[str]] = None, force: bool = False
) -> Dict[str, dict]:
    """Compile the named sources (default: all), one ``nvcc`` per source,
    all started together.  Returns ``{name: {"seconds", "log"}}`` for each
    source built (``log`` holds ptxas's register and shared-memory report).
    Sources whose library is newer than the source and every ``csrc/*.cuh``
    are skipped unless ``force``."""
    import time

    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    headers = [h.stat().st_mtime for h in SRC_DIR.glob("*.cuh")]
    for name in names:
        lib = _lib_path(name)
        src = SRC_DIR / f"{name}.cu"
        newest = max([src.stat().st_mtime, *headers])
        if not force and lib.exists() and lib.stat().st_mtime >= newest:
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _compile_cmd(name, tmp),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    took: Dict[str, dict] = {}
    errors = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        took[name] = {"seconds": time.perf_counter() - t0, "log": out}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
        hooks = list(_load_hooks)
    for fn in hooks:
        fn(name)
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")

"""Serve: the request endpoints and the daemon's startup warm-up."""

from .warmup import ALL_KINDS, compile_count, ensure_compile_watcher, warm_kernels

__all__ = ["ALL_KINDS", "compile_count", "ensure_compile_watcher", "warm_kernels"]

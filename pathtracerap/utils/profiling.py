"""Profiler hooks.

The reference's only profiling is ``std::chrono`` prints (SURVEY.md
section 5).  Here: ``jax.profiler`` trace capture (viewable in
TensorBoard/Perfetto) plus named scopes so traces show the render phases
(generate / trace / shade / accumulate) instead of a fused soup, and a
device memory report analog of ``printCUDAMemoryInfo`` (utility.h:25-40).
"""

from __future__ import annotations

import contextlib

import jax


def enable_compile_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, names the directory and no
    other is set.  Otherwise the cache lives at the fixed ``.jax_cache/``
    of the checkout (a fixed path, because the path is part of the cache
    key).
    """
    import os

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR", "")
    if not path:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        path = os.path.join(repo, ".jax_cache")
        os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a device trace for the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope visible in profiler traces (and HLO metadata)."""
    return jax.named_scope(name)


def device_memory_report() -> dict:
    """Best-effort device memory stats (cudaMemGetInfo analog)."""
    out = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats()
        except Exception:
            stats = None
        if stats:
            out[str(d)] = {
                "bytes_in_use": stats.get("bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit"),
            }
    return out

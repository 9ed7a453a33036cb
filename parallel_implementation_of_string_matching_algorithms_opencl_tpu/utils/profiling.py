"""Tracing / profiling helpers (SURVEY.md §5 "Tracing / profiling").

The reference's profiling story is host timers + OpenCL event profiling
printed to stdout; ours wraps ``jax.profiler`` (Perfetto/TensorBoard traces)
plus compiled-module cost introspection, and a pipelined wall-clock timer
that amortizes host-sync latency.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a device trace viewable in TensorBoard/Perfetto/XProf
    (default directory: ``matcher-trace`` under the temp directory)."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "matcher-trace")
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, iters: int = 10, warmup: int = 1):
    """(seconds_per_call, last_output) with pipelined dispatch: ``iters``
    dispatches, one sync — measures device throughput, not per-call
    host-sync latency."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    jax.block_until_ready(outs[-1])
    return (time.perf_counter() - t0) / iters, outs[-1]


def compiled_stats(fn, *args) -> dict:
    """Cost analysis of the jitted fn at these args: flops, bytes accessed,
    peak memory — straight from XLA's compiled-module analysis."""
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    cost = compiled.cost_analysis() or {}
    mem = compiled.memory_analysis()
    out = {
        "flops": cost.get("flops"),
        "bytes_accessed": cost.get("bytes accessed"),
        "transcendentals": cost.get("transcendentals"),
    }
    if mem is not None:
        out.update(
            {
                "argument_size_bytes": getattr(mem, "argument_size_in_bytes", None),
                "output_size_bytes": getattr(mem, "output_size_in_bytes", None),
                "temp_size_bytes": getattr(mem, "temp_size_in_bytes", None),
                "peak_bytes": getattr(mem, "peak_memory_in_bytes", None),
            }
        )
    return out

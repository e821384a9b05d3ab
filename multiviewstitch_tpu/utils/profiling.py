"""Profiling helpers: jax.profiler traces + per-stage device timing.

The reference's only measurement is a clock() print around PartRecog
(Alignment.cpp:46-52; SURVEY §5.1). Here: a context manager that captures a
jax.profiler trace for any code region (viewable in TensorBoard/Perfetto),
plus a device-timer that measures compiled-callable latency with proper
warmup and synchronization — the harness bench.py and bench/scaling.py use.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str = "/tmp/mvs_trace", enabled: bool = True):
    """Capture a jax.profiler trace of the enclosed region."""
    if not enabled:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_time(fn: Callable, *args, reps: int = 5,
                warmup: int = 1) -> float:
    """Best-of-reps wall seconds of fn(*args) with block_until_ready."""
    for _ in range(warmup):
        out = fn(*args)
        jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def compiled_flops(fn: Callable, *args) -> Optional[float]:
    """Per-device FLOPs of the compiled program (None if unavailable)."""
    try:
        c = jax.jit(fn).lower(*args).compile()
        return float(c.cost_analysis().get("flops", 0.0))
    except Exception:
        return None


def device_info() -> dict:
    """The device a measurement ran on, as JAX reports it."""
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}

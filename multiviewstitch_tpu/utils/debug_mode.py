"""Numeric debug mode + elastic stage execution.

SURVEY §5.2-5.3: the reference has no sanitizers and fails hard
(exit(-1) everywhere, e.g. ParamParser.cpp:50, Processor.cpp:798-799).
JAX equivalents:

  - ``debug_numerics()``: a context manager enabling jax_debug_nans /
    jax_debug_infs (traced NaN/Inf checks inside jit) plus highest matmul
    precision — the "sanitizer" for a numeric pipeline. Also exposed as
    the MVS_DEBUG_NUMERICS=1 environment switch in the CLI.
  - ``check_finite(name, **arrays)``: host-side assertion helper for stage
    boundaries (cheap: one fused reduce per array).
  - ``run_stage(...)``: elastic stage execution — retries a stage function
    on transient failures (device OOM / RPC preemption patterns) with
    exponential backoff, re-raising real errors. Combined with the stage
    manifest (io/manifest.py), a killed pipeline resumes at the last
    completed stage — the coarse elasticity SURVEY §5.3 prescribes.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Iterable, Tuple

import numpy as np
import jax

log = logging.getLogger("mvs")

# error signatures considered transient (worth a retry): device resets,
# RPC drops, allocator pressure
_TRANSIENT = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED",
              "ABORTED", "preempt", "connection reset", "socket closed")


@contextlib.contextmanager
def debug_numerics(enable: bool = True):
    """Enable traced NaN/Inf detection inside every jitted stage."""
    if not enable:
        yield
        return
    old_nan = jax.config.jax_debug_nans
    old_inf = jax.config.jax_debug_infs
    jax.config.update("jax_debug_nans", True)
    jax.config.update("jax_debug_infs", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nan)
        jax.config.update("jax_debug_infs", old_inf)


def check_finite(name: str, **arrays) -> None:
    """Host-side stage-boundary check: raise with the offending array's
    name and stats if any value is non-finite."""
    for k, a in arrays.items():
        a = np.asarray(a)
        if not np.isfinite(a).all():
            bad = (~np.isfinite(a)).sum()
            raise FloatingPointError(
                f"stage '{name}': array '{k}' has {bad}/{a.size} "
                f"non-finite values (shape {a.shape})")


def _is_transient(err: BaseException) -> bool:
    s = f"{type(err).__name__}: {err}"
    return any(sig.lower() in s.lower() for sig in _TRANSIENT)


def run_stage(fn: Callable, *args, stage: str = "", retries: int = 2,
              backoff_s: float = 2.0, **kwargs):
    """Run a pipeline stage with retry-on-preemption semantics.

    Transient device/RPC failures are retried up to ``retries`` times with
    exponential backoff (the elastic-recovery behavior SURVEY §5.3 asks
    for); deterministic errors re-raise immediately. Stage functions must
    be idempotent — every pipeline stage here is (pure compute + manifest-
    checkpointed writes)."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - classify then re-raise
            if attempt >= retries or not _is_transient(e):
                raise
            attempt += 1
            wait = backoff_s * (2.0 ** (attempt - 1))
            log.warning("stage %r hit transient failure (%s); retry "
                        "%d/%d in %.1fs", stage or fn.__name__, e,
                        attempt, retries, wait)
            time.sleep(wait)

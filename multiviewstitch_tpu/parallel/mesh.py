"""Device-mesh setup and sharding helpers.

The reference is single-process/single-thread (SURVEY §2 'Parallelism...
none'); this module provides the scaling substrate required by
BASELINE configs 4-5: a jax.sharding.Mesh over the chips of one or more
hosts, with named axes for the framework's parallel dimensions:

  - 'views'  : data parallelism over frames / view-graph edges / TSDF
               frame batches (collectives: psum for reductions)
  - 'blocks' : deformation-graph or point-block parallelism for the
               solvers (Schur reduction via psum, halo via ppermute)

Multi-host launch uses jax.distributed.initialize (call `init_distributed`
once per process before any jax op); single-host multi-chip and the
8-virtual-device CPU test mesh need no init.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Initialize multi-host JAX (no-op if single process). Mirrors the
    standard jax.distributed bootstrap; reads env vars when args omitted."""
    if num_processes is None:
        num_processes = int(os.environ.get("MVS_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("views",)) -> Mesh:
    """1D (or reshaped nD) mesh over the first n devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    arr = np.array(devs[:n])
    if len(axis_names) > 1:
        # split n into near-square factors, hosts-major
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        arr = arr.reshape(a, n // a)
    return Mesh(arr, axis_names=axis_names)


def shard_along(mesh: Mesh, axis: str = "views") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0,
                    fill=0):
    """Pad axis 0 (or given axis) so it divides the mesh size."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill), n

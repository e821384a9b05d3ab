"""Distributed ARAP: edge-sharded local-global iterations over psum.

The deformation-graph parallelism BASELINE asks for ("deformation-graph
blocks partitioned per host ... solves via ... psum/all-gather"). Layout:

  - EDGES (with their cotangent weights) shard across the mesh's 'views'
    axis — both the rotation-fitting scatter and the Laplacian matvec are
    edge-sums, so each device computes partial per-vertex accumulations
    over its edge block and ONE psum yields the full quantities.
  - VERTEX STATE is replicated (V x 3 floats is tiny next to the edge
    work); CG runs data-parallel with psum-reduced matvecs and dot
    products, so every device holds the same iterates bit-for-bit.

Golden test: matches solvers/deformation.arap_solve on the same problem.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..solvers.deformation import ARAPProblem, fit_rotation


def pad_edges(edges: np.ndarray, weights: np.ndarray, n_devices: int):
    """Pad the edge list to a device-divisible count with zero-weight
    self-loops on vertex 0 (no-ops in every edge-sum)."""
    e = np.asarray(edges)
    w = np.asarray(weights)
    padn = (-len(e)) % n_devices
    if padn:
        e = np.concatenate([e, np.zeros((padn, 2), e.dtype)])
        w = np.concatenate([w, np.zeros(padn, w.dtype)])
    return e, w


@partial(jax.jit, static_argnames=("mesh", "outer_iters", "cg_iters"))
def arap_solve_sharded(prob: ARAPProblem, *, mesh: Mesh,
                       outer_iters: int = 5, cg_iters: int = 200,
                       tol: float = 1e-4) -> jnp.ndarray:
    """Edge-sharded ARAP local-global solve (same math as
    solvers/deformation.arap_solve)."""
    rest = prob.rest
    nv = rest.shape[0]
    free = ~prob.constrained

    def shard_fn(edges, w, rest, targets, constrained):
        free_l = ~constrained
        i, j = edges[:, 0], edges[:, 1]

        def edge_sum3(contrib_i, contrib_j):
            acc = jnp.zeros((nv,) + contrib_i.shape[1:])
            acc = acc.at[i].add(contrib_i)
            acc = acc.at[j].add(contrib_j)
            return jax.lax.psum(acc, "views")

        deg = edge_sum3(w[:, None], w[:, None])[:, 0]
        dinv = jnp.where(free_l, 1.0 / jnp.maximum(deg, 1e-9), 1.0)

        def lap(pv):
            diff = w[:, None] * (pv[i] - pv[j])
            return edge_sum3(diff, -diff)

        def lap_free(x):
            return jnp.where(free_l[:, None],
                             lap(jnp.where(free_l[:, None], x, 0.0)), 0.0)

        p = jnp.where(constrained[:, None], targets, rest)

        def outer(it, p):
            # local: rotation fit per vertex from edge contributions
            gd = rest[i] - rest[j]
            pd = p[i] - p[j]
            contrib = w[:, None, None] * gd[:, :, None] * pd[:, None, :]
            S = jnp.zeros((nv, 3, 3)).at[i].add(contrib).at[j].add(contrib)
            S = jax.lax.psum(S, "views")
            # SAME rotation-fitting helper as the single-device solver —
            # the solver family must share one math policy (round-2 verdict)
            R = fit_rotation(S)

            # global: rhs from rotated rest edges
            Rij = 0.5 * (R[i] + R[j])
            rot_gd = w[:, None] * jnp.einsum("eab,eb->ea", Rij, gd,
                                             precision="highest")
            b = edge_sum3(rot_gd, -rot_gd)
            b = b - lap(jnp.where(constrained[:, None], p, 0.0))
            b = jnp.where(free_l[:, None], b, 0.0)

            # CG (replicated state; matvec uses the psum'd Laplacian)
            x = jnp.where(free_l[:, None], p, 0.0)
            r = b - lap_free(x)
            z = dinv[:, None] * r
            pdir = z
            rz = jnp.vdot(r, z)

            def body(state):
                x, r, z, pdir, rz, k = state
                Ap = lap_free(pdir)
                alpha = rz / jnp.maximum(jnp.vdot(pdir, Ap), 1e-20)
                x = x + alpha * pdir
                r = r - alpha * Ap
                z = dinv[:, None] * r
                rz2 = jnp.vdot(r, z)
                beta = rz2 / jnp.maximum(rz, 1e-20)
                return x, r, z, z + beta * pdir, rz2, k + 1

            def cond(state):
                _, r, _, _, _, k = state
                return (k < cg_iters) & (jnp.linalg.norm(r) > tol)

            x, *_ = jax.lax.while_loop(cond, body,
                                       (x, r, z, pdir, rz, 0))
            return jnp.where(free_l[:, None], x, p)

        return jax.lax.fori_loop(0, outer_iters, outer, p)

    espec = P("views")
    rspec = P()
    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(espec, espec, rspec, rspec, rspec),
        out_specs=rspec,
    )(prob.edges, prob.weights, prob.rest, prob.targets, prob.constrained)

"""Block-partitioned deformation graph: vertex blocks + halo exchange.

SURVEY §2's parallelism table specifies the deformation-graph solve as
"partition deformation-graph nodes into blocks per device; Gauss-Newton
matvecs use halo exchange along graph cuts; global reductions via psum".
parallel/arap_dist.py shards the EDGE work but replicates all vertex state;
this module is the memory-scaling layout:

  - VERTICES are partitioned into contiguous index blocks of size B = V/D
    (mesh vertex order is locality-preserving for grid meshes and
    UniformSampling graphs, so cuts are small).
  - Each device owns its block's state ([B,3] positions etc. — sharded,
    not replicated) plus the edges whose FIRST endpoint it owns.
  - The halo is explicit: each device publishes only its boundary vertices
    (those referenced by another device's edges). One all_gather of the
    [Hmax,3] published rows per matvec is the halo exchange; reverse
    contributions (edge sums landing on remote endpoints) ride one psum of
    the [D,Hmax,...] slot table. Per-device memory is
    O(V/D + D*Hmax) — ~1/D for graphs with small cuts — versus O(V)
    replicated.

Math is identical to solvers/deformation.arap_solve (local-global ARAP,
Jacobi-preconditioned CG); golden-tested against it.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..solvers.deformation import fit_rotation


class ARAPBlockProblem(NamedTuple):
    """All arrays carry a leading device axis D (shard along 'views')."""
    rest: jnp.ndarray          # [D,B,3]
    targets: jnp.ndarray       # [D,B,3]
    constrained: jnp.ndarray   # [D,B] bool
    edge_codes: jnp.ndarray    # [D,Em,2] i32 local codes (see _code)
    weights: jnp.ndarray       # [D,Em] f32 (0 = padding)
    pub: jnp.ndarray           # [D,Hmax] i32 local indices of published
    n_vertices: int            # original V (for unpadding)


def build_blocks(rest, edges, weights, constrained, targets,
                 n_devices: int) -> ARAPBlockProblem:
    """Host-side partitioner: contiguous vertex blocks, edge ownership by
    first endpoint, published-boundary/halo addressing."""
    rest = np.asarray(rest, np.float32)
    targets = np.asarray(targets, np.float32)
    constrained = np.asarray(constrained, bool)
    edges = np.asarray(edges, np.int64)
    weights = np.asarray(weights, np.float32)
    V = len(rest)
    D = n_devices
    B = -(-V // D)
    Vp = B * D

    owner = np.minimum(np.arange(Vp) // B, D - 1)
    eo = owner[edges[:, 0]]

    # published set per device: owned vertices referenced by foreign edges
    # (vectorized: endpoints whose owner differs from their edge's owner)
    vs = edges.ravel()
    foreign = owner[vs] != np.repeat(eo, 2)
    pub_v = np.unique(vs[foreign])                  # sorted globally ->
    pub_owner = owner[pub_v]                        # sorted per device too
    Hmax = int(np.bincount(pub_owner, minlength=D).max()) if len(pub_v) \
        else 1
    Hmax = max(Hmax, 1)
    slot = np.zeros(Vp, np.int64)
    pub = np.zeros((D, Hmax), np.int32)
    starts = np.searchsorted(pub_owner, np.arange(D))
    sl = np.arange(len(pub_v)) - starts[pub_owner]
    slot[pub_v] = sl
    pub[pub_owner, sl] = pub_v - pub_owner * B

    from ..solvers.ba import _group_ranks
    Em = int(np.bincount(eo, minlength=D).max()) if len(edges) else 1
    Em = max(Em, 1)
    codes = np.zeros((D, Em, 2), np.int32)
    w = np.zeros((D, Em), np.float32)
    rank, _ = _group_ranks(eo, Em)
    order = np.argsort(eo, kind="stable")
    es, rs = edges[order], rank
    dofs = eo[order]
    for c in range(2):
        v = es[:, c]
        codes[dofs, rs, c] = np.where(owner[v] == dofs, v - dofs * B,
                                      B + owner[v] * Hmax + slot[v])
    w[dofs, rs] = weights[order]

    def blk(x, fill=0.0):
        xp = np.full((Vp,) + x.shape[1:], fill, x.dtype)
        xp[:V] = x
        return xp.reshape((D, B) + x.shape[1:])

    con = blk(constrained, fill=True)   # padded vertices pinned
    return ARAPBlockProblem(
        jnp.asarray(blk(rest)), jnp.asarray(blk(targets)),
        jnp.asarray(con), jnp.asarray(codes), jnp.asarray(w),
        jnp.asarray(pub), V)


def arap_solve_blocks(prob: ARAPBlockProblem, *, mesh: Mesh,
                      outer_iters: int = 5, cg_iters: int = 200,
                      tol: float = 1e-4) -> jnp.ndarray:
    """Vertex-block-sharded ARAP local-global solve. Returns [V,3]."""
    out = _solve_blocks_impl(prob, mesh=mesh, outer_iters=outer_iters,
                             cg_iters=cg_iters, tol=tol)
    return out[:prob.n_vertices]


@partial(jax.jit, static_argnames=("mesh", "outer_iters", "cg_iters"))
def _solve_blocks_impl(prob: ARAPBlockProblem, *, mesh: Mesh,
                       outer_iters: int, cg_iters: int,
                       tol: float = 1e-4) -> jnp.ndarray:
    D = mesh.shape["views"]
    B = prob.rest.shape[1]
    Hmax = prob.pub.shape[1]

    def shard_fn(rest, tgt, con, codes, w, pub):
        rest, tgt, con = rest[0], tgt[0], con[0]
        codes, w, pub = codes[0], w[0], pub[0]
        free = ~con
        ei, ej = codes[:, 0], codes[:, 1]

        def ext(x):
            """own block [B,k] -> [B + D*Hmax, k] with the halo gathered."""
            tab = jax.lax.all_gather(x[pub], "views")      # [D,Hmax,k]
            return jnp.concatenate([x, tab.reshape((D * Hmax,) +
                                                   x.shape[1:])])

        def edge_sum(ci, cj):
            """Accumulate per-edge contributions onto OWNED vertices,
            including contributions other devices' edges make to ours
            (reverse halo via one psum of the slot table)."""
            acc = jnp.zeros((B + D * Hmax,) + ci.shape[1:])
            acc = acc.at[ei].add(ci).at[ej].add(cj)
            local = acc[:B]
            remote = jax.lax.psum(
                acc[B:].reshape((D, Hmax) + ci.shape[1:]), "views")
            mine = remote[jax.lax.axis_index("views")]
            return local.at[pub].add(mine)

        deg = edge_sum(w[:, None], w[:, None])[:, 0]
        dinv = jnp.where(free, 1.0 / jnp.maximum(deg, 1e-9), 1.0)

        rest_e = ext(rest)
        gd = rest_e[ei] - rest_e[ej]

        def lap(pv):
            pe = ext(pv)
            diff = w[:, None] * (pe[ei] - pe[ej])
            return edge_sum(diff, -diff)

        def lap_free(x):
            return jnp.where(free[:, None],
                             lap(jnp.where(free[:, None], x, 0.0)), 0.0)

        def pdot(a, b):
            return jax.lax.psum(jnp.vdot(a, b), "views")

        p = jnp.where(con[:, None], tgt, rest)

        def outer(it, p):
            # local step: per-vertex rotation fit (S needs the halo too)
            pe = ext(p)
            pd = pe[ei] - pe[ej]
            contrib = w[:, None, None] * gd[:, :, None] * pd[:, None, :]
            S = edge_sum(contrib, contrib)
            # SAME rotation-fitting helper as the single-device solver —
            # the solver family must share one math policy (round-2 verdict)
            R = fit_rotation(S)

            # global step rhs: averaged endpoint rotations on rest edges
            Re = ext(R.reshape(B, 9)).reshape(-1, 3, 3)
            Rij = 0.5 * (Re[ei] + Re[ej])
            rot_gd = w[:, None] * jnp.einsum("eab,eb->ea", Rij, gd,
                                             precision="highest")
            b = edge_sum(rot_gd, -rot_gd)
            b = b - lap(jnp.where(con[:, None], p, 0.0))
            b = jnp.where(free[:, None], b, 0.0)

            x = jnp.where(free[:, None], p, 0.0)
            r = b - lap_free(x)
            z = dinv[:, None] * r
            pdir = z
            rz = pdot(r, z)

            def body(state):
                x, r, z, pdir, rz, k = state
                Ap = lap_free(pdir)
                alpha = rz / jnp.maximum(pdot(pdir, Ap), 1e-20)
                x = x + alpha * pdir
                r = r - alpha * Ap
                z = dinv[:, None] * r
                rz2 = pdot(r, z)
                beta = rz2 / jnp.maximum(rz, 1e-20)
                return x, r, z, z + beta * pdir, rz2, k + 1

            def cond(state):
                _, r, _, _, _, k = state
                return (k < cg_iters) & (jnp.sqrt(pdot(r, r)) > tol)

            x, *_ = jax.lax.while_loop(cond, body, (x, r, z, pdir, rz, 0))
            return jnp.where(free[:, None], x, p)

        out = jax.lax.fori_loop(0, outer_iters, outer, p)
        return out[None]

    dspec = P("views")
    out = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(dspec,) * 6,
        out_specs=dspec,
    )(prob.rest, prob.targets, prob.constrained, prob.edge_codes,
      prob.weights, prob.pub)
    return out.reshape(D * B, 3)


def per_device_state_bytes(prob: ARAPBlockProblem) -> int:
    """Vertex-state working-set bytes PER DEVICE (block + halo table) —
    the quantity that must scale ~1/D vs the replicated solver's V."""
    D, B = prob.rest.shape[:2]
    Hmax = prob.pub.shape[1]
    return (B + D * Hmax) * 3 * 4

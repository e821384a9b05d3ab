"""Distributed bundle adjustment: point-sharded Schur reduction over psum.

The BASELINE north-star pattern: "views/keyframes ... partitioned per host,
distributed BA ... via Schur-complement reduction over psum/all-gather
collectives". Sharding layout:

  - POINTS (and their observation lists) are sharded across the mesh's
    'views' axis — each device owns a contiguous point block with all of
    that point's observations (per-point grouping is what the Schur cross
    terms need, so this layout makes the reduction local-then-psum).
  - CAMERAS are replicated (6C dof is tiny).
  - Each device assembles its partial reduced camera system S_part/b_part;
    one psum produces the full S on every device; the dense solve is
    replicated; point back-substitution is local to each shard.

The observation data here uses a per-point padded layout [P, M] (camera id,
uv, mask per slot) rather than solvers/ba.py's flat [O] layout — the
grouped layout IS the distribution strategy. A golden test checks the
sharded solve matches the single-device solver (SURVEY §4: "sharded
BA/deformation solve matches the unsharded solve").
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..solvers.ba import BAState, rodrigues, _residual_one


class BAPointBlocks(NamedTuple):
    """Per-point grouped observations, padded to [P, M]."""
    K: jnp.ndarray          # [3,3]
    cam_of: jnp.ndarray     # [P,M] int32 camera per obs slot
    uv: jnp.ndarray         # [P,M,2]
    mask: jnp.ndarray       # [P,M] bool
    fixed_cams: jnp.ndarray  # [C] bool


def group_by_point(K, cam_idx, pt_idx, uv, n_points, n_cams,
                   max_obs_per_point=16, fixed_cams=(0,)) -> BAPointBlocks:
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv, np.float32)
    cam_of = np.zeros((n_points, max_obs_per_point), np.int32)
    uvp = np.zeros((n_points, max_obs_per_point, 2), np.float32)
    mask = np.zeros((n_points, max_obs_per_point), bool)
    # vectorized group-by-point (same capacity semantics as the old
    # per-observation loop: first max_obs per point, observation order)
    from ..solvers.ba import _group_ranks
    slot, keep = _group_ranks(pt_idx, max_obs_per_point)
    obs_ids = np.argsort(pt_idx, kind="stable")
    sel = obs_ids[keep]
    cam_of[pt_idx[sel], slot[keep]] = cam_idx[sel]
    uvp[pt_idx[sel], slot[keep]] = uv[sel]
    mask[pt_idx[sel], slot[keep]] = True
    fc = np.zeros(n_cams, bool)
    fc[list(fixed_cams)] = True
    return BAPointBlocks(jnp.asarray(K, jnp.float32), jnp.asarray(cam_of),
                         jnp.asarray(uvp), jnp.asarray(mask),
                         jnp.asarray(fc))


def _point_block_terms(K, rvec, tvec, points, cam_of, uv, mask, lam):
    """Per-point-shard GN terms (scatter-free matmul assembly, shared with
    the single-chip solver — solvers/ba.py::_grouped_schur_terms).
    points [p,3] local; cam_of/uv/mask [p,M]. Returns PARTIAL
    (S [C,C,6,6], b [C,6]) — valid to psum across point shards — plus the
    local back-substitution operands (Hpp_inv, W, bp, onehot)."""
    from ..solvers.ba import _grouped_schur_terms
    num_cams = rvec.shape[0]
    return _grouped_schur_terms(K, rvec, tvec, points, cam_of, uv, mask,
                                lam, num_cams)


@partial(jax.jit, static_argnames=("mesh", "num_cams"))
def gn_step_sharded(prob: BAPointBlocks, st: BAState, lam, *, mesh: Mesh,
                    num_cams: int) -> BAState:
    """One damped GN/Schur step with points sharded over mesh axis 'views'."""

    def shard_fn(K, cam_of, uv, mask, fixed, rvec, tvec, points):
        S, b, Hpp_inv, W, bp, oh = _point_block_terms(
            K, rvec, tvec, points, cam_of, uv, mask, lam)
        # global reduction of the camera system across point shards
        S = jax.lax.psum(S, "views")
        b = jax.lax.psum(b, "views")
        S = S + lam * jnp.eye(6)[None, None] * jnp.eye(num_cams)[
            :, :, None, None]

        ffree = (~fixed).astype(S.dtype)
        S = S * ffree[:, None, None, None] * ffree[None, :, None, None]
        S = S.at[jnp.arange(num_cams), jnp.arange(num_cams)].add(
            jnp.eye(6) * fixed[:, None, None])
        b = b * ffree[:, None]

        Sd = S.transpose(0, 2, 1, 3).reshape(num_cams * 6, num_cams * 6)
        dc = jnp.linalg.solve(Sd + 1e-9 * jnp.eye(num_cams * 6),
                              b.reshape(-1)).reshape(num_cams, 6)
        dc = dc * ffree[:, None]

        # local point back-substitution
        from ..solvers.ba import back_substitute_points
        dp = back_substitute_points(W, Hpp_inv, bp, oh, dc)
        return dc, points + dp

    pspec = P("views")
    rspec = P()
    dc, new_pts = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(rspec, pspec, pspec, pspec, rspec, rspec, rspec, pspec),
        out_specs=(rspec, pspec),
    )(prob.K, prob.cam_of, prob.uv, prob.mask, prob.fixed_cams,
      st.rvec, st.tvec, st.points)

    return BAState(st.rvec + dc[:, :3], st.tvec + dc[:, 3:], new_pts)


def reprojection_rmse_blocks(prob: BAPointBlocks, st: BAState):
    def one(pt, c, uv1, m):
        r = _residual_one(prob.K, st.rvec[c], st.tvec[c], pt, uv1)
        return jnp.where(m, (r ** 2).sum(), 0.0)
    e = jax.vmap(lambda p, cs, us, ms: jax.vmap(
        lambda c, u, m: one(p, c, u, m))(cs, us, ms))(
        st.points, prob.cam_of, prob.uv, prob.mask)
    n = jnp.maximum(prob.mask.sum(), 1)
    return jnp.sqrt(e.sum() / (2 * n))


@partial(jax.jit, static_argnames=("mesh", "iters", "num_cams"))
def _solve_ba_sharded_device(prob: BAPointBlocks, st: BAState, lam0, *,
                             mesh: Mesh, iters: int, num_cams: int):
    """The ENTIRE LM loop as one shard_map program: per iteration the
    partial camera system psums across point shards, the reduced solve and
    damping control replicate, and point updates stay local. One dispatch
    per solve: a host accept/reject loop would sync twice per step."""

    def shard_fn(K, cam_of, uv, mask, fixed, rvec, tvec, points, lam0):
        def rmse_local(rvec, tvec, points):
            def one(pt, c, uv1, m):
                r = _residual_one(K, rvec[c], tvec[c], pt, uv1)
                return jnp.where(m, (r ** 2).sum(), 0.0)
            e = jax.vmap(lambda p, cs, us, ms: jax.vmap(
                lambda c, u, m: one(p, c, u, m))(cs, us, ms))(
                points, cam_of, uv, mask)
            ssum = jax.lax.psum(e.sum(), "views")
            n = jax.lax.psum(mask.sum(), "views")
            return jnp.sqrt(ssum / (2 * jnp.maximum(n, 1)))

        def step(rvec, tvec, points, lam):
            S, b, Hpp_inv, W, bp, oh = _point_block_terms(
                K, rvec, tvec, points, cam_of, uv, mask, lam)
            S = jax.lax.psum(S, "views")
            b = jax.lax.psum(b, "views")
            S = S + lam * jnp.eye(6)[None, None] * jnp.eye(num_cams)[
                :, :, None, None]
            ffree = (~fixed).astype(S.dtype)
            S = S * ffree[:, None, None, None] * ffree[None, :, None, None]
            S = S.at[jnp.arange(num_cams), jnp.arange(num_cams)].add(
                jnp.eye(6) * fixed[:, None, None])
            b = b * ffree[:, None]
            Sd = S.transpose(0, 2, 1, 3).reshape(num_cams * 6, num_cams * 6)
            dc = jnp.linalg.solve(Sd + 1e-9 * jnp.eye(num_cams * 6),
                                  b.reshape(-1)).reshape(num_cams, 6)
            dc = dc * ffree[:, None]
            from ..solvers.ba import back_substitute_points
            dp = back_substitute_points(W, Hpp_inv, bp, oh, dc)
            return rvec + dc[:, :3], tvec + dc[:, 3:], points + dp

        def body(carry):
            rvec, tvec, points, best, lam, it = carry
            rv2, tv2, pt2 = step(rvec, tvec, points, lam)
            err = rmse_local(rv2, tv2, pt2)
            acc = err < best
            rvec = jnp.where(acc, rv2, rvec)
            tvec = jnp.where(acc, tv2, tvec)
            points = jnp.where(acc, pt2, points)
            best = jnp.where(acc, err, best)
            lam = jnp.where(acc, jnp.maximum(lam * 0.5, 1e-7),
                            jnp.minimum(lam * 4.0, 1e3))
            return rvec, tvec, points, best, lam, it + 1

        def cond(carry):
            *_, lam, it = carry
            return (it < iters) & (lam < 1e3)

        best0 = rmse_local(rvec, tvec, points)
        rvec, tvec, points, best, _, _ = jax.lax.while_loop(
            cond, body, (rvec, tvec, points, best0, lam0, jnp.int32(0)))
        return rvec, tvec, points, best

    pspec = P("views")
    rspec = P()
    rvec, tvec, points, best = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(rspec, pspec, pspec, pspec, rspec, rspec, rspec, pspec,
                  rspec),
        out_specs=(rspec, rspec, pspec, rspec),
    )(prob.K, prob.cam_of, prob.uv, prob.mask, prob.fixed_cams,
      st.rvec, st.tvec, st.points, jnp.asarray(lam0, jnp.float32))
    return BAState(rvec, tvec, points), best


def solve_ba_sharded(prob: BAPointBlocks, st: BAState, mesh: Mesh, *,
                     iters: int = 20, lam0: float = 1e-3
                     ) -> Tuple[BAState, float]:
    """Sharded LM solve: one dispatch, damping control on device; the
    single host sync is the final RMSE fetch."""
    num_cams = st.rvec.shape[0]
    st, best = _solve_ba_sharded_device(prob, st, lam0, mesh=mesh,
                                        iters=iters, num_cams=num_cams)
    return st, float(best)

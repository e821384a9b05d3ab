"""Bundle adjustment: Gauss-Newton / LM with Schur-complement reduction.

The reference has no BA — its pose estimation is a greedy per-pair RANSAC
SRT chain (Processor.cpp:813-826). BASELINE's north star requires "camera
pose estimation and bundle adjustment over the view graph ... distributed BA
and deformation solves via Schur-complement reduction over psum/all-gather".
This module is the single-chip core; ``parallel/ba_dist.py`` shards the
observation set and psum-reduces the camera system.

Formulation (textbook BA, batched):
  - cameras: axis-angle rotation + translation (6 dof each), fixed K
  - points: free 3D positions
  - residuals: pinhole reprojection errors, one [O] batch
  - per-observation Jacobians by autodiff (jacfwd of the scalar-obs
    residual, vmapped) — no hand-derived derivatives to get wrong
  - normal equations assembled SCATTER-FREE in a per-point grouped [P,M]
    layout: camera-indexed reductions (H_cc, b_c, the Schur cross blocks)
    are one-hot einsums, and the cross term
    S = H_cc - sum_p (W Hpp^-1)(p) W(p)^T collapses to ONE large matmul
    [6C, 3P] @ [3P, 6C] (in place of a [P,M,M,6,6] scatter-add: 37.7M
    scattered elements at the 64-cam/16k-pt shape).
    The point blocks H_pp [P,3,3] invert batched; the reduced system
    (6C x 6C, small) solves dense, or sharded with a psum in
    parallel/ba_dist.py which reuses the same grouped assembly.
All shapes static; masks carry validity. Assembly uses the per-point
observation lists [P, max_obs_per_point]; ``make_problem`` auto-sizes the
capacity to the true per-point maximum by default so the gradient is EXACT
(round-2 advisor: a silent cap biases the fixed point), and warns if an
explicit smaller cap drops observations. To mask outliers after
construction use ``apply_mask`` (keeps the flat mask and the grouped
pt_obs_mask consistent so the optimizer and the RMSE agree on the
observation set).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp


def rodrigues(rvec):
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (exp map).

    Series-safe formulation with the UNNORMALIZED skew matrix so the
    zero-rotation point is smooth (no ||r|| in any denominator — autodiff
    through ||r|| at r=0 produces NaN Jacobians otherwise):
      R = I + A(θ²) K + B(θ²) K², A = sinθ/θ, B = (1-cosθ)/θ².
    """
    rx, ry, rz = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zeros = jnp.zeros_like(rx)
    K = jnp.stack([
        jnp.stack([zeros, -rz, ry], -1),
        jnp.stack([rz, zeros, -rx], -1),
        jnp.stack([-ry, rx, zeros], -1),
    ], -2)
    t2 = jnp.sum(rvec * rvec, axis=-1)[..., None, None]
    small = t2 < 1e-10
    t2s = jnp.where(small, 1.0, t2)        # double-where: safe denominator
    t = jnp.sqrt(t2s)
    A = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(t) / t)
    B = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(t)) / t2s)
    eye = jnp.eye(3, dtype=rvec.dtype)
    return eye + A * K + B * jnp.matmul(K, K, precision="highest")


class BAProblem(NamedTuple):
    K: jnp.ndarray          # [3,3] shared intrinsics
    cam_idx: jnp.ndarray    # [O] int32
    pt_idx: jnp.ndarray     # [O] int32
    uv: jnp.ndarray         # [O,2] observed pixels
    mask: jnp.ndarray       # [O] bool
    # per-point padded observation lists for the Schur cross terms:
    pt_obs: jnp.ndarray     # [P,M] int32 indices into the obs arrays
    pt_obs_mask: jnp.ndarray  # [P,M] bool
    fixed_cams: jnp.ndarray   # [C] bool — gauge fixing (e.g. camera 0)
    # grouped observation data (gathered once on the host so the device
    # step never scatters/gathers through the flat arrays):
    cam_of: jnp.ndarray     # [P,M] int32 camera of each obs slot
    uv_g: jnp.ndarray       # [P,M,2] observed pixels per slot


class BAState(NamedTuple):
    rvec: jnp.ndarray       # [C,3]
    tvec: jnp.ndarray       # [C,3]
    points: jnp.ndarray     # [P,3]


def _group_ranks(group_of: np.ndarray, capacity: int):
    """For each element of a stable sort by ``group_of``: its rank within
    its group and a mask of ranks below ``capacity``. Shared by the BA
    assemblers here and in parallel/ba_dist.py."""
    order = np.argsort(group_of, kind="stable")
    gs = np.asarray(group_of)[order]
    n = len(gs)
    starts = np.zeros(n, np.int64)
    if n:
        firsts = np.r_[0, np.flatnonzero(gs[1:] != gs[:-1]) + 1]
        starts[firsts] = firsts
        starts = np.maximum.accumulate(starts)
    rank = (np.arange(n) - starts).astype(np.int32)
    return rank, rank < capacity


def make_problem(K, cam_idx, pt_idx, uv, n_points, max_obs_per_point=None,
                 fixed_cams=None, n_cams=None) -> BAProblem:
    """Host-side assembly of the static problem structure.

    ``max_obs_per_point=None`` (default) sizes the grouped layout to the
    TRUE per-point maximum so no observation is dropped and the assembled
    gradient is exact. An explicit smaller cap trades memory for a biased
    fixed point on over-observed tracks — it warns when it drops
    observations (round-2 advisor finding)."""
    import warnings
    cam_idx = np.asarray(cam_idx, np.int32)
    pt_idx = np.asarray(pt_idx, np.int32)
    uv = np.asarray(uv, np.float32)
    O = len(cam_idx)
    counts = np.bincount(pt_idx, minlength=n_points) if O else \
        np.zeros(n_points, np.int64)
    true_max = max(int(counts.max(initial=0)), 1)
    if max_obs_per_point is None:
        max_obs_per_point = true_max
    elif max_obs_per_point < true_max:
        dropped = int(np.maximum(counts - max_obs_per_point, 0).sum())
        warnings.warn(
            f"make_problem: max_obs_per_point={max_obs_per_point} drops "
            f"{dropped} of {O} observations from the normal equations "
            f"(true per-point max {true_max}); the optimum will be biased "
            "on over-observed tracks", stacklevel=2)
    pt_obs = np.zeros((n_points, max_obs_per_point), np.int32)
    pt_obs_mask = np.zeros((n_points, max_obs_per_point), bool)
    # vectorized group-by-point with per-group capacity: stable sort keeps
    # observation order within each point, rank-within-group = position -
    # group start (O(O log O); the per-observation Python loop was minutes
    # at 64-view scale)
    slot, keep = _group_ranks(pt_idx, max_obs_per_point)
    obs_ids = np.argsort(pt_idx, kind="stable").astype(np.int32)
    sel = obs_ids[keep]
    pt_obs[pt_idx[sel], slot[keep]] = sel
    pt_obs_mask[pt_idx[sel], slot[keep]] = True
    cam_of = np.zeros((n_points, max_obs_per_point), np.int32)
    uv_g = np.zeros((n_points, max_obs_per_point, 2), np.float32)
    cam_of[pt_idx[sel], slot[keep]] = cam_idx[sel]
    uv_g[pt_idx[sel], slot[keep]] = uv[sel]
    C = n_cams or int(cam_idx.max()) + 1
    fc = np.zeros(C, bool)
    if fixed_cams is None:
        fc[0] = True
    else:
        fc[np.asarray(fixed_cams)] = True
    return BAProblem(jnp.asarray(K, jnp.float32), jnp.asarray(cam_idx),
                     jnp.asarray(pt_idx), jnp.asarray(uv),
                     jnp.ones(O, bool), jnp.asarray(pt_obs),
                     jnp.asarray(pt_obs_mask), jnp.asarray(fc),
                     jnp.asarray(cam_of), jnp.asarray(uv_g))


def apply_mask(prob: BAProblem, keep) -> BAProblem:
    """Disable observations where ``keep`` [O] is False, CONSISTENTLY: both
    the flat mask (residuals / reprojection_rmse) and the grouped
    pt_obs_mask (normal-equation assembly in gn_step) are updated, so the
    optimizer and the LM accept test see the same observation set. Call
    this instead of ``prob._replace(mask=...)`` (round-2 advisor: a bare
    mask replace left the optimizer fitting the masked observations)."""
    keep = jnp.asarray(keep, bool)
    new_mask = prob.mask & keep
    grouped = prob.pt_obs_mask & new_mask[prob.pt_obs]
    return prob._replace(mask=new_mask, pt_obs_mask=grouped)


def _residual_one(K, rvec, tvec, point, uv):
    R = rodrigues(rvec)
    pc = jnp.matmul(R, point, precision="highest") + tvec
    z = jnp.where(jnp.abs(pc[2]) < 1e-9, 1e-9, pc[2])
    u = K[0, 0] * pc[0] / z + K[0, 2]
    v = K[1, 1] * pc[1] / z + K[1, 2]
    return jnp.stack([u - uv[0], v - uv[1]])


def residuals(prob: BAProblem, st: BAState):
    f = lambda c, p, uv: _residual_one(prob.K, st.rvec[c], st.tvec[c],
                                       st.points[p], uv)
    r = jax.vmap(f)(prob.cam_idx, prob.pt_idx, prob.uv)          # [O,2]
    return jnp.where(prob.mask[:, None], r, 0.0)


def reprojection_rmse(prob: BAProblem, st: BAState) -> jnp.ndarray:
    r = residuals(prob, st)
    n = jnp.maximum(prob.mask.sum(), 1)
    return jnp.sqrt((r ** 2).sum() / (2 * n))


def _skew(v):
    """[...,3] -> [...,3,3] cross-product matrices."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([z, -v[..., 2], v[..., 1]], -1),
        jnp.stack([v[..., 2], z, -v[..., 0]], -1),
        jnp.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _so3_right_jacobian(w):
    """Right Jacobian of the exponential map: R(w + dw) ~= R(w) exp([Jr dw])
    (Taylor-guarded at small angles). [...,3] -> [...,3,3]."""
    th2 = jnp.sum(w * w, axis=-1)
    th = jnp.sqrt(jnp.maximum(th2, 1e-24))
    Kw = _skew(w)
    K2 = jnp.matmul(Kw, Kw, precision="highest")
    small = th < 1e-4
    a = jnp.where(small, 0.5 - th2 / 24.0,
                  (1.0 - jnp.cos(th)) / jnp.maximum(th2, 1e-24))
    b = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                  (th - jnp.sin(th)) / jnp.maximum(th2 * th, 1e-24))
    eye = jnp.broadcast_to(jnp.eye(3), Kw.shape)
    return eye - a[..., None, None] * Kw + b[..., None, None] * K2


def projection_jacobians(K, rvec, tvec, X, uv):
    """Batched ANALYTIC residual + Jacobians of the reprojection residual:
    r [.,2], Jc = dr/d(rvec,tvec) [.,2,6], Jp = dr/dX [.,2,3].

    Replaces the per-observation jacfwd (6+3 dual-number passes of a
    scalar-heavy function): one closed-form chain
      dr/dpc = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
      dpc/dt = I,  dpc/dX = R,  dpc/drvec = -R [X]x Jr(rvec)
    — identical values (regression-tested against jacfwd) at a fraction
    of the op count."""
    R = rodrigues(rvec)
    pc = jnp.einsum("...ij,...j->...i", R, X, precision="highest") + tvec
    z = jnp.where(jnp.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
    fx, fy = K[0, 0], K[1, 1]
    u = fx * pc[..., 0] / z + K[0, 2]
    v = fy * pc[..., 1] / z + K[1, 2]
    r = jnp.stack([u - uv[..., 0], v - uv[..., 1]], -1)

    iz = 1.0 / z
    zero = jnp.zeros_like(iz)
    Jpc = jnp.stack([
        jnp.stack([fx * iz, zero, -fx * pc[..., 0] * iz * iz], -1),
        jnp.stack([zero, fy * iz, -fy * pc[..., 1] * iz * iz], -1)],
        -2)                                            # [.,2,3]
    mm = partial(jnp.matmul, precision="highest")
    Jp = mm(Jpc, R)                                            # [.,2,3]
    Jw = -mm(mm(Jp, _skew(X)), _so3_right_jacobian(rvec))      # [.,2,3]
    Jc = jnp.concatenate([Jw, Jpc], axis=-1)           # [.,2,6]
    return r, Jc, Jp


def inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det). Purely elementwise
    so XLA fuses it — jnp.linalg.inv lowers batched small matrices to a
    general LU path. Used for the
    damped SPD point blocks (det > 0 by construction)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30,
                              jnp.where(det < 0, -1e-30, 1e-30), det)
    adj = jnp.stack([
        jnp.stack([A00, A01, A02], -1),
        jnp.stack([A10, A11, A12], -1),
        jnp.stack([A20, A21, A22], -1)], -2)
    return adj * inv_det[..., None, None]


def _grouped_schur_terms(K, rvec, tvec, points, cam_of, uv, mask, lam,
                         num_cams: int):
    """Scatter-free Schur-term assembly in the per-point grouped layout.

    Inputs: camera params [C,·], a (possibly local/sharded) point block
    ``points`` [p,3] with its observation slots cam_of/uv/mask [p,M,·].
    Every camera-indexed reduction is a one-hot einsum and the cross term
    is a single [6C, 3p] @ [3p, 6C] matmul, so the step contains NO
    scatter/gather ops. Shared by the
    single-chip step (gn_step) and the psum-sharded step
    (parallel/ba_dist.py — returns PARTIAL S/b, valid to psum).

    Returns (S [C,C,6,6] incl. undamped H_cc on the diagonal, b [C,6],
    Hpp_inv [p,3,3], W [p,M,6,3], bp [p,3], onehot [p,M,C]).
    """
    hi = jax.lax.Precision.HIGHEST
    oh = (jnp.where(mask, cam_of, num_cams)[..., None] ==
          jnp.arange(num_cams)).astype(jnp.float32)        # [p,M,C]
    # camera params per slot via one-hot matmul (tiny; avoids row gathers)
    rv = jnp.einsum("pmc,ci->pmi", oh, rvec, precision=hi)
    tv = jnp.einsum("pmc,ci->pmi", oh, tvec, precision=hi)
    r, Jc, Jp = projection_jacobians(
        K, rv, tv, jnp.broadcast_to(points[:, None, :], cam_of.shape + (3,)),
        uv)
    mm = mask.astype(r.dtype)
    r = r * mm[..., None]
    Jc = Jc * mm[..., None, None]
    Jp = Jp * mm[..., None, None]
    # r [p,M,2], Jc [p,M,2,6], Jp [p,M,2,3]

    Hpp = jnp.einsum("pmai,pmaj->pij", Jp, Jp, precision=hi) + \
        lam * jnp.eye(3)
    Hpp_inv = inv3x3(Hpp)
    bp = -jnp.einsum("pmai,pma->pi", Jp, r, precision=hi)
    W = jnp.einsum("pmai,pmaj->pmij", Jc, Jp, precision=hi)  # [p,M,6,3]
    Y = jnp.einsum("pmij,pjk->pmik", W, Hpp_inv, precision=hi)  # [p,M,6,3]

    # H_cc and b_c: one-hot reductions over observation slots
    HccO = jnp.einsum("pmai,pmaj->pmij", Jc, Jc, precision=hi)
    Hcc = jnp.einsum("pmc,pmij->cij", oh, HccO, precision=hi)
    bcO = -jnp.einsum("pmai,pma->pmi", Jc, r, precision=hi)
    bc = jnp.einsum("pmc,pmi->ci", oh, bcO, precision=hi)

    # cross term: accumulate Y and W per (point, camera), then one matmul
    #   S_cross[c,d] = sum_p G_y[p,c] G_w[p,d]^T
    Gy = jnp.einsum("pmc,pmik->pcik", oh, Y, precision=hi)  # [p,C,6,3]
    Gw = jnp.einsum("pmc,pmik->pcik", oh, W, precision=hi)
    Ay = Gy.transpose(1, 2, 0, 3).reshape(num_cams * 6, -1)  # [6C, 3p]
    Aw = Gw.transpose(1, 2, 0, 3).reshape(num_cams * 6, -1)
    cross = jnp.matmul(Ay, Aw.T, precision=hi)
    cross = cross.reshape(num_cams, 6, num_cams, 6).transpose(0, 2, 1, 3)

    S = (-cross).at[jnp.arange(num_cams), jnp.arange(num_cams)].add(Hcc)
    # reduced rhs: b = bc - sum_p G_y[p,c] bp_p
    red = jnp.matmul(Ay, bp.reshape(-1), precision=hi).reshape(num_cams, 6)
    return S, bc - red, Hpp_inv, W, bp, oh


def back_substitute_points(W, Hpp_inv, bp, oh, delta_c):
    """dp = Hpp^-1 (bp - sum_{obs} W^T dc), camera gather as one-hot."""
    hi = jax.lax.Precision.HIGHEST
    dc_of = jnp.einsum("pmc,ci->pmi", oh, delta_c, precision=hi)  # [p,M,6]
    WTdc = jnp.einsum("pmik,pmi->pmk", W, dc_of, precision=hi)
    return jnp.einsum("pij,pj->pi", Hpp_inv, bp - WTdc.sum(1), precision=hi)


def _gn_step_impl(prob: BAProblem, st: BAState, lam: jnp.ndarray, *,
                  num_cams: int, num_points: int
                  ) -> Tuple[BAState, jnp.ndarray]:
    """One damped GN step via the Schur complement (traceable body —
    called from the jitted gn_step AND from inside solve_ba's on-device
    LM while_loop). Returns (new state, step norm for LM control)."""
    S, b_s, Hpp_inv, W, bp, oh = _grouped_schur_terms(
        prob.K, st.rvec, st.tvec, st.points, prob.cam_of, prob.uv_g,
        prob.pt_obs_mask, lam, num_cams)

    # LM damping on the camera blocks (H_pp damped inside the assembly)
    S = S.at[jnp.arange(num_cams), jnp.arange(num_cams)].add(
        lam * jnp.eye(6))

    # gauge fixing: zero out fixed cameras' rows/cols, identity diagonal
    fixed = prob.fixed_cams
    ffree = (~fixed).astype(S.dtype)
    S = S * ffree[:, None, None, None] * ffree[None, :, None, None]
    S = S.at[jnp.arange(num_cams), jnp.arange(num_cams)].add(
        jnp.eye(6) * fixed[:, None, None])
    b_s = b_s * ffree[:, None]

    # dense solve of the reduced system (6C x 6C)
    Sd = S.transpose(0, 2, 1, 3).reshape(num_cams * 6, num_cams * 6)
    delta_c = jnp.linalg.solve(
        Sd + 1e-9 * jnp.eye(num_cams * 6),
        b_s.reshape(-1)).reshape(num_cams, 6)
    delta_c = delta_c * ffree[:, None]

    delta_p = back_substitute_points(W, Hpp_inv, bp, oh, delta_c)

    new = BAState(st.rvec + delta_c[:, :3], st.tvec + delta_c[:, 3:],
                  st.points + delta_p)
    return new, jnp.sqrt((delta_c ** 2).sum() + (delta_p ** 2).sum())


gn_step = partial(jax.jit, static_argnames=("num_cams", "num_points"))(
    _gn_step_impl)


@partial(jax.jit, static_argnames=("iters", "num_cams", "num_points"))
def _solve_ba_device(prob: BAProblem, st: BAState, lam0, *, iters: int,
                     num_cams: int, num_points: int):
    """The whole LM loop as ONE device program: accept/reject damping is
    pure arithmetic, so it lives in a lax.while_loop carry instead of a
    host loop that would sync on float(rmse) every iteration."""

    def body(carry):
        st, best, lam, it = carry
        cand, _ = _gn_step_impl(prob, st, lam, num_cams=num_cams,
                                num_points=num_points)
        err = reprojection_rmse(prob, cand)
        acc = err < best
        st = jax.tree_util.tree_map(
            lambda c, s: jnp.where(acc, c, s), cand, st)
        best = jnp.where(acc, err, best)
        lam = jnp.where(acc, jnp.maximum(lam * 0.5, 1e-7),
                        jnp.minimum(lam * 4.0, 1e3))
        return st, best, lam, it + 1

    def cond(carry):
        _, _, lam, it = carry
        return (it < iters) & (lam < 1e3)

    best0 = reprojection_rmse(prob, st)
    st, best, _, _ = jax.lax.while_loop(
        cond, body, (st, best0, jnp.asarray(lam0, jnp.float32), 0))
    return st, best


def solve_ba(prob: BAProblem, st: BAState, *, iters: int = 20,
             lam0: float = 1e-3, verbose: bool = False
             ) -> Tuple[BAState, float]:
    """LM solve: one dispatch, damping control on device. The single host
    sync is the final RMSE fetch."""
    num_cams = st.rvec.shape[0]
    num_points = st.points.shape[0]
    st, best = _solve_ba_device(prob, st, lam0, iters=iters,
                                num_cams=num_cams, num_points=num_points)
    best = float(best)
    if verbose:
        print(f"  BA: rmse {best:.4f} after <= {iters} LM iters")
    return st, best

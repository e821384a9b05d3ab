"""Similarity-transform (s, R, t) estimation: batched Kabsch + vmapped RANSAC.

Re-design of Solver/SRTSolver.{h,cpp}: the reference runs ``iter_num``
serial RANSAC iterations, each doing a 3-point Eigen SVD and a full-match
residual loop (EstimateRTRansac, SRTSolver.cpp:131-185). Here all hypotheses
are one vmapped batch: K index-triples are drawn at once, K 3x3 SVDs run
batched, and the [K, M] residual matrix reduces with a single argmin —
the whole solve is one fused XLA program.

Math matches the reference:
  scale  = mean(|p2_i - c2| / |p1_i - c1|)                (SRTSolver.cpp:31-46)
  R      = Kabsch on scaled centered points, det-reflection fix
                                                          (SRTSolver.cpp:65-129)
  t      = c2 - s R c1
  residual = mean over matches of 0.5*(px err in cam2 of s R p1 + t vs p2
             + px err in cam1 of (1/s) R^T (p2 - t) vs p1), with the
             reference's integer pixel rounding              (SRTSolver.cpp:6-29)
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.cameras import CameraBatch, project
from ..core.transforms import Similarity

_EPS = 1e-12


def _masked_mean(x, mask, axis=None):
    m = mask.astype(x.dtype)
    return (x * m).sum(axis) / jnp.maximum(m.sum(axis), 1.0)


def _masked_median(x, mask, axis=0):
    """Median over valid entries along ``axis`` (invalid sorted to +inf,
    middle of the valid prefix indexed; averages the two middles)."""
    mask = jnp.broadcast_to(mask, x.shape)
    n = jnp.maximum(mask.sum(axis), 1)
    r = jnp.sort(jnp.where(mask, x, jnp.inf), axis=axis)
    size = x.shape[axis]
    lo = jnp.clip((n - 1) // 2, 0, size - 1)
    hi = jnp.clip(n // 2, 0, size - 1)
    rlo = jnp.take_along_axis(r, jnp.expand_dims(lo, axis), axis=axis)
    rhi = jnp.take_along_axis(r, jnp.expand_dims(hi, axis), axis=axis)
    return jnp.squeeze(0.5 * (rlo + rhi), axis=axis)


def estimate_scale(p1, p2, mask) -> jnp.ndarray:
    """Ratio of distances to barycenters (SRTSolver.cpp:31-46), aggregated
    by MASKED MEDIAN rather than the reference's mean: the mean is a single
    shared estimate feeding every RANSAC hypothesis, so one gross outlier
    match corrupts the scale no matter how many iterations run (measured:
    30% uniform outliers pushed the mean ratio 1.2 -> 2.6). The median
    matches the mean on clean data and survives <50% contamination —
    a deliberate robustness upgrade over SRTSolver.cpp:44 (round-3;
    tests/test_noise_robustness.py). Exactly: two MAD-gated passes —
    mean-center ratios, median pilot + 5-MAD gate to drop gross outliers,
    then recompute the mean centers and the mean ratio over the gated
    inliers. Mean centers (not coordinate-wise medians) are load-bearing:
    they correspond under the similarity (c2 = sRc1+t), making clean-data
    ratios exactly s; the second pass restores that exactness once the
    outliers are gone, while the gate keeps everything on clean data
    (preserving the reference's estimate bit-for-bit there)."""
    def ratios(m):
        c1 = _masked_mean(p1, m[:, None], axis=0)
        c2 = _masked_mean(p2, m[:, None], axis=0)
        d1 = jnp.linalg.norm(p1 - c1, axis=-1)
        d2 = jnp.linalg.norm(p2 - c2, axis=-1)
        return d2 / jnp.maximum(d1, _EPS)

    def gated(ratio, m):
        pilot = _masked_median(ratio, m)
        mad = _masked_median(jnp.abs(ratio - pilot), m)
        return m & (jnp.abs(ratio - pilot) <=
                    jnp.maximum(5.0 * mad, 1e-3 * jnp.abs(pilot)))

    gate = gated(ratios(mask), mask)
    ratio2 = ratios(gate)
    gate2 = gated(ratio2, gate)
    return _masked_mean(ratio2, gate2)


def kabsch_rt(p1, p2, weights, scale) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted Kabsch: R,t minimizing |s R p1 + t - p2| over weighted pairs.

    Matches EstimateRT (SRTSolver.cpp:65-129): covariance S = X Y^T with
    X = s*(p1-c1), Y = (p2-c2); SVD(S) = U Σ V^T; R = V U^T with
    det-reflection fix; t = c2 - s R c1.  Batched over leading dims.
    """
    w = weights[..., :, None]
    wsum = jnp.maximum(w.sum(-2, keepdims=True), _EPS)
    c1 = (p1 * w).sum(-2, keepdims=True) / wsum
    c2 = (p2 * w).sum(-2, keepdims=True) / wsum
    X = (p1 - c1) * jnp.asarray(scale)[..., None, None]
    Y = p2 - c2
    # full f32 accumulation: the covariance reduction spans every point, and
    # reduced-precision operands (bf16/TF32) lose enough bits to
    # deorthogonalize R
    S = jnp.einsum("...ni,...nj->...ij", X * w, Y,
                   precision=jax.lax.Precision.HIGHEST)
    U, _, Vt = jnp.linalg.svd(S)
    V = jnp.swapaxes(Vt, -1, -2)
    det = jnp.linalg.det(jnp.einsum("...ij,...kj->...ik", V, U,
                                    precision="highest"))
    D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], -1)
    R = jnp.einsum("...ij,...j,...kj->...ik", V, D, U, precision="highest")
    t = (c2[..., 0, :] -
         jnp.asarray(scale)[..., None] *
         jnp.einsum("...ij,...j->...i", R, c1[..., 0, :], precision="highest"))
    return R, t


def _round_px(x):
    return jnp.floor(x + 0.5)


def residual_error(T: Similarity, p1, p2, mask, cam1: CameraBatch,
                   cam2: CameraBatch) -> jnp.ndarray:
    """Symmetric mean pixel reprojection error (SRTSolver.cpp:6-29).
    T batch dims broadcast; returns error per batch element."""
    fwd = (jnp.asarray(T.s)[..., None, None] *
           jnp.einsum("...ij,...nj->...ni", T.R, p1,
                      precision="highest") + T.t[..., None, :])
    uv_f, _ = project(cam2, fwd)
    uv_2, _ = project(cam2, p2)
    e1 = jnp.linalg.norm(_round_px(uv_f) - _round_px(uv_2), axis=-1)

    inv_s = 1.0 / jnp.asarray(T.s)
    bwd = inv_s[..., None, None] * jnp.einsum(
        "...ji,...nj->...ni", T.R, p2 - T.t[..., None, :], precision="highest")
    uv_b, _ = project(cam1, bwd)
    uv_1, _ = project(cam1, p1)
    e2 = jnp.linalg.norm(_round_px(uv_b) - _round_px(uv_1), axis=-1)
    return _masked_mean(0.5 * (e1 + e2), mask, axis=-1)


def per_match_errors(T: Similarity, p1, p2, cam1, cam2):
    """Both directional pixel errors per match (for outlier pruning,
    Processor.cpp:210-239). Returns (err_fwd [M], err_bwd [M])."""
    fwd = T.s * jnp.einsum("ij,nj->ni", T.R, p1, precision="highest") + T.t
    uv_f, _ = project(cam2, fwd)
    uv_2, _ = project(cam2, p2)
    e1 = jnp.linalg.norm(_round_px(uv_f) - _round_px(uv_2), axis=-1)
    bwd = (1.0 / T.s) * jnp.einsum("ji,nj->ni", T.R, p2 - T.t,
                                   precision="highest")
    uv_b, _ = project(cam1, bwd)
    uv_1, _ = project(cam1, p1)
    e2 = jnp.linalg.norm(_round_px(uv_b) - _round_px(uv_1), axis=-1)
    return e1, e2


@partial(jax.jit, static_argnames=("iter_num",))
def estimate_srt_ransac(
    p1: jnp.ndarray,           # [M,3] points in frame 1
    p2: jnp.ndarray,           # [M,3] matched points in frame 2
    mask: jnp.ndarray,         # [M] bool valid matches
    cam1: CameraBatch,
    cam2: CameraBatch,
    key: jax.Array,
    *,
    iter_num: int = 200,
) -> Tuple[Similarity, jnp.ndarray]:
    """RANSAC similarity solve, all hypotheses batched.

    Equivalent of EstimateTransformRansac (SRTSolver.cpp:277-280): scale from
    all matches, then iter_num 3-point hypotheses scored by symmetric pixel
    residual over all matches; returns (best Similarity, best residual).
    """
    m = p1.shape[0]
    scale = estimate_scale(p1, p2, mask)

    # sample 3 valid indices per hypothesis (Gumbel top-k over valid mask ==
    # uniform sample without replacement, one shot for all hypotheses)
    g = jax.random.gumbel(key, (iter_num, m))
    g = jnp.where(mask[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, 3)                       # [K,3]

    q1 = p1[idx]                                       # [K,3,3]
    q2 = p2[idx]
    w = jnp.ones(q1.shape[:-1], p1.dtype)
    R, t = kabsch_rt(q1, q2, w, scale)                 # [K,3,3], [K,3]
    Ts = Similarity(jnp.broadcast_to(scale, (iter_num,)), R, t)
    # hypothesis SELECTION by least-median-of-squares (LMedS): the
    # reference scores by the unbounded mean (SRTSolver.cpp:6-29), which
    # gross outliers turn into noise that swamps the inlier signal — the
    # median is outlier-free for <50% contamination and equals the mean
    # ranking on clean data. The RETURNED residual stays the reference's
    # mean formula on the winner, so keyframe selection (min residual
    # across edges, Processor.cpp:750-765) keeps parity semantics.
    e1, e2 = _per_match_errors_batched(Ts, p1, p2, cam1, cam2)
    per = 0.5 * (e1 + e2)                              # [K,M]
    per = jnp.where(mask[None, :], per, jnp.inf)
    m_valid = jnp.maximum(mask.sum(), 1)
    srt = jnp.sort(per, axis=-1)
    mid = jnp.clip((m_valid - 1) // 2, 0, m - 1)
    med = srt[:, mid]
    best = jnp.argmin(med)
    best_T = Ts[best]
    best_err = residual_error(best_T, p1, p2, mask, cam1, cam2)
    return best_T, best_err


def _per_match_errors_batched(Ts: Similarity, p1, p2, cam1, cam2):
    """per_match_errors over a batch of hypotheses: ([K,M], [K,M])."""
    s = jnp.asarray(Ts.s)[..., None, None]
    fwd = s * jnp.einsum("...ij,nj->...ni", Ts.R, p1,
                         precision="highest") + Ts.t[..., None, :]
    uv_f, _ = project(cam2, fwd)
    uv_2, _ = project(cam2, p2)
    e1 = jnp.linalg.norm(_round_px(uv_f) - _round_px(uv_2)[None], axis=-1)
    bwd = (1.0 / s) * jnp.einsum("...ji,...nj->...ni", Ts.R,
                                 p2[None] - Ts.t[..., None, :],
                                 precision="highest")
    uv_b, _ = project(cam1, bwd)
    uv_1, _ = project(cam1, p1)
    e2 = jnp.linalg.norm(_round_px(uv_b) - _round_px(uv_1)[None], axis=-1)
    return e1, e2


def estimate_srt(p1, p2, mask, scale=None) -> Similarity:
    """Non-RANSAC solve over all (masked) matches (EstimateTransform,
    SRTSolver.cpp:274-276)."""
    s = estimate_scale(p1, p2, mask) if scale is None else scale
    R, t = kabsch_rt(p1, p2, mask.astype(p1.dtype), s)
    return Similarity(s, R, t)


@partial(jax.jit, static_argnames=("iter_num", "rounds"))
def remove_outliers(
    p1, p2, mask, cam1: CameraBatch, cam2: CameraBatch, key,
    *,
    pixel_err: float,
    adapt_ratio: float,
    iter_num: int = 200,
    rounds: int = 3,
) -> Tuple[jnp.ndarray, Similarity, jnp.ndarray]:
    """The reference's adaptive outlier-pruning loop (RemoveOutliers,
    Processor.cpp:177-259): `rounds` rounds of {RANSAC fit -> drop matches
    whose either directional pixel error exceeds pixel_err * ratio}, with
    ratio shrinking by adapt_ratio each round. Returns (mask, T, residual).
    """
    ratio = 1.0
    T = Similarity.identity()
    res = jnp.asarray(jnp.inf, p1.dtype)
    for r in range(rounds):
        key, sub = jax.random.split(key)
        T, res = estimate_srt_ransac(p1, p2, mask, cam1, cam2, sub,
                                     iter_num=iter_num)
        e1, e2 = per_match_errors(T, p1, p2, cam1, cam2)
        thr = pixel_err * ratio
        new_mask = mask & (e1 <= thr) & (e2 <= thr)
        # keep pruning only while >=3 matches remain (Processor.cpp:258)
        mask = jnp.where(new_mask.sum() >= 3, new_mask, mask)
        ratio = ratio * adapt_ratio
    return mask, T, res

"""Essential-matrix RANSAC match filter (the reference's experimental
'Parsac' path).

Re-design of Processor::RemoveOutliersParsac (Processor.cpp:271-378, marked
"being tested", Processor.h:39-41): 8-point essential-matrix hypotheses over
normalized camera rays, scored NOT by inlier count but by the inlier set's
covariance area (sqrt det of the 2D pixel covariance) — the hypothesis with
the most spatially COMPACT inlier set wins. Kept for behavioral parity; all
hypotheses run as one vmapped batch of 8x9 SVDs on device.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


def _eight_point(y1, y2):
    """E from 8 normalized correspondences (rows of the constraint matrix
    as in Processor.cpp:296-308), rank-2 projected."""
    Y = jnp.stack([
        y2[:, 0] * y1[:, 0], y2[:, 0] * y1[:, 1], y2[:, 0],
        y2[:, 1] * y1[:, 0], y2[:, 1] * y1[:, 1], y2[:, 1],
        y1[:, 0], y1[:, 1], jnp.ones_like(y1[:, 0]),
    ], axis=1)                                   # [8,9]
    _, _, Vt = jnp.linalg.svd(Y, full_matrices=True)
    E = Vt[8].reshape(3, 3)
    U, s, Vt2 = jnp.linalg.svd(E)
    S = jnp.asarray([1.0, 1.0, 0.0], E.dtype)    # reference forces (1,1,0)
    return jnp.matmul(U * S[None, :], Vt2, precision="highest")


def _epipolar_err(E, y1, y2):
    """|y2^T E y1| per match (algebraic error, Processor.cpp:330)."""
    return jnp.abs(jnp.einsum("ni,ij,nj->n", y2, E, y1, precision="highest"))


@partial(jax.jit, static_argnames=("iters", "score"))
def remove_outliers_essential(
    rays1: jnp.ndarray,       # [M,3] normalized cam rays (x/z, y/z, 1)
    rays2: jnp.ndarray,
    uv1: jnp.ndarray,         # [M,2] pixel coords (for covariance scoring)
    uv2: jnp.ndarray,
    mask: jnp.ndarray,        # [M]
    key: jax.Array,
    *,
    iters: int = 50,
    pixel_err: float = 0.3,
    score: str = "count",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (new_mask, E_best, mean_err).

    score="area" reproduces the reference's experimental criterion exactly
    (smallest inlier covariance area in both images, Processor.cpp:340-359)
    — which degenerates on tight thresholds (it rewards tiny clustered
    inlier sets; likely why the reference left the path disabled).
    score="count" (default) is the standard max-inlier criterion."""
    m = rays1.shape[0]

    g = jax.random.gumbel(key, (iters, m))
    g = jnp.where(mask[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, 8)                       # [K,8]

    Es = jax.vmap(lambda ii: _eight_point(rays1[ii], rays2[ii]))(idx)

    def score_area(E):
        err = _epipolar_err(E, rays1, rays2)
        inl = mask & (err <= pixel_err)
        n = jnp.maximum(inl.sum(), 1)
        w = inl.astype(uv1.dtype)

        def cov_area(uv):
            c = (uv * w[:, None]).sum(0) / n
            d = (uv - c) * w[:, None]
            C = jnp.matmul(d.T, d, precision="highest") / jnp.maximum(
                n - 1, 1)
            return jnp.sqrt(jnp.maximum(jnp.linalg.det(C), 0.0))

        a1 = cov_area(uv1)
        a2 = cov_area(uv2)
        # hypotheses with <2 inliers are unusable (Processor.cpp:340)
        bad = inl.sum() < 2
        big = jnp.asarray(jnp.inf, uv1.dtype)
        return jnp.where(bad, big, a1), jnp.where(bad, big, a2)

    if score == "area":
        a1s, a2s = jax.vmap(score_area)(Es)
        # reference keeps hypotheses improving BOTH areas; argmin of the
        # max-of-areas reproduces that preference deterministically
        best = jnp.argmin(jnp.maximum(a1s, a2s))
    else:
        counts = jax.vmap(lambda E: (mask & (
            _epipolar_err(E, rays1, rays2) <= pixel_err)).sum())(Es)
        best = jnp.argmax(counts)
    E = Es[best]
    err = _epipolar_err(E, rays1, rays2)
    new_mask = mask & (err <= pixel_err)
    mean_err = jnp.where(mask, err, 0.0).sum() / jnp.maximum(mask.sum(), 1)
    return new_mask, E, mean_err


def rays_from_pixels(uv, K):
    """Pixel coords [M,2] -> normalized rays (x/z, y/z, 1) via K^-1 —
    equivalent to the reference's GetPointCam + divide by z
    (Processor.cpp:281-285) for points on the image plane."""
    x = (uv[:, 0] - K[0, 2]) / K[0, 0]
    y = (uv[:, 1] - K[1, 2]) / K[1, 1]
    return jnp.stack([x, y, jnp.ones_like(x)], -1)

"""Point-set PCA utilities (PointSetUtils re-design).

Replaces SetUtils/PointSetUtils.{h,cpp}: barycenter/AABB
(PointSetUtils.cpp:43-62) and CalcPivots — eigenvectors of the 3x3
covariance in descending eigenvalue order (PointSetUtils.cpp:9-41) — as
one-liner jnp.linalg.eigh calls, batched/vmapped when needed (SURVEY §2).
"""

from __future__ import annotations

import jax.numpy as jnp


def barycenter(points, mask=None):
    if mask is None:
        return points.mean(axis=-2)
    m = mask[..., None].astype(points.dtype)
    return (points * m).sum(-2) / jnp.maximum(m.sum(-2), 1.0)


def aabb(points, mask=None):
    if mask is None:
        return points.min(-2), points.max(-2)
    big = jnp.asarray(jnp.inf, points.dtype)
    lo = jnp.where(mask[..., None], points, big).min(-2)
    hi = jnp.where(mask[..., None], points, -big).max(-2)
    return lo, hi


def pivots(points, mask=None):
    """Principal axes as COLUMNS of a 3x3 matrix, descending eigenvalue
    order (CalcPivots, PointSetUtils.cpp:9-41). Returns (P, eigvals, center).
    Sign convention matches eigh (arbitrary, like Eigen's) — callers fix
    signs against rays exactly as the reference does."""
    c = barycenter(points, mask)
    d = points - c[..., None, :]
    if mask is not None:
        d = d * mask[..., None].astype(points.dtype)
        n = jnp.maximum(mask.sum(-1), 1.0)
    else:
        n = points.shape[-2]
    cov = jnp.einsum("...ni,...nj->...ij", d, d, precision="highest") / n
    w, v = jnp.linalg.eigh(cov)            # ascending
    order = jnp.argsort(-w, axis=-1)
    v = jnp.take_along_axis(v, order[..., None, :], axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    return v, w, c


def extent_along(points, axis_vec, center, mask=None):
    """Signed extent range (min,max) of projections t = axis.(p-c)/|axis|^2,
    the reference's scale measurement (Alignment.cpp:281-296)."""
    t = jnp.einsum("...ni,...i->...n", points - center[..., None, :],
                   axis_vec, precision="highest") / jnp.maximum(
        jnp.sum(axis_vec * axis_vec, -1), 1e-12)[..., None]
    if mask is None:
        return t.min(-1), t.max(-1), t
    big = jnp.asarray(jnp.inf, points.dtype)
    return (jnp.where(mask, t, big).min(-1),
            jnp.where(mask, t, -big).max(-1), t)


def plane_fit(points):
    """LS plane through points via the reference's normal-equation form
    (Alignment.cpp:148-161): solve A x = -b with A = sum p p^T, b = sum p;
    returns (unit normal, d) with plane n.x + d = 0."""
    A = jnp.einsum("ni,nj->ij", points, points, precision="highest")
    b = points.sum(0)
    ans = -jnp.linalg.solve(A, b)
    norm = jnp.linalg.norm(ans)
    d = 1.0 / jnp.maximum(norm, 1e-12)
    n = ans / jnp.maximum(norm, 1e-12)
    return n, d

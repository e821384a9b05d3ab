"""Similarity transforms (s, R, t) and their algebra.

The reference threads (double s, Matrix3d R, Vector3d t) triples through the
pipeline and left-composes them ad hoc (Processor.cpp:819-823:
``R0 <- R*R0, t0 <- s*R*t0 + t, s0 <- s*s0``). Here a Similarity is a small
pytree with batched apply/compose/inverse, so a whole pose chain composes as
one ``lax.associative_scan`` and RANSAC hypotheses vmapped over leading dims.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class Similarity:
    """x -> s * R @ x + t; fields broadcastable with leading batch dims.

    s: [...], R: [...,3,3], t: [...,3]
    """

    def __init__(self, s, R, t):
        self.s = s
        self.R = R
        self.t = t

    def tree_flatten(self):
        return (self.s, self.R, self.t), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "Similarity":
        s = jnp.ones(batch_shape, dtype)
        R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
        t = jnp.zeros(batch_shape + (3,), dtype)
        return Similarity(s, R, t)

    def __getitem__(self, idx) -> "Similarity":
        return Similarity(self.s[idx], self.R[idx], self.t[idx])

    def matrix(self):
        """Return the 4x4 homogeneous matrix [s*R | t; 0 1]."""
        sR = self.s[..., None, None] * self.R
        top = jnp.concatenate([sR, self.t[..., :, None]], axis=-1)
        bshape = jnp.shape(self.s)
        bottom = jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 0.0, 1.0], top.dtype), bshape + (1, 4))
        return jnp.concatenate([top, bottom], axis=-2)


def apply(T: Similarity, pts):
    """Apply x -> s R x + t. T's batch dims must broadcast against the
    leading dims of pts [...,3] (e.g. unbatched T with [N,3] points, or
    [K]-batched T with [K,N,3] points after expanding T to [K,1])."""
    rotated = jnp.einsum("...ij,...j->...i", T.R, pts, precision="highest")
    return jnp.asarray(T.s)[..., None] * rotated + T.t


def apply_points(T: Similarity, pts):
    """Apply a single (unbatched) similarity to points [N,3] (or [...,3])."""
    return T.s * jnp.einsum("ij,...j->...i", T.R, pts,
                            precision="highest") + T.t


def rotate_normals(T: Similarity, normals):
    """Transform unit normals (rotation only; uniform scale preserves them).
    Matches the reference's normal handling at Processor.cpp:1024-1027."""
    return jnp.einsum("ij,...j->...i", T.R, normals, precision="highest")


def compose(A: Similarity, B: Similarity) -> Similarity:
    """Composition (A ∘ B)(x) = A(B(x)).

    Matches the reference's left-compose update (Processor.cpp:819-823) with
    A the newly solved transform and B the accumulated one:
      s = sA*sB, R = RA@RB, t = sA*RA@tB + tA.
    """
    s = A.s * B.s
    R = jnp.einsum("...ij,...jk->...ik", A.R, B.R, precision="highest")
    t = (A.s[..., None] * jnp.einsum("...ij,...j->...i", A.R, B.t,
                                     precision="highest")) + A.t
    return Similarity(s, R, t)


def inverse(T: Similarity) -> Similarity:
    """Inverse: x -> 1/s R^T (x - t). Used by Render's model-to-sequence
    inverse map p_k = 1/s_k R_k^T (p - t_k) (Processor.cpp:1171-1189)."""
    s = 1.0 / T.s
    R = jnp.swapaxes(T.R, -1, -2)
    t = -s[..., None] * jnp.einsum("...ij,...j->...i", R, T.t,
                                   precision="highest")
    return Similarity(s, R, t)


def chain(transforms: Similarity) -> Similarity:
    """Given per-edge transforms T_k (leading axis K) mapping frame k to
    frame k+1, return cumulative transforms mapping frame 0..K into frame K
    via an associative scan (replaces the serial loop Processor.cpp:819-823).

    Returns batch of K+1 transforms; entry k maps sequence-k coords into the
    final (sequence K) frame. Entry K is identity.
    """
    def comb(a, b):
        # After reversal, scan element a (earlier in scan order) is the
        # *later* pipeline transform, i.e. the outer function: a ∘ b.
        return (a[0] * b[0],
                jnp.einsum("...ij,...jk->...ik", a[1], b[1],
                           precision="highest"),
                a[0][..., None] * jnp.einsum("...ij,...j->...i", a[1], b[2],
                                             precision="highest") + a[2])

    # cumulative_k = T_{K-1} ∘ ... ∘ T_k ; compute via reverse scan
    s, R, t = transforms.s, transforms.R, transforms.t
    rev = (s[::-1], R[::-1], t[::-1])
    cs, cR, ct = jax.lax.associative_scan(comb, rev)
    cum = Similarity(cs[::-1], cR[::-1], ct[::-1])
    ident = Similarity.identity((1,), dtype=R.dtype)
    return Similarity(jnp.concatenate([cum.s, ident.s]),
                      jnp.concatenate([cum.R, ident.R]),
                      jnp.concatenate([cum.t, ident.t]))


def rotation_between(a, b, eps: float = 1e-12):
    """Rotation matrix taking direction a to direction b (the reference's
    CalcRotation, Common/Utils.h:140-149: axis = a x b, angle from the dot
    product). Falls back to identity for parallel vectors."""
    a = a / jnp.maximum(jnp.linalg.norm(a, axis=-1, keepdims=True), eps)
    b = b / jnp.maximum(jnp.linalg.norm(b, axis=-1, keepdims=True), eps)
    axis = jnp.cross(a, b)
    s = jnp.linalg.norm(axis, axis=-1)
    c = jnp.sum(a * b, axis=-1)
    angle = jnp.arctan2(s, c)
    safe_axis = jnp.where(s[..., None] > eps, axis / jnp.maximum(
        s[..., None], eps), jnp.asarray([1.0, 0.0, 0.0], a.dtype))
    R = rotation_about_axis(safe_axis, angle)
    # antiparallel: rotate pi about any perpendicular axis
    perp = jnp.cross(a, jnp.asarray([1.0, 0.0, 0.0], a.dtype))
    perp2 = jnp.cross(a, jnp.asarray([0.0, 1.0, 0.0], a.dtype))
    perp = jnp.where(jnp.linalg.norm(perp, axis=-1, keepdims=True) > 1e-6,
                     perp, perp2)
    perp = perp / jnp.maximum(jnp.linalg.norm(perp, axis=-1, keepdims=True),
                              eps)
    R_pi = rotation_about_axis(perp, jnp.asarray(jnp.pi, a.dtype))
    anti = (s <= eps) & (c < 0)
    return jnp.where(anti[..., None, None], R_pi,
                     jnp.where((s <= eps)[..., None, None],
                               jnp.eye(3, dtype=a.dtype), R))


def rotation_about_axis(axis, angle):
    """Rodrigues rotation matrix about unit axis [...,3] by angle [...] (rad).

    Equivalent of Common/Utils.h:124-149 (RotationMatrix) used for virtual
    view synthesis (Image3D.cpp:131-144).
    """
    axis = jnp.asarray(axis)
    angle = jnp.asarray(angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c, s = jnp.cos(angle), jnp.sin(angle)
    C = 1.0 - c
    R = jnp.stack([
        jnp.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], -1),
        jnp.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], -1),
        jnp.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], -1),
    ], axis=-2)
    return R

"""Descriptor matching as one matmul per view pair.

Replacement for the reference's SiftMatchGPU wrapper (MatchFeature,
FeatureProc.cpp:77-130): descriptor distances become one [K1,128]x[128,K2]
matmul per view pair (the all-pairs loop FeatureProc.cpp:123-128 becomes a
batched einsum), followed by the same acceptance rule SiftMatchGPU applies:
best-match distance threshold (``distmax``), Lowe ratio test (``ratiomax``)
and mutual-best consistency.

Descriptors are L2-normalized, so squared distance = 2 - 2*dot and both
thresholds translate to dot-product space exactly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Matches(NamedTuple):
    idx1: jnp.ndarray   # [M] indices into set 1
    idx2: jnp.ndarray   # [M] indices into set 2
    valid: jnp.ndarray  # [M] bool


@partial(jax.jit, static_argnames=("mutual",))
def match_descriptors(
    d1: jnp.ndarray, v1: jnp.ndarray,     # [K1,128], [K1] bool
    d2: jnp.ndarray, v2: jnp.ndarray,     # [K2,128], [K2] bool
    *,
    distmax: float = 0.7,
    ratiomax: float = 0.8,
    mutual: bool = False,
) -> Matches:
    """Match normalized descriptors; returns one candidate per set-1 keypoint
    with a validity mask (fixed capacity K1).

    mutual=False matches SiftMatchGPU's acceptance rule exactly (distmax +
    ratio only, FeatureProc.cpp:83-90). The optional mutual-best check
    raises precision a few points but interacts badly with dual-orientation
    duplicate keypoints (the back-pointer lands on the twin copy) and costs
    measurable recall — the downstream dedup/SSD/gap/RANSAC cascade is the
    reference's outlier defense, not the matcher."""
    # dot products; invalid columns forced to -1 (max distance). HIGHEST:
    # a TF32 product (~3 decimal digits) would move the ratio test
    dots = jnp.dot(d1, d2.T, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)
    dots = jnp.where(v1[:, None] & v2[None, :], dots, -1.0)

    top2, top2_idx = jax.lax.top_k(dots, 2)          # [K1,2]
    best = top2[:, 0]
    second = top2[:, 1]
    dist_best = jnp.sqrt(jnp.maximum(2.0 - 2.0 * best, 0.0))
    dist_second = jnp.sqrt(jnp.maximum(2.0 - 2.0 * second, 0.0))

    ok = (best > -1.0) & (dist_best <= distmax)
    ok &= dist_best <= ratiomax * dist_second

    rows = jnp.arange(d1.shape[0])
    if mutual:
        # mutual-best: set-2's best for the chosen column must be this row
        back_best = jnp.argmax(dots, axis=0)         # [K2]
        ok &= back_best[top2_idx[:, 0]] == rows
    ok &= v1
    return Matches(rows, top2_idx[:, 0], ok)


def match_all_pairs(desc1, valid1, desc2, valid2, **kw):
    """All view-pair matching: desc1 [V1,K,128] x desc2 [V2,K,128] ->
    Matches with leading dims [V1,V2] (the reference's m1*m2 loop,
    FeatureProc.cpp:123-128, as a double vmap)."""
    f = lambda a, va, b, vb: match_descriptors(a, va, b, vb, **kw)
    g = jax.vmap(lambda a, va: jax.vmap(
        lambda b, vb: f(a, va, b, vb))(desc2, valid2))
    return g(desc1, valid1)

"""Virtual-view synthesis by homography warp (the reference's GenNewViews).

Re-design of Image3D::GenNewViews (Image3D.cpp:109-222): for each of
``view_count`` angles about the camera's ``axis``-th basis vector, the
reference builds H = K * R(angle) * K^-1, inverse-warps over a 2x-expanded
destination grid, re-centers the valid region, bilinear-resamples the RGB
image, and keeps a ``texIndex`` map from each synthesized pixel back to its
nearest source pixel (used later to dedup matches, Processor.cpp:649-680).

Here all views are one vmapped jitted op over the angle batch: the serial
per-pixel double loop becomes gathers + elementwise math. Semantics match:
same H, same 2x expanded grid with the same centering rule, same bilinear
weights, same nearest-pixel texIndex convention (-1 = unmapped).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.transforms import rotation_about_axis


class SynthViews(NamedTuple):
    images: jnp.ndarray      # [V,H,W,C] warped views (0 outside coverage)
    tex_index: jnp.ndarray   # [V,H,W] i32 source pixel id v*W+u, -1 invalid


def view_angles(view_count: int, rot_angle_deg: float):
    """The reference's angle list (Image3D.cpp:131-133):
    [-a*(c/2), ..., -a, 0, a, ..., a*(c/2)] covering view_count entries."""
    half = view_count // 2
    return jnp.asarray(
        [-rot_angle_deg * i for i in range(half, 0, -1)] +
        [rot_angle_deg * i for i in range(0, half + 1)],
        jnp.float32)[:view_count] * (jnp.pi / 180.0)


def bilinear_sample(srcs: jnp.ndarray, sy: jnp.ndarray, sx: jnp.ndarray):
    """Exact 4-tap bilinear sampling of srcs [C,H,W] at continuous source
    coords sy/sx [Ho,Wo] (edge-clamped) -> [C,Ho,Wo]."""
    _, h, w = srcs.shape
    x0f = jnp.clip(jnp.floor(sx), 0.0, w - 2)
    y0f = jnp.clip(jnp.floor(sy), 0.0, h - 2)
    fx = jnp.clip(sx - x0f, 0.0, 1.0)
    fy = jnp.clip(sy - y0f, 0.0, 1.0)
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    v00 = srcs[:, y0, x0]
    v01 = srcs[:, y0, x0 + 1]
    v10 = srcs[:, y0 + 1, x0]
    v11 = srcs[:, y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) +
            v10 * (1 - fx) * fy + v11 * fx * fy)


@partial(jax.jit, static_argnames=("axis",))
def synthesize_views(
    image: jnp.ndarray,        # [H,W,C] float
    K: jnp.ndarray,            # [3,3]
    R: jnp.ndarray,            # [3,3] camera rotation (world->cam rows)
    angles: jnp.ndarray,       # [V] radians
    *,
    axis: int = 1,
) -> SynthViews:
    h, w = image.shape[:2]
    # rotation axis = camera's axis-th basis vector in world coords
    # (Image3D.cpp:129: R.row(axis))
    ax = R[axis, :]
    Kinv = jnp.asarray(
        [[1.0 / K[0, 0], 0.0, -K[0, 2] / K[0, 0]],
         [0.0, 1.0 / K[1, 1], -K[1, 2] / K[1, 1]],
         [0.0, 0.0, 1.0]], K.dtype)                  # (Image3D.cpp:123-126)

    # 2x expanded destination grid with origin shifted by (w/2, h/2)
    # (Image3D.cpp:118-121,152-153: scale=2, u = i%W2 - W2/4)
    w2, h2 = 2 * w, 2 * h
    uu = (jnp.arange(w2, dtype=jnp.float32) - w * 0.5)
    vv = (jnp.arange(h2, dtype=jnp.float32) - h * 0.5)
    gv, gu = jnp.meshgrid(vv, uu, indexing="ij")      # [H2,W2]

    imgs_chw = jnp.moveaxis(image.astype(jnp.float32), -1, 0)  # [C,H,W]

    def warp_field(Hm, gu_, gv_):
        wf = Hm[2, 0] * gu_ + Hm[2, 1] * gv_ + Hm[2, 2]
        uf = (Hm[0, 0] * gu_ + Hm[0, 1] * gv_ + Hm[0, 2]) / wf
        vf = (Hm[1, 0] * gu_ + Hm[1, 1] * gv_ + Hm[1, 2]) / wf
        return uf, vf

    def one_view(angle):
        Rr = rotation_about_axis(ax, angle)
        H = jnp.matmul(jnp.matmul(K, Rr, precision="highest"), Kinv,
                       precision="highest")           # (Image3D.cpp:144)

        # pass 1 (elementwise + reductions only, no gathers): centering —
        # bbox (in expanded-grid coords + offset back) of dest pixels
        # whose source lies in range (Image3D.cpp:147-167); the eps
        # absorbs float32 roundoff in H (K@R@Kinv) at the image border
        uf, vf = warp_field(H, gu, gv)
        eps = 1e-3
        inr = ((uf >= -eps) & (uf <= w - 1 + eps) &
               (vf >= -eps) & (vf <= h - 1 + eps))
        gu_abs = gu + w * 0.5
        gv_abs = gv + h * 0.5
        big = jnp.float32(1e9)
        minu = jnp.min(jnp.where(inr, gu_abs, big))
        maxu = jnp.max(jnp.where(inr, gu_abs, -big))
        minv = jnp.min(jnp.where(inr, gv_abs, big))
        maxv = jnp.max(jnp.where(inr, gv_abs, -big))
        # integer centering so the zero-angle view is exactly the identity
        # (the reference's float centering, Image3D.cpp:166-169, carries an
        # intrinsic +1px shift from int truncation — an artifact we fix)
        offx = jnp.floor((maxu + minu) * 0.5 - (w - 1) * 0.5 + 0.5)
        offy = jnp.floor((maxv + minv) * 0.5 - (h - 1) * 0.5 + 0.5)

        # pass 2: evaluate the warp field ONLY on the final [h,w]
        # destination window. Window pixel (r,c) sits at expanded-grid
        # coords (offx + c - w/2, offy + r - h/2) — offx/offy are
        # integer-valued traced scalars, so the window field is analytic
        # and nothing of the 2x grid is ever sampled or sliced (sampling
        # the full 2x grid then slicing would be 4x the gather work).
        cu = jnp.arange(w, dtype=jnp.float32) + (offx - w * 0.5)
        cv = jnp.arange(h, dtype=jnp.float32) + (offy - h * 0.5)
        gvw, guw = jnp.meshgrid(cv, cu, indexing="ij")    # [h,w]
        ufw, vfw = warp_field(H, guw, gvw)
        inrw = ((ufw >= -eps) & (ufw <= w - 1 + eps) &
                (vfw >= -eps) & (vfw <= h - 1 + eps))

        # bilinear sample source at (ufw, vfw) (Image3D.cpp:178-211).
        # Sanitize: wf ~ 0 rows produce inf/NaN coords; they are outside
        # `inrw` (zeroed below) but must not reach the gather's indices.
        ufc = jnp.clip(jnp.where(jnp.isfinite(ufw), ufw, 0.0), 0.0, w - 1.0)
        vfc = jnp.clip(jnp.where(jnp.isfinite(vfw), vfw, 0.0), 0.0, h - 1.0)
        sample = jnp.moveaxis(bilinear_sample(imgs_chw, vfc, ufc), 0, -1)

        # texIndex: nearest source pixel, computed analytically from the
        # window warp field (-1 = unmapped); no gather needed
        tex = jnp.where(inrw,
                        jnp.floor(vfw + 0.5).astype(jnp.int32) * w +
                        jnp.floor(ufw + 0.5).astype(jnp.int32),
                        -1)
        out = jnp.where((tex >= 0)[..., None], sample, 0.0)
        return out, tex

    imgs, tex = jax.vmap(one_view)(angles)
    return SynthViews(imgs, tex)

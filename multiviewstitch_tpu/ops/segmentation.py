"""Foreground segmentation (the reference's GrabCut stand-in).

The reference optionally runs cv::grabCut at half resolution with a margin
rectangle as the foreground prior (Image3D.cpp:23-51, gated by ``Segment``)
to mask background pixels before feature detection. GrabCut's iterated
graph cut is host-serial and needs OpenCV; the jitted stand-in keeps
the same contract — [H,W] boolean foreground mask from an RGB/gray image +
margin rectangle — using a jitted color-model EM over the rectangle prior:

  1. pixels outside the margin rectangle are hard background
  2. k-means-ish EM (fixed iterations) fits fg/bg color clusters seeded by
     the rectangle interior/exterior
  3. per-pixel fg/bg assignment by nearest cluster + spatial smoothing
     (majority filter), mirroring GrabCut's GMM-likelihood + smoothness.

When depth is available (our pipelines always have it), prefer
``foreground_from_disparity`` — the valid-disparity-range test the pipeline
already applies (Image3D.cpp:95-103) IS the robust segmentation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def foreground_from_disparity(disparity, min_dsp: float, max_dsp: float):
    """[.,H,W] disparity -> foreground mask (valid depth range)."""
    return (disparity >= min_dsp) & (disparity <= max_dsp)


@partial(jax.jit, static_argnames=("n_clusters", "iters", "smooth_rounds"))
def segment_foreground(
    image: jnp.ndarray,          # [H,W] gray or [H,W,C]
    *,
    hl: float = 0.1, hr: float = 0.25, vl: float = 0.33, vr: float = 0.25,
    n_clusters: int = 4,
    iters: int = 8,
    smooth_rounds: int = 2,
) -> jnp.ndarray:
    """Margin-rectangle-seeded color EM segmentation -> [H,W] bool."""
    if image.ndim == 2:
        img = image[..., None].astype(jnp.float32)
    else:
        img = image.astype(jnp.float32)
    h, w, c = img.shape
    u = jnp.arange(w)
    v = jnp.arange(h)
    in_rect = ((u[None, :] >= hl * w) & (u[None, :] < w * (1 - hr)) &
               (v[:, None] >= vl * h) & (v[:, None] < h * (1 - vr)))

    flat = img.reshape(-1, c)
    rect = in_rect.reshape(-1)

    def seeded_means(mask_sel, key):
        # quantile-spread seeds from the selected region
        wgt = mask_sel.astype(jnp.float32)
        mu = (flat * wgt[:, None]).sum(0) / jnp.maximum(wgt.sum(), 1.0)
        sd = jnp.sqrt(((flat - mu) ** 2 * wgt[:, None]).sum(0) /
                      jnp.maximum(wgt.sum(), 1.0) + 1e-6)
        offs = jnp.linspace(-1.0, 1.0, n_clusters)[:, None]
        return mu[None, :] + offs * sd[None, :]

    fg_mu = seeded_means(rect, 0)
    bg_mu = seeded_means(~rect, 1)

    def em_round(_, mus):
        fg_mu, bg_mu = mus

        def assign(mu):
            d2 = ((flat[:, None, :] - mu[None]) ** 2).sum(-1)   # [P,K]
            return d2.min(1), d2.argmin(1)

        dfg, afg = assign(fg_mu)
        dbg, abg = assign(bg_mu)
        is_fg = (dfg < dbg) & rect      # outside rect stays background

        def update(mu, asg, sel):
            K = mu.shape[0]
            wsel = sel.astype(jnp.float32)
            acc = jnp.zeros_like(mu).at[asg].add(flat * wsel[:, None])
            cnt = jnp.zeros((K,)).at[asg].add(wsel)
            return jnp.where(cnt[:, None] > 0, acc /
                             jnp.maximum(cnt[:, None], 1.0), mu)

        return (update(fg_mu, afg, is_fg), update(bg_mu, abg, ~is_fg))

    fg_mu, bg_mu = jax.lax.fori_loop(0, iters, em_round, (fg_mu, bg_mu))

    dfg = ((flat[:, None, :] - fg_mu[None]) ** 2).sum(-1).min(1)
    dbg = ((flat[:, None, :] - bg_mu[None]) ** 2).sum(-1).min(1)
    mask = ((dfg < dbg) & rect).reshape(h, w)

    # smoothness: 3x3 majority vote rounds (GrabCut's pairwise term analogue)
    for _ in range(smooth_rounds):
        acc = mask.astype(jnp.float32)
        cnt = jnp.ones_like(acc)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                acc = acc + jnp.roll(jnp.roll(mask.astype(jnp.float32), dy,
                                              0), dx, 1)
                cnt = cnt + 1
        mask = (acc / cnt > 0.5) & in_rect
    return mask


def trim_mesh_by_all_cameras(vertices, faces, normals, transforms,
                             sequences_cams):
    """AllSeqProj trim (Processor.cpp:1064-1102): drop vertices that fall
    outside ANY camera of ANY sequence after inverse-mapping the fused model
    into that sequence's frame; faces reindexed. Host wrapper over a jitted
    all-camera projection test."""
    import numpy as np
    from ..core.cameras import CameraBatch, project
    from ..core.transforms import inverse as sim_inverse

    keep = np.ones(len(vertices), bool)
    v = jnp.asarray(vertices, jnp.float32)
    for T, cams in zip(transforms, sequences_cams):
        inv = sim_inverse(T)
        pts = (jnp.asarray(inv.s) *
               jnp.einsum("ij,nj->ni", inv.R, v, precision="highest") + inv.t)
        camsE = CameraBatch(cams.K[:, None], cams.R[:, None],
                            cams.t[:, None], cams.width, cams.height)
        uv, z = project(camsE, pts[None])
        inb = ((uv[..., 0] >= 0) & (uv[..., 0] <= cams.width - 1) &
               (uv[..., 1] >= 0) & (uv[..., 1] <= cams.height - 1) &
               (z > 0))
        keep &= np.asarray(jnp.all(inb, axis=0))

    remap = np.cumsum(keep) - 1
    fmask = keep[faces].all(1)
    new_faces = remap[faces[fmask]].astype(np.int32)
    new_norms = normals[keep] if normals is not None else None
    return vertices[keep], new_faces, new_norms

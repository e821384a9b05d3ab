"""Cross-view depth-consistency filtering.

Re-design of Processor::CheckConsistency[Core]
(Processor.cpp:29-115): the reference walks every pixel of every frame in
serial C++ (O(h*w*refs) scalar loop), unprojects it, reprojects into the ±1
neighbor frames, and zeroes the disparity unless the round trip lands within
``reproj_err`` pixels and the neighbor pixel is itself valid. Here the whole
sequence is one fused jitted op over ``[N,H,W]`` disparity tensors — the
per-pixel loop becomes batched gathers + elementwise math.

Semantics match the reference exactly:
  - pixel valid iff disparity ∈ [min_dsp, max_dsp]   (Processor.cpp:79)
  - neighbor sampling is nearest (int round)          (Camera.cpp:46-49)
  - a pixel is killed if, for ANY existing neighbor: its projection leaves
    the neighbor image, the neighbor pixel is invalid, the round-trip
    reprojection leaves the current image, or the round-trip pixel error
    exceeds ``reproj_err``                            (Processor.cpp:82-108)
  - neighbors that don't exist (sequence ends) don't participate
                                                      (Processor.cpp:49-55)
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.cameras import CameraBatch, project, unproject, pixel_grid


def gather_frames(imgs, vy, vx):
    """Per-frame nearest gather: imgs [N,H,W] sampled at integer (vy, vx)
    [N,Ho,Wo] within each frame, indices clipped into the image (callers
    mask out-of-image targets themselves). Ho/Wo may differ from H/W
    (strided query grids)."""
    n, h, w = imgs.shape
    frame = jnp.arange(n, dtype=jnp.int32)[:, None, None]
    return imgs[frame, jnp.clip(vy, 0, h - 1), jnp.clip(vx, 0, w - 1)]


def _round_px(x):
    """C++ ``(int)(x + 0.5)`` for the in-bounds positive coords we test."""
    return jnp.floor(x + 0.5).astype(jnp.int32)


def _offset_check(pts, cam_pix: CameraBatch, uv, ndisp, ncams: CameraBatch,
                  *, min_dsp, max_dsp, reproj_err):
    """Round-trip consistency test of every pixel against ONE neighbor
    assignment (Processor.cpp:82-108): project current-frame world points
    [N,H,W,3] into the neighbor cameras, nearest-sample the neighbor
    disparity, unproject, reproject back, threshold the pixel error.
    Shared by the fused sequence op below and the window-sharded variant
    (parallel/view_windows.py). Returns ok [N,H,W]."""
    h, w = ndisp.shape[-2:]
    ncams_pix = CameraBatch(ncams.K[:, None, None], ncams.R[:, None, None],
                            ncams.t[:, None, None], ncams.width,
                            ncams.height)

    # project current-frame points into the neighbor camera
    uvn, zn = project(ncams_pix, pts)
    un, vn = _round_px(uvn[..., 0]), _round_px(uvn[..., 1])
    inb1 = (un >= 0) & (un <= w - 1) & (vn >= 0) & (vn <= h - 1) & (zn > 0)

    # nearest-sample the neighbor disparity (clipped gather; masked later)
    uc = jnp.clip(un, 0, w - 1)
    vc = jnp.clip(vn, 0, h - 1)
    dn = gather_frames(ndisp, vc, uc)
    ref_valid = (dn >= min_dsp) & (dn <= max_dsp)

    # round trip: unproject the neighbor pixel, project into current cam
    uvn_f = jnp.stack([uc, vc], -1).astype(ndisp.dtype)
    ptsn = unproject(ncams_pix, uvn_f, 1.0 / jnp.where(ref_valid, dn, 1.0))
    uvb, zb = project(cam_pix, ptsn)
    ub, vb = _round_px(uvb[..., 0]), _round_px(uvb[..., 1])
    inb2 = (ub >= 0) & (ub <= w - 1) & (vb >= 0) & (vb <= h - 1)

    du = (uv[None, ..., 0].astype(jnp.int32) - ub).astype(ndisp.dtype)
    dv = (uv[None, ..., 1].astype(jnp.int32) - vb).astype(ndisp.dtype)
    err_ok = du * du + dv * dv <= reproj_err * reproj_err
    return inb1 & ref_valid & inb2 & err_ok


@partial(jax.jit, static_argnames=("offsets", "min_dsp", "max_dsp",
                                   "reproj_err"))
def check_consistency(
    disparity: jnp.ndarray,          # [N,H,W] float32
    cams: CameraBatch,               # batch N
    *,
    min_dsp: float,
    max_dsp: float,
    reproj_err: float,
    offsets: Tuple[int, ...] = (-1, 1),
) -> jnp.ndarray:
    """Filter a sequence of disparity maps by cross-view consistency.

    Returns [N,H,W] disparities with inconsistent pixels set to 0
    (the reference's convention for "invalid", Processor.cpp:84-105).
    """
    n, h, w = disparity.shape
    valid = (disparity >= min_dsp) & (disparity <= max_dsp)

    # world point of every pixel of every frame: [N,H,W,3]
    uv = pixel_grid(h, w, disparity.dtype)
    depth = 1.0 / jnp.where(valid, disparity, 1.0)
    cam_pix = CameraBatch(cams.K[:, None, None], cams.R[:, None, None],
                          cams.t[:, None, None], cams.width, cams.height)
    pts = unproject(cam_pix, uv[None], depth)

    keep = valid
    for off in offsets:
        nbr = jnp.clip(jnp.arange(n) + off, 0, n - 1)
        exists = ((jnp.arange(n) + off >= 0) &
                  (jnp.arange(n) + off < n))[:, None, None]
        ncams = CameraBatch(cams.K[nbr], cams.R[nbr], cams.t[nbr],
                            cams.width, cams.height)
        ok = _offset_check(pts, cam_pix, uv, disparity[nbr], ncams,
                           min_dsp=min_dsp, max_dsp=max_dsp,
                           reproj_err=reproj_err)
        keep = keep & jnp.where(exists, ok, True)

    return jnp.where(keep, disparity, 0.0)


def consistency_stats(before: jnp.ndarray, after: jnp.ndarray,
                      min_dsp: float, max_dsp: float):
    """Per-sequence metrics: valid fraction before/after filtering."""
    v0 = ((before >= min_dsp) & (before <= max_dsp)).mean()
    v1 = ((after >= min_dsp) & (after <= max_dsp)).mean()
    return {"valid_before": float(v0), "valid_after": float(v1)}

"""Multi-frame point sampling with normals + confidence (GeoRec part 1).

The reference outsources this to the closed-source ``ZJU::GeoRec`` library
(Reconstruction/GeometryRec.cpp:9-39 forwards: sample radius, disparity
range, max disparity error, min confidence, neighbor frame num/step) which
reads the CHECK-filtered depth maps and emits oriented points
(``Rec/*.npts``: x y z nx ny nz, read back at Processor.cpp:952-964).
No source exists, so this is built from scratch (SURVEY §2 'Geometry
reconstruction backend'): the parameter names dictate the algorithm shape —
multi-frame disparity-agreement voting:

  - sample the pixel grid at ``sample_radius`` stride
  - normal = normalized cross product of the world-space depth-map tangents
    (central differences), oriented to face the camera
  - confidence = fraction of existing neighbor frames (i ± k*step,
    k=1..num) whose rendered disparity at the reprojected pixel agrees
    within ``dsp_err``
  - keep points with confidence >= ``conf_min``
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.cameras import CameraBatch, project, unproject, pixel_grid
from .consistency import gather_frames


class OrientedPoints(NamedTuple):
    points: jnp.ndarray    # [N, S, 3] world points (S = samples per frame)
    normals: jnp.ndarray   # [N, S, 3]
    conf: jnp.ndarray      # [N, S] agreement confidence
    valid: jnp.ndarray     # [N, S] bool


@partial(jax.jit, static_argnames=("min_dsp", "max_dsp", "sample_radius",
                                   "nbr_num", "nbr_step", "dsp_err",
                                   "conf_min"))
def sample_oriented_points(
    disparity: jnp.ndarray,        # [N,H,W]
    cams: CameraBatch,
    *,
    min_dsp: float,
    max_dsp: float,
    sample_radius: int = 2,
    nbr_num: int = 2,
    nbr_step: int = 1,
    dsp_err: float = 0.01,
    conf_min: float = 0.6,
) -> OrientedPoints:
    n, h, w = disparity.shape
    valid = (disparity >= min_dsp) & (disparity <= max_dsp)
    depth = 1.0 / jnp.where(valid, disparity, 1.0)

    cam_pix = CameraBatch(cams.K[:, None, None], cams.R[:, None, None],
                          cams.t[:, None, None], cams.width, cams.height)
    uv = pixel_grid(h, w, disparity.dtype)
    pts = unproject(cam_pix, uv[None], depth)                  # [N,H,W,3]

    # everything below the (cheap, fusable) unprojection runs on the
    # STRIDED sample grid only: votes/normals for pixels the stride would
    # discard are never computed (identical results to computing every
    # pixel and subsampling)
    sub = (slice(None), slice(None, None, sample_radius),
           slice(None, None, sample_radius))
    s_h = len(range(0, h, sample_radius))
    s_w = len(range(0, w, sample_radius))
    pts_s = pts[sub]                                       # [N,Hs,Ws,3]
    valid_s = valid[sub]

    # world-space tangents via central differences (invalid-neighbor
    # aware), evaluated on the full grid then strided before the expensive
    # cross/normalize/orient chain
    def shift(a, dy, dx):
        return jnp.roll(jnp.roll(a, -dy, axis=1), -dx, axis=2)

    du = jnp.where(
        (shift(valid, 0, 1) & shift(valid, 0, -1))[sub][..., None],
        shift(pts, 0, 1)[sub] - shift(pts, 0, -1)[sub], 0.0)
    dv = jnp.where(
        (shift(valid, 1, 0) & shift(valid, -1, 0))[sub][..., None],
        shift(pts, 1, 0)[sub] - shift(pts, -1, 0)[sub], 0.0)
    nrm = jnp.cross(dv, du)
    nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    has_n = (nlen[..., 0] > 1e-12)
    nrm = nrm / jnp.maximum(nlen, 1e-12)
    # orient toward the camera: n . (C - p) > 0
    C = cams.centers()[:, None, None, :]
    flip = jnp.sum(nrm * (C - pts_s), axis=-1) < 0
    nrm = jnp.where(flip[..., None], -nrm, nrm)

    # multi-frame disparity agreement (at sampled pixels)
    votes = jnp.zeros((n, s_h, s_w), disparity.dtype)
    exists_total = jnp.zeros((n, s_h, s_w), disparity.dtype)
    for k in range(1, nbr_num + 1):
        for sgn in (-1, 1):
            off = sgn * k * nbr_step
            nbr = jnp.clip(jnp.arange(n) + off, 0, n - 1)
            exists = ((jnp.arange(n) + off >= 0) &
                      (jnp.arange(n) + off < n)).astype(disparity.dtype)
            ncams = CameraBatch(cams.K[nbr][:, None, None],
                                cams.R[nbr][:, None, None],
                                cams.t[nbr][:, None, None],
                                cams.width, cams.height)
            uvn, zn = project(ncams, pts_s)
            un = jnp.floor(uvn[..., 0] + 0.5).astype(jnp.int32)
            vn = jnp.floor(uvn[..., 1] + 0.5).astype(jnp.int32)
            inb = (un >= 0) & (un <= w - 1) & (vn >= 0) & (vn <= h - 1) & \
                  (zn > 0)
            dn = gather_frames(disparity[nbr], vn, un)
            # the point's disparity as seen from the neighbor camera
            d_proj = jnp.where(zn > 1e-12, 1.0 / jnp.maximum(zn, 1e-12), 0.0)
            agree = inb & (jnp.abs(dn - d_proj) <= dsp_err) & \
                (dn >= min_dsp) & (dn <= max_dsp)
            votes += jnp.where(exists[:, None, None] > 0,
                               agree.astype(disparity.dtype), 0.0)
            exists_total += exists[:, None, None]

    conf = votes / jnp.maximum(exists_total, 1.0)
    # frames with no neighbors at all keep conf 1 (nothing contradicts them)
    conf = jnp.where(exists_total > 0, conf, 1.0)

    keep = valid_s & has_n & (conf >= conf_min)
    return OrientedPoints(
        pts_s.reshape(n, s_h * s_w, 3),
        nrm.reshape(n, s_h * s_w, 3),
        conf.reshape(n, s_h * s_w),
        keep.reshape(n, s_h * s_w))


@partial(jax.jit, static_argnames=())
def visibility_filter(points: jnp.ndarray, valid: jnp.ndarray,
                      cams: CameraBatch) -> jnp.ndarray:
    """Drop points that project outside ANY camera of the rig — the
    reference's per-sequence visibility filter (Processor.cpp:971-1004).
    points [S,3]; cams batch [N]; returns updated valid [S]."""
    camsE = CameraBatch(cams.K[:, None], cams.R[:, None], cams.t[:, None],
                        cams.width, cams.height)
    uv, z = project(camsE, points[None])            # [N,S,2], [N,S]
    inb = ((uv[..., 0] >= 0) & (uv[..., 0] <= cams.width - 1) &
           (uv[..., 1] >= 0) & (uv[..., 1] <= cams.height - 1) & (z > 0))
    return valid & jnp.all(inb, axis=0)

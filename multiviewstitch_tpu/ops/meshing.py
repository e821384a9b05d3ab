"""Depth-map -> grid mesh extraction (the reference's Depth2Model).

Re-design of Depth2Model::SaveModel (Depth2Model.cpp:7-107): the reference
scans pixels serially, numbering valid ones (row-major ``tab``) and emitting
up to two triangles per quad when the three corner disparity deltas are below
``smooth_thres*(max_dsp-min_dsp)/100``. Here both passes are one jitted op:
vertex ids come from an exclusive cumsum over the validity mask and triangles
from vectorized quad-corner tests; compaction uses static-capacity scatters
(fixed shapes for jit) with counts returned alongside.

Vertex order (row-major over valid pixels) and triangle vertex order match
the reference exactly, so OBJ artifacts diff cleanly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.cameras import CameraBatch, unproject, pixel_grid


class GridMesh(NamedTuple):
    """Padded mesh with validity counts (static shapes for jit)."""
    vertices: jnp.ndarray    # [cap_v, 3] f32, padded with 0
    tex_index: jnp.ndarray   # [cap_v] i32 source pixel (v*W+u), -1 padding
    faces: jnp.ndarray       # [cap_f, 3] i32 vertex ids, -1 padding
    num_vertices: jnp.ndarray  # scalar i32
    num_faces: jnp.ndarray     # scalar i32


@partial(jax.jit, static_argnames=("min_dsp", "max_dsp", "smooth_thres",
                                   "edge_sz_thres", "max_faces"))
def grid_mesh(
    disparity: jnp.ndarray,      # [H,W]
    cam: CameraBatch,            # single camera
    *,
    min_dsp: float,
    max_dsp: float,
    smooth_thres: float,
    edge_sz_thres: float = 0.0,  # max 3D edge length; 0 disables
    max_faces: int = 0,          # 0 -> 2*(H-1)*(W-1)
) -> GridMesh:
    h, w = disparity.shape
    cap_v = h * w
    cap_f = max_faces or 2 * (h - 1) * (w - 1)

    # validity: disparity > 0 and inside range (Depth2Model.cpp:31-33)
    d = disparity
    valid = (d > 0) & (d >= min_dsp) & (d <= max_dsp)
    flat_valid = valid.reshape(-1)

    # row-major vertex numbering via exclusive cumsum (== reference `tab`-1)
    ids = jnp.cumsum(flat_valid.astype(jnp.int32)) - 1          # [H*W]
    num_v = flat_valid.sum().astype(jnp.int32)

    # world positions of valid pixels
    uv = pixel_grid(h, w, d.dtype)
    depth = 1.0 / jnp.where(valid, d, 1.0)
    pts = unproject(cam, uv, depth).reshape(-1, 3)

    # compact via scatter: invalid pixels target index cap_v (dropped)
    tgt = jnp.where(flat_valid, ids, cap_v)
    vertices = jnp.zeros((cap_v, 3), d.dtype).at[tgt].set(pts, mode="drop")
    pix = jnp.arange(cap_v, dtype=jnp.int32)
    tex_index = jnp.full((cap_v,), -1, jnp.int32).at[tgt].set(pix, mode="drop")

    # quad tests (Depth2Model.cpp:45-77). threshold on raw disparity deltas.
    thr = smooth_thres * (max_dsp - min_dsp) / 100.0
    d00 = d[:-1, :-1]
    d10 = d[1:, :-1]      # (y+1, x)
    d01 = d[:-1, 1:]      # (y, x+1)
    d11 = d[1:, 1:]       # (y+1, x+1)
    v00 = valid[:-1, :-1]
    v10 = valid[1:, :-1]
    v01 = valid[:-1, 1:]
    v11 = valid[1:, 1:]

    tri1 = (v00 & v11 & v10 &
            (jnp.abs(d00 - d10) <= thr) &
            (jnp.abs(d11 - d10) <= thr) &
            (jnp.abs(d00 - d11) <= thr))
    tri2 = (v00 & v11 & v01 &
            (jnp.abs(d00 - d01) <= thr) &
            (jnp.abs(d11 - d01) <= thr) &
            (jnp.abs(d11 - d00) <= thr))

    if edge_sz_thres and edge_sz_thres > 0:
        # EdgeSzThres (config.txt / GeometryRec.cpp:30-39): reject triangles
        # with any 3D edge longer than the threshold — the world-space
        # counterpart of the disparity-delta smoothness test above
        P = pts.reshape(h, w, 3)
        p00, p10 = P[:-1, :-1], P[1:, :-1]
        p01, p11 = P[:-1, 1:], P[1:, 1:]

        def _short(a, b):
            return jnp.sum((a - b) ** 2, axis=-1) <= edge_sz_thres ** 2

        tri1 = tri1 & _short(p00, p10) & _short(p10, p11) & _short(p00, p11)
        tri2 = tri2 & _short(p00, p11) & _short(p11, p01) & _short(p00, p01)

    id2 = ids.reshape(h, w)
    i00, i10, i01, i11 = id2[:-1, :-1], id2[1:, :-1], id2[:-1, 1:], id2[1:, 1:]

    # reference emits per quad: tri1 (v00,v10,v11) then tri2 (v00,v11,v01),
    # scanning quads row-major -> interleave on the last axis then compact.
    tri_mask = jnp.stack([tri1, tri2], axis=-1).reshape(-1)      # [(H-1)(W-1)*2]
    tri_ids = jnp.stack([
        jnp.stack([i00, i10, i11], axis=-1),
        jnp.stack([i00, i11, i01], axis=-1),
    ], axis=-2).reshape(-1, 3)

    fidx = jnp.cumsum(tri_mask.astype(jnp.int32)) - 1
    num_f = tri_mask.sum().astype(jnp.int32)
    ftgt = jnp.where(tri_mask, jnp.minimum(fidx, cap_f - 1), cap_f)
    faces = jnp.full((cap_f, 3), -1, jnp.int32).at[ftgt].set(
        tri_ids, mode="drop")
    num_f = jnp.minimum(num_f, cap_f)

    return GridMesh(vertices, tex_index, faces, num_v, num_f)


def compact_mesh(m: GridMesh):
    """Host-side: strip padding -> (verts [V,3], faces [F,3], tex [V]) numpy."""
    import numpy as np
    nv = int(m.num_vertices)
    nf = int(m.num_faces)
    return (np.asarray(m.vertices[:nv]), np.asarray(m.faces[:nf]),
            np.asarray(m.tex_index[:nv]))

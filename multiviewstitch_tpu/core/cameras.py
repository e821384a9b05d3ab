"""Batched pinhole cameras as a structure-of-arrays pytree.

Re-design of the reference's scalar ``Camera`` class
(``Camera/Camera.{h,cpp}``). The reference stores one Eigen K/R/t per camera
and converts a single pixel at a time (``Camera.cpp:40-72``); here a whole
rig is one pytree of stacked arrays (``K: [N,3,3]``, ``R: [N,3,3]``,
``t: [N,3]``) and all transforms are batched/jittable over arbitrary leading
point dimensions, so per-pixel loops become single fused XLA ops.

Conventions (identical to the reference so calibration files interoperate):
  cam   = R @ world + t                       (Camera.cpp:68-72)
  world = R^T @ (cam - t)                     (Camera.cpp:62-66)
  u     = fx * x/z + cx,  v = fy * y/z + cy   (Camera.cpp:46-49)
  image size: W = 2*(cx+0.5), H = 2*(cy+0.5)  (Camera.cpp:135-136)
Depth maps store *disparity* (1/z) as float32 (Common/Utils.h:166-186);
a pixel is valid iff disparity ∈ [min_dsp, max_dsp] (Image3D.cpp:95-103).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
class CameraBatch:
    """SoA batch of pinhole cameras: K [*,3,3], R [*,3,3], t [*,3]."""

    def __init__(self, K, R, t, width: int = 0, height: int = 0):
        self.K = K
        self.R = R
        self.t = t
        # Static (non-traced) image size; uniform across the batch like the
        # reference (it derives W/H from intrinsics, Camera.cpp:135-136).
        self.width = int(width)
        self.height = int(height)

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.K, self.R, self.t), (self.width, self.height)

    @classmethod
    def tree_unflatten(cls, aux, children):
        K, R, t = children
        return cls(K, R, t, *aux)

    # -- convenience -------------------------------------------------------
    @property
    def batch_shape(self):
        return self.K.shape[:-2]

    def __len__(self):
        return self.K.shape[0]

    def __getitem__(self, idx) -> "CameraBatch":
        return CameraBatch(self.K[idx], self.R[idx], self.t[idx],
                           self.width, self.height)

    @property
    def fx(self):
        return self.K[..., 0, 0]

    @property
    def fy(self):
        return self.K[..., 1, 1]

    @property
    def cx(self):
        return self.K[..., 0, 2]

    @property
    def cy(self):
        return self.K[..., 1, 2]

    def centers(self):
        """Camera centers in world coordinates: C = -R^T t."""
        return -jnp.einsum("...ji,...j->...i", self.R, self.t,
                           precision="highest")

    def view_rays(self):
        """Forward (+z) viewing direction in world coords = R^T e_z =
        third row of R. Matches Processor.cpp:1129 (R.transpose().col(2))."""
        return self.R[..., 2, :]

    @staticmethod
    def single(K, R, t, width=0, height=0) -> "CameraBatch":
        return CameraBatch(jnp.asarray(K, jnp.float32),
                           jnp.asarray(R, jnp.float32),
                           jnp.asarray(t, jnp.float32), width, height)

    @staticmethod
    def stack(cams) -> "CameraBatch":
        K = jnp.stack([c.K for c in cams])
        R = jnp.stack([c.R for c in cams])
        t = jnp.stack([c.t for c in cams])
        return CameraBatch(K, R, t, cams[0].width, cams[0].height)


# ---------------------------------------------------------------------------
# Coordinate transforms. `cam` has batch shape B, points have shape [..., 3];
# B must broadcast against the points' leading dims (typically cam is a single
# camera or has leading dims matching the points').
# ---------------------------------------------------------------------------

def _rot3(R, pts, transpose=False):
    """[...,3,3] x [...,3] -> [...,3] as EXPLICIT elementwise math: nine
    multiply-adds fuse with their neighbors and run in full f32, where a
    3-wide einsum/dot_general becomes a matmul with a 3-element contraction
    (and, on the GPU, a TF32 product unless its precision is pinned)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    if transpose:
        return jnp.stack([
            R[..., 0, 0] * x + R[..., 1, 0] * y + R[..., 2, 0] * z,
            R[..., 0, 1] * x + R[..., 1, 1] * y + R[..., 2, 1] * z,
            R[..., 0, 2] * x + R[..., 1, 2] * y + R[..., 2, 2] * z,
        ], axis=-1)
    return jnp.stack([
        R[..., 0, 0] * x + R[..., 0, 1] * y + R[..., 0, 2] * z,
        R[..., 1, 0] * x + R[..., 1, 1] * y + R[..., 1, 2] * z,
        R[..., 2, 0] * x + R[..., 2, 1] * y + R[..., 2, 2] * z,
    ], axis=-1)


def world_to_cam(cam: CameraBatch, pts):
    """world [...,3] -> camera frame [...,3].  (Camera.cpp:68-72)"""
    return _rot3(cam.R, pts) + cam.t


def cam_to_world(cam: CameraBatch, pts):
    """camera [...,3] -> world frame [...,3].  (Camera.cpp:62-66)"""
    return _rot3(cam.R, pts - cam.t, transpose=True)


def project(cam: CameraBatch, pts_world, eps: float = 1e-12):
    """World points [...,3] -> (uv [...,2], z [...]) continuous pixel coords.

    Equivalent of GetImgCoordFromWorld (Camera.cpp:55-59) without the
    reference's int round — callers round or bilinear-sample as needed.
    Returns camera-frame depth z so callers can mask behind-camera points.
    """
    pc = world_to_cam(cam, pts_world)
    z = pc[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < eps, eps, z)
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    return jnp.stack([u, v], axis=-1), z


def unproject(cam: CameraBatch, uv, depth):
    """Pixel coords [...,2] + depth [...] -> world points [...,3].

    Equivalent of GetWorldCoordFromImg (Camera.cpp:51-54): back-project
    through K then rotate into world.
    """
    x = (uv[..., 0] - cam.cx) * depth / cam.fx
    y = (uv[..., 1] - cam.cy) * depth / cam.fy
    pc = jnp.stack([x, y, depth], axis=-1)
    return cam_to_world(cam, pc)


def pixel_grid(height: int, width: int, dtype=jnp.float32):
    """[H,W,2] grid of (u,v) pixel coordinates (u = column, v = row)."""
    v, u = jnp.meshgrid(jnp.arange(height, dtype=dtype),
                        jnp.arange(width, dtype=dtype), indexing="ij")
    return jnp.stack([u, v], axis=-1)


def unproject_depth_map(cam: CameraBatch, disparity, min_dsp: float,
                        max_dsp: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Disparity map [H,W] -> (world points [H,W,3], valid mask [H,W]).

    Batched equivalent of Image3D::SolveUnProjectionD (Image3D.cpp:72-107):
    valid iff disparity in [min_dsp, max_dsp]; depth = 1/disparity.
    """
    h, w = disparity.shape[-2:]
    valid = (disparity >= min_dsp) & (disparity <= max_dsp)
    safe = jnp.where(valid, disparity, 1.0)
    depth = 1.0 / safe
    uv = pixel_grid(h, w, disparity.dtype)
    pts = unproject(cam, uv, depth)
    return jnp.where(valid[..., None], pts, 0.0), valid


def in_bounds(uv, width: int, height: int, margin: float = 0.0):
    """Mask of pixel coords inside the image rectangle."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= margin) & (u <= width - 1 - margin) &
            (v >= margin) & (v <= height - 1 - margin))


# ---------------------------------------------------------------------------
# .act calibration parser (host-side, numpy).
# ---------------------------------------------------------------------------

def load_act(path: str) -> CameraBatch:
    """Parse the reference's .act calibration format into a CameraBatch.

    Format (LoadCalibrationFromActs, Camera.cpp:74-157):
      - '#' comment lines; blank lines ignored outside blocks
      - '<intrinsic parameter>' followed by a line 'fx fy cx cy'
      - 'start:<i>', 'step:<i>', 'end:<i>'
      - '<Camera Track>' then per frame: separator line, frame-name line,
        four rows of a 4x4 [R|t; 0 0 0 1] matrix, separator line.
    Image size: W = 2*(cx+0.5), H = 2*(cy+0.5)  (Camera.cpp:135-136).
    """
    with open(path, "r") as f:
        lines = f.read().splitlines()

    K = np.zeros((3, 3), np.float64)
    start = step = end = 0
    Rs, ts = [], []
    i = 0
    n = len(lines)
    while i < n:
        s = lines[i].strip()
        i += 1
        if not s or s.startswith("#"):
            continue
        if s == "<intrinsic parameter>":
            vals = [float(x) for x in lines[i].split()]
            i += 1
            K[0, 0], K[1, 1], K[0, 2], K[1, 2] = vals[:4]
            K[2, 2] = 1.0
        elif s == "<Camera Track>":
            nframes = 0 if step == 0 else (end - start) // step + 1
            for _ in range(max(nframes, 0)):
                i += 2  # separator + frame-name lines
                rows = []
                for r in range(4):
                    rows.append([float(x) for x in lines[i].split()])
                    i += 1
                i += 1  # trailing separator
                M = np.asarray(rows[:3], np.float64)
                Rs.append(M[:, :3])
                ts.append(M[:, 3])
            break
        elif ":" in s:
            key, _, val = s.partition(":")
            key = key.strip()
            if key == "start":
                start = int(val)
            elif key == "step":
                step = int(val)
            elif key == "end":
                end = int(val)

    nf = len(Rs)
    R = np.stack(Rs) if nf else np.zeros((0, 3, 3))
    t = np.stack(ts) if nf else np.zeros((0, 3))
    width = int(2 * (K[0, 2] + 0.5))
    height = int(2 * (K[1, 2] + 0.5))
    Kb = np.broadcast_to(K, (nf, 3, 3)).copy()
    return CameraBatch(jnp.asarray(Kb, jnp.float32), jnp.asarray(R, jnp.float32),
                       jnp.asarray(t, jnp.float32), width, height)


def save_act(path: str, cam: CameraBatch, start: int = 0, step: int = 1):
    """Write a CameraBatch in the reference .act format (round-trips load_act)."""
    K = np.asarray(cam.K)
    R = np.asarray(cam.R)
    t = np.asarray(cam.t)
    nf = R.shape[0]
    with open(path, "w") as f:
        f.write("# multiviewstitch_tpu calibration\n")
        f.write("<intrinsic parameter>\n")
        f.write(f"{K[0,0,0]} {K[0,1,1]} {K[0,0,2]} {K[0,1,2]}\n")
        f.write(f"start:{start}\nstep:{step}\nend:{start + step * (nf - 1)}\n")
        f.write("<Camera Track>\n")
        for fi in range(nf):
            f.write("----\n")
            f.write(f"frame{start + fi * step}\n")
            for r in range(3):
                f.write(f"{R[fi,r,0]} {R[fi,r,1]} {R[fi,r,2]} {t[fi,r]}\n")
            f.write("0 0 0 1\n")
            f.write("----\n")

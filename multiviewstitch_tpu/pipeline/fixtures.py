"""Synthetic scene fixtures: known mesh + known cameras -> rendered RGB-D.

The reference ships no data (``../data/body3/...`` in imgPathList.txt:1-6 is
absent; SURVEY §6) and has no tests, so all parity/benchmark claims run on
synthetic fixtures: we render disparity maps of a known mesh with known
cameras using our own rasterizer, feed them through the pipeline, and assert
recovered transforms / geometry against ground truth (SURVEY §4).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..core.cameras import CameraBatch
from ..core.transforms import Similarity
from ..ops.rasterizer import render_sequence


def uv_sphere(n_lat: int = 24, n_lon: int = 32, radius: float = 0.5,
              bumps: float = 0.0, seed: int = 0):
    """UV-sphere mesh (optionally with low-frequency radial bumps so views
    are photometrically/geometrically distinctive) -> (verts [V,3] f32,
    faces [F,3] i32)."""
    # open interval: the poles would otherwise be n_lon duplicated vertices
    # (zero-area triangles, zero point spacing)
    lat = np.linspace(0, np.pi, n_lat + 2)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    r = np.full_like(th, radius)
    if bumps > 0:
        r = r * (1.0 + bumps * (np.sin(3 * th) * np.cos(4 * ph) +
                                0.5 * np.sin(5 * ph + 1.0)))
    x = r * np.sin(th) * np.cos(ph)
    y = r * np.cos(th)
    z = r * np.sin(th) * np.sin(ph)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)

    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            j2 = (j + 1) % n_lon
            a = i * n_lon + j
            b = i * n_lon + j2
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + j2
            faces.append([a, c, d])
            faces.append([a, d, b])
    return verts, np.asarray(faces, np.int32)


def ring_cameras(n: int, radius: float = 2.0, height: float = 0.0,
                 width: int = 160, length_focal: float = 120.0,
                 img_height: int = 120, look_at=(0.0, 0.0, 0.0),
                 arc_deg: float = 360.0,
                 arc_center_deg: float = 0.0) -> CameraBatch:
    """n cameras on a circle (or partial arc of `arc_deg`) in the y=height
    plane, all looking at look_at. A partial arc with small angular steps
    mimics the reference's hand-held video sequences (its consistency and
    agreement tests assume small inter-frame baselines).

    Returns a CameraBatch with the reference's convention p_c = R p_w + t.
    """
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = length_focal
    K[:, 1, 1] = length_focal
    K[:, 0, 2] = (width - 1) / 2.0
    K[:, 1, 2] = (img_height - 1) / 2.0
    K[:, 2, 2] = 1.0

    Rs, ts = [], []
    tgt = np.asarray(look_at, np.float64)
    for i in range(n):
        if arc_deg >= 360.0:
            ang = 2 * np.pi * i / max(n, 1)
        else:
            step = np.radians(arc_deg) / max(n - 1, 1)
            ang = (i - (n - 1) / 2) * step + np.radians(arc_center_deg)
        center = np.array([radius * np.cos(ang), height,
                           radius * np.sin(ang)])
        fwd = tgt - center
        fwd = fwd / np.linalg.norm(fwd)
        up_hint = np.array([0.0, -1.0, 0.0])   # image +v is down
        right = np.cross(up_hint, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])        # rows: cam x,y,z in world
        t = -R @ center
        Rs.append(R)
        ts.append(t)
    return CameraBatch(jnp.asarray(K),
                       jnp.asarray(np.stack(Rs), jnp.float32),
                       jnp.asarray(np.stack(ts), jnp.float32),
                       width, img_height)


class Scene(NamedTuple):
    vertices: np.ndarray         # [V,3]
    faces: np.ndarray            # [F,3]
    cams: CameraBatch            # N frames
    disparity: np.ndarray        # [N,H,W] rendered ground-truth disparity
    gt_transform: Optional[Similarity]  # world transform vs base scene


def make_scene(n_frames: int = 4, width: int = 160, height: int = 120,
               cam_radius: float = 2.0, bumps: float = 0.12, seed: int = 0,
               transform: Optional[Similarity] = None,
               n_lat: int = 48, n_lon: int = 64,
               arc_deg: float = 360.0, arc_center_deg: float = 0.0) -> Scene:
    """Render a bumpy-sphere scene. If `transform` is given, the world (mesh
    AND cameras) is mapped through it — two scenes of the same mesh related
    by a known similarity, exactly the multi-sequence stitching setup."""
    verts, faces = uv_sphere(n_lat, n_lon, bumps=bumps, seed=seed)
    cams = ring_cameras(n_frames, radius=cam_radius, width=width,
                        img_height=height, arc_deg=arc_deg,
                        arc_center_deg=arc_center_deg)
    if transform is not None:
        # map world by T: points x' = sRx+t; camera (R_c, t_c) becomes
        # (R_c R^T, t_c - R_c R^T t ... ) derived from p_c = R_c p_w + t_c
        # with p_w = T^{-1} p'_w  =>  R'_c = (1/s) R_c R^T ... but scaling
        # changes depth; instead scale cam translation: p_c' must equal
        # s * p_c for uniform world scale (depth scales with s).
        s = np.float64(np.asarray(transform.s))
        Rt = np.asarray(transform.R, np.float64)
        tt = np.asarray(transform.t, np.float64)
        verts = (s * (Rt @ verts.T).T + tt).astype(np.float32)
        Rc = np.asarray(cams.R, np.float64)
        tc = np.asarray(cams.t, np.float64)
        # want p'_c = R'_c p'_w + t'_c = s*(R_c p_w + t_c) so the scene is
        # the same up to global similarity: R'_c = R_c R^T,
        # t'_c = s t_c - R_c R^T t
        Rc2 = np.einsum("nij,kj->nik", Rc, Rt)
        tc2 = s * tc - np.einsum("nij,j->ni", Rc2, tt)
        cams = CameraBatch(cams.K, jnp.asarray(Rc2, jnp.float32),
                           jnp.asarray(tc2, jnp.float32),
                           cams.width, cams.height)

    fmask = jnp.ones((faces.shape[0],), bool)
    disp = render_sequence(jnp.asarray(verts), jnp.asarray(faces), fmask,
                           cams, height=height, width=width)
    return Scene(verts, faces, cams, np.asarray(disp), transform)


def textured_views(scene: Scene, scale: float = 255.0) -> np.ndarray:
    """View-consistent 'photos' [N,H,W] (0..255): per-pixel albedo is a
    procedural function of the OBJECT-space surface point, so the same
    surface point has the same intensity from every view and in every
    similarity-transformed copy of the scene — ideal for feature-matching
    and SSD-filter tests (replaces the reference's absent image data)."""
    from ..core.cameras import unproject_depth_map
    from ..core.transforms import inverse as sim_inverse, apply_points

    n, h, w = scene.disparity.shape
    inv = sim_inverse(scene.gt_transform) if scene.gt_transform is not None \
        else None
    imgs = []
    for i in range(n):
        pts, valid = unproject_depth_map(
            scene.cams[i], jnp.asarray(scene.disparity[i]), 1e-6, 1e6)
        p = pts.reshape(-1, 3)
        if inv is not None:
            p = apply_points(inv, p)
        a = (0.5 + 0.22 * jnp.sin(23.0 * p[:, 0]) * jnp.cos(17.0 * p[:, 1])
             + 0.18 * jnp.sin(31.0 * p[:, 2] + 1.3)
             + 0.10 * jnp.sin(57.0 * (p[:, 0] + p[:, 1] + p[:, 2])))
        img = jnp.where(valid.reshape(-1), a * scale, 0.0)
        imgs.append(np.asarray(img.reshape(h, w), np.float32))
    return np.stack(imgs)


def sensor_noise(gray: np.ndarray, disparity: np.ndarray, level: float,
                 seed: int = 0):
    """Apply a realistic RGB-D sensor noise model at strength ``level``
    (0 = clean; 1 = a plausible hand-held consumer depth camera — the
    reference's operating regime, imgPathList.txt's hand-held scans;
    its pixel_err/dsp_err/conf_min thresholds exist exactly for this).

    Photometric (gray, 0..255 scale): per-frame gain/offset drift (auto
    exposure), radial vignetting, additive Gaussian pixel noise.
    Geometric (disparity): multiplicative Gaussian noise (stereo disparity
    error grows with disparity), then QUANTIZATION to discrete disparity
    steps (the staircase artifact of real stereo/structured-light sensors),
    plus salt dropouts (invalid pixels).

    Returns (gray_noisy, disparity_noisy) as float32 copies.
    """
    rng = np.random.default_rng(seed)
    n, h, w = gray.shape
    g = gray.astype(np.float32).copy()
    d = disparity.astype(np.float32).copy()
    if level <= 0:
        return g, d

    # photometric: gain in [1-0.08L, 1+0.08L], offset +-4L gray levels,
    # vignette up to 20%*L at the corners, noise sigma 2.5L
    gain = 1.0 + rng.uniform(-0.08, 0.08, size=(n, 1, 1)) * level
    offset = rng.uniform(-4.0, 4.0, size=(n, 1, 1)) * level
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = (((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2) / 2
    vig = 1.0 - 0.2 * level * r2[None]
    g = g * gain * vig + offset + \
        rng.normal(size=g.shape).astype(np.float32) * 2.5 * level
    g = np.clip(g, 0.0, 255.0).astype(np.float32)

    # geometric: 1% * L multiplicative noise, quantize to 0.5% * L steps,
    # 0.5% * L dropouts
    valid = d > 0
    d = d * (1.0 + rng.normal(size=d.shape).astype(np.float32) *
             0.01 * level)
    q = 0.005 * level * float(d[valid].mean()) if valid.any() else 0.0
    if q > 0:
        d = np.round(d / q) * q
    drop = rng.random(d.shape) < 0.005 * level
    d = np.where(valid & ~drop, d, 0.0).astype(np.float32)
    return g, d


def inject_outlier_matches(uv1: np.ndarray, uv2: np.ndarray,
                           mask: np.ndarray, frac: float, width: int,
                           height: int, seed: int = 0):
    """Replace ``frac`` of the valid matches' second endpoints with uniform
    random pixels — synthetic gross outliers for RANSAC/filter-cascade
    robustness tests (the reference's RemoveOutliers rounds exist for
    these, Processor.cpp:196-259)."""
    rng = np.random.default_rng(seed)
    uv2 = uv2.copy()
    vi = np.flatnonzero(mask)
    n_bad = int(len(vi) * frac)
    bad = rng.choice(vi, size=n_bad, replace=False) if n_bad else \
        np.zeros(0, np.int64)
    uv2[bad, 0] = rng.integers(0, width, size=n_bad)
    uv2[bad, 1] = rng.integers(0, height, size=n_bad)
    return uv2, bad


def shade_views(scene: Scene, light=(0.4, 0.7, 0.2)) -> np.ndarray:
    """Cheap lambertian grayscale 'photos' [N,H,W] from the scene's
    disparity maps + mesh — gives photometric texture for feature tests."""
    from ..core.cameras import unproject_depth_map
    from ..ops.mesh_normals import vertex_normals

    n, h, w = scene.disparity.shape
    light = np.asarray(light) / np.linalg.norm(light)
    imgs = []
    vn = np.asarray(vertex_normals(jnp.asarray(scene.vertices),
                                   jnp.asarray(scene.faces)))
    for i in range(n):
        pts, valid = unproject_depth_map(
            scene.cams[i], jnp.asarray(scene.disparity[i]), 1e-6, 1e6)
        pts = np.asarray(pts).reshape(-1, 3)
        # nearest mesh vertex normal (small fixtures -> brute force fine)
        d2 = ((pts[:, None, :] - scene.vertices[None]) ** 2).sum(-1)
        nearest = d2.argmin(1)
        shade = np.abs(vn[nearest] @ light)
        img = np.where(np.asarray(valid).reshape(-1), 0.2 + 0.8 * shade, 0.0)
        imgs.append(img.reshape(h, w))
    return np.stack(imgs).astype(np.float32)


def _e2e_config():
    from ..config import StitchConfig
    return StitchConfig().replace(
        view_count=1, min_match_count=7, iter_num=256, sample_interval=4,
        ssd_win=3, ssd_err=40.0, reproj_err=4, pixel_err=12.0,
        adapt_pixel_err_ratio=0.6, distmax=0.7, ratiomax=0.8,
        hl_margin_ratio=0.02, hr_margin_ratio=0.02, vl_margin_ratio=0.02,
        vr_margin_ratio=0.02, min_dsp=1e-3, max_dsp=10.0,
        max_keypoints=256, nbr_frm_num=1, conf_min=0.5, dsp_err=0.05)


# the StitchConfig the two-sequence fixture is aligned with (BASELINE
# configs 1-2; benchmarks raise max_keypoints to 512)
E2E_CONFIG = _e2e_config()


def build_two_sequences(n_frames: int = 4, width: int = 128,
                        height: int = 96):
    """Two sequences of the same bumpy sphere related by a known similarity
    (BASELINE config 1; config 2 at 5 VGA frames). Returns
    (seq1, seq2, gt, base_scene, moved_scene)."""
    from .align_seq import Sequence
    gt = Similarity(jnp.asarray(1.3, jnp.float32),
                    jnp.asarray(np.array(
                        [[0.9689124, 0.0, 0.24740396],
                         [0.0, 1.0, 0.0],
                         [-0.24740396, 0.0, 0.9689124]], np.float32)),
                    jnp.asarray([0.15, -0.1, 0.2], jnp.float32))
    # video-like 15 deg inter-frame baselines (partial arc) — the regime the
    # reference's consistency / agreement tests are designed for
    base = make_scene(n_frames=n_frames, width=width, height=height,
                      bumps=0.15, n_lat=64, n_lon=96, arc_deg=45.0)
    moved = make_scene(n_frames=n_frames, width=width, height=height,
                       bumps=0.15, n_lat=64, n_lon=96, transform=gt,
                       arc_deg=45.0)
    seq1 = Sequence(jnp.asarray(textured_views(base)),
                    jnp.asarray(base.disparity), base.cams)
    seq2 = Sequence(jnp.asarray(textured_views(moved)),
                    jnp.asarray(moved.disparity), moved.cams)
    return seq1, seq2, gt, base, moved


def synth_ba_problem(n_cams=6, n_pts=60, noise_px=0.0, pose_noise=0.0,
                     pt_noise=0.0, seed=0, ang_step=0.08, t_step=0.15):
    """Cameras on an arc (``ang_step`` rad and ``t_step`` apart) looking at
    a point cloud; observations = exact projections (+noise). Returns
    (problem, gt_state, init_state)."""
    from ..solvers import ba
    rng = np.random.default_rng(seed)
    K = np.array([[200.0, 0, 120.0], [0, 200.0, 90.0], [0, 0, 1]],
                 np.float32)
    pts = rng.uniform(-0.5, 0.5, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 4.0

    rvecs, tvecs = [], []
    for i in range(n_cams):
        ang = (i - n_cams / 2) * ang_step
        rvecs.append(np.array([0.0, ang, 0.0], np.float32))
        tvecs.append(np.array([t_step * i, 0.0, 0.2 * abs(ang)], np.float32))
    rvec = np.stack(rvecs)
    tvec = np.stack(tvecs)

    cam_idx, pt_idx, uvs = [], [], []
    for c in range(n_cams):
        R = np.asarray(ba.rodrigues(jnp.asarray(rvec[c])))
        pc = (R @ pts.T).T + tvec[c]
        uv = np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                       K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], -1)
        inb = ((uv[:, 0] > 0) & (uv[:, 0] < 240) &
               (uv[:, 1] > 0) & (uv[:, 1] < 180))
        for p in np.nonzero(inb)[0]:
            cam_idx.append(c)
            pt_idx.append(p)
            uvs.append(uv[p] + rng.normal(size=2) * noise_px)

    prob = ba.make_problem(K, cam_idx, pt_idx, np.asarray(uvs), n_pts,
                           max_obs_per_point=n_cams, n_cams=n_cams)
    gt = ba.BAState(jnp.asarray(rvec), jnp.asarray(tvec), jnp.asarray(pts))
    init = ba.BAState(
        jnp.asarray(rvec + rng.normal(size=rvec.shape).astype(np.float32)
                    * pose_noise),
        jnp.asarray(tvec + rng.normal(size=tvec.shape).astype(np.float32)
                    * pose_noise * 3),
        jnp.asarray(pts + rng.normal(size=pts.shape).astype(np.float32)
                    * pt_noise))
    return prob, gt, init

"""Smoke run of the stitching pipeline on one NVIDIA GPU.

    python chip_smoke.py               # phases 1-3 on one card
    python chip_smoke.py --four-gpus   # phase 4 only, on four cards

Phases, in order:

1. Device: print the JAX devices, their kind and the card's name and power
   limit. A process whose default backend is not ``gpu`` exits non-zero
   here; there is no CPU fallback.
2. Kernel parity at VGA: each device op of the main path, run on the card,
   against its plain reference (the same function on the CPU device of this
   process, or numpy), each with its tolerance and the reason for it.
3. Main path: config-2 align + fuse + TSDF reconstruct at 640x480 through
   the library calls the ``mvs align`` command makes, checked against the
   ground-truth similarity; then template fit (``mvs deform``) and the
   re-render of 8 VGA frames (``mvs render``). Wall times per stage.
4. ``--four-gpus`` only: 64-view sharded align+fuse (config 5), the
   point-sharded BA Gauss-Newton step and block ARAP on a 4-device mesh,
   each against the same computation unsharded on one card.

Any failed phase makes the exit code non-zero; the last line of standard
output is the JSON result only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

W, H = 640, 480


class PhaseFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def say(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def require_gpu():
    """Return jax.devices() if the default backend is the GPU, else exit 2
    without printing a result."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: default JAX backend is {backend!r}, not 'gpu'; "
              "this script runs on the card only", file=sys.stderr)
        sys.exit(2)
    return jax.devices()


def card_label() -> str:
    """Print nvidia-smi's name and power limit of each card as it gives
    them, one line per card; return them joined, deduplicated."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    say(out.rstrip("\n"))
    lines = sorted({ln.strip() for ln in out.splitlines() if ln.strip()})
    check(lines, "nvidia-smi reported no card")
    return " | ".join(lines)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def on_cpu(fn, *args, **kw):
    """Run fn on the CPU device of this process; numpy results."""
    import jax
    args = jax.device_get(args)
    with jax.default_device(jax.devices("cpu")[0]):
        return jax.device_get(fn(*args, **kw))


def on_gpu(fn, *args, **kw):
    import jax
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    return jax.device_get(out)


def timed(fn, *args, **kw):
    import jax
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def vga_scene(n_frames=8, width=W, height=H, focal=520.0, arc_deg=60.0,
              n_lat=96, n_lon=128):
    """Bumpy sphere seen by n ring cameras at VGA (rendered on the card)."""
    import jax.numpy as jnp
    from multiviewstitch_tpu.pipeline.fixtures import (Scene, ring_cameras,
                                                       uv_sphere)
    from multiviewstitch_tpu.ops.rasterizer import render_sequence
    verts, faces = uv_sphere(n_lat, n_lon, bumps=0.15, seed=0)
    cams = ring_cameras(n_frames, radius=2.0, width=width, img_height=height,
                        length_focal=focal, arc_deg=arc_deg)
    disp = render_sequence(jnp.asarray(verts), jnp.asarray(faces),
                           jnp.ones(len(faces), bool), cams, height=height,
                           width=width)
    return Scene(verts, faces, cams, np.asarray(disp), None)


def _near_half(x, eps):
    """C++ (int)(x + 0.5) flips where x + 0.5 is within eps of an integer."""
    y = x + 0.5
    return np.abs(y - np.round(y)) < eps


class _Rig:
    """float64 numpy pinhole rig for the rounding-boundary masks."""

    def __init__(self, K, R, t):
        self.K = np.asarray(K, np.float64)
        self.R = np.asarray(R, np.float64)
        self.t = np.asarray(t, np.float64)

    def unproject(self, idx, u, v, depth):
        K = self.K[idx]
        x = (u - K[..., 0, 2]) * depth / K[..., 0, 0]
        y = (v - K[..., 1, 2]) * depth / K[..., 1, 1]
        pc = np.stack([x, y, depth], -1) - self.t[idx]
        return np.einsum("...ji,...j->...i", self.R[idx], pc)

    def project(self, idx, pw):
        K = self.K[idx]
        pc = np.einsum("...ij,...j->...i", self.R[idx], pw) + self.t[idx]
        z = pc[..., 2]
        zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
        return (K[..., 0, 0] * pc[..., 0] / zs + K[..., 0, 2],
                K[..., 1, 1] * pc[..., 1] / zs + K[..., 1, 2], z)


def consistency_boundary(disp, rig, offsets, min_dsp, max_dsp, eps=1e-4):
    """Pixels whose consistency outcome may differ between two correct f32
    implementations: a reprojection (to the neighbor, or back) lands within
    eps px of a .5 rounding boundary."""
    n, h, w = disp.shape
    d = disp.astype(np.float64)
    valid = (disp >= min_dsp) & (disp <= max_dsp)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    fi = np.arange(n)[:, None, None]
    pw = rig.unproject(fi, u, v, 1.0 / np.where(valid, d, 1.0))
    flag = np.zeros(disp.shape, bool)
    for off in offsets:
        nb = np.clip(np.arange(n) + off, 0, n - 1)[:, None, None]
        exists = ((np.arange(n) + off >= 0) &
                  (np.arange(n) + off < n))[:, None, None]
        un, vn, z = rig.project(nb, pw)
        ui, vi = np.floor(un + 0.5), np.floor(vn + 0.5)
        inb = (ui >= 0) & (ui <= w - 1) & (vi >= 0) & (vi <= h - 1) & (z > 0)
        uc = np.clip(ui, 0, w - 1).astype(np.int64)
        vc = np.clip(vi, 0, h - 1).astype(np.int64)
        dn = d[nb, vc, uc]
        refv = (dn >= min_dsp) & (dn <= max_dsp)
        pw2 = rig.unproject(nb, uc.astype(np.float64), vc.astype(np.float64),
                            1.0 / np.where(refv, dn, 1.0))
        ub, vb, _ = rig.project(fi, pw2)
        f1 = _near_half(un, eps) | _near_half(vn, eps)
        f2 = (_near_half(ub, eps) | _near_half(vb, eps)) & inb & refv
        flag |= exists & valid & (f1 | f2)
    return flag


def sampling_boundary(disp, rig, stride, nbr_num, min_dsp, max_dsp, dsp_err,
                      eps=1e-4, eps_d=1e-5):
    """Strided samples whose agreement vote may differ between two correct
    f32 implementations: the neighbor reprojection is within eps px of a .5
    rounding boundary, or |dn - d_proj| is within eps_d of dsp_err."""
    n, h, w = disp.shape
    d = disp.astype(np.float64)
    valid = (disp >= min_dsp) & (disp <= max_dsp)
    v, u = np.mgrid[0:h:stride, 0:w:stride].astype(np.float64)
    fi = np.arange(n)[:, None, None]
    ds = d[:, ::stride, ::stride]
    vs = valid[:, ::stride, ::stride]
    pw = rig.unproject(fi, u, v, 1.0 / np.where(vs, ds, 1.0))
    flag = np.zeros(vs.shape, bool)
    for k in range(1, nbr_num + 1):
        for off in (-k, k):
            nb = np.clip(np.arange(n) + off, 0, n - 1)[:, None, None]
            exists = ((np.arange(n) + off >= 0) &
                      (np.arange(n) + off < n))[:, None, None]
            un, vn, z = rig.project(nb, pw)
            ui, vi = np.floor(un + 0.5), np.floor(vn + 0.5)
            uc = np.clip(ui, 0, w - 1).astype(np.int64)
            vc = np.clip(vi, 0, h - 1).astype(np.int64)
            dn = d[nb, vc, uc]
            dproj = np.where(z > 1e-12, 1.0 / np.maximum(z, 1e-12), 0.0)
            near_thr = np.abs(np.abs(dn - dproj) - dsp_err) < eps_d
            f1 = _near_half(un, eps) | _near_half(vn, eps)
            flag |= exists & vs & (f1 | near_thr)
    return flag.reshape(n, -1)


def zbuffer_oracle(verts, faces, h, w, fx, fy, cx, cy):
    """Brute-force z-buffer of camera-frame vertices under a frontal pinhole,
    in numpy: the float32 arithmetic of the loop oracle in
    tests/test_rasterizer_meshing.py per (face, pixel), vectorized over the
    faces with one pass per bbox offset."""
    ua = verts[:, 0] / verts[:, 2] * fx + cx
    va = verts[:, 1] / verts[:, 2] * fy + cy
    iz = 1.0 / verts[:, 2]
    xs, ys, zs = ua[faces], va[faces], iz[faces]               # [F,3]
    x0 = np.maximum(np.floor(xs.min(1)).astype(np.int64), 0)
    x1 = np.minimum(np.ceil(xs.max(1)).astype(np.int64), w - 1)
    y0 = np.maximum(np.floor(ys.min(1)).astype(np.int64), 0)
    y1 = np.minimum(np.ceil(ys.max(1)).astype(np.int64), h - 1)
    area = ((xs[:, 1] - xs[:, 0]) * (ys[:, 2] - ys[:, 0]) -
            (ys[:, 1] - ys[:, 0]) * (xs[:, 2] - xs[:, 0]))
    live = (x1 >= x0) & (y1 >= y0) & (np.abs(area) > 1e-12)
    ref = np.zeros(h * w, np.float32)

    def cover(s, px, py):
        X, Y, Z, A = xs[s], ys[s], zs[s], area[s]
        e0 = (X[:, 1] - X[:, 0]) * (py - Y[:, 0]) - \
            (Y[:, 1] - Y[:, 0]) * (px - X[:, 0])
        e1 = (X[:, 2] - X[:, 1]) * (py - Y[:, 1]) - \
            (Y[:, 2] - Y[:, 1]) * (px - X[:, 1])
        e2 = (X[:, 0] - X[:, 2]) * (py - Y[:, 2]) - \
            (Y[:, 0] - Y[:, 2]) * (px - X[:, 2])
        ins = np.where(A >= 0, (e0 >= 0) & (e1 >= 0) & (e2 >= 0),
                       (e0 <= 0) & (e1 <= 0) & (e2 <= 0))
        disp = (e1 * Z[:, 0] + e2 * Z[:, 1] + e0 * Z[:, 2]) / A
        idx = (py * w + px).astype(np.int64)
        np.maximum.at(ref, idx[ins], disp[ins].astype(np.float32))

    bw, bh = x1 - x0 + 1, y1 - y0 + 1
    big = live & ((bw > 64) | (bh > 64))
    small = live & ~big
    for dy in range(int(bh[small].max(initial=0))):
        for dx in range(int(bw[small].max(initial=0))):
            s = np.nonzero(small & (dx < bw) & (dy < bh))[0]
            cover(s, (x0[s] + dx).astype(np.float32),
                  (y0[s] + dy).astype(np.float32))
    for f in np.nonzero(big)[0]:
        gy, gx = np.mgrid[y0[f]:y1[f] + 1, x0[f]:x1[f] + 1]
        s = np.full(gx.size, f)
        cover(s, gx.ravel().astype(np.float32), gy.ravel().astype(np.float32))
    return ref.reshape(h, w)


# ---------------------------------------------------------------------------
# phase 2: kernel parity at VGA
# ---------------------------------------------------------------------------

def parity_consistency_sampling(scene, rng):
    import jax.numpy as jnp
    from multiviewstitch_tpu.core.cameras import CameraBatch
    from multiviewstitch_tpu.ops.consistency import check_consistency
    from multiviewstitch_tpu.ops.point_sampling import sample_oriented_points

    cams = scene.cams
    disp = scene.disparity.copy()
    # corrupt 5% of the pixels so the filter has inconsistent depth to kill
    bad = rng.random(disp.shape) < 0.05
    disp[bad] *= 0.5
    kc = dict(min_dsp=1e-3, max_dsp=10.0, reproj_err=4)
    ks = dict(min_dsp=1e-3, max_dsp=10.0, sample_radius=2, nbr_num=2,
              nbr_step=1, dsp_err=0.05, conf_min=0.5)
    K, R, t = (np.asarray(x) for x in (cams.K, cams.R, cams.t))

    def cons(d, K, R, t):
        return check_consistency(d, CameraBatch(K, R, t, disp.shape[2],
                                                disp.shape[1]), **kc)

    def samp(d, K, R, t):
        return sample_oriented_points(
            d, CameraBatch(K, R, t, disp.shape[2], disp.shape[1]), **ks)

    args = (jnp.asarray(disp), jnp.asarray(K), jnp.asarray(R), jnp.asarray(t))
    on_gpu(cons, *args)
    f_gpu, dt = timed(cons, *args)
    f_gpu = np.asarray(f_gpu)
    f_cpu = on_cpu(cons, disp, K, R, t)
    rig = _Rig(K, R, t)
    flag = consistency_boundary(disp, rig, (-1, 1), kc["min_dsp"],
                                kc["max_dsp"])
    diff = (f_gpu > 0) != (f_cpu > 0)
    say(f"  consistency 8x{H}x{W}: {dt * 1e3:.2f} ms; kept {int((f_cpu > 0).sum())}"
        f" px; GPU/CPU mask differ at {int(diff.sum())} px, all of which "
        f"must lie within 1e-4 px of a .5 rounding boundary "
        f"({int(flag.sum())} such px)")
    check((f_cpu > 0).sum() > 0.2 * (disp > 0).sum(),
          "consistency kept too few pixels")
    check(not (diff & ~flag).any(),
          f"consistency masks differ off the rounding boundary at "
          f"{int((diff & ~flag).sum())} px")
    same = ~diff
    check(np.array_equal(f_gpu[same], f_cpu[same]),
          "kept disparities are not passed through unchanged")

    # sampling on the SAME filtered input on both devices
    fin = f_cpu.astype(np.float32)
    args = (jnp.asarray(fin), jnp.asarray(K), jnp.asarray(R), jnp.asarray(t))
    on_gpu(samp, *args)
    op_gpu, dt = timed(samp, *args)
    op_gpu = [np.asarray(x) for x in op_gpu]
    op_cpu = on_cpu(samp, fin, K, R, t)
    sflag = sampling_boundary(fin, rig, ks["sample_radius"], ks["nbr_num"],
                              ks["min_dsp"], ks["max_dsp"], ks["dsp_err"])
    vg, vc = op_gpu[3], np.asarray(op_cpu.valid)
    vdiff = vg != vc
    say(f"  point sampling: {dt * 1e3:.2f} ms; {int(vc.sum())} oriented "
        f"points; valid masks differ at {int(vdiff.sum())} samples, which "
        f"must all be rounding-boundary or dsp_err-threshold samples "
        f"({int(sflag.sum())} such)")
    check(not (vdiff & ~sflag).any(), "sampling masks differ off boundary")
    both = vg & vc
    perr = np.abs(op_gpu[0][both] - np.asarray(op_cpu.points)[both]).max()
    nerr = np.abs(op_gpu[1][both] - np.asarray(op_cpu.normals)[both]).max()
    say(f"    max |point diff| {perr:.3g} (tol 1e-5: a few f32 ulps of "
        f"~2 m), max |normal diff| {nerr:.3g} (tol 1e-3: cross product of "
        f"~1 cm tangents loses ~3 digits to cancellation)")
    check(perr <= 1e-5, "sampled points differ")
    check(nerr <= 1e-3, "normals differ")
    return f_cpu


def parity_view_synth(scene):
    import jax
    import jax.numpy as jnp
    from multiviewstitch_tpu.ops.view_synth import (bilinear_sample,
                                                    synthesize_views,
                                                    view_angles)
    from multiviewstitch_tpu.pipeline.fixtures import textured_views

    rgb = np.moveaxis(textured_views(scene)[:3], 0, -1)          # [H,W,3]
    K = np.asarray(scene.cams.K[0])
    R = np.asarray(scene.cams.R[0])
    angles = np.asarray(view_angles(3, 16.0))
    synth = jax.jit(lambda im, K, R, a: synthesize_views(im, K, R, a,
                                                         axis=1))
    args = (jnp.asarray(rgb), jnp.asarray(K), jnp.asarray(R),
            jnp.asarray(angles))
    on_gpu(synth, *args)
    sv_gpu, dt = timed(synth, *args)
    sv_cpu = on_cpu(synth, rgb, K, R, angles)
    tg, tc = np.asarray(sv_gpu.tex_index), np.asarray(sv_cpu.tex_index)
    tdiff = (tg != tc).mean()
    same = (tg == tc) & (tg >= 0)
    ierr = np.abs(np.asarray(sv_gpu.images) - sv_cpu.images)[same].max()
    say(f"  view synthesis 3 views x {H}x{W} RGB: {dt * 1e3:.2f} ms; "
        f"texIndex differs at {tdiff:.2e} of px (tol 1e-3: nearest-pixel "
        f"rounding of the warp field at .5), image max diff {ierr:.3g} "
        f"(tol 0.05: the devices round the warp coordinates differently by "
        f"~1e-4 px, times texture gradients up to ~255/px)")
    check(tdiff <= 1e-3, "texIndex differs")
    check(ierr <= 0.05, "synthesized images differ")
    check((tg >= 0).mean() > 0.3, "synthesized views are mostly empty")

    # the sampler alone, against an exact float64 4-tap reference
    rng = np.random.default_rng(1)
    src = rng.uniform(0, 255, (3, H, W)).astype(np.float32)
    sy = rng.uniform(-2, H + 1, (H, W)).astype(np.float32)
    sx = rng.uniform(-2, W + 1, (H, W)).astype(np.float32)
    got = on_gpu(jax.jit(bilinear_sample), jnp.asarray(src),
                 jnp.asarray(sy), jnp.asarray(sx))
    x0 = np.clip(np.floor(sx), 0, W - 2).astype(np.int64)
    y0 = np.clip(np.floor(sy), 0, H - 2).astype(np.int64)
    fx = np.clip(sx.astype(np.float64) - x0, 0, 1)
    fy = np.clip(sy.astype(np.float64) - y0, 0, 1)
    s64 = src.astype(np.float64)
    want = (s64[:, y0, x0] * (1 - fx) * (1 - fy) +
            s64[:, y0, x0 + 1] * fx * (1 - fy) +
            s64[:, y0 + 1, x0] * (1 - fx) * fy +
            s64[:, y0 + 1, x0 + 1] * fx * fy)
    err = np.abs(got - want).max()
    say(f"  bilinear sampler vs float64 4-tap reference: max err {err:.3g} "
        f"(tol 1e-3: f32 rounding of values <= 255)")
    check(err <= 1e-3, "bilinear sampler differs from the 4-tap reference")


def parity_sift(scene):
    import jax
    import jax.numpy as jnp
    from multiviewstitch_tpu.ops.features import detect_batch
    from multiviewstitch_tpu.ops.match import match_descriptors
    from multiviewstitch_tpu.pipeline.fixtures import textured_views

    grays = textured_views(scene)                                # [8,H,W]
    margins = (0.02, 0.02, 0.02, 0.02)
    det = jax.jit(lambda g: detect_batch(g, max_keypoints=512,
                                         margins=margins))
    on_gpu(det, jnp.asarray(grays))
    kp_gpu, dt = timed(det, jnp.asarray(grays))
    kp_gpu = jax.device_get(kp_gpu)
    kp_cpu = on_cpu(det, grays)
    n = grays.shape[0]

    def kp_overlap(a, b):
        fr = []
        for i in range(n):
            ua = a.uv[i][a.valid[i]]
            ub = b.uv[i][b.valid[i]]
            d = np.abs(ua[:, None, :] - ub[None, :, :]).max(-1)
            fr.append((d.min(1) < 1e-2).mean() if len(ua) else 1.0)
        return float(np.min(fr))

    kov = kp_overlap(kp_gpu, kp_cpu)
    say(f"  SIFT detect+describe 8x{H}x{W}, 512 kp: {dt * 1e3:.2f} ms; "
        f"{int(kp_cpu.valid.sum())} keypoints; worst-frame share of GPU "
        f"keypoints found by the CPU run (within 0.01 px): {kov:.4f} "
        f"(tol >= 0.98: near-equal DoG responses may swap at the 512 cut)")
    check(kov >= 0.98, "keypoint sets differ")

    match = jax.jit(lambda d1, v1, d2, v2: match_descriptors(
        d1, v1, d2, v2, distmax=0.7, ratiomax=0.8))

    def cpu_to_gpu(i):
        """CPU keypoint index -> GPU keypoint index of frame i, for the
        keypoints found by both runs (same uv within 0.01 px and the same
        orientation within 0.01 rad)."""
        g = np.nonzero(kp_gpu.valid[i])[0]
        c = np.nonzero(kp_cpu.valid[i])[0]
        du = np.abs(kp_cpu.uv[i][c][:, None] - kp_gpu.uv[i][g][None]).max(-1)
        da = np.abs(np.angle(np.exp(1j * (kp_cpu.angle[i][c][:, None] -
                                          kp_gpu.angle[i][g][None]))))
        j = (du + da).argmin(1)
        r = np.arange(len(c))
        ok = (du[r, j] < 1e-2) & (da[r, j] < 1e-2)
        return {int(c[k]): int(g[j[k]]) for k in np.nonzero(ok)[0]}

    def decision_margin(kp, i):
        """Per keypoint of frame i: distance of its match decision from the
        distmax / ratio cuts and from a tie for the best partner."""
        d1, d2 = kp.desc[i].astype(np.float64), kp.desc[i + 1].astype(
            np.float64)
        dots = np.where(kp.valid[i][:, None] & kp.valid[i + 1][None],
                        d1 @ d2.T, -1.0)
        top = -np.sort(-dots, 1)[:, :2]
        db = np.sqrt(np.maximum(2 - 2 * top[:, 0], 0))
        ds = np.sqrt(np.maximum(2 - 2 * top[:, 1], 0))
        return np.minimum(np.minimum(np.abs(db - 0.7),
                                     np.abs(db - 0.8 * ds)),
                          top[:, 0] - top[:, 1])

    def matches(kp, run, i):
        m = run(match, kp.desc[i], kp.valid[i], kp.desc[i + 1],
                kp.valid[i + 1])
        return {int(a): int(b) for a, b in
                zip(np.asarray(m.idx1)[m.valid], np.asarray(m.idx2)[m.valid])}

    # the card's descriptors matched on the card, the CPU run's on the CPU;
    # a match may differ only where one run's decision lies within 2e-3 of
    # a cut (descriptors differ in the last bits between the devices:
    # transcendentals and sum order) or where a keypoint is missing from
    # one run (bounded by the keypoint tolerance above)
    n_g = n_c = n_diff = n_missing = n_unexplained = 0
    ddesc = 0.0
    for i in range(n - 1):
        mg = matches(kp_gpu, lambda f, *a: on_gpu(f, *map(jnp.asarray, a)),
                     i)
        mc = matches(kp_cpu, lambda f, *a: on_cpu(f, *a), i)
        n_g += len(mg)
        n_c += len(mc)
        c2g, c2g_next = cpu_to_gpu(i), cpu_to_gpu(i + 1)
        g2c = {v: k for k, v in c2g.items()}
        if c2g:
            cc, gg = map(list, zip(*c2g.items()))
            ddesc = max(ddesc, float(np.abs(kp_gpu.desc[i][gg] -
                                            kp_cpu.desc[i][cc]).max()))
        mar_g = decision_margin(kp_gpu, i)
        mar_c = decision_margin(kp_cpu, i)
        mc_in_g = {c2g.get(a, -1 - a): c2g_next.get(b, -1)
                   for a, b in mc.items()}
        for key in mg.keys() | mc_in_g.keys():
            if mg.get(key) == mc_in_g.get(key):
                continue
            n_diff += 1
            if key < 0 or key not in g2c or mc_in_g.get(key) == -1:
                n_missing += 1
                continue
            near = min(mar_g[key], mar_c[g2c[key]])
            n_unexplained += near >= 2e-3
    say(f"  matches (7 frame pairs, distmax 0.7, ratio 0.8): GPU {n_g}, CPU "
        f"{n_c}; max |descriptor diff| {ddesc:.3g}; {n_diff} matches "
        f"differ: {n_missing} at a keypoint only one run found, "
        f"{n_unexplained} with a decision margin >= 2e-3 (tol 0: only "
        f"decisions at a cut may flip)")
    check(n_c > 100, "too few matches")
    check(n_unexplained == 0, "match sets differ off the decision cuts")

    # the ratio test at HIGHEST vs the card's default f32 matmul precision
    d1, v1 = jnp.asarray(kp_gpu.desc[0]), jnp.asarray(kp_gpu.valid[0])
    d2, v2 = jnp.asarray(kp_gpu.desc[1]), jnp.asarray(kp_gpu.valid[1])

    def ratio_ok(prec):
        dots = jnp.dot(d1, d2.T, precision=prec,
                       preferred_element_type=jnp.float32)
        dots = jnp.where(v1[:, None] & v2[None, :], dots, -1.0)
        top2, _ = jax.lax.top_k(dots, 2)
        db = jnp.sqrt(jnp.maximum(2 - 2 * top2[:, 0], 0))
        d2_ = jnp.sqrt(jnp.maximum(2 - 2 * top2[:, 1], 0))
        return np.asarray((db <= 0.7) & (db <= 0.8 * d2_) & v1)

    flips = int((ratio_ok(jax.lax.Precision.DEFAULT) !=
                 ratio_ok(jax.lax.Precision.HIGHEST)).sum())
    say(f"    ratio-test outcomes that flip between DEFAULT and HIGHEST "
        f"matmul precision on this card (frame pair 0-1): {flips} — the "
        f"matcher pins HIGHEST")
    return dt


def parity_raster(rng):
    import jax
    import jax.numpy as jnp
    from multiviewstitch_tpu.core.cameras import CameraBatch
    from multiviewstitch_tpu.ops.rasterizer import render_disparity
    from multiviewstitch_tpu.pipeline.fixtures import uv_sphere

    v, f = uv_sphere(224, 224, radius=0.8)
    v = v.astype(np.float32)
    v[:, 2] += 2.5
    fx = 520.0
    cx, cy = (W - 1) / 2, (H - 1) / 2
    K = jnp.asarray([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], jnp.float32)
    cam = CameraBatch(K, jnp.eye(3), jnp.zeros(3), W, H)
    rend = jax.jit(lambda vv, ff: render_disparity(
        vv, ff, jnp.ones(ff.shape[0], bool), cam, height=H, width=W))
    fi = f.astype(np.int32)
    on_gpu(rend, jnp.asarray(v), jnp.asarray(fi))
    out, dt = timed(rend, jnp.asarray(v), jnp.asarray(fi))
    got = np.asarray(out.disparity)
    ref = zbuffer_oracle(v, fi, H, W, fx, fx, cx, cy)
    bad = np.abs(got - ref) > 2e-5 * np.abs(ref) + 1e-7
    cover = (ref > 0).sum()
    say(f"  rasterizer {H}x{W} @ {len(fi)} faces: {dt * 1e3:.2f} ms/frame; "
        f"overflow {int(out.overflow)}; {cover} covered px; "
        f"{int(bad.sum())} px outside rtol 2e-5 of the brute-force oracle "
        f"(tol <= 1e-4 of covered px: pixel centers within float rounding "
        f"of a silhouette edge)")
    check(int(out.overflow) == 0, "rasterizer overflow")
    check(cover > 50000, "sphere covers too little of the frame")
    check(bad.sum() <= 1e-4 * cover, "rasterizer differs from the oracle")


def parity_poisson():
    from multiviewstitch_tpu.ops.poisson import reconstruct_poisson

    rng = np.random.default_rng(0)
    d = rng.normal(size=(200000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bump = 1.0 + 0.08 * np.sin(5 * d[:, 0]) * np.cos(4 * d[:, 1])
    pts = (d * bump[:, None]).astype(np.float32)
    nrm = d.astype(np.float32)
    t0 = time.perf_counter()
    verts, faces = reconstruct_poisson(pts, nrm, depth=8)
    wall = time.perf_counter() - t0
    dd = verts / np.maximum(np.linalg.norm(verts, axis=1, keepdims=True),
                            1e-9)
    bb = 1.0 + 0.08 * np.sin(5 * dd[:, 0]) * np.cos(4 * dd[:, 1])
    rmse = float(np.sqrt(np.mean((np.linalg.norm(verts, axis=1) - bb) ** 2)))
    say(f"  Poisson depth 8 (256^3), 200k-point bumpy sphere: {wall:.2f} s "
        f"incl. compile; {len(verts)} verts; surface RMSE {rmse:.5f} (tol "
        f"<= 0.003: the CPU run gives 0.00265, a third of a 0.0086 voxel)")
    check(np.isfinite(verts).all() and len(faces) > 100000,
          "Poisson mesh empty or non-finite")
    check(rmse <= 0.003, "Poisson surface RMSE too large")


# ---------------------------------------------------------------------------
# phase 3: main path
# ---------------------------------------------------------------------------

def main_path(label):
    import jax
    from multiviewstitch_tpu.pipeline.fixtures import (
        build_two_sequences, E2E_CONFIG as CFG)
    from multiviewstitch_tpu.pipeline.align_seq import (align_sequences,
                                                        fuse_sequences)
    from multiviewstitch_tpu.ops.tsdf import fuse_multi_sequence
    from multiviewstitch_tpu.solvers.unionfind import retain_largest_component
    from multiviewstitch_tpu.models.template_body import (make_template,
                                                          pose_template)
    from multiviewstitch_tpu.pipeline.deform_render import (deform_stage,
                                                            render_stage)
    from multiviewstitch_tpu.pipeline.fixtures import ring_cameras
    from multiviewstitch_tpu.core.transforms import Similarity

    cfg = CFG.replace(max_keypoints=512)
    seq1, seq2, gt, _, _ = build_two_sequences(n_frames=5, width=W, height=H)
    seqs = [seq1, seq2]
    times = {}

    def stage(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        jax.block_until_ready(jax.tree_util.tree_leaves(out))
        times[name] = time.perf_counter() - t0
        return out

    for rep in ("cold", "warm"):
        res = stage("align", align_sequences, seqs, cfg, seed=0)
        pts, nrm = stage("fuse", fuse_sequences, seqs, res, cfg)
        grid = min(1 << cfg.psn_dpt_max, 256)
        verts, faces, _ = stage(
            "reconstruct", fuse_multi_sequence,
            [np.asarray(s.disparity) for s in seqs], [s.cams for s in seqs],
            res.transforms, grid=grid, min_dsp=cfg.min_dsp,
            max_dsp=cfg.max_dsp)
        verts, faces, _ = retain_largest_component(verts, faces)
        say(f"  config-2 align+fuse+reconstruct ({rep}) 2 seq x 5 frames "
            f"{W}x{H}: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                     times.items()) + f"  [{label}]")

    T = res.transforms[0]
    dR = np.asarray(T.R) @ np.asarray(gt.R).T
    ang = float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
    s_err = abs(float(T.s) - float(gt.s)) / float(gt.s)
    t_err = float(np.linalg.norm(np.asarray(T.t) - np.asarray(gt.t)))
    say(f"  similarity vs ground truth: scale rel err {s_err:.5f} (tol 0.05),"
        f" rotation {ang:.4f} deg (tol 3), translation {t_err:.5f} "
        f"(tol 0.08); fused cloud {len(pts)} pts; TSDF mesh {len(verts)} "
        f"verts / {len(faces)} faces")
    check(s_err < 0.05 and ang < 3.0 and t_err < 0.08,
          "recovered similarity outside the e2e test bounds")
    check(len(pts) > 2000 and np.isfinite(pts).all(), "fused cloud bad")
    check(len(faces) > 1000 and np.isfinite(verts).all(), "TSDF mesh bad")

    # template fit to a ~100k-face scan, then re-render 8 VGA frames of
    # the fitted template and of the scan itself
    tv, tf, tl = make_template()
    hv, hf, hl = make_template(n_seg=48, n_ring=56)
    scan_v = (1.1 * pose_template(hv, hl, arm_angle_deg=18.0) +
              np.array([0.15, 0.0, -0.05])).astype(np.float32)
    times = {}
    d = stage("deform", deform_stage, tv, tf, tl, scan_v, hf,
              np.array([0.0, 0.0, 1.0]), deform_passes=2)
    check(np.isfinite(d.vertices).all(), "deformed template not finite")
    center = scan_v.mean(0)
    bound = float(np.linalg.norm(scan_v - center, axis=1).max())
    cams = ring_cameras(8, radius=1.8 * bound, width=W, img_height=H,
                        length_focal=520.0, arc_deg=60.0,
                        look_at=tuple(center.tolist()))
    for what, vv, ff in (("template", d.vertices, d.faces),
                         ("scan", scan_v, hf)):
        for rep in ("cold", "warm"):
            m = {}
            out = stage(f"render_{what}_{rep}", render_stage, vv, ff,
                        [Similarity.identity()], [cams], metrics=m)
        dd = out[0]
        say(f"  render {what} ({len(ff)} faces) into 8 x {W}x{H}: coverage "
            f"{m['render_coverage']:.4f}")
        check(dd.shape == (8, H, W) and np.isfinite(dd).all(),
              f"{what} render not finite")
        check((dd > 0).mean() > 0.01, f"{what} render empty")
    say("  deform/render: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                        times.items()) + f"  [{label}]")


# ---------------------------------------------------------------------------
# phase 4: four cards
# ---------------------------------------------------------------------------

def four_gpus(label, n_dev=4, width=320, height=240, frames=32,
              ba_cams=64, ba_pts=16384, arap_grid=(64, 96)):
    import jax
    import jax.numpy as jnp
    from multiviewstitch_tpu.parallel.mesh import make_mesh
    from multiviewstitch_tpu.core.transforms import Similarity
    from multiviewstitch_tpu.pipeline.fixtures import make_scene, textured_views
    from multiviewstitch_tpu.pipeline.align_seq import (
        Sequence, align_sequences, fuse_sequences)
    from multiviewstitch_tpu.parallel import ba_dist
    from multiviewstitch_tpu.parallel.arap_blocks import (build_blocks,
                                                          arap_solve_blocks)
    from multiviewstitch_tpu.solvers import deformation as D
    from multiviewstitch_tpu.solvers.ba import rodrigues
    from multiviewstitch_tpu.pipeline.fixtures import uv_sphere
    from multiviewstitch_tpu.pipeline.fixtures import (
        E2E_CONFIG as CFG, synth_ba_problem)

    check(len(jax.devices()) >= n_dev, f"need {n_dev} devices")
    mesh = make_mesh(n_dev, ("views",))
    mesh1 = make_mesh(1, ("views",))

    # config 5: 2 sequences x 32 frames = 64 views
    cfg = CFG.replace(max_keypoints=256, iter_num=64)
    gt = Similarity(jnp.asarray(1.15, jnp.float32),
                    jnp.asarray(np.array([[0.9848, 0.0, 0.1736],
                                          [0.0, 1.0, 0.0],
                                          [-0.1736, 0.0, 0.9848]],
                                         np.float32)),
                    jnp.asarray([0.1, -0.05, 0.15], jnp.float32))
    scenes = [make_scene(n_frames=frames, width=width, height=height,
                         bumps=0.15, n_lat=48, n_lon=64, arc_deg=120.0,
                         transform=tr) for tr in (None, gt)]
    seqs = [Sequence(jnp.asarray(textured_views(s)), jnp.asarray(s.disparity),
                     s.cams) for s in scenes]

    def e2e(m):
        res = align_sequences(seqs, cfg, seed=0, mesh=m)
        pts, _ = fuse_sequences(seqs, res, cfg)
        return res, pts

    def rot_deg(Ra, Rb):
        dR = np.asarray(Ra) @ np.asarray(Rb).T
        return float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2,
                                                  -1, 1))))

    walls = {}
    for name, m in (("1 card", None), (f"{n_dev} cards", mesh)):
        e2e(m)
        t0 = time.perf_counter()
        res, pts = e2e(m)
        walls[name] = (time.perf_counter() - t0, res, pts)
    (w1, r1, p1), (w4, r4, p4) = walls.values()
    peaks = [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
             for d in jax.devices()[:n_dev]]
    T1, T4 = r1.transforms[0], r4.transforms[0]
    say(f"  config-5 64-view align+fuse at {width}x{height}: unsharded "
        f"{w1:.3f} s, sharded over {n_dev} cards {w4:.3f} s  [{label}]")
    say(f"    rotation vs GT {rot_deg(T4.R, gt.R):.4f} deg (sharded) / "
        f"{rot_deg(T1.R, gt.R):.4f} (unsharded); sharded vs unsharded "
        f"{rot_deg(T4.R, T1.R):.5f} deg, scale {float(T4.s):.6f} vs "
        f"{float(T1.s):.6f}; fused points {len(p4)} vs {len(p1)}; peak "
        f"bytes per device {peaks}")
    check(rot_deg(T4.R, gt.R) < 3.0, "sharded config-5 rotation off")
    check(rot_deg(T4.R, T1.R) < 0.1 and abs(float(T4.s) - float(T1.s)) <
          1e-3 * float(T1.s), "sharded and unsharded similarity differ")
    check(abs(len(p4) - len(p1)) <= 0.01 * len(p1), "fused clouds differ")
    if jax.devices()[0].platform == "gpu":
        check(min(peaks[1:]) >= 0.01 * peaks[0] > 0,
              "work lands on device 0 only")

    # point-sharded BA Gauss-Newton step
    # the six-camera arc of tests/test_parallel.py, sampled by ba_cams
    # cameras: every camera sees (nearly) every point
    prob, _, init = synth_ba_problem(n_cams=ba_cams, n_pts=ba_pts,
                                     pose_noise=0.01, pt_noise=0.02,
                                     ang_step=0.48 / ba_cams,
                                     t_step=0.9 / ba_cams)
    check(np.bincount(np.asarray(prob.cam_idx), minlength=ba_cams).min()
          >= 0.9 * ba_pts, "a BA camera sees under 90% of the points")
    blocks = ba_dist.group_by_point(
        np.asarray(prob.K), np.asarray(prob.cam_idx), np.asarray(prob.pt_idx),
        np.asarray(prob.uv), ba_pts, ba_cams, max_obs_per_point=ba_cams)
    outs = {}
    for name, m in (("1", mesh1), (str(n_dev), mesh)):
        step = lambda: ba_dist.gn_step_sharded(  # noqa: E731
            blocks, init, jnp.asarray(1e-3), mesh=m, num_cams=ba_cams)
        jax.block_until_ready(step())
        t0 = time.perf_counter()
        jax.block_until_ready(step())
        t_step = time.perf_counter() - t0
        ba_dist.solve_ba_sharded(blocks, init, m, iters=15)     # compile
        t0 = time.perf_counter()
        st, rmse = ba_dist.solve_ba_sharded(blocks, init, m, iters=15)
        outs[name] = (t_step, time.perf_counter() - t0, jax.device_get(st),
                      rmse)
    (t1, w1, s1, r1), (t4, w4, s4, r4) = outs.values()

    def shape_of_rig(st):
        """Camera centers relative to the fixed camera 0, divided by their
        mean distance from it: invariant under the one gauge camera 0
        leaves free (a scale about its center)."""
        R = np.asarray(rodrigues(jnp.asarray(st.rvec)), np.float64)
        c = -np.einsum("kji,kj->ki", R, np.asarray(st.tvec, np.float64))
        rel = c - c[0]
        norm = np.linalg.norm(rel, axis=1).mean()
        return rel / norm, norm

    (g1, n1), (g4, n4) = shape_of_rig(s1), shape_of_rig(s4)
    e_r = float(np.abs(s4.rvec - s1.rvec).max())
    e_c = float(np.abs(g4 - g1).max())
    say(f"  BA {ba_cams} cams x {ba_pts} pts: GN step 1 card {t1 * 1e3:.2f} "
        f"ms, {n_dev} cards {t4 * 1e3:.2f} ms; 15-iteration LM solve "
        f"{w1 * 1e3:.1f} / {w4 * 1e3:.1f} ms, reprojection RMSE {r1:.4f} / "
        f"{r4:.4f} px (tol < 0.2 and within 0.1 px); max |drvec| "
        f"{e_r:.3g} (tol 2e-3, tests/test_parallel.py); rig scale "
        f"{n4 / n1:.5f} of the unsharded one, max difference of the "
        f"scale-normalized camera centers {e_c:.3g} (tol 1e-3: with camera "
        f"0 fixed the scale is a free gauge of exact data, which the psum's "
        f"other f32 summation order moves along)  [{label}]")
    check(r4 < 0.2 and abs(r4 - r1) < 0.1, "sharded BA RMSE differs")
    check(e_r <= 2e-3 and e_c <= 1e-3, "sharded BA solution differs")

    # block ARAP vs the unsharded solve
    v, f = uv_sphere(*arap_grid, radius=1.0)
    edges = D.mesh_edges(f)
    wts = D.cotangent_weights(v, f, edges)
    ang = np.radians(25)
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0],
                   [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    moved = (Rz @ v.T).T + np.array([0.2, -0.1, 0.3], np.float32)
    con = np.zeros(len(v), bool)
    con[D.uniform_sampling(v)] = True
    tgt = np.where(con[:, None], moved, 0.0)
    prob = D.ARAPProblem(jnp.asarray(v), jnp.asarray(edges),
                         jnp.asarray(wts), jnp.asarray(con),
                         jnp.asarray(tgt))
    t0 = time.perf_counter()
    ref = np.asarray(D.arap_solve(prob, outer_iters=6, cg_iters=200))
    t_ref = time.perf_counter() - t0
    blocks = build_blocks(v, edges, wts, con, tgt, n_dev)
    t0 = time.perf_counter()
    out = np.asarray(arap_solve_blocks(blocks, mesh=mesh, outer_iters=6,
                                       cg_iters=200))
    t_blk = time.perf_counter() - t0
    err = float(np.abs(out - ref).max())
    say(f"  block ARAP {len(v)} verts: unsharded {t_ref:.3f} s, {n_dev} "
        f"blocks {t_blk:.3f} s (both incl. compile); max |diff| {err:.3g} "
        f"(tol 5e-3, as in tests/test_parallel.py)  [{label}]")
    check(err <= 5e-3, "block ARAP differs from the unsharded solve")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card sharded-vs-unsharded phase")
    args = ap.parse_args(argv)

    devices = require_gpu()
    from multiviewstitch_tpu.utils.compile_cache import enable_compile_cache
    from multiviewstitch_tpu.utils.profiling import device_info

    say(f"jax.devices(): {devices}")
    say(f"device_kind: {devices[0].device_kind}")
    label = card_label()
    say(f"nvidia-smi name, power.limit: {label}")
    say(f"compile cache: {enable_compile_cache()}")

    failed = []

    def phase(name, fn, *a):
        say(f"[{name}]")
        t0 = time.perf_counter()
        try:
            fn(*a)
        except Exception:  # a failed phase is reported, the next one runs
            traceback.print_exc()
            failed.append(name)
            say(f"[{name}] FAILED")
        else:
            say(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)  [{label}]")

    if args.four_gpus:
        phase("four-gpus", four_gpus, label)
    else:
        rng = np.random.default_rng(0)
        scene = vga_scene()
        phase("parity:consistency+sampling", parity_consistency_sampling,
              scene, rng)
        phase("parity:view-synthesis", parity_view_synth, scene)
        phase("parity:sift", parity_sift, scene)
        phase("parity:rasterizer", parity_raster, rng)
        phase("parity:poisson", parity_poisson)
        phase("main-path", main_path, label)

    if failed:
        say(f"FAILED phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

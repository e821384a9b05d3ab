"""The plain bilinear samplers of view synthesis and SIFT against an exact
float64 4-tap reference (Image3D.cpp:178-211 bilinear weights; edge
coordinates clamp to the border pixel)."""

import numpy as np
import pytest
import jax.numpy as jnp

from multiviewstitch_tpu.ops.view_synth import bilinear_sample


def _four_tap(src, sy, sx):
    """float64 4-tap bilinear of src [C,H,W] at (sy, sx), edge-clamped."""
    _, h, w = src.shape
    sx = np.asarray(sx, np.float64)
    sy = np.asarray(sy, np.float64)
    x0 = np.clip(np.floor(sx), 0, w - 2).astype(np.int64)
    y0 = np.clip(np.floor(sy), 0, h - 2).astype(np.int64)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)
    s = np.asarray(src, np.float64)
    return (s[:, y0, x0] * (1 - fx) * (1 - fy) +
            s[:, y0, x0 + 1] * fx * (1 - fy) +
            s[:, y0 + 1, x0] * (1 - fx) * fy +
            s[:, y0 + 1, x0 + 1] * fx * fy)


def _homography_field(h, w, yaw_deg, focal):
    """Source coords of a yaw homography H = K R K^-1 over the [h,w] grid
    (the view-synthesis warp, Image3D.cpp:144)."""
    K = np.array([[focal, 0, (w - 1) / 2], [0, focal, (h - 1) / 2],
                  [0, 0, 1]])
    a = np.radians(yaw_deg)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    Hm = K @ R @ np.linalg.inv(K)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    p = np.einsum("ij,jhw->ihw", Hm, np.stack([u, v, np.ones_like(u)]))
    return (p[1] / p[2]).astype(np.float32), (p[0] / p[2]).astype(np.float32)


@pytest.mark.parametrize("field", ["random_with_edges", "yaw16",
                                   "yaw56_wide_fov"])
def test_view_synth_sampler_matches_four_tap(field):
    h, w = 48, 64
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 255, (3, h, w)).astype(np.float32)
    if field == "random_with_edges":
        sy = rng.uniform(-3, h + 2, (h, w)).astype(np.float32)
        sx = rng.uniform(-3, w + 2, (h, w)).astype(np.float32)
    elif field == "yaw16":
        sy, sx = _homography_field(h, w, 16.0, 60.0)
    else:
        # the wide-warp geometry: 56 deg yaw under a wide field of view,
        # where the source row varies strongly along each output row
        sy, sx = _homography_field(h, w, 56.0, 25.0)
    sy = np.clip(sy, -1e4, 1e4)
    sx = np.clip(sx, -1e4, 1e4)
    got = np.asarray(bilinear_sample(jnp.asarray(src), jnp.asarray(sy),
                                     jnp.asarray(sx)))
    want = _four_tap(src, sy, sx)
    # f32 rounding of four weighted taps of values <= 255
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("where", ["interior", "edges"])
def test_sift_sampler_matches_four_tap(where):
    from multiviewstitch_tpu.ops.features import (_grad_pyramid,
                                                  _sample_grad_patches)
    rng = np.random.default_rng(5)
    img = rng.standard_normal((64, 96)).astype(np.float32)
    gx_atlas, gy_atlas, meta = _grad_pyramid(jnp.asarray(img), 2)
    K, S = 32, 24
    lvl = rng.integers(0, 4, K)
    ds = np.asarray(meta[3], np.float64)[lvl]
    ws = np.asarray(meta[2], np.float64)[lvl]
    hs = np.asarray(meta[1], np.float64)[lvl]
    if where == "interior":
        cx, cy = rng.uniform(10, ws - 10), rng.uniform(10, hs - 10)
        span = 8
    else:
        # centers on the level border, offsets reaching past every edge
        cx = np.where(rng.random(K) < 0.5, 0.5, ws - 1.5)
        cy = np.where(rng.random(K) < 0.5, 0.5, hs - 1.5)
        span = 24
    uv = np.stack([cx * ds, cy * ds], -1).astype(np.float32)
    dx = rng.uniform(-span, span, (K, S)).astype(np.float32)
    dy = rng.uniform(-span, span, (K, S)).astype(np.float32)
    gx, gy = _sample_grad_patches(gx_atlas, gy_atlas, meta,
                                  jnp.asarray(lvl, jnp.int32),
                                  jnp.asarray(uv), jnp.asarray(dx),
                                  jnp.asarray(dy))
    offs = np.asarray(meta[0])
    for atlas, got in ((np.asarray(gx_atlas), np.asarray(gx)),
                       (np.asarray(gy_atlas), np.asarray(gy))):
        for i in range(K):
            o, hl, wl = offs[lvl[i]], int(hs[i]), int(ws[i])
            level = atlas[o:o + hl, :wl][None]
            sx = np.float32(uv[i, 0] / np.float32(ds[i])) + dx[i]
            sy = np.float32(uv[i, 1] / np.float32(ds[i])) + dy[i]
            want = _four_tap(level, sy, sx)[0]
            scale = max(np.abs(level).max(), 1e-6)
            np.testing.assert_allclose(got[i], want, rtol=0,
                                       atol=1e-5 * scale)

import numpy as np
import jax
import jax.numpy as jnp

from multiviewstitch_tpu.ops.features import detect_and_describe, detect_batch
from multiviewstitch_tpu.ops.match import match_descriptors
from multiviewstitch_tpu.ops.filters import (dedup_matches, ssd_filter,
                                             gap_filter, margin_mask)
from multiviewstitch_tpu.ops.view_synth import synthesize_views, view_angles


def checkerboard_with_dots(h=120, w=160, seed=0, n_dots=40):
    """Textured test image: smooth gradient + gaussian blobs (corner-rich)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.2 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    for _ in range(n_dots):
        cx, cy = rng.uniform(10, w - 10), rng.uniform(10, h - 10)
        amp = rng.uniform(0.5, 1.0) * rng.choice([-1, 1])
        sig = rng.uniform(1.5, 3.0)
        img += amp * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig ** 2))
    return img.astype(np.float32)


def test_detector_finds_blobs_and_respects_margins():
    img = checkerboard_with_dots()
    kp = detect_and_describe(jnp.asarray(img), max_keypoints=128,
                             margins=(0.25, 0.25, 0.1, 0.1))
    uv = np.asarray(kp.uv)[np.asarray(kp.valid)]
    assert len(uv) > 20
    h, w = img.shape
    assert uv[:, 0].min() >= 0.25 * w - 1
    assert uv[:, 0].max() <= 0.75 * w + 1
    assert uv[:, 1].min() >= 0.1 * h - 1
    assert uv[:, 1].max() <= 0.9 * h + 1


def test_descriptors_match_under_translation():
    img = checkerboard_with_dots(seed=1)
    # shift by whole pixels: descriptors should match at shifted positions
    sh = 6
    img2 = np.roll(img, (sh, sh), axis=(0, 1))
    kp1 = detect_and_describe(jnp.asarray(img), max_keypoints=128)
    kp2 = detect_and_describe(jnp.asarray(img2), max_keypoints=128)
    m = match_descriptors(kp1.desc, kp1.valid, kp2.desc, kp2.valid,
                          distmax=0.7, ratiomax=0.8)
    i1 = np.asarray(m.idx1)[np.asarray(m.valid)]
    i2 = np.asarray(m.idx2)[np.asarray(m.valid)]
    assert len(i1) >= 10
    duv = np.asarray(kp2.uv)[i2] - np.asarray(kp1.uv)[i1]
    good = (np.abs(duv - sh) <= 1.5).all(axis=1)
    assert good.mean() > 0.8  # most matches consistent with the shift


def test_matcher_ratio_and_mutual():
    # two distinct descriptors + one ambiguous pair
    d1 = np.zeros((3, 128), np.float32)
    d2 = np.zeros((4, 128), np.float32)
    d1[0, 0] = 1
    d2[0, 0] = 1                      # perfect match
    d1[1, 1] = 1
    d2[1, 1] = 0.9; d2[1, 2] = np.sqrt(1 - 0.81)
    d2[2, 1] = 0.9; d2[2, 3] = np.sqrt(1 - 0.81)  # ambiguous twin
    d1[2, 5] = 1                      # no counterpart
    for d in (d1, d2):
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    m = match_descriptors(jnp.asarray(d1), jnp.ones(3, bool),
                          jnp.asarray(d2), jnp.ones(4, bool),
                          distmax=0.7, ratiomax=0.8)
    v = np.asarray(m.valid)
    assert v[0] and not v[1] and not v[2]
    assert np.asarray(m.idx2)[0] == 0


def test_dedup():
    uv1 = jnp.asarray([[3, 4], [3, 4], [5, 6], [1, 1]], jnp.int32)
    uv2 = jnp.asarray([[7, 8], [7, 8], [9, 9], [2, 2]], jnp.int32)
    mask = jnp.asarray([True, True, True, False])
    a, b, m = dedup_matches(uv1, uv2, mask)
    kept1 = np.asarray(a)[np.asarray(m)]
    assert len(kept1) == 2
    # sorted by (u1,v1,...): (3,4) then (5,6)
    np.testing.assert_array_equal(kept1, [[3, 4], [5, 6]])


def test_ssd_filter():
    img1 = checkerboard_with_dots(seed=2) * 100
    img2 = img1.copy()
    img2[40:60, 40:60] += 80.0  # corrupt one region
    uv = jnp.asarray([[20, 20], [50, 50], [2, 2]], jnp.int32)
    mask = jnp.ones(3, bool)
    out = ssd_filter(jnp.asarray(img1), jnp.asarray(img2), uv, uv, mask,
                     win=3, ssd_err=40.0)
    v = np.asarray(out)
    assert v[0]           # identical region passes
    assert not v[1]       # corrupted region fails
    assert not v[2]       # window out of bounds fails (ref: u >= ssd_win)


def test_gap_filter_sequential_semantics():
    # matches in order; second conflicts with first via endpoint 1,
    # third conflicts with first via endpoint 2, fourth is clear
    uv1 = jnp.asarray([[0, 0], [3, 0], [50, 50], [100, 0]], jnp.int32)
    uv2 = jnp.asarray([[0, 0], [60, 60], [2, 2], [100, 0]], jnp.int32)
    mask = jnp.ones(4, bool)
    kept = np.asarray(gap_filter(uv1, uv2, mask, min_gap_sq=25.0))
    np.testing.assert_array_equal(kept, [True, False, False, True])


def test_gap_filter_block_greedy_equals_sequential_oracle():
    """The chunked (block-greedy) gap filter is bit-identical to the
    reference's per-match greedy scan (Processor.cpp:711-735), across
    random sizes incl. non-multiples of the chunk and dense conflicts."""
    rng = np.random.default_rng(42)
    for m, g in [(50, 25.0), (64, 9.0), (129, 100.0), (2048, 9.0)]:
        uv1 = rng.integers(0, 120, size=(m, 2)).astype(np.int32)
        uv2 = rng.integers(0, 120, size=(m, 2)).astype(np.int32)
        mask = rng.random(m) < 0.9
        kept_ref = np.zeros(m, bool)
        for k in range(m):
            if not mask[k]:
                continue
            d1 = ((uv1 - uv1[k]).astype(np.float64) ** 2).sum(-1)
            d2 = ((uv2 - uv2[k]).astype(np.float64) ** 2).sum(-1)
            if not np.any(kept_ref & ((d1 <= g) | (d2 <= g))):
                kept_ref[k] = True
        out = np.asarray(gap_filter(jnp.asarray(uv1), jnp.asarray(uv2),
                                    jnp.asarray(mask), min_gap_sq=g))
        np.testing.assert_array_equal(out, kept_ref, err_msg=f"m={m} g={g}")


def test_margin_mask():
    mm = np.asarray(margin_mask(10, 20, 0.25, 0.25, 0.1, 0.1))
    assert mm[5, 2] == 0 and mm[5, 17] == 0      # horizontal margins
    assert mm[0, 10] == 0                        # vertical margin
    assert mm[5, 10] == 1


def test_view_synthesis_identity_angle():
    img = checkerboard_with_dots()[..., None]
    K = jnp.asarray([[100.0, 0, 79.5], [0, 100.0, 59.5], [0, 0, 1]])
    R = jnp.eye(3)
    out = synthesize_views(jnp.asarray(img), K, R,
                           jnp.asarray([0.0]), axis=1)
    # zero rotation: output == input, texIndex = identity
    got = np.asarray(out.images[0, ..., 0])
    np.testing.assert_allclose(got, img[..., 0], atol=1e-4)
    h, w = img.shape[:2]
    np.testing.assert_array_equal(np.asarray(out.tex_index[0]).ravel(),
                                  np.arange(h * w))


def test_view_synthesis_rotation_roundtrip():
    # warping by +a then matching features against the original image:
    # tex_index must map view pixels back to source pixels within ~1px
    img = checkerboard_with_dots(seed=3)[..., None]
    K = jnp.asarray([[100.0, 0, 79.5], [0, 100.0, 59.5], [0, 0, 1]])
    R = jnp.eye(3)
    angles = view_angles(3, 10.0)
    assert np.allclose(np.asarray(angles) * 180 / np.pi, [-10, 0, 10])
    out = synthesize_views(jnp.asarray(img), K, R, angles, axis=1)
    tex = np.asarray(out.tex_index[1])
    h, w = img.shape[:2]
    valid = tex >= 0
    assert valid.mean() > 0.95
    # the 0-angle middle view keeps identity mapping
    np.testing.assert_array_equal(tex[valid],
                                  np.arange(h * w).reshape(h, w)[valid])
    # rotated views: coverage shifts but stays substantial
    tex0 = np.asarray(out.tex_index[0])
    assert (tex0 >= 0).mean() > 0.6


def test_detect_batch_shapes():
    imgs = np.stack([checkerboard_with_dots(seed=s) for s in range(3)])
    kp = detect_batch(jnp.asarray(imgs), max_keypoints=64)
    assert kp.desc.shape == (3, 64, 128)
    assert kp.valid.shape == (3, 64)
    n = np.linalg.norm(np.asarray(kp.desc), axis=-1)
    ok = np.asarray(kp.valid)
    np.testing.assert_allclose(n[ok], 1.0, atol=1e-3)


def test_dog_scales_are_interpolated_off_grid():
    """Scale interpolation (1D fit along the DoG scale axis): detected
    sigmas must be continuous, not snapped to the discrete k^s pyramid."""
    img = checkerboard_with_dots(seed=7)
    kp = detect_and_describe(jnp.asarray(img), max_keypoints=128)
    sc = np.asarray(kp.scale)[np.asarray(kp.valid, bool)]
    assert len(sc) > 20
    k = 2.0 ** (1.0 / 3.0)
    grid = k ** np.arange(0, 12, dtype=np.float64)
    grid = np.concatenate([grid, 2 * grid, 4 * grid])
    off_grid = np.min(np.abs(sc[:, None] - grid[None, :]), axis=1) > 1e-4
    assert off_grid.mean() > 0.3


def test_sample_grad_patches_exact_mode_is_f32_exact():
    """The gradient sampler must return f32-exact bilinear taps of the
    atlas: error within a few ulps of the tap magnitudes (FMA/association
    order differs across backends), far below any bf16 rounding."""
    import jax.numpy as jnp
    from multiviewstitch_tpu.ops.features import (_grad_pyramid,
                                                  _sample_grad_patches)

    rng = np.random.default_rng(3)
    img = rng.standard_normal((64, 96)).astype(np.float32)
    gx_atlas, gy_atlas, meta = _grad_pyramid(jnp.asarray(img), 2)
    K, S = 24, 16
    lvl = jnp.asarray(rng.integers(0, 4, K), jnp.int32)
    ds = np.asarray(meta[3], np.float32)[np.asarray(lvl)]
    ws = np.asarray(meta[2], np.float32)[np.asarray(lvl)]
    hs = np.asarray(meta[1], np.float32)[np.asarray(lvl)]
    # centers well inside each level, offsets within the window bound
    cx = rng.uniform(12, ws - 12) * ds
    cy = rng.uniform(12, hs - 12) * ds
    uv = jnp.asarray(np.stack([cx, cy], -1), jnp.float32)
    dx = jnp.asarray(rng.uniform(-8, 8, (K, S)), jnp.float32)
    dy = jnp.asarray(rng.uniform(-8, 8, (K, S)), jnp.float32)
    gx, gy = _sample_grad_patches(gx_atlas, gy_atlas, meta, lvl, uv,
                                  dx, dy)

    # NumPy oracle: f32 bilinear taps of the same atlas rows
    gxa = np.asarray(gx_atlas)
    gya = np.asarray(gy_atlas)
    offs = np.asarray(meta[0])
    for atlas, got in ((gxa, np.asarray(gx)), (gya, np.asarray(gy))):
        for i in range(K):
            li = int(lvl[i])
            o, hl, wl, d = offs[li], int(hs[i]), int(ws[i]), ds[i]
            cxl, cyl = cx[i] / d, cy[i] / d
            for s in range(S):
                sx = np.float32(cxl) + np.float32(dx[i, s])
                sy = np.float32(cyl) + np.float32(dy[i, s])
                x0 = int(np.clip(np.int32(sx), 0, wl - 2))
                y0 = int(np.clip(np.int32(sy), 0, hl - 2))
                fx = np.float32(np.clip(sx - x0, 0.0, 1.0))
                fy = np.float32(np.clip(sy - y0, 0.0, 1.0))
                r0 = (np.float32(1) - fx) * atlas[o + y0, x0] \
                    + fx * atlas[o + y0, x0 + 1]
                r1 = (np.float32(1) - fx) * atlas[o + y0 + 1, x0] \
                    + fx * atlas[o + y0 + 1, x0 + 1]
                want = (np.float32(1) - fy) * r0 + fy * r1
                taps = max(abs(atlas[o + y0, x0]), abs(atlas[o + y0, x0+1]),
                           abs(atlas[o + y0+1, x0]), abs(atlas[o + y0+1,
                                                                x0+1]))
                # 16 f32 ulps of the tap scale (bf16 rounding would sit
                # >= 64x above this bound)
                assert abs(got[i, s] - want) <= 1e-6 * max(taps, 1e-6)

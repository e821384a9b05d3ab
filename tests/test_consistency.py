import numpy as np
import pytest
import jax.numpy as jnp

from multiviewstitch_tpu.ops.consistency import (check_consistency,
                                                 consistency_stats)
from multiviewstitch_tpu.pipeline.fixtures import make_scene

MIN_DSP, MAX_DSP = 1e-3, 10.0


def test_consistent_scene_survives():
    # 12 ring cameras = 30 deg neighbor baseline (video-like; the check is
    # built for small-baseline sequences, Processor.cpp:49-55)
    scene = make_scene(n_frames=12, width=96, height=72, bumps=0.0,
                       n_lat=48, n_lon=64)
    d = jnp.asarray(scene.disparity)
    out = check_consistency(d, scene.cams, min_dsp=MIN_DSP, max_dsp=MAX_DSP,
                            reproj_err=4)
    before = (scene.disparity >= MIN_DSP) & (scene.disparity <= MAX_DSP)
    after = np.asarray(out) > 0
    # a geometrically consistent scene keeps the bulk of its valid pixels
    # (silhouette pixels die: neighbors see past the rim — correct behavior)
    assert after.sum() > 0.5 * before.sum()
    # every surviving pixel was valid before and keeps its exact disparity
    assert np.all(before[after])
    np.testing.assert_array_equal(np.asarray(out)[after],
                                  scene.disparity[after])


def test_corrupted_frame_pixels_killed():
    scene = make_scene(n_frames=12, width=96, height=72, bumps=0.0,
                       n_lat=48, n_lon=64)
    d = scene.disparity.copy()
    clean = check_consistency(jnp.asarray(d), scene.cams, min_dsp=MIN_DSP,
                              max_dsp=MAX_DSP, reproj_err=4)
    clean_mask = np.asarray(clean)[1] > 0
    # corrupt frame 1's depths in a block that survives the clean pass:
    # halving the disparity doubles the depth -> inconsistent with neighbors
    ys, xs = np.where(clean_mask)
    yc, xc = int(np.median(ys)), int(np.median(xs))
    sel = (slice(yc - 4, yc + 4), slice(xc - 4, xc + 4))
    assert clean_mask[sel].sum() > 16  # block sits on surviving surface
    d1 = d.copy()
    d1[1][sel] = d1[1][sel] * 0.5
    out = np.asarray(check_consistency(jnp.asarray(d1), scene.cams,
                                       min_dsp=MIN_DSP, max_dsp=MAX_DSP,
                                       reproj_err=4))
    corrupted_then = d[1][sel] > 0
    survived = out[1][sel][corrupted_then] > 0
    assert survived.mean() < 0.2  # corrupted pixels overwhelmingly killed


def test_out_of_range_zeroed():
    scene = make_scene(n_frames=3, width=64, height=48, bumps=0.0,
                       n_lat=32, n_lon=48)
    d = scene.disparity.copy()
    d[0, 0, 0] = 100.0  # out of range
    out = np.asarray(check_consistency(jnp.asarray(d), scene.cams,
                                       min_dsp=MIN_DSP, max_dsp=MAX_DSP,
                                       reproj_err=4))
    assert out[0, 0, 0] == 0.0


def test_single_frame_passthrough():
    # with one frame there are no neighbors: valid pixels survive untouched
    scene = make_scene(n_frames=1, width=64, height=48, bumps=0.0,
                       n_lat=32, n_lon=48)
    d = jnp.asarray(scene.disparity)
    out = np.asarray(check_consistency(d, scene.cams, min_dsp=MIN_DSP,
                                       max_dsp=MAX_DSP, reproj_err=4))
    valid = (scene.disparity >= MIN_DSP) & (scene.disparity <= MAX_DSP)
    np.testing.assert_array_equal(out[valid], scene.disparity[valid])
    assert np.all(out[~valid] == 0)


def test_stats():
    scene = make_scene(n_frames=2, width=64, height=48, bumps=0.0,
                       n_lat=32, n_lon=48)
    d = jnp.asarray(scene.disparity)
    out = check_consistency(d, scene.cams, min_dsp=MIN_DSP, max_dsp=MAX_DSP,
                            reproj_err=4)
    s = consistency_stats(d, out, MIN_DSP, MAX_DSP)
    assert 0 < s["valid_after"] <= s["valid_before"] < 1


# ---------------------------------------------------------------------------
# per-pixel loop references (Processor.cpp:82-108 and the agreement vote of
# ops/point_sampling.py), float64. A pixel whose reprojection lands within
# EPS px of a .5 rounding boundary may legitimately round either way in
# float32, so it is reported as ambiguous and left out of the comparison.
# ---------------------------------------------------------------------------

EPS = 1e-4


def _near_half(x):
    y = x + 0.5
    return abs(y - np.floor(y + 0.5)) < EPS


def _rig(cams):
    return (np.asarray(cams.K, np.float64), np.asarray(cams.R, np.float64),
            np.asarray(cams.t, np.float64))


def _unproject(K, R, t, u, v, depth):
    pc = np.array([(u - K[0, 2]) * depth / K[0, 0],
                   (v - K[1, 2]) * depth / K[1, 1], depth])
    return R.T @ (pc - t)


def _project(K, R, t, pw):
    pc = R @ pw + t
    z = pc[2] if abs(pc[2]) >= 1e-12 else 1e-12
    return K[0, 0] * pc[0] / z + K[0, 2], K[1, 1] * pc[1] / z + K[1, 2], pc[2]


def _loop_consistency(disp, cams, offsets, reproj_err):
    Ks, Rs, ts = _rig(cams)
    n, h, w = disp.shape
    keep = np.zeros(disp.shape, bool)
    amb = np.zeros(disp.shape, bool)
    for i in range(n):
        for y in range(h):
            for x in range(w):
                d = float(disp[i, y, x])
                if not MIN_DSP <= d <= MAX_DSP:
                    continue
                pw = _unproject(Ks[i], Rs[i], ts[i], x, y, 1.0 / d)
                ok, near = True, False
                for off in offsets:
                    j = i + off
                    if not 0 <= j < n:
                        continue
                    u, v, z = _project(Ks[j], Rs[j], ts[j], pw)
                    near |= _near_half(u) or _near_half(v)
                    ui, vi = np.floor(u + 0.5), np.floor(v + 0.5)
                    if not (0 <= ui <= w - 1 and 0 <= vi <= h - 1 and z > 0):
                        ok = False
                        break
                    dn = float(disp[j, int(vi), int(ui)])
                    if not MIN_DSP <= dn <= MAX_DSP:
                        ok = False
                        break
                    pn = _unproject(Ks[j], Rs[j], ts[j], ui, vi, 1.0 / dn)
                    ub, vb, _ = _project(Ks[i], Rs[i], ts[i], pn)
                    near |= _near_half(ub) or _near_half(vb)
                    ib, jb = np.floor(ub + 0.5), np.floor(vb + 0.5)
                    if not (0 <= ib <= w - 1 and 0 <= jb <= h - 1):
                        ok = False
                        break
                    if (x - ib) ** 2 + (y - jb) ** 2 > reproj_err ** 2:
                        ok = False
                        break
                keep[i, y, x] = ok
                amb[i, y, x] = near
    return keep, amb


def _loop_votes(disp, cams, stride, nbr_num, dsp_err):
    Ks, Rs, ts = _rig(cams)
    n, h, w = disp.shape
    ys, xs = range(0, h, stride), range(0, w, stride)
    conf = np.ones((n, len(ys), len(xs)))
    amb = np.zeros(conf.shape, bool)
    for i in range(n):
        for a, y in enumerate(ys):
            for b, x in enumerate(xs):
                d = float(disp[i, y, x])
                if not MIN_DSP <= d <= MAX_DSP:
                    continue
                pw = _unproject(Ks[i], Rs[i], ts[i], x, y, 1.0 / d)
                votes = exists = 0
                for k in range(1, nbr_num + 1):
                    for j in (i - k, i + k):
                        if not 0 <= j < n:
                            continue
                        exists += 1
                        u, v, z = _project(Ks[j], Rs[j], ts[j], pw)
                        ui, vi = np.floor(u + 0.5), np.floor(v + 0.5)
                        inb = (0 <= ui <= w - 1 and 0 <= vi <= h - 1 and
                               z > 0)
                        dn = float(disp[j, int(np.clip(vi, 0, h - 1)),
                                        int(np.clip(ui, 0, w - 1))])
                        dproj = 1.0 / z if z > 1e-12 else 0.0
                        amb[i, a, b] |= (_near_half(u) or _near_half(v) or
                                         abs(abs(dn - dproj) - dsp_err) < 1e-5)
                        votes += (inb and abs(dn - dproj) <= dsp_err and
                                  MIN_DSP <= dn <= MAX_DSP)
                if exists:
                    conf[i, a, b] = votes / exists
    return conf, amb


def _edge_scene(n_frames, width, height, seed):
    """Close-up sphere that fills the frame, so reprojections leave the
    image across every edge row and column; 5% of the pixels corrupted."""
    scene = make_scene(n_frames=n_frames, width=width, height=height,
                       bumps=0.15, n_lat=32, n_lon=48, arc_deg=40.0)
    d = scene.disparity.copy()
    rng = np.random.default_rng(seed)
    d[rng.random(d.shape) < 0.05] *= 0.6
    return d, scene.cams


@pytest.mark.parametrize("n,h,w,offsets", [
    (3, 24, 32, (-1, 1)),
    (5, 20, 36, (-2, -1, 1, 2)),
    (4, 17, 23, (-1, 1)),
])
def test_consistency_matches_pixel_loop(n, h, w, offsets):
    disp, cams = _edge_scene(n, w, h, seed=n)
    out = np.asarray(check_consistency(jnp.asarray(disp), cams,
                                       min_dsp=MIN_DSP, max_dsp=MAX_DSP,
                                       reproj_err=4, offsets=offsets))
    keep, amb = _loop_consistency(disp, cams, offsets, 4)
    assert keep.any() and (~keep & (disp > 0)).any()
    assert not ((out > 0) != keep)[~amb].any()
    np.testing.assert_array_equal(out[keep & ~amb], disp[keep & ~amb])


@pytest.mark.parametrize("n,h,w,stride,nbr_num", [
    (3, 24, 32, 2, 1),
    (5, 20, 36, 2, 2),
    (4, 17, 23, 3, 1),
])
def test_point_sampling_votes_match_pixel_loop(n, h, w, stride, nbr_num):
    from multiviewstitch_tpu.ops.point_sampling import sample_oriented_points
    disp, cams = _edge_scene(n, w, h, seed=10 + n)
    op = sample_oriented_points(jnp.asarray(disp), cams, min_dsp=MIN_DSP,
                                max_dsp=MAX_DSP, sample_radius=stride,
                                nbr_num=nbr_num, nbr_step=1, dsp_err=0.01,
                                conf_min=0.5)
    conf, amb = _loop_votes(disp, cams, stride, nbr_num, 0.01)
    valid = (disp >= MIN_DSP) & (disp <= MAX_DSP)
    vs = valid[:, ::stride, ::stride].reshape(n, -1)
    sel = vs & ~amb.reshape(n, -1)
    got = np.asarray(op.conf)
    np.testing.assert_allclose(got[sel], conf.reshape(n, -1)[sel], atol=1e-6)
    assert 0 < conf.reshape(n, -1)[vs].mean() < 1
    assert not (np.asarray(op.valid) & ~vs).any()

import numpy as np
import pytest
import jax.numpy as jnp

from multiviewstitch_tpu.core.cameras import CameraBatch, unproject_depth_map
from multiviewstitch_tpu.ops.rasterizer import render_disparity
from multiviewstitch_tpu.ops.meshing import grid_mesh, compact_mesh
from multiviewstitch_tpu.ops.mesh_normals import vertex_normals, facet_normals
from multiviewstitch_tpu.pipeline.fixtures import uv_sphere, ring_cameras, make_scene


def frontal_cam(w=64, h=48, f=60.0):
    K = jnp.asarray([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]],
                    jnp.float32)
    return CameraBatch(K, jnp.eye(3), jnp.zeros(3), w, h)


def test_rasterize_plane_analytic_depth():
    # a large quad at z=2 covering the full view -> disparity 0.5 everywhere
    z = 2.0
    verts = jnp.asarray([[-5, -5, z], [5, -5, z], [5, 5, z], [-5, 5, z]],
                        jnp.float32)
    faces = jnp.asarray([[0, 1, 2], [0, 2, 3]], jnp.int32)
    cam = frontal_cam()
    out = render_disparity(verts, faces, jnp.ones(2, bool), cam,
                           height=48, width=64)
    d = np.asarray(out.disparity)
    assert int(out.overflow) == 0
    np.testing.assert_allclose(d, 0.5, atol=1e-5)


def test_rasterize_slanted_plane_matches_analytic():
    # plane z = 2 + 0.5x: disparity varies; check center row analytically
    verts = jnp.asarray([[-1.5, -1.5, 0.0], [1.5, -1.5, 0.0],
                         [1.5, 1.5, 0.0], [-1.5, 1.5, 0.0]], jnp.float32)
    verts = verts.at[:, 2].set(2.0 + 0.5 * verts[:, 0])
    faces = jnp.asarray([[0, 1, 2], [0, 2, 3]], jnp.int32)
    cam = frontal_cam()
    out = render_disparity(verts, faces, jnp.ones(2, bool), cam,
                           height=48, width=64, tile_large=256)
    d = np.asarray(out.disparity)
    # ray through pixel u: x = (u-cx)/f * z; z = 2 + 0.5x =>
    # z = 2 / (1 - 0.5*(u-cx)/f)
    cx = (64 - 1) / 2
    for u in [10, 31, 50]:
        xz = (u - cx) / 60.0
        z_true = 2.0 / (1.0 - 0.5 * xz)
        got = d[24, u]
        assert got > 0
        np.testing.assert_allclose(1.0 / got, z_true, rtol=2e-2)


def test_rasterize_occlusion_keeps_nearest():
    # two stacked quads; nearer one (z=1) must win where both cover
    verts = jnp.asarray(
        [[-5, -5, 2], [5, -5, 2], [5, 5, 2], [-5, 5, 2],     # far
         [-0.2, -0.2, 1], [0.2, -0.2, 1], [0.2, 0.2, 1], [-0.2, 0.2, 1]],
        jnp.float32)
    faces = jnp.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]],
                        jnp.int32)
    cam = frontal_cam()
    d = np.asarray(render_disparity(verts, faces, jnp.ones(4, bool), cam,
                                    height=48, width=64).disparity)
    cx, cy = 31, 23
    np.testing.assert_allclose(d[cy, cx], 1.0, atol=1e-5)   # center: near quad
    np.testing.assert_allclose(d[2, 2], 0.5, atol=1e-5)     # corner: far quad


def test_sphere_render_depth_range():
    scene = make_scene(n_frames=2, width=96, height=72, bumps=0.0,
                       n_lat=32, n_lon=48)
    d = scene.disparity[0]
    hit = d > 0
    assert hit.mean() > 0.02
    z = 1.0 / d[hit]
    # camera at radius 2, sphere radius .5 -> depths within [1.5, 2.5]
    assert z.min() > 1.4 and z.max() < 2.6
    # silhouette: center pixel hits, border doesn't
    assert d[36, 47] > 0 and d[0, 0] == 0


def test_grid_mesh_on_ramp():
    # synthetic disparity ramp -> full grid connectivity, exact vertex count
    h, w = 12, 16
    disp = np.linspace(0.2, 0.25, h * w, dtype=np.float32).reshape(h, w)
    cam = frontal_cam(w, h)
    m = grid_mesh(jnp.asarray(disp), cam, min_dsp=0.01, max_dsp=1.0,
                  smooth_thres=100.0)
    v, f, tex = compact_mesh(m)
    assert v.shape[0] == h * w
    assert f.shape[0] == 2 * (h - 1) * (w - 1)
    # row-major numbering: tex index of vertex k == k
    np.testing.assert_array_equal(tex, np.arange(h * w))
    # all faces reference valid vertices
    assert f.min() >= 0 and f.max() < h * w


def test_grid_mesh_smoothness_threshold_cuts_cliffs():
    h, w = 8, 8
    disp = np.full((h, w), 0.2, np.float32)
    disp[:, 4:] = 0.4  # depth cliff between col 3 and 4
    cam = frontal_cam(w, h)
    m = grid_mesh(jnp.asarray(disp), cam, min_dsp=0.01, max_dsp=1.0,
                  smooth_thres=1.0)  # thr = 1.0*(1-0.01)/100 ≈ 0.0099 < 0.2
    v, f, _ = compact_mesh(m)
    assert v.shape[0] == h * w
    # no face may span the cliff: vertices 0..3 cols vs 4..7 cols
    cols = (np.arange(h * w) % w)[f]
    assert not np.any((cols.min(1) <= 3) & (cols.max(1) >= 4))


def test_grid_mesh_invalid_pixels_skipped():
    h, w = 6, 6
    disp = np.full((h, w), 0.3, np.float32)
    disp[2, 2] = 0.0
    disp[3, 3] = 5.0   # out of range
    cam = frontal_cam(w, h)
    m = grid_mesh(jnp.asarray(disp), cam, min_dsp=0.01, max_dsp=1.0,
                  smooth_thres=100.0)
    v, f, tex = compact_mesh(m)
    assert v.shape[0] == h * w - 2
    assert 2 * w + 2 not in tex and 3 * w + 3 not in tex
    assert f.min() >= 0 and f.max() < v.shape[0]


def test_render_unproject_roundtrip():
    # unprojected rasterized sphere points must lie near the unit sphere
    scene = make_scene(n_frames=1, width=96, height=72, bumps=0.0,
                       n_lat=48, n_lon=64)
    pts, valid = unproject_depth_map(scene.cams[0],
                                     jnp.asarray(scene.disparity[0]),
                                     1e-6, 1e6)
    r = np.linalg.norm(np.asarray(pts)[np.asarray(valid)], axis=1)
    assert abs(np.median(r) - 0.5) < 0.02


def test_vertex_normals_sphere():
    verts, faces = uv_sphere(24, 32, radius=1.0)
    vn = np.asarray(vertex_normals(jnp.asarray(verts), jnp.asarray(faces)))
    # away from the poles, vertex normals of a sphere ≈ radial direction
    vr = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    interior = np.abs(verts[:, 1]) < 0.9
    dots = np.abs((vn[interior] * vr[interior]).sum(1))
    assert dots.min() > 0.97


def test_facet_normals_orientation():
    verts = jnp.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], jnp.float32)
    n = np.asarray(facet_normals(verts, jnp.asarray([[0, 1, 2]])))
    np.testing.assert_allclose(n[0], [0, 0, 1], atol=1e-6)


def test_grid_mesh_edge_sz_thres_cuts_long_edges():
    """EdgeSzThres (GeometryRec.cpp:30-39 analogue): triangles whose 3D
    edges exceed the threshold are not emitted, even when the disparity
    deltas pass the smoothness test."""
    h, w = 8, 8
    # smooth disparity GRADIENT: passes smooth_thres but the world-space
    # depth difference between adjacent columns grows toward the right
    disp = np.tile(np.linspace(0.5, 0.05, w, dtype=np.float32), (h, 1))
    cam = frontal_cam(w, h)
    kw = dict(min_dsp=0.01, max_dsp=1.0, smooth_thres=1e9)
    m_all = grid_mesh(jnp.asarray(disp), cam, **kw)
    m_cut = grid_mesh(jnp.asarray(disp), cam, edge_sz_thres=1.0, **kw)
    _, f_all, _ = compact_mesh(m_all)
    v, f_cut, _ = compact_mesh(m_cut)
    assert f_all.shape[0] == 2 * (h - 1) * (w - 1)
    assert 0 < f_cut.shape[0] < f_all.shape[0]
    # every surviving face really has all edges <= 1.0
    e = v[f_cut]
    for a, b in ((0, 1), (1, 2), (0, 2)):
        assert (np.linalg.norm(e[:, a] - e[:, b], axis=1) <= 1.0 + 1e-5).all()


def test_rasterize_closeup_giant_triangles_render_exactly():
    """Faces with bboxes far beyond tile_large (close-up camera) must
    RENDER, not just count in overflow (round-2 verdict: the GL reference
    rasterizes any triangle, Model2Depth.cpp:58-79; the counter-only
    behavior silently dropped geometry on config 3's close-up loop)."""
    z = 2.0
    verts = jnp.asarray([[-20, -20, z], [20, -20, z], [20, 20, z],
                         [-20, 20, z]], jnp.float32)
    faces = jnp.asarray([[0, 1, 2], [0, 2, 3]], jnp.int32)
    w, h = 320, 240
    K = jnp.asarray([[300.0, 0, (w - 1) / 2], [0, 300.0, (h - 1) / 2],
                     [0, 0, 1]], jnp.float32)
    cam = CameraBatch(K, jnp.eye(3), jnp.zeros(3), w, h)
    out = render_disparity(verts, faces, jnp.ones(2, bool), cam,
                           height=h, width=w)
    d = np.asarray(out.disparity)
    assert int(out.overflow) == 0
    # full-frame coverage at the analytic disparity
    np.testing.assert_allclose(d, 0.5, atol=1e-5)

    # nearest-surface wins against a background plane behind it
    verts2 = jnp.concatenate([verts, jnp.asarray(
        [[-30, -30, 4.0], [30, -30, 4.0], [30, 30, 4.0]], jnp.float32)])
    faces2 = jnp.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6]], jnp.int32)
    out2 = render_disparity(verts2, faces2, jnp.ones(3, bool), cam,
                            height=h, width=w)
    np.testing.assert_allclose(np.asarray(out2.disparity), 0.5, atol=1e-5)


def test_rasterize_overflow_counts_beyond_capacity():
    """Giant faces beyond overflow_capacity are the only ones left
    unrendered, and are reported."""
    z = 2.0
    verts = jnp.asarray([[-20, -20, z], [20, -20, z], [20, 20, z],
                         [-20, 20, z]], jnp.float32)
    faces = jnp.asarray([[0, 1, 2], [0, 2, 3]], jnp.int32)
    w, h = 320, 240
    K = jnp.asarray([[300.0, 0, (w - 1) / 2], [0, 300.0, (h - 1) / 2],
                     [0, 0, 1]], jnp.float32)
    cam = CameraBatch(K, jnp.eye(3), jnp.zeros(3), w, h)
    out = render_disparity(verts, faces, jnp.ones(2, bool), cam,
                           height=h, width=w, overflow_capacity=1)
    assert int(out.overflow) == 1          # one face over capacity
    d = np.asarray(out.disparity)
    assert (d == 0.5).mean() > 0.4         # the in-capacity half rendered


def test_tiled_pass_dense_tile_renders_exactly():
    """700 tiny faces crammed into one tile: the ts=8 tile-local pass has
    no per-tile capacity, so silhouette-dense tiles must still z-test
    exactly against a brute-force oracle (round-4 tile-binned rasterizer;
    round-5 advisor: this case never reaches the mid-class spill path —
    that is covered by test_mid_class_capacity_spill_renders_exactly)."""
    import numpy as np
    import jax.numpy as jnp
    from multiviewstitch_tpu.core.cameras import CameraBatch
    from multiviewstitch_tpu.ops.rasterizer import render_disparity

    rng = np.random.default_rng(0)
    n = 700
    # tiny triangles all landing inside pixel box [320..334] x [240..254]
    # at depth z; later faces (higher 1/z) must win the z-test where they
    # overlap
    cx, cy = 327.0, 247.0
    verts = []
    faces = []
    for i in range(n):
        ox = cx + rng.uniform(-6, 6)
        oy = cy + rng.uniform(-6, 6)
        z = 2.0 + i * 1e-4
        # project-at-z inverse: x = (u - cx0)/fx * z with K below
        for (du, dv) in ((0, 0), (2.5, 0), (0, 2.5)):
            u_ = ox + du
            v_ = oy + dv
            verts.append([(u_ - 319.5) / 500.0 * z,
                          (v_ - 239.5) / 500.0 * z, z])
        faces.append([3 * i, 3 * i + 1, 3 * i + 2])
    verts = jnp.asarray(np.asarray(verts, np.float32))
    faces = jnp.asarray(np.asarray(faces, np.int32))
    K = jnp.asarray([[500.0, 0, 319.5], [0, 500.0, 239.5], [0, 0, 1]],
                    jnp.float32)
    cam = CameraBatch(K, jnp.eye(3), jnp.zeros(3), 640, 480)
    out = render_disparity(verts, faces, jnp.ones(n, bool), cam,
                           height=480, width=640)
    d = np.asarray(out.disparity)
    assert int(out.overflow) == 0
    got = d[240:256, 320:336]
    assert (got > 0).any()
    # z-test correctness: every hit pixel must hold the NEAREST (max 1/z)
    # surface among faces covering it — check against a brute-force oracle
    ua = np.asarray(verts)[:, 0] / np.asarray(verts)[:, 2] * 500.0 + 319.5
    va = np.asarray(verts)[:, 1] / np.asarray(verts)[:, 2] * 500.0 + 239.5
    iz = 1.0 / np.asarray(verts)[:, 2]
    fidx = np.asarray(faces)
    ref = np.zeros((480, 640), np.float32)
    for t in range(n):
        i0, i1, i2 = fidx[t]
        xs = ua[[i0, i1, i2]]
        ys = va[[i0, i1, i2]]
        zs = iz[[i0, i1, i2]]
        x0, x1 = int(np.floor(xs.min())), int(np.ceil(xs.max()))
        y0, y1 = int(np.floor(ys.min())), int(np.ceil(ys.max()))
        for py in range(y0, y1 + 1):
            for px in range(x0, x1 + 1):
                e0 = (xs[1]-xs[0])*(py-ys[0]) - (ys[1]-ys[0])*(px-xs[0])
                e1 = (xs[2]-xs[1])*(py-ys[1]) - (ys[2]-ys[1])*(px-xs[1])
                e2 = (xs[0]-xs[2])*(py-ys[2]) - (ys[0]-ys[2])*(px-xs[2])
                area = (xs[1]-xs[0])*(ys[2]-ys[0]) - \
                    (ys[1]-ys[0])*(xs[2]-xs[0])
                if area >= 0:
                    ins = e0 >= 0 and e1 >= 0 and e2 >= 0
                else:
                    ins = e0 <= 0 and e1 <= 0 and e2 <= 0
                if ins and abs(area) > 1e-12:
                    disp = (e1*zs[0] + e2*zs[1] + e0*zs[2]) / area
                    ref[py, px] = max(ref[py, px], disp)
    np.testing.assert_allclose(d, ref, rtol=2e-5, atol=1e-7)


def _oracle_raster(verts, faces, h, w, fx, fy, cx0, cy0):
    """Brute-force z-buffer oracle (frontal camera, verts already in cam
    frame)."""
    ua = verts[:, 0] / verts[:, 2] * fx + cx0
    va = verts[:, 1] / verts[:, 2] * fy + cy0
    iz = 1.0 / verts[:, 2]
    ref = np.zeros((h, w), np.float32)
    for t in range(faces.shape[0]):
        i0, i1, i2 = faces[t]
        xs = ua[[i0, i1, i2]]
        ys = va[[i0, i1, i2]]
        zs = iz[[i0, i1, i2]]
        x0, x1 = int(np.floor(xs.min())), int(np.ceil(xs.max()))
        y0, y1 = int(np.floor(ys.min())), int(np.ceil(ys.max()))
        for py in range(max(y0, 0), min(y1 + 1, h)):
            for px in range(max(x0, 0), min(x1 + 1, w)):
                e0 = (xs[1]-xs[0])*(py-ys[0]) - (ys[1]-ys[0])*(px-xs[0])
                e1 = (xs[2]-xs[1])*(py-ys[1]) - (ys[2]-ys[1])*(px-xs[1])
                e2 = (xs[0]-xs[2])*(py-ys[2]) - (ys[0]-ys[2])*(px-xs[2])
                area = (xs[1]-xs[0])*(ys[2]-ys[0]) - \
                    (ys[1]-ys[0])*(xs[2]-xs[0])
                if area >= 0:
                    ins = e0 >= 0 and e1 >= 0 and e2 >= 0
                else:
                    ins = e0 <= 0 and e1 <= 0 and e2 <= 0
                if ins and abs(area) > 1e-12:
                    disp = (e1*zs[0] + e2*zs[1] + e0*zs[2]) / area
                    ref[py, px] = max(ref[py, px], disp)
    return ref


def test_mid_class_capacity_spill_renders_exactly():
    """Mid-class faces (7 <= bbox < 15) beyond the compacted pass's
    capacity must spill into the scatter ladder's first rung and still
    render exactly (round-5 advisor: the spill path for the tiled mid
    class had no coverage — mid_capacity, render_disparity)."""
    import jax.numpy as jnp
    from multiviewstitch_tpu.core.cameras import CameraBatch
    from multiviewstitch_tpu.ops.rasterizer import render_disparity

    rng = np.random.default_rng(7)
    n = 96
    w, h = 320, 240
    fx = fy = 300.0
    cx0, cy0 = (w - 1) / 2, (h - 1) / 2
    verts = []
    faces = []
    for i in range(n):
        # 10-px bboxes scattered over the frame, staggered depths so the
        # z-test matters where they overlap
        ox = rng.uniform(20, w - 32)
        oy = rng.uniform(20, h - 32)
        z = 2.0 + i * 1e-3
        for (du, dv) in ((0, 0), (10.0, 1.0), (1.0, 10.0)):
            verts.append([(ox + du - cx0) / fx * z,
                          (oy + dv - cy0) / fy * z, z])
        faces.append([3 * i, 3 * i + 1, 3 * i + 2])
    verts_np = np.asarray(verts, np.float32)
    faces_np = np.asarray(faces, np.int32)
    K = jnp.asarray([[fx, 0, cx0], [0, fy, cy0], [0, 0, 1]], jnp.float32)
    cam = CameraBatch(K, jnp.eye(3), jnp.zeros(3), w, h)
    # capacity 32 << 96 mid-class faces: two thirds must spill
    out = render_disparity(jnp.asarray(verts_np), jnp.asarray(faces_np),
                           jnp.ones(n, bool), cam, height=h, width=w,
                           mid_capacity=32)
    assert int(out.overflow) == 0
    ref = _oracle_raster(verts_np, faces_np, h, w, fx, fy, cx0, cy0)
    np.testing.assert_allclose(np.asarray(out.disparity), ref,
                               rtol=2e-5, atol=1e-7)
    # control: the uncapped pass agrees
    out2 = render_disparity(jnp.asarray(verts_np), jnp.asarray(faces_np),
                            jnp.ones(n, bool), cam, height=h, width=w)
    np.testing.assert_allclose(np.asarray(out2.disparity), ref,
                               rtol=2e-5, atol=1e-7)


def _mixed_small_mid_fixture():
    """150 faces with bboxes from 1.5 to 13 px: the ts=8 tile pass, the
    compacted mid-class pass and the first ladder rung all render."""
    rng = np.random.default_rng(11)
    w, h = 320, 240
    verts, faces = [], []
    for i in range(150):
        ox, oy = rng.uniform(5, w - 20), rng.uniform(5, h - 20)
        sz = rng.uniform(1.5, 13.0)
        verts += [(ox, oy, 2.0 + i * 1e-3),
                  (ox + sz, oy + rng.uniform(0, 2), 2.0 + i * 1e-3),
                  (ox + rng.uniform(0, 2), oy + sz, 2.0 + i * 1e-3)]
        faces.append([3 * i, 3 * i + 1, 3 * i + 2])
    return verts, faces, w, h, 300.0


def _edge_offscreen_fixture():
    """Faces straddling 8/16-px tile seams, partially offscreen faces and
    an image whose size is no multiple of the tile sizes."""
    w, h = 200, 100
    verts, faces = [], []
    for i, (ox, oy) in enumerate([(124.0, 40.0), (60.0, 6.5), (-3.0, 50.0),
                                  (193.0, 94.0), (100.0, -2.0)]):
        verts += [(ox, oy, 2.0), (ox + 9.0, oy + 1.0, 2.0),
                  (ox + 1.0, oy + 9.0, 2.0)]
        faces.append([3 * i, 3 * i + 1, 3 * i + 2])
    return verts, faces, w, h, 150.0


def _giant_face_fixture():
    """Close-up faces wider than 64 px next to small ones: the full-frame
    pass of the rasterizer and the oracle's per-face path."""
    w, h = 160, 120
    verts = [(-20.3, -10.7, 1.5), (150.6, 5.2, 1.7), (10.4, 130.9, 1.6),
             (40.3, 40.6, 1.2), (47.2, 41.1, 1.2), (41.1, 48.3, 1.2)]
    return verts, [[0, 1, 2], [3, 4, 5]], w, h, 100.0


@pytest.mark.parametrize("fixture", [_mixed_small_mid_fixture,
                                     _edge_offscreen_fixture,
                                     _giant_face_fixture])
def test_xla_raster_matches_oracle(fixture):
    """render_disparity against the brute-force z-buffer oracle."""
    import jax.numpy as jnp
    from multiviewstitch_tpu.core.cameras import CameraBatch
    from multiviewstitch_tpu.ops.rasterizer import render_disparity

    px_verts, faces, w, h, f = fixture()
    cx0, cy0 = (w - 1) / 2, (h - 1) / 2
    verts_np = np.asarray([[(u - cx0) / f * z, (v - cy0) / f * z, z]
                           for u, v, z in px_verts], np.float32)
    faces_np = np.asarray(faces, np.int32)
    K = jnp.asarray([[f, 0, cx0], [0, f, cy0], [0, 0, 1]], jnp.float32)
    cam = CameraBatch(K, jnp.eye(3), jnp.zeros(3), w, h)
    out = render_disparity(jnp.asarray(verts_np), jnp.asarray(faces_np),
                           jnp.ones(len(faces), bool), cam, height=h,
                           width=w)
    assert int(out.overflow) == 0
    ref = _oracle_raster(verts_np, faces_np, h, w, f, f, cx0, cy0)
    np.testing.assert_allclose(np.asarray(out.disparity), ref,
                               rtol=2e-5, atol=1e-7)
    assert (ref > 0).sum() > 100
    # the vectorized oracle chip_smoke.py uses at VGA is the same oracle
    from chip_smoke import zbuffer_oracle
    np.testing.assert_array_equal(
        zbuffer_oracle(verts_np, faces_np, h, w, f, f, cx0, cy0), ref)

"""Virtual-view synthesis end to end: the reference's GenNewViews trick
(Image3D.cpp:109-222) exists to bridge viewpoint gaps between sequences —
synthesized rotated views + texIndex dedup (Processor.cpp:649-680) make
cross-sequence matching possible where raw views share too little
appearance. This fixture PROVES the path does that: two sequences whose
cameras differ by a 56 deg in-place yaw (wide FOV, so the yaw homography is
a real perspective distortion, not a translation). 48 deg was enough in
round 2; the round-3 SIFT rework (scale-matched pyramid sampling) closed
that gap with RAW views — correctly, to 0.65 deg — so the
negative case moved to 56 deg, where raw matching finds only 3 pairs:

  - view_count=1 must FAIL keyframe selection (too few surviving matches)
  - view_count=5, rot_angle=56 must align to the identity ground truth

Stable across RANSAC seeds (detection is deterministic; the 256-iteration
RANSAC converges to the same inlier set — checked for seeds 0..3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multiviewstitch_tpu.core.cameras import CameraBatch
from multiviewstitch_tpu.ops.rasterizer import render_sequence
from multiviewstitch_tpu.pipeline.fixtures import (uv_sphere, ring_cameras,
                                                   Scene, textured_views)
from multiviewstitch_tpu.pipeline.align_seq import (Sequence,
                                                    match_sequence_pair)
from tests.test_e2e_align import CFG

pytestmark = pytest.mark.slow

YAW_DEG = 56.0


@pytest.fixture(scope="module")
def yawed_pair():
    verts, faces = uv_sphere(64, 96, bumps=0.15)
    # wide FOV (close ring + short focal): the yaw homography carries real
    # perspective foreshortening, which plain SIFT does not survive
    cams = ring_cameras(3, radius=1.1, width=160, img_height=120,
                        length_focal=70.0, arc_deg=20.0)
    fmask = jnp.ones((faces.shape[0],), bool)
    th = np.radians(YAW_DEG)
    Ry = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0],
                   [np.sin(th), 0, np.cos(th)]], np.float64)
    # second sequence: every camera rotated IN PLACE about its own y axis
    Rc = np.asarray(cams.R, np.float64)
    tc = np.asarray(cams.t, np.float64)
    cams2 = CameraBatch(cams.K,
                        jnp.asarray(np.einsum("ij,njk->nik", Ry, Rc),
                                    jnp.float32),
                        jnp.asarray(np.einsum("ij,nj->ni", Ry, tc),
                                    jnp.float32),
                        cams.width, cams.height)
    seqs = []
    for cb in (cams, cams2):
        d = render_sequence(jnp.asarray(verts), jnp.asarray(faces), fmask,
                            cb, height=120, width=160)
        sc = Scene(verts, faces, cb, np.asarray(d), None)
        seqs.append(Sequence(jnp.asarray(textured_views(sc)),
                             jnp.asarray(sc.disparity), cb))
    return seqs


def test_raw_views_cannot_align(yawed_pair):
    s1, s2 = yawed_pair
    cfg = CFG.replace(view_count=1, rot_angle=0.0)
    with pytest.raises(RuntimeError, match="cannot align"):
        match_sequence_pair(s1, s2, cfg, jax.random.key(0))


def test_synth_views_bridge_the_gap(yawed_pair):
    s1, s2 = yawed_pair
    # rot_angle is the per-view STEP (the reference's RotAngle knob,
    # Image3D.cpp:131-133): view_count=5 at step yaw/2 synthesizes
    # {-yaw, -yaw/2, 0, +yaw/2, +yaw}, whose +-yaw members see seq2's
    # viewpoint exactly. Passing the full yaw as the step (an earlier
    # version of this test) puts the extremes at +-2*yaw, where the
    # homography foreshortening destroys matchability.
    cfg = CFG.replace(view_count=5, rot_angle=YAW_DEG / 2)
    T, best, cands = match_sequence_pair(s1, s2, cfg, jax.random.key(0))
    # ground truth: the sequences share one world, T must be ~identity
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(np.asarray(T.R)) - 1) / 2, -1, 1)))
    assert best.num_matches >= cfg.min_match_count
    assert ang < 5.0
    assert abs(float(T.s) - 1.0) < 0.05
    assert np.linalg.norm(np.asarray(T.t)) < 0.06
    # the winning matches must include texIndex-deduped synth-view matches
    # (all matches map back to source pixels; dedup keeps them unique)
    uv = best.uv1[best.mask]
    assert len(np.unique(uv[:, 0] * (1 << 16) + uv[:, 1])) == len(uv)

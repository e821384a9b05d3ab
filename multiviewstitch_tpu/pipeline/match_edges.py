"""Batched all-pairs matching front-end over view-graph edges.

The reference's MatchFeature runs an m1 x m2 all-view-pairs loop
(FeatureProc.cpp:114-129) inside a serial per-frame-pair loop
(Processor.cpp:629-833), with per-pair filter cascades and RANSAC. Round 1
reproduced that as a host Python loop with one device dispatch and one
blocking host sync per (frame_i, frame_j) candidate — host-bound at scale.

This module is the batched re-design: ALL edges (frame pairs) of a
sequence pair are processed by ONE jitted program — descriptor matching,
texIndex dedup, SSD, gap-NMS, 3D lifting, and the adaptive RANSAC pruning
cascade are vmapped over the edge axis (chunked with ``lax.map`` to bound
memory), so a full n1 x n2 edge sweep costs one dispatch and ZERO per-pair
host syncs. Keyframe selection (min residual with >= min_match_count
surviving matches, Processor.cpp:746-805) reduces on device; the host pulls
one [E] residual/count vector.

Per-edge RANSAC keys are derived with ``jax.random.fold_in(key, edge_id)``
so the batched sweep, the loop reference implementation (kept in
pipeline/align_seq.py for golden testing), and the edge-sharded variant
(parallel/match_dist.py) are all bitwise-reproducible against each other.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import StitchConfig
from ..core.cameras import CameraBatch, unproject_depth_map
from ..ops.match import match_descriptors
from ..ops.filters import dedup_matches, ssd_filter, gap_filter
from ..solvers.srt import remove_outliers


class SequencePrep(NamedTuple):
    """Per-sequence device-resident state shared by every edge: features on
    all (frame, view) images, texIndex maps, gray frames, unprojected
    world-point maps. Computed ONCE per sequence (the reference re-runs
    Image3D::LoadModel per pair, Processor.cpp:543-563)."""
    desc: jnp.ndarray      # [N,V,K,128]
    kp_valid: jnp.ndarray  # [N,V,K]
    kp_uv: jnp.ndarray     # [N,V,K,2]
    tex: jnp.ndarray       # [N,V,H,W] int32 texIndex -> source pixel
    gray: jnp.ndarray      # [N,H,W]
    pts: jnp.ndarray       # [N,H,W,3] unprojected world points
    pmask: jnp.ndarray     # [N,H,W] valid-depth mask
    cams: CameraBatch      # batch N


class EdgeBatch(NamedTuple):
    """Per-edge match state for all E = n1*n2 frame pairs (padded/masked)."""
    edge_i: jnp.ndarray      # [E] int32 frame index in sequence 1
    edge_j: jnp.ndarray      # [E] int32 frame index in sequence 2
    uv1: jnp.ndarray         # [E,M,2] int32 source-pixel coords
    uv2: jnp.ndarray         # [E,M,2]
    p1: jnp.ndarray          # [E,M,3]
    p2: jnp.ndarray          # [E,M,3]
    mask: jnp.ndarray        # [E,M] surviving inlier mask
    residual: jnp.ndarray    # [E] keyframe-selection residual (inf if bad)
    num_matches: jnp.ndarray  # [E] int32 surviving match count


@jax.jit
def _unproject_batch(cams, disp, min_dsp, max_dsp):
    # jitted: a bare vmap dispatches every primitive eagerly
    return jax.vmap(
        lambda cam, d: unproject_depth_map(cam, d, min_dsp, max_dsp)
    )(cams, disp)


@partial(jax.jit, static_argnames=("view_count", "rot_angle", "axis",
                                   "segment", "max_keypoints", "margins",
                                   "min_dsp", "max_dsp"))
def _prep_fused(gray, disparity, cams, *, view_count, rot_angle, axis,
                segment, max_keypoints, margins, min_dsp, max_dsp):
    """The ENTIRE per-sequence prep — segmentation mask, virtual-view
    synthesis, SIFT detect/describe, unprojection — as ONE jitted program:
    a staged version interleaves ~20 eager ops (reshapes, tree_maps, angle
    builds) between its jitted pieces, each one a host dispatch."""
    from ..ops.view_synth import synthesize_views, view_angles
    from ..ops.features import detect_and_describe
    n = gray.shape[0]
    h, w = gray.shape[1:]
    g = gray
    if segment:
        from ..ops.segmentation import foreground_from_disparity
        fg = foreground_from_disparity(disparity, min_dsp, max_dsp)
        g = jnp.where(fg, g, 0.0)
    angles = view_angles(view_count, rot_angle)
    sv = jax.vmap(lambda g1, K, R: synthesize_views(
        g1[..., None], K, R, angles, axis=axis))(g, cams.K, cams.R)
    flat = sv.images[..., 0].reshape(n * view_count, h, w)
    kp = jax.vmap(lambda im: detect_and_describe(
        im, max_keypoints=max_keypoints, margins=margins))(flat)
    kp = jax.tree_util.tree_map(
        lambda x: x.reshape((n, view_count) + x.shape[1:]), kp)
    pts, pmask = jax.vmap(
        lambda cam, d: unproject_depth_map(cam, d, min_dsp, max_dsp)
    )(cams, disparity)
    return kp, sv.tex_index, pts, pmask


def prep_sequence(seq, cfg: StitchConfig) -> SequencePrep:
    """Features + texIndex + unprojection maps for one sequence — one
    device dispatch (see _prep_fused)."""
    kp, tex, pts, pmask = _prep_fused(
        seq.gray, seq.disparity, seq.cams,
        view_count=cfg.view_count, rot_angle=float(cfg.rot_angle),
        axis=int(cfg.axis), segment=bool(cfg.segment),
        max_keypoints=int(cfg.max_keypoints),
        margins=(float(cfg.hl_margin_ratio), float(cfg.hr_margin_ratio),
                 float(cfg.vl_margin_ratio), float(cfg.vr_margin_ratio)),
        min_dsp=float(cfg.min_dsp), max_dsp=float(cfg.max_dsp))
    return SequencePrep(kp.desc, kp.valid, kp.uv, tex, seq.gray,
                        pts, pmask, seq.cams)


def _edge_fn(i, j, key, prep1: SequencePrep, prep2: SequencePrep, *,
             view_count: int, distmax, ratiomax, ssd_win: int, ssd_err,
             min_gap_sq, pixel_err, adapt_ratio, iter_num: int, rounds: int):
    """Full per-edge pipeline for ONE (frame_i, frame_j) pair; pure jnp so it
    vmaps over the edge axis. Mirrors the reference's per-pair body
    (Processor.cpp:644-744 + RemoveOutliers 177-259)."""
    h, w = prep1.gray.shape[-2:]
    wh = jnp.asarray([w - 1, h - 1])

    uv1_all, uv2_all, ok_all = [], [], []
    for vi in range(view_count):
        for vj in range(view_count):
            m = match_descriptors(
                prep1.desc[i, vi], prep1.kp_valid[i, vi],
                prep2.desc[j, vj], prep2.kp_valid[j, vj],
                distmax=distmax, ratiomax=ratiomax)
            kuv1 = prep1.kp_uv[i, vi][m.idx1]
            kuv2 = prep2.kp_uv[j, vj][m.idx2]
            iu1 = jnp.clip(kuv1.astype(jnp.int32), 0, wh)
            iu2 = jnp.clip(kuv2.astype(jnp.int32), 0, wh)
            # map through texIndex to source-image pixels
            t1 = prep1.tex[i, vi][iu1[:, 1], iu1[:, 0]]
            t2 = prep2.tex[j, vj][iu2[:, 1], iu2[:, 0]]
            ok = m.valid & (t1 >= 0) & (t2 >= 0)
            uv1_all.append(jnp.stack([t1 % w, t1 // w], -1))
            uv2_all.append(jnp.stack([t2 % w, t2 // w], -1))
            ok_all.append(ok)
    uv1 = jnp.concatenate(uv1_all)
    uv2 = jnp.concatenate(uv2_all)
    ok = jnp.concatenate(ok_all)

    # filter cascade in source-pixel space
    uv1, uv2, ok = dedup_matches(uv1, uv2, ok)
    ok = ssd_filter(prep1.gray[i], prep2.gray[j], uv1, uv2, ok,
                    win=ssd_win, ssd_err=ssd_err)
    ok = gap_filter(uv1, uv2, ok, min_gap_sq=min_gap_sq)

    # lift to 3D through the unprojection maps
    cu1 = jnp.clip(uv1, 0, wh)
    cu2 = jnp.clip(uv2, 0, wh)
    p1 = prep1.pts[i][cu1[:, 1], cu1[:, 0]]
    p2 = prep2.pts[j][cu2[:, 1], cu2[:, 0]]
    ok = (ok & prep1.pmask[i][cu1[:, 1], cu1[:, 0]]
          & prep2.pmask[j][cu2[:, 1], cu2[:, 0]])

    # RANSAC pruning cascade; edges with <3 lifted matches are ineligible
    # (the reference 'continue's them, Processor.cpp:746) — run the solve on
    # a safe placeholder mask and invalidate the outputs instead of
    # branching, so the whole sweep stays one straight-line program.
    n_ok = ok.sum()
    eligible = n_ok >= 3
    safe = jnp.where(eligible, ok, jnp.arange(ok.shape[0]) < 3)
    mask, _, res = remove_outliers(
        p1, p2, safe, prep1.cams[i], prep2.cams[j], key,
        pixel_err=pixel_err, adapt_ratio=adapt_ratio,
        iter_num=iter_num, rounds=rounds)
    mask = mask & eligible
    res = jnp.where(eligible, res, jnp.inf)
    return uv1, uv2, p1, p2, mask, res, mask.sum().astype(jnp.int32)


@partial(jax.jit, static_argnames=("view_count", "ssd_win", "iter_num",
                                   "rounds", "edge_chunk"))
def match_edges(prep1: SequencePrep, prep2: SequencePrep, key, *,
                view_count: int, distmax, ratiomax, ssd_win: int, ssd_err,
                min_gap_sq, pixel_err, adapt_ratio, iter_num: int,
                rounds: int, edge_chunk: int = 16) -> EdgeBatch:
    """All n1*n2 frame-pair edges in one dispatch, vmapped in chunks of
    ``edge_chunk`` (lax.map batches) to bound the live distance-matrix and
    SSD-window memory."""
    n1 = prep1.gray.shape[0]
    n2 = prep2.gray.shape[0]
    ei, ej = jnp.meshgrid(jnp.arange(n1, dtype=jnp.int32),
                          jnp.arange(n2, dtype=jnp.int32), indexing="ij")
    ei = ei.ravel()
    ej = ej.ravel()
    eids = jnp.arange(ei.shape[0], dtype=jnp.uint32)
    keys = jax.vmap(lambda e: jax.random.fold_in(key, e))(eids)

    def body(args):
        i, j, k = args
        return _edge_fn(i, j, k, prep1, prep2, view_count=view_count,
                        distmax=distmax, ratiomax=ratiomax, ssd_win=ssd_win,
                        ssd_err=ssd_err, min_gap_sq=min_gap_sq,
                        pixel_err=pixel_err, adapt_ratio=adapt_ratio,
                        iter_num=iter_num, rounds=rounds)

    uv1, uv2, p1, p2, mask, res, nm = jax.lax.map(
        body, (ei, ej, keys), batch_size=min(edge_chunk, ei.shape[0]))
    return EdgeBatch(ei, ej, uv1, uv2, p1, p2, mask, res, nm)


def edge_knobs(cfg: StitchConfig) -> dict:
    """The match_edges keyword set derived from a StitchConfig."""
    return dict(view_count=cfg.view_count, distmax=cfg.distmax,
                ratiomax=cfg.ratiomax, ssd_win=cfg.ssd_win,
                ssd_err=cfg.ssd_err,
                min_gap_sq=float(cfg.sample_interval) ** 2,
                pixel_err=cfg.pixel_err,
                adapt_ratio=cfg.adapt_pixel_err_ratio,
                iter_num=cfg.iter_num, rounds=cfg.ransac_rounds)


def select_keyframe(edges: EdgeBatch, min_match_count: int
                    ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Keyframe selection (Processor.cpp:750-765): min residual among edges
    with >= min_match_count surviving matches. ONE host sync (two [E]
    vectors). Raises like the reference (Processor.cpp:794-800) if no edge
    qualifies."""
    # one host round trip for both [E] vectors
    nm, res = map(np.asarray,
                  jax.device_get((edges.num_matches, edges.residual)))
    elig = nm >= min_match_count
    if not elig.any():
        raise RuntimeError(
            f"no frame pair with >= {min_match_count} matches "
            f"(best had {int(nm.max(initial=0))}) — cannot align sequences "
            "(Processor.cpp:794-800 analogue)")
    scored = np.where(elig, res, np.inf)
    return int(scored.argmin()), nm, res


@partial(jax.jit, static_argnames=("min_match_count", "iter_num"))
def select_and_solve(edges: EdgeBatch, cams1: CameraBatch,
                     cams2: CameraBatch, key, *, min_match_count: int,
                     iter_num: int):
    """Keyframe selection + final SRT solve fused into ONE device program
    (one host round trip per pair instead of two: one for the [E] vectors,
    one for the winning edge's solve inputs). The winning edge is argmin'd
    on device,
    its cameras gathered with traced indices, and the RANSAC solve runs
    speculatively even when no edge qualifies (the caller checks ``ok``
    and raises — error path, wasted compute is irrelevant).

    Returns (ok, best_e, nm [E], res [E], T) — ONE host pull gets all of
    them, and T lands as numpy so the chain composition stays off-device.
    """
    from ..solvers.srt import estimate_srt_ransac
    nm = edges.num_matches
    res = edges.residual
    elig = nm >= min_match_count
    scored = jnp.where(elig, res, jnp.inf)
    best_e = jnp.argmin(scored).astype(jnp.int32)
    fi = edges.edge_i[best_e]
    fj = edges.edge_j[best_e]
    T, _ = estimate_srt_ransac(
        edges.p1[best_e], edges.p2[best_e], edges.mask[best_e],
        cams1[fi], cams2[fj],
        jax.random.fold_in(key, nm.shape[0]), iter_num=iter_num)
    return elig.any(), best_e, nm, res, T

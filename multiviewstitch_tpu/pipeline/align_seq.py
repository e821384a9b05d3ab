"""Sequence alignment pipeline: the AlignmentSeq stage.

Orchestrates the reference's main reconstruction flow
(Processor::AlignmentSeq + CalcSimilarityTransformationSeq,
Processor.cpp:835-1106 / 514-833) over jitted stages:

  consistency check -> virtual-view synthesis -> feature detect ->
  per-sequence-pair: all-(frame,view)-pair matching -> dedup -> SSD ->
  gap NMS -> lift matches to 3D -> adaptive RANSAC outlier pruning ->
  keyframe pair selection (min residual with >= min_match_count matches,
  Processor.cpp:746-805) -> SRT solve -> left-compose chain
  (Processor.cpp:813-826) -> multi-frame point sampling -> visibility
  filter -> transform into the reference frame -> fused oriented cloud
  (Processor.cpp:905-1040).

The host loop only sequences stages and carries tiny pytrees; all pixel
and match math runs on device. Frame/view pair loops are kept explicit
here so `parallel/` can shard them across a device mesh later.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import StitchConfig
from ..core.cameras import CameraBatch, unproject_depth_map, pixel_grid
from ..core.transforms import Similarity, compose, apply_points, rotate_normals
from ..ops.consistency import check_consistency
from ..ops.view_synth import synthesize_views, view_angles
from ..ops.features import detect_and_describe
from ..ops.match import match_descriptors
from ..ops.filters import dedup_matches, ssd_filter, gap_filter
from ..ops.point_sampling import sample_oriented_points, visibility_filter
from ..solvers.srt import remove_outliers, estimate_srt_ransac


@dataclass
class Sequence:
    """One RGB-D sequence: gray images [N,H,W] (0..255 scale), disparity
    [N,H,W], cameras (batch N)."""
    gray: jnp.ndarray
    disparity: jnp.ndarray
    cams: CameraBatch


@dataclass
class PairCandidate:
    frame_i: int
    frame_j: int
    uv1: np.ndarray          # [M,2] source-pixel coords (int)
    uv2: np.ndarray
    p1: np.ndarray           # [M,3] 3D points lifted from frame i
    p2: np.ndarray
    mask: np.ndarray         # [M] bool after the full filter cascade
    residual: float
    num_matches: int


@dataclass
class AlignResult:
    transforms: List[Similarity]      # per sequence -> final frame
    keyframes: List[Tuple[int, int]]  # chosen (frame_i, frame_j) per pair
    residuals: List[float]
    metrics: Dict[str, float] = field(default_factory=dict)


def _prep_sequence_views(seq: Sequence, cfg: StitchConfig):
    """Synthesize all frames' virtual views (one vmapped dispatch) then
    detect features on every (frame, view) image in one detect_batch
    dispatch — the reference loops frames and views serially on the host
    (CalcSimilarityTransformationSeq, Processor.cpp:543-563).

    Returns (kps with leading dims [N, V], tex_index [N, V, H, W])."""
    n = seq.gray.shape[0]
    h, w = seq.gray.shape[1:]
    gray = seq.gray
    if cfg.segment:
        # foreground masking before detection — the reference's GrabCut
        # step (Image3D.cpp:23-51); with depth available the valid-range
        # test IS the robust mask
        from ..ops.segmentation import foreground_from_disparity
        fg = foreground_from_disparity(seq.disparity, cfg.min_dsp,
                                       cfg.max_dsp)
        gray = jnp.where(fg, gray, 0.0)
    angles = view_angles(cfg.view_count, cfg.rot_angle)
    sv = jax.vmap(lambda g1, K, R: synthesize_views(
        g1[..., None], K, R, angles, axis=cfg.axis))(
            gray, seq.cams.K, seq.cams.R)
    margins = (cfg.hl_margin_ratio, cfg.hr_margin_ratio,
               cfg.vl_margin_ratio, cfg.vr_margin_ratio)
    from ..ops.features import detect_batch
    flat = sv.images[..., 0].reshape(n * cfg.view_count, h, w)
    kp = detect_batch(flat, max_keypoints=cfg.max_keypoints,
                      margins=margins)
    kp = jax.tree_util.tree_map(
        lambda x: x.reshape((n, cfg.view_count) + x.shape[1:]), kp)
    return kp, sv.tex_index


def _lift_to_3d(pts_map, valid_map, uv):
    """Gather per-pixel world points at integer uv [M,2]."""
    h, w = valid_map.shape
    u = jnp.clip(uv[:, 0], 0, w - 1)
    v = jnp.clip(uv[:, 1], 0, h - 1)
    p = pts_map[v, u]
    ok = valid_map[v, u]
    return p, ok


def match_sequence_pair(
    seq1: Sequence, seq2: Sequence, cfg: StitchConfig, key,
    prep1=None, prep2=None, mesh=None, want_candidates: bool = True,
) -> Tuple[Similarity, PairCandidate, List[PairCandidate]]:
    """Find the best keyframe pair between two sequences and solve its SRT
    (the per-pair body of CalcSimilarityTransformationSeq,
    Processor.cpp:629-833).

    Production path: ALL n1*n2 frame-pair edges are swept by ONE batched
    device program (pipeline/match_edges.py) with zero per-pair host syncs;
    keyframe selection pulls a single [E] residual/count vector. Optional
    ``prep1/prep2`` (SequencePrep) let callers hoist per-sequence feature
    extraction out of the pair loop. With ``mesh``, the edge sweep is
    sharded over the mesh's 'views' axis (parallel/match_dist.py).
    """
    from .match_edges import (prep_sequence, match_edges, edge_knobs,
                              select_and_solve)
    n2 = seq2.gray.shape[0]
    if prep1 is None:
        prep1 = prep_sequence(seq1, cfg)
    if prep2 is None:
        prep2 = prep_sequence(seq2, cfg)

    if mesh is not None:
        from ..parallel.match_dist import match_edges_sharded
        eb = match_edges_sharded(prep1, prep2, key, mesh=mesh,
                                 **edge_knobs(cfg))
    else:
        eb = match_edges(prep1, prep2, key, **edge_knobs(cfg))

    # keyframe argmin + final SRT solve fused on device: the plain align
    # path costs ONE host round trip per sequence pair, and T arrives as
    # numpy so chain composition needs no device ops at all.
    ok_any, best_e, nm_h, res_h, T = jax.device_get(
        select_and_solve(eb, seq1.cams, seq2.cams, key,
                         min_match_count=cfg.min_match_count,
                         iter_num=cfg.iter_num))
    if not ok_any:
        raise RuntimeError(
            f"no frame pair with >= {cfg.min_match_count} matches "
            f"(best had {int(nm_h.max(initial=0))}) — cannot align "
            "sequences (Processor.cpp:794-800 analogue)")
    best_e = int(best_e)

    candidates: List[PairCandidate] = []
    best: Optional[PairCandidate] = None
    if want_candidates:
        # host-side candidate list (for the pose graph + debug artifacts):
        # pull ONLY the eligible edges (nm >= 3) — at config-5 shape the
        # full [E, max_matches, ...] arrays are ~400 MB while eligible
        # edges are a handful
        elig = np.nonzero(nm_h >= 3)[0]
        sel = jnp.asarray(elig.astype(np.int32))
        # ONE host round trip for all five per-edge arrays
        uv1_h, uv2_h, p1_h, p2_h, mask_h = jax.device_get(
            (eb.uv1[sel], eb.uv2[sel], eb.p1[sel], eb.p2[sel],
             eb.mask[sel]))
        for k, e in enumerate(elig):
            c = PairCandidate(int(e) // n2, int(e) % n2, uv1_h[k],
                              uv2_h[k], p1_h[k], p2_h[k], mask_h[k],
                              float(res_h[e]), int(nm_h[e]))
            candidates.append(c)
            if e == best_e:
                best = c
    if best is None:
        # candidates skipped (or best below the nm>=3 pull floor): the
        # caller only needs the keyframe ids + stats on this path
        empty = np.zeros((0,), np.float32)
        best = PairCandidate(best_e // n2, best_e % n2, empty, empty,
                             empty, empty, empty.astype(bool),
                             float(res_h[best_e]), int(nm_h[best_e]))
    return T, best, candidates


def match_sequence_pair_loop(
    seq1: Sequence, seq2: Sequence, cfg: StitchConfig, key,
) -> Tuple[Similarity, PairCandidate, List[PairCandidate]]:
    """Reference implementation of the edge sweep as an explicit host loop
    (one dispatch + one host sync per (frame_i, frame_j) pair) — kept as the
    golden oracle for the batched path; uses the same fold_in(key, edge_id)
    RANSAC keys so results are reproducible against match_sequence_pair."""
    n1 = seq1.gray.shape[0]
    n2 = seq2.gray.shape[0]
    h, w = seq1.gray.shape[1:]

    # unprojected per-pixel world points for lifting matches to 3D
    maps1, maps2 = [], []
    for seq, maps in ((seq1, maps1), (seq2, maps2)):
        for i in range(seq.gray.shape[0]):
            pm, vm = unproject_depth_map(seq.cams[i], seq.disparity[i],
                                         cfg.min_dsp, cfg.max_dsp)
            maps.append((pm, vm))

    # features on all (frame, view) images of both sequences — two batched
    # dispatches per sequence
    kp1, tex1_all = _prep_sequence_views(seq1, cfg)
    kp2, tex2_all = _prep_sequence_views(seq2, cfg)

    candidates: List[PairCandidate] = []
    for i in range(n1):
        for j in range(n2):
            # gather matches across all view pairs (view_count^2 pairs)
            uv1_all, uv2_all, ok_all = [], [], []
            for vi in range(cfg.view_count):
                for vj in range(cfg.view_count):
                    m = match_descriptors(
                        kp1.desc[i, vi], kp1.valid[i, vi],
                        kp2.desc[j, vj], kp2.valid[j, vj],
                        distmax=cfg.distmax, ratiomax=cfg.ratiomax)
                    kuv1 = kp1.uv[i, vi][m.idx1]
                    kuv2 = kp2.uv[j, vj][m.idx2]
                    # map through texIndex to source-image pixels
                    iu1 = jnp.clip(kuv1.astype(jnp.int32), 0,
                                   jnp.asarray([w - 1, h - 1]))
                    iu2 = jnp.clip(kuv2.astype(jnp.int32), 0,
                                   jnp.asarray([w - 1, h - 1]))
                    t1 = tex1_all[i, vi][iu1[:, 1], iu1[:, 0]]
                    t2 = tex2_all[j, vj][iu2[:, 1], iu2[:, 0]]
                    ok = m.valid & (t1 >= 0) & (t2 >= 0)
                    suv1 = jnp.stack([t1 % w, t1 // w], -1)
                    suv2 = jnp.stack([t2 % w, t2 // w], -1)
                    uv1_all.append(suv1)
                    uv2_all.append(suv2)
                    ok_all.append(ok)
            uv1 = jnp.concatenate(uv1_all)
            uv2 = jnp.concatenate(uv2_all)
            ok = jnp.concatenate(ok_all)

            # filter cascade (dedup -> SSD -> gap NMS), source-pixel space
            uv1, uv2, ok = dedup_matches(uv1, uv2, ok)
            ok = ssd_filter(seq1.gray[i], seq2.gray[j], uv1, uv2, ok,
                            win=cfg.ssd_win, ssd_err=cfg.ssd_err)
            ok = gap_filter(uv1, uv2, ok,
                            min_gap_sq=float(cfg.sample_interval) ** 2)

            # lift to 3D through the depth maps
            p1, ok1 = _lift_to_3d(*maps1[i], uv1)
            p2, ok2 = _lift_to_3d(*maps2[j], uv2)
            ok = ok & ok1 & ok2

            if int(ok.sum()) < 3:
                continue

            sub = jax.random.fold_in(key, i * n2 + j)
            mask, T, res = remove_outliers(
                p1, p2, ok, seq1.cams[i], seq2.cams[j], sub,
                pixel_err=cfg.pixel_err,
                adapt_ratio=cfg.adapt_pixel_err_ratio,
                iter_num=cfg.iter_num, rounds=cfg.ransac_rounds)
            nm = int(mask.sum())
            candidates.append(PairCandidate(
                i, j, np.asarray(uv1), np.asarray(uv2),
                np.asarray(p1), np.asarray(p2), np.asarray(mask),
                float(res), nm))

    # keyframe selection: min residual among pairs with enough matches
    # (Processor.cpp:750-765); abort like the reference if none qualify
    eligible = [c for c in candidates if c.num_matches >= cfg.min_match_count]
    if not eligible:
        raise RuntimeError(
            f"no frame pair with >= {cfg.min_match_count} matches "
            f"(best had {max((c.num_matches for c in candidates), default=0)})"
            " — cannot align sequences (Processor.cpp:794-800 analogue)")
    best = min(eligible, key=lambda c: c.residual)

    # final solve on the winning pair's surviving matches
    sub = jax.random.fold_in(key, n1 * n2)
    T, res = estimate_srt_ransac(
        jnp.asarray(best.p1), jnp.asarray(best.p2), jnp.asarray(best.mask),
        seq1.cams[best.frame_i], seq2.cams[best.frame_j], sub,
        iter_num=cfg.iter_num)
    return T, best, candidates


def _identity_host() -> Similarity:
    """Host-side (numpy-leaved) identity similarity — no device ops."""
    return Similarity(np.float32(1.0), np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32))


def _compose_host(A: Similarity, B: Similarity) -> Similarity:
    """compose() in numpy for host-resident transforms (the chain loop):
    s = sA*sB, R = RA@RB, t = sA*RA@tB + tA (Processor.cpp:819-823)."""
    sA = np.float32(np.asarray(A.s))
    RA = np.asarray(A.R, np.float32)
    return Similarity(sA * np.float32(np.asarray(B.s)),
                      (RA @ np.asarray(B.R, np.float32)).astype(np.float32),
                      (sA * (RA @ np.asarray(B.t, np.float32)) +
                       np.asarray(A.t, np.float32)).astype(np.float32))


def align_sequences(seqs: List[Sequence], cfg: StitchConfig,
                    seed: int = 0, refine=False,
                    all_pairs: bool = False,
                    debug_dir: str = None, mesh=None) -> AlignResult:
    """Chain all sequences into the last sequence's frame
    (CalcSimilarityTransformationSeq loop, Processor.cpp:629-833).

    ``refine`` selects the view-graph refinement the reference lacks
    (SURVEY §7 step 6):
      - False: greedy chain only (the reference's behavior,
        Processor.cpp:813-826)
      - True or "pose_graph": global similarity pose-graph solve over ALL
        surviving 3D-3D matches (solvers/pose_graph.py)
      - "ba": reprojection bundle adjustment over keyframe cameras and
        union-find-merged pixel tracks (pipeline/ba_refine.py,
        solvers/ba.py; sharded over ``mesh`` when given)
    initialized from the greedy chain either way."""
    from .match_edges import prep_sequence
    key = jax.random.key(seed)
    # all per-pair keys derived up front — ONE eager split op instead of
    # a split dispatch per pair
    n_pairs = max(len(seqs) - 1, 1)
    subs = jax.random.split(key, n_pairs + 1)
    key = subs[0]
    # per-sequence feature/unprojection prep is hoisted out of the pair
    # loop — interior sequences are prepped once, not once per pair
    preps = [prep_sequence(s, cfg) for s in seqs]
    edges: List[Similarity] = []
    keyframes, residuals = [], []
    all_candidates = []
    want_cands = bool(refine) or bool(debug_dir) or cfg.debug_artifacts
    for k in range(len(seqs) - 1):
        T, best, cands = match_sequence_pair(seqs[k], seqs[k + 1], cfg,
                                             subs[k + 1],
                                             preps[k], preps[k + 1],
                                             mesh=mesh,
                                             want_candidates=want_cands)
        edges.append(T)
        keyframes.append((best.frame_i, best.frame_j))
        residuals.append(best.residual)
        all_candidates.append((k, cands))

        if debug_dir or cfg.debug_artifacts:
            # the reference's Match/match%d_%d_%d.jpg dumps
            # (Processor.cpp:767-793)
            import os
            from ..utils.debug_artifacts import save_match_visualization
            d = debug_dir or "./Match"
            os.makedirs(d, exist_ok=True)
            save_match_visualization(
                os.path.join(d, f"match{k}_{best.frame_i}_"
                                f"{best.frame_j}.png"),
                np.asarray(seqs[k].gray[best.frame_i]),
                np.asarray(seqs[k + 1].gray[best.frame_j]),
                best.uv1, best.uv2, best.mask)

    # cumulative transforms: sequence k -> final frame (left-compose chain,
    # Processor.cpp:819-823). Pure numpy: the per-pair T's arrive as host
    # arrays (select_and_solve), so the chain never dispatches device ops
    # (eager jnp composes would be a host round trip each).
    transforms = []
    for k in range(len(seqs)):
        acc = _identity_host()
        for j in range(k, len(edges)):
            acc = _compose_host(edges[j], acc)
        transforms.append(acc)
    result = AlignResult(transforms, keyframes, residuals)

    if refine and len(seqs) > 1:
        mode = "pose_graph" if refine is True else str(refine)
        cand_pairs = [(k, k + 1, c) for k, cands in all_candidates
                      for c in cands
                      if c.num_matches >= cfg.min_match_count]
        if all_pairs:
            # densify the view graph with skip edges (k, l>k+1): the
            # reference only ever links consecutive sequences
            # (Processor.cpp:629); extra edges over-determine the pose
            # graph and pin down drift
            for k in range(len(seqs) - 2):
                for l in range(k + 2, len(seqs)):
                    key, sub = jax.random.split(key)
                    try:
                        _, _, cands = match_sequence_pair(
                            seqs[k], seqs[l], cfg, sub, preps[k], preps[l],
                            mesh=mesh)
                    except RuntimeError:
                        continue
                    cand_pairs += [(k, l, c) for c in cands
                                   if c.num_matches >= cfg.min_match_count]
        if cand_pairs and mode == "ba":
            from .ba_refine import refine_with_ba
            refined, metrics = refine_with_ba(
                seqs, cand_pairs, transforms, mesh=mesh)
            result = AlignResult(refined, keyframes, residuals, metrics)
        elif cand_pairs:
            from ..solvers.pose_graph import build_data, refine_pose_graph
            pairs = [(k, l, c.p1, c.p2, c.mask) for k, l, c in cand_pairs]
            data = build_data(pairs, max_matches=cfg.max_matches)
            refined, rmse = refine_pose_graph(transforms, data)
            result = AlignResult(refined, keyframes, residuals,
                                 {"pose_graph_rmse": rmse,
                                  "pose_graph_edges": float(len(pairs))})
    return result


@jax.jit
def _fuse_one(points, valid_in, normals, cams, s, R, t):
    """Visibility filter + similarity transform for one sequence, ONE
    dispatch (a bare vmap/einsum chain runs eagerly, one dispatch per
    op)."""
    valid = jax.vmap(lambda p, v: visibility_filter(p, v, cams))(
        points, valid_in)
    pts = s * jnp.einsum("ij,nj->ni", R, points.reshape(-1, 3),
                         precision="highest") + t
    nrm = jnp.einsum("ij,nj->ni", R, normals.reshape(-1, 3),
                     precision="highest")
    return pts, nrm, valid.reshape(-1)


def fuse_sequences(seqs: List[Sequence], result: AlignResult,
                   cfg: StitchConfig):
    """Consistency-check depths, sample oriented points per sequence,
    visibility-filter, and map everything into the reference frame
    (Processor.cpp:905-1040). Returns (points [P,3], normals [P,3]) numpy."""
    outs = []
    for k, seq in enumerate(seqs):
        disp = check_consistency(
            seq.disparity, seq.cams, min_dsp=cfg.min_dsp,
            max_dsp=cfg.max_dsp, reproj_err=cfg.reproj_err)
        op = sample_oriented_points(
            disp, seq.cams, min_dsp=cfg.min_dsp, max_dsp=cfg.max_dsp,
            sample_radius=cfg.sample_radius, nbr_num=cfg.nbr_frm_num,
            nbr_step=cfg.nbr_frm_step, dsp_err=cfg.dsp_err,
            conf_min=cfg.conf_min)
        T = result.transforms[k]
        # dispatches stay async inside the loop; ALL sequences pull in
        # one device_get below
        outs.append(_fuse_one(op.points, op.valid, op.normals, seq.cams,
                              T.s, T.R, T.t))
    all_pts, all_nrm = [], []
    for pts, nrm, v in jax.device_get(outs):
        all_pts.append(pts[v])
        all_nrm.append(nrm[v])
    return np.concatenate(all_pts), np.concatenate(all_nrm)

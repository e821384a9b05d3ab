"""Jitted compute ops (the framework's device-side hot path)."""

from .consistency import check_consistency, consistency_stats
from .view_synth import synthesize_views, view_angles
from .features import detect_and_describe, detect_batch, Keypoints
from .match import match_descriptors, match_all_pairs, Matches
from .filters import dedup_matches, ssd_filter, gap_filter, margin_mask
from .meshing import grid_mesh, compact_mesh, GridMesh
from .mesh_normals import facet_normals, vertex_normals
from .rasterizer import render_disparity, render_sequence, RenderResult
from .point_sampling import (sample_oriented_points, visibility_filter,
                             OrientedPoints)
from .tsdf import fuse_tsdf, surface_nets, reconstruct, TSDF, SurfaceMesh
from .poisson import reconstruct_poisson, poisson_field
from .depth_refine import refine_depth
from .segmentation import (segment_foreground, foreground_from_disparity,
                           trim_mesh_by_all_cameras)
from .simplify import simplify_mesh

__all__ = [
    "check_consistency", "consistency_stats",
    "synthesize_views", "view_angles",
    "detect_and_describe", "detect_batch", "Keypoints",
    "match_descriptors", "match_all_pairs", "Matches",
    "dedup_matches", "ssd_filter", "gap_filter", "margin_mask",
    "grid_mesh", "compact_mesh", "GridMesh",
    "facet_normals", "vertex_normals",
    "render_disparity", "render_sequence", "RenderResult",
    "sample_oriented_points", "visibility_filter", "OrientedPoints",
    "fuse_tsdf", "surface_nets", "reconstruct", "TSDF", "SurfaceMesh",
    "reconstruct_poisson", "poisson_field",
    "refine_depth",
    "segment_foreground", "foreground_from_disparity",
    "trim_mesh_by_all_cameras",
    "simplify_mesh",
]

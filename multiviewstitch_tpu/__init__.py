"""multiviewstitch_tpu — multi-view RGB-D reconstruction & stitching in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
zjuzly/MultiViewStitch (reference: /root/reference/MultiViewStitch):
depth-consistency filtering, virtual-view synthesis, feature detection and
matching, similarity-transform (SRT) solving, view-graph pose chaining and
bundle adjustment, multi-frame point sampling and fusion, surface
reconstruction, template-body alignment, embedded-deformation (ARAP)
non-rigid fitting, and model-to-depth re-rendering — all as batched,
jitted compute over device meshes rather than serial per-pixel C++.

Package layout:
  core/      batched pinhole cameras, similarity transforms, view graph
  io/        .act / .raw / .obj / .npts parsers + stage checkpoint manifest
  ops/       jitted ops (consistency, warp, features, match,
             filters, meshing, rasterizer, knn, tsdf fusion)
  solvers/   Kabsch/RANSAC SRT, PCA/plane fits, bundle adjustment,
             embedded-deformation Gauss-Newton, Poisson/CG solves
  parallel/  device-mesh setup and sharding specs (views / edges / graph blocks)
  models/    template body model, part recognition
  pipeline/  stage orchestration (align / deform / render), synthetic fixtures
  utils/     logging, timing, metrics
"""

__version__ = "0.1.0"

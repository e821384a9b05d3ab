"""Screened Poisson surface reconstruction on a regular grid.

The reference's Poisson stage is the closed-source GeoRec binary
(RunPoisson, Reconstruction/GeometryRec.cpp:61-86) with octree depth knobs
``psn_dpt_min..max`` (config.txt:33-34, forwarded at GeometryRec.cpp:30-39
— depth 8..10 upstream). This is the from-scratch JAX equivalent on
a REGULAR grid of resolution 2^psn_dpt (SURVEY §7 hard part #1): splat
oriented points into a normal vector field, solve the screened Poisson
equation for the indicator function, and extract the iso-surface whose
level is the mean indicator value at the samples (Kazhdan's iso
selection), via the surface-nets extractor shared with the TSDF backend.

Two solvers:
  - Jacobi-preconditioned CG (pure stencil matvecs — fused XLA); the
    round-1/2 path, fine to depth 8.
  - GEOMETRIC MULTIGRID V-cycles (round 3, verdict item 6): damped-Jacobi
    smoothing, full-weighting (2x average) restriction, piecewise-constant
    prolongation; the stencil is unscaled, so the restricted residual and
    the screen coefficient scale by 4 per level (the h^2 factor of the
    continuous operator). O(N) per cycle with grid-size-independent
    contraction, which is what makes depth 9-10 tractable where CG's
    iteration count grows with resolution.

At depth >= 9 the [g^3, 8] corner stacks of a whole-grid extraction would
not fit device memory; ``reconstruct_poisson`` therefore extracts in
overlapping Z-slabs (each face owned by exactly one slab; duplicated halo
vertices are exact binary duplicates and are welded on the host).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .tsdf import TSDF, surface_nets, SurfaceMesh


def _trilinear_scatter(grid_shape, pts_idx, values):
    """Scatter values [N,C] into grid [G,G,G,C] with trilinear weights.
    pts_idx: continuous grid coords [N,3] (x,y,z order)."""
    G = grid_shape[0]
    out = jnp.zeros(grid_shape + (values.shape[-1],), values.dtype)
    base = jnp.floor(pts_idx).astype(jnp.int32)
    frac = pts_idx - base
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (jnp.where(dx, frac[:, 0], 1 - frac[:, 0]) *
                     jnp.where(dy, frac[:, 1], 1 - frac[:, 1]) *
                     jnp.where(dz, frac[:, 2], 1 - frac[:, 2]))
                ix = jnp.clip(base[:, 0] + dx, 0, G - 1)
                iy = jnp.clip(base[:, 1] + dy, 0, G - 1)
                iz = jnp.clip(base[:, 2] + dz, 0, G - 1)
                out = out.at[iz, iy, ix].add(w[:, None] * values)
    return out


def _trilinear_gather(field, pts_idx):
    """Sample field [G,G,G] at continuous grid coords [N,3] (x,y,z)."""
    G = field.shape[0]
    base = jnp.floor(pts_idx).astype(jnp.int32)
    frac = pts_idx - base
    acc = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (jnp.where(dx, frac[:, 0], 1 - frac[:, 0]) *
                     jnp.where(dy, frac[:, 1], 1 - frac[:, 1]) *
                     jnp.where(dz, frac[:, 2], 1 - frac[:, 2]))
                ix = jnp.clip(base[:, 0] + dx, 0, G - 1)
                iy = jnp.clip(base[:, 1] + dy, 0, G - 1)
                iz = jnp.clip(base[:, 2] + dz, 0, G - 1)
                acc = acc + w * field[iz, iy, ix]
    return acc


def _divergence(V):
    """Central-difference divergence of V [G,G,G,3] (x,y,z components;
    storage order [z,y,x])."""
    def d_axis(f, axis):
        return (jnp.roll(f, -1, axis) - jnp.roll(f, 1, axis)) * 0.5
    return (d_axis(V[..., 0], 2) + d_axis(V[..., 1], 1) +
            d_axis(V[..., 2], 0))


def _laplacian(x):
    out = -6.0 * x
    for ax in range(3):
        out = out + jnp.roll(x, 1, ax) + jnp.roll(x, -1, ax)
    return out


def _smooth_jacobi(x, b, screen, iters: int, omega: float = 0.8):
    """Damped Jacobi relaxation of (L - screen) x = b (L = unscaled
    7-point stencil, diagonal -6 - screen)."""
    for _ in range(iters):
        r = b - (_laplacian(x) - screen * x)
        x = x + omega * r / (-6.0 - screen)
    return x


def _pair_mat(g):
    """[g, 2g] 0/1 interleave: row i hits columns 2i and 2i+1."""
    cols = jnp.arange(2 * g) // 2
    return (cols[None, :] == jnp.arange(g)[:, None]).astype(jnp.float32)


def _restrict2(x):
    """Full-weighting restriction: 2x average pooling, as three per-axis
    einsums against an exact 0/0.5 pairing matrix (in place of
    reshape(G/2,2,G/2,2,G/2,2).mean((1,3,5)), whose 6-D buffer with size-2
    minor dims padded badly under an earlier accelerator's tiled layouts).
    HIGHEST precision keeps the transfer operator exact in f32."""
    g = x.shape[0]
    R = _pair_mat(g // 2).T * 0.5                       # [g, g/2]
    hi = jax.lax.Precision.HIGHEST
    x = jnp.einsum("zyx,zw->wyx", x, R, precision=hi)
    x = jnp.einsum("zyx,yw->zwx", x, R, precision=hi)
    return jnp.einsum("zyx,xw->zyw", x, R, precision=hi)


def _prolong2(x):
    """Piecewise-constant prolongation (cell-centered): per-axis einsums
    against the [g,2g] interleave (see _restrict2 for why not repeat)."""
    g = x.shape[0]
    P = _pair_mat(g)                                    # [g, 2g]
    hi = jax.lax.Precision.HIGHEST
    x = jnp.einsum("zyx,zw->wyx", x, P, precision=hi)
    x = jnp.einsum("zyx,yw->zwx", x, P, precision=hi)
    return jnp.einsum("zyx,xw->zyw", x, P, precision=hi)


def _vcycle(x, b, screen, *, coarsest: int = 16, nu: int = 2):
    """One multigrid V-cycle on the unscaled screened-Laplacian stencil.
    Residual and screen scale by 4 per level (h^2 of the continuous
    operator under the unscaled stencil). Recursion unrolls at trace."""
    G = x.shape[0]
    x = _smooth_jacobi(x, b, screen, nu)
    if G > coarsest:
        r = b - (_laplacian(x) - screen * x)
        bc = 4.0 * _restrict2(r)
        ec = _vcycle(jnp.zeros_like(bc), bc, 4.0 * screen,
                     coarsest=coarsest, nu=nu)
        x = x + _prolong2(ec)
        x = _smooth_jacobi(x, b, screen, nu)
    else:
        x = _smooth_jacobi(x, b, screen, 40)
    return x


@partial(jax.jit, static_argnames=("grid", "cg_iters", "screen", "solver",
                                   "vcycles"))
def poisson_field(points: jnp.ndarray, normals: jnp.ndarray,
                  valid: jnp.ndarray, origin: jnp.ndarray,
                  spacing: jnp.ndarray, *, grid: int = 128,
                  cg_iters: int = 300, screen: float = 1e-3,
                  solver: str = "auto", vcycles: int = 12):
    """Solve (Δ - screen) χ = ∇·V for the indicator-like field χ and return
    (χ - iso, point_weight_grid) so the zero level set is the surface.

    solver: "cg", "multigrid", or "auto" (multigrid from grid >= 256 —
    CG's iteration count grows with resolution; V-cycles don't)."""
    gidx = (points - origin) / spacing                    # (x,y,z) coords
    w = valid.astype(points.dtype)
    # Build the divergence rhs one normal COMPONENT at a time instead of
    # materializing V [G^3,3] (12.9 GB at G=1024). Smoothing and
    # central differences are linear and componentwise, so
    # div(smooth(splat(n))) == sum_ax d_ax(smooth(splat(n_ax))) exactly
    # (same op order per component as the former fused form).
    b = jnp.zeros((grid, grid, grid), points.dtype)
    for comp_ax, grid_ax in ((0, 2), (1, 1), (2, 0)):   # (x,y,z) storage
        comp = _trilinear_scatter(
            (grid, grid, grid),
            gidx, (normals[:, comp_ax] * w)[:, None])[..., 0]
        # mild smoothing of the splat (box blur x2 ~ B-spline-ish)
        for _ in range(2):
            for ax in range(3):
                comp = (comp + jnp.roll(comp, 1, ax) +
                        jnp.roll(comp, -1, ax)) / 3.0
        b = b + (jnp.roll(comp, -1, grid_ax) -
                 jnp.roll(comp, 1, grid_ax)) * 0.5
    if solver == "auto":
        solver = "multigrid" if grid >= 256 else "cg"

    if solver == "multigrid":
        def cyc(k, x):
            return _vcycle(x, b, screen)
        x = jax.lax.fori_loop(0, vcycles, cyc, jnp.zeros_like(b))
    else:
        matvec = lambda x: _laplacian(x) - screen * x
        pre = lambda r: r / (-6.0 - screen)

        x = jnp.zeros_like(b)
        r = b - matvec(x)
        z = pre(r)
        p = z
        rz = jnp.vdot(r, z)

        def body(k, st):
            x, r, z, p, rz = st
            Ap = matvec(p)
            alpha = rz / jnp.maximum(jnp.abs(jnp.vdot(p, Ap)), 1e-20) * \
                jnp.sign(jnp.vdot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = pre(r)
            rz2 = jnp.vdot(r, z)
            beta = rz2 / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
            return x, r, z, z + beta * p, rz2

        x, *_ = jax.lax.fori_loop(0, cg_iters, body, (x, r, z, p, rz))

    # iso level: mean field value at the input samples
    at_pts = _trilinear_gather(x, gidx)
    iso = (at_pts * w).sum() / jnp.maximum(w.sum(), 1.0)
    # sample-weight grid scattered AFTER the solve: holding it across the
    # V-cycles would add a fine-level buffer to the peak (depth-10 budget)
    wgt = _trilinear_scatter((grid, grid, grid), gidx, w[:, None])[..., 0]
    for _ in range(2):
        for ax in range(3):
            wgt = (wgt + jnp.roll(wgt, 1, ax) + jnp.roll(wgt, -1, ax)) / 3.0
    return x - iso, wgt


@partial(jax.jit, static_argnames=("radius",))
def _dilate_occupancy(wgt, radius: int):
    """Bool occupancy (wgt > eps) dilated by ``radius`` voxels, one jitted
    program (not 18 eager roll dispatches; bool keeps the buffer at 1/4
    the f32 size)."""
    occ = wgt > 1e-6
    for _ in range(radius):
        for ax in range(3):
            occ = occ | jnp.roll(occ, 1, ax) | jnp.roll(occ, -1, ax)
    return occ


def _extract_mesh(field, occ, origin, spacing, max_vertices=65536,
                  max_faces=131072):
    """surface_nets + host-side compaction. Sign flip: χ > iso inside
    (normals outward); surface nets expects negative inside like a TSDF.
    Returns (verts, faces, cells) — cells are the per-vertex integer
    (z,y,x) owning grid cells (exact identity for cross-slab welds)."""
    tsdf_like = TSDF(-field, occ.astype(field.dtype), origin,
                     jnp.asarray(spacing, jnp.float32))
    mesh = surface_nets(tsdf_like, min_weight=0.5,
                        max_vertices=max_vertices, max_faces=max_faces)
    nv = int(mesh.num_vertices)
    nf = int(mesh.num_faces)
    verts = np.asarray(mesh.vertices[:nv])
    cells = np.asarray(mesh.cells[:nv])
    faces = np.asarray(mesh.faces[:nf])
    faces = faces[(faces >= 0).all(1) & (faces < nv).all(1)]
    return verts, faces, cells


def _extract_mesh_slabs(field, occ, origin, spacing, slab: int = 64,
                        return_cells: bool = False):
    """Z-slab extraction for grids whose whole-volume surface-nets corner
    stacks would not fit device memory (depth >= 9): overlapping slabs of
    ``slab`` interior cell-layers (+1 halo cell-layer each side so boundary
    faces see all four of their cells), welded on the host by GLOBAL INTEGER
    CELL keys — surface-nets emits exactly one vertex per cell, so
    (z+slab_offset, y, x) is an exact identity; welding by float position
    is not (the slab-local origin shift differs from the global sum by
    f32 rounding). Faces are owned by the slab containing their minimum
    global cell z, so each face is emitted exactly once."""
    G = field.shape[0]
    n_cells = G - 1
    all_v, all_f, all_c = [], [], []
    for z0 in range(0, n_cells, slab):
        z1 = min(z0 + slab, n_cells)
        lo = max(z0 - 1, 0)
        hi = min(z1 + 1, n_cells) + 1                # +1: corner layer
        sub_f = field[lo:hi]
        sub_o = occ[lo:hi]
        sub_origin = np.asarray(origin, np.float32).copy()
        sub_origin[2] += lo * float(spacing)         # z offset (x,y,z)
        v, f, c = _extract_mesh(sub_f, sub_o, jnp.asarray(sub_origin),
                                spacing, max_vertices=131072,
                                max_faces=262144)
        if len(f) == 0:
            continue
        c = c.astype(np.int64)
        c[:, 0] += lo                                # global cell z
        # own faces whose min global cell z lies in [z0, z1)
        fz = c[f][:, :, 0].min(1)
        keep = (fz >= z0) & (fz < z1) if z1 < n_cells else (fz >= z0)
        f = f[keep]
        base = sum(len(x) for x in all_v)
        all_v.append(v)
        all_c.append(c)
        all_f.append(f + base)
    if not all_v:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    V = np.concatenate(all_v)
    C = np.concatenate(all_c)
    F = np.concatenate(all_f)
    # weld halo duplicates by exact global cell key
    uniq, inv = np.unique(C, axis=0, return_inverse=True)
    first = np.zeros(len(uniq), np.int64)
    first[inv[::-1]] = np.arange(len(V))[::-1]       # first occurrence
    Vw = V[first]
    Fw = inv[F]
    good = (Fw[:, 0] != Fw[:, 1]) & (Fw[:, 1] != Fw[:, 2]) & \
        (Fw[:, 0] != Fw[:, 2])
    if return_cells:
        return Vw.astype(np.float32), Fw[good], C[first]
    return Vw.astype(np.float32), Fw[good]


def reconstruct_poisson(points: np.ndarray, normals: np.ndarray,
                        *, depth: int = 7, margin: float = 0.1,
                        cg_iters: int = 300,
                        support_radius: int = 6,
                        solver: str = "auto", vcycles: int = 12,
                        grid_override: int | None = None,
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Full Poisson pipeline: oriented cloud -> (vertices, faces).
    ``depth`` mirrors psn_dpt: grid = 2^depth (the reference runs 8-10,
    config.txt:33-34). Extraction is restricted to cells within
    `support_radius` voxels of any sample (far-field χ is unconstrained,
    like the octree's adaptive support). depth >= 9 uses the multigrid
    solver and Z-slab extraction (see module docstring).

    ``grid_override`` sets a non-power-of-two grid (multigrid only needs
    divisibility by 2 down to the coarsest level), for grid classes
    between two depths."""
    grid = grid_override if grid_override else (1 << depth)
    mins = points.min(0)
    maxs = points.max(0)
    span = (maxs - mins).max()
    mins = mins - margin * span
    spacing = float((maxs - mins + margin * span).max() / (grid - 1))
    origin = jnp.asarray(mins, jnp.float32)

    field, wgt = poisson_field(
        jnp.asarray(points, jnp.float32), jnp.asarray(normals, jnp.float32),
        jnp.ones(len(points), bool), origin,
        jnp.asarray(spacing, jnp.float32), grid=grid, cg_iters=cg_iters,
        solver=solver, vcycles=vcycles)

    # support mask: dilate the sample-occupancy grid (bool — a f32 grid
    # would cost 4.3 GB at depth 10; the extractor casts per slab); the
    # weight grid is dead after this — drop it before extraction (1.7 GB
    # at 768^3, where the first run OOM'd in the slab extractor)
    occ = _dilate_occupancy(wgt, support_radius)
    del wgt

    if grid <= 256:
        # caps sized for a fully-occupied 256^3 surface (round 4: the
        # 65536 default silently truncated the depth-8 bench mesh at
        # EXACTLY the cap; the slab path extracted 198k vertices from
        # the same field)
        verts, faces, _ = _extract_mesh(field, occ, origin, spacing,
                                        max_vertices=1 << 19,
                                        max_faces=1 << 20)
        return verts, faces
    # thinner slabs past 512: the per-slab corner stacks scale with
    # slab * G^2 and sit next to the 1.7-4.3 GB field
    return _extract_mesh_slabs(field, occ, origin, spacing,
                               slab=64 if grid <= 512 else 32)

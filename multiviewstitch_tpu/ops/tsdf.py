"""TSDF fusion + surface-nets mesh extraction (GeoRec part 2).

The reference's Poisson surface reconstruction lives in the closed-source
``ZJU::GeoRec`` binary (GeometryRec::RunPoisson, Reconstruction/
GeometryRec.cpp:61-86; octree depth ``psn_dpt_min..max`` from
config.txt:33-34) — no source exists, so the new framework builds a
functionally equivalent reconstructor in JAX (SURVEY §7 'hard parts' #1):

  1. **Projective TSDF fusion** over a regular voxel grid: every voxel
     projects into every depth frame; signed distance = (frame depth at the
     pixel) − (voxel camera depth), truncated to ±trunc and averaged over
     frames with valid observations (the KinectFusion formulation — dense,
     batched; one fused jit).
  2. **Surface nets** extraction: one vertex per sign-change voxel cell
     (centroid of edge zero-crossings), two triangles per grid face with a
     sign change along its dual edge. Static-capacity compaction like
     ops/meshing.py.

Grid resolution 2^psn_dpt mirrors the reference's octree-depth knob.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.cameras import CameraBatch, project


class TSDF(NamedTuple):
    values: jnp.ndarray    # [G,G,G] truncated signed distance (+out/-in)
    weights: jnp.ndarray   # [G,G,G] observation counts
    origin: jnp.ndarray    # [3] world position of voxel (0,0,0) center
    spacing: jnp.ndarray   # scalar voxel edge length


@partial(jax.jit, static_argnames=("grid", "min_dsp", "max_dsp"))
def fuse_tsdf(
    disparity: jnp.ndarray,     # [N,H,W]
    cams: CameraBatch,
    origin: jnp.ndarray,        # [3]
    spacing: jnp.ndarray,       # scalar
    *,
    grid: int = 128,
    trunc: float | None = None,
    min_dsp: float = 1e-4,
    max_dsp: float = 1e4,
) -> TSDF:
    n, h, w = disparity.shape
    trunc_v = trunc if trunc is not None else 3.0

    g = jnp.arange(grid, dtype=jnp.float32)
    zz, yy, xx = jnp.meshgrid(g, g, g, indexing="ij")
    pts = origin + spacing * jnp.stack([xx, yy, zz], -1)   # [G,G,G,3]
    flat = pts.reshape(-1, 3)

    valid = (disparity >= min_dsp) & (disparity <= max_dsp)
    depth_maps = jnp.where(valid, 1.0 / jnp.where(valid, disparity, 1.0), 0.0)

    def one_frame(carry, inp):
        acc, wacc = carry
        K, R, t, dm, vm = inp
        cam = CameraBatch(K, R, t, w, h)
        uv, z = project(cam, flat)
        u = jnp.floor(uv[:, 0] + 0.5).astype(jnp.int32)
        v = jnp.floor(uv[:, 1] + 0.5).astype(jnp.int32)
        inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (z > 0)
        uc = jnp.clip(u, 0, w - 1)
        vc = jnp.clip(v, 0, h - 1)
        d_obs = dm[vc, uc]
        v_obs = vm[vc, uc] & inb
        sdf = (d_obs - z) / (trunc_v * spacing)       # + outside, - inside
        # integrate only near the surface; far-behind voxels are unobserved
        near = v_obs & (sdf > -1.0)
        tsdf = jnp.clip(sdf, -1.0, 1.0)
        acc = acc + jnp.where(near, tsdf, 0.0)
        wacc = wacc + near.astype(jnp.float32)
        return (acc, wacc), None

    acc0 = jnp.zeros((grid ** 3,), jnp.float32)
    w0 = jnp.zeros((grid ** 3,), jnp.float32)
    (acc, wsum), _ = jax.lax.scan(
        one_frame, (acc0, w0),
        (cams.K, cams.R, cams.t, depth_maps, valid))

    vals = jnp.where(wsum > 0, acc / jnp.maximum(wsum, 1.0), 1.0)
    return TSDF(vals.reshape(grid, grid, grid),
                wsum.reshape(grid, grid, grid), origin, spacing)


class SurfaceMesh(NamedTuple):
    vertices: jnp.ndarray     # [cap_v,3]
    faces: jnp.ndarray        # [cap_f,3], -1 padded
    num_vertices: jnp.ndarray
    num_faces: jnp.ndarray
    cells: jnp.ndarray        # [cap_v,3] int32 (z,y,x) owning grid cell —
    #                           exact integer identity for cross-slab welds


@partial(jax.jit, static_argnames=("max_vertices", "max_faces", "min_weight"))
def surface_nets(tsdf: TSDF, *, max_vertices: int = 65536,
                 max_faces: int = 131072,
                 min_weight: float = 1.0) -> SurfaceMesh:
    """Extract the zero isosurface: one vertex per cell with a sign change,
    placed at the mean of its edge zero-crossings; two triangles per grid
    face whose dual edge crosses the surface. The grid may be RECTANGULAR
    [Gz,Gy,Gx] (Poisson's Z-slab extraction passes slabs)."""
    v = tsdf.values
    wt = tsdf.weights
    Gz, Gy, Gx = v.shape
    observed = wt >= min_weight

    # cell = (i,j,k) with corners (i..i+1, j..j+1, k..k+1) cells
    def corner(di, dj, dk):
        return v[di:Gz - 1 + di, dj:Gy - 1 + dj, dk:Gx - 1 + dk]

    def cobs(di, dj, dk):
        return observed[di:Gz - 1 + di, dj:Gy - 1 + dj, dk:Gx - 1 + dk]

    corners = [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
               (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]
    cv = jnp.stack([corner(*c) for c in corners], -1)    # [g,g,g,8]
    co = jnp.stack([cobs(*c) for c in corners], -1)
    all_obs = jnp.all(co, axis=-1)
    sign = cv < 0
    has_surf = all_obs & jnp.any(sign, -1) & jnp.any(~sign, -1)

    # vertex position: average of edge zero crossings inside the cell
    # 12 edges as corner index pairs (in `corners` order)
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    # corner offsets (x,y,z) matching `corners` (dz fastest in index order:
    # corners tuple is (di,dj,dk) = (z?,y?,x?) -- we built meshgrid as
    # (zz,yy,xx) in fuse_tsdf, so axis0=z, axis1=y, axis2=x; offsets below
    # are (x,y,z) per corner accordingly
    coff = jnp.asarray([[c[2], c[1], c[0]] for c in corners],
                       jnp.float32)                       # [8,3] (x,y,z)

    pos_acc = jnp.zeros(cv.shape[:3] + (3,), jnp.float32)
    cnt = jnp.zeros(cv.shape[:3], jnp.float32)
    for a, b in edges:
        va, vb = cv[..., a], cv[..., b]
        crossing = (va < 0) != (vb < 0)
        tpar = va / jnp.where(jnp.abs(va - vb) < 1e-12, 1e-12, va - vb)
        tpar = jnp.clip(tpar, 0.0, 1.0)
        p = coff[a] + tpar[..., None] * (coff[b] - coff[a])
        pos_acc = pos_acc + jnp.where(crossing[..., None], p, 0.0)
        cnt = cnt + crossing.astype(jnp.float32)
    vpos = pos_acc / jnp.maximum(cnt[..., None], 1.0)     # cell-local (x,y,z)

    zz, yy, xx = jnp.meshgrid(jnp.arange(Gz - 1, dtype=jnp.float32),
                              jnp.arange(Gy - 1, dtype=jnp.float32),
                              jnp.arange(Gx - 1, dtype=jnp.float32),
                              indexing="ij")
    base = jnp.stack([xx, yy, zz], -1)
    world = tsdf.origin + tsdf.spacing * (base + vpos)    # [g,g,g,3]

    # vertex ids for surface cells (row-major over cells)
    flat_surf = has_surf.reshape(-1)
    ids = jnp.cumsum(flat_surf.astype(jnp.int32)) - 1
    num_v = jnp.minimum(flat_surf.sum(), max_vertices).astype(jnp.int32)
    # overflow entries (ids >= max_vertices) route to the DROPPED index
    # max_vertices, not a clamped last slot: the columns below scatter
    # independently, and XLA gives no cross-scatter duplicate-resolution
    # guarantee — a clamped slot could mix x/y/z from different cells
    tgt = jnp.where(flat_surf & (ids < max_vertices), ids, max_vertices)
    # Column-wise scatters, one flat [G^3] column per coordinate, in place
    # of one [G^3,3] scatter whose 3-wide minor dim padded badly under an
    # earlier accelerator's tiled layouts (ROADMAP: re-measure the plain
    # form on the GPU).
    verts = jnp.stack(
        [jnp.zeros((max_vertices,), jnp.float32).at[tgt].set(
            world[..., k].reshape(-1), mode="drop") for k in range(3)], -1)
    cell_cols = (zz, yy, xx)
    cells = jnp.stack(
        [jnp.full((max_vertices,), -1, jnp.int32).at[tgt].set(
            cell_cols[k].astype(jnp.int32).reshape(-1), mode="drop")
         for k in range(3)], -1)

    id_grid = ids.reshape(has_surf.shape)
    surf = has_surf

    # faces: for each grid edge along axis ax between voxel (i,j,k) and its
    # +ax neighbor with a sign change, connect the 4 cells sharing that edge
    cm = (Gz - 1, Gy - 1, Gx - 1)        # cells per storage axis
    tri_cols = [[], [], []]              # per-column lists (see note above)
    tris_ok = []

    def cell_ok(ii, jj, kk):
        return surf[ii, jj, kk]

    # axis x: voxel edge (x,y,z)->(x+1,y,z); shared cells vary in (y,z):
    # cells (z-1..z, y-1..y) at x  -> quad over 4 cell vertices
    for ax in range(3):
        # sign change along voxel axis: v[p] vs v[p + e_ax] where axes are
        # (z,y,x) in storage; e for x is axis 2, y axis 1, z axis 0
        store_ax = 2 - ax  # ax: 0=x,1=y,2=z -> storage axis
        va = v
        vb = jnp.roll(v, -1, axis=store_ax)
        oa = observed & jnp.roll(observed, -1, axis=store_ax)
        change = ((va < 0) != (vb < 0)) & oa
        flip = vb < va  # orientation by gradient direction

        # quad cells: the 4 cells adjacent to this voxel edge. In cell
        # coords, cells c with c_store_ax = p_store_ax and the other two
        # axes in {p-1, p}. Build index grids over voxels [G]^3, clip later.
        zi, yi, xi = jnp.meshgrid(jnp.arange(Gz), jnp.arange(Gy),
                                  jnp.arange(Gx), indexing="ij")
        pidx = [zi, yi, xi]
        other = [a for a in range(3) if a != store_ax]

        def cellid(dz, dy, dx):
            cz = pidx[0] - dz
            cy = pidx[1] - dy
            cx = pidx[2] - dx
            okb = ((cz >= 0) & (cz < cm[0]) & (cy >= 0) & (cy < cm[1]) &
                   (cx >= 0) & (cx < cm[2]))
            czc = jnp.clip(cz, 0, cm[0] - 1)
            cyc = jnp.clip(cy, 0, cm[1] - 1)
            cxc = jnp.clip(cx, 0, cm[2] - 1)
            return (jnp.where(okb & surf[czc, cyc, cxc],
                              id_grid[czc, cyc, cxc], -1))

        # offsets for the 4 cells in ring order around the edge
        offs = []
        for d0, d1 in ((0, 0), (1, 0), (1, 1), (0, 1)):
            d = [0, 0, 0]
            d[other[0]] = d0
            d[other[1]] = d1
            offs.append(tuple(d))
        q = [cellid(*o) for o in offs]                    # 4 x [G,G,G]
        qok = change & (q[0] >= 0) & (q[1] >= 0) & (q[2] >= 0) & (q[3] >= 0)

        # two triangles (q0,q1,q2) and (q0,q2,q3); flip winding by gradient
        t1c = (q[0], jnp.where(flip, q[1], q[2]), jnp.where(flip, q[2], q[1]))
        t2c = (q[0], jnp.where(flip, q[2], q[3]), jnp.where(flip, q[3], q[2]))
        for k in range(3):
            tri_cols[k] += [t1c[k].reshape(-1), t2c[k].reshape(-1)]
        tris_ok += [qok.reshape(-1), qok.reshape(-1)]

    tok = jnp.concatenate(tris_ok)
    fids = jnp.cumsum(tok.astype(jnp.int32)) - 1
    num_f = jnp.minimum(tok.sum(), max_faces).astype(jnp.int32)
    # same overflow routing as tgt above: spill to the dropped index
    ftgt = jnp.where(tok & (fids < max_faces), fids, max_faces)
    faces = jnp.stack(
        [jnp.full((max_faces,), -1, jnp.int32).at[ftgt].set(
            jnp.concatenate(tri_cols[k]), mode="drop") for k in range(3)], -1)
    return SurfaceMesh(verts, faces, num_v, num_f, cells)


def fuse_multi_sequence(seq_disparities, seq_cams, transforms, *,
                        grid: int = 128, min_dsp: float = 1e-4,
                        max_dsp: float = 1e4, trunc_cells: float = 3.0,
                        margin: float = 0.05):
    """Fuse MULTIPLE sequences' depth maps into one TSDF in the reference
    frame: sequence k's transform T_k maps its world into the reference
    frame, so voxels are pulled back through T_k^{-1} before projecting
    into k's cameras (signed distances measured in reference units by
    scaling with s_k). This is the true multi-sequence Model.obj fusion
    (the reference instead concatenates sampled points and hands them to
    Poisson, Processor.cpp:1021-1058 — the npts path `fuse_sequences`
    reproduces that; this is the denser TSDF equivalent).

    Returns (vertices, faces, tsdf) like `reconstruct`."""
    import jax

    from ..core.transforms import inverse as sim_inverse, apply_points
    from ..core.cameras import unproject_depth_map

    # bounds over all sequences (in the reference frame)
    mins = np.full(3, np.inf)
    maxs = np.full(3, -np.inf)
    for disp, cams, T in zip(seq_disparities, seq_cams, transforms):
        for i in range(disp.shape[0]):
            pts, valid = unproject_depth_map(cams[i],
                                             jnp.asarray(disp[i]),
                                             min_dsp, max_dsp)
            p = np.asarray(pts)[np.asarray(valid)]
            if len(p):
                p = np.asarray(apply_points(T, jnp.asarray(p)))
                mins = np.minimum(mins, p.min(0))
                maxs = np.maximum(maxs, p.max(0))
    span = maxs - mins
    mins -= margin * span
    maxs += margin * span
    spacing = float((maxs - mins).max() / (grid - 1))
    origin = jnp.asarray(mins, jnp.float32)

    acc = jnp.zeros((grid, grid, grid))
    wsum = jnp.zeros((grid, grid, grid))
    for disp, cams, T in zip(seq_disparities, seq_cams, transforms):
        inv = sim_inverse(T)
        # transform cameras to view the REFERENCE frame directly. The
        # sequence camera sees q = T^{-1}(p); scaling its frame by s gives
        # p_c' = s*(R_c q + t_c) = (R_c R^T) p + (s t_c - R_c R^T t):
        # a PURE rotation R_c R^T with depths in reference units
        # (z' = s * z_seq), and projection is unchanged (u = fx x/z + cx is
        # scale invariant). Observed disparities convert as 1/(s*z) = d/s.
        s = float(np.asarray(T.s))
        Rc = np.asarray(cams.R)
        tc = np.asarray(cams.t)
        Rt = np.asarray(T.R).T
        R2 = np.einsum("nij,jk->nik", Rc, Rt)
        t2 = s * tc - np.einsum("nij,j->ni", R2, np.asarray(T.t))
        cams2 = CameraBatch(cams.K, jnp.asarray(R2, jnp.float32),
                            jnp.asarray(t2, jnp.float32),
                            cams.width, cams.height)
        t_local = fuse_tsdf(jnp.asarray(disp) / s, cams2, origin,
                            jnp.asarray(spacing, jnp.float32), grid=grid,
                            trunc=trunc_cells, min_dsp=min_dsp / s,
                            max_dsp=max_dsp / s)
        acc = acc + t_local.values * t_local.weights
        wsum = wsum + t_local.weights

    vals = jnp.where(wsum > 0, acc / jnp.maximum(wsum, 1.0), 1.0)
    tsdf = TSDF(vals, wsum, origin, jnp.asarray(spacing, jnp.float32))
    mesh = surface_nets(tsdf)
    nv = int(mesh.num_vertices)
    nf = int(mesh.num_faces)
    verts = np.asarray(mesh.vertices[:nv])
    faces = np.asarray(mesh.faces[:nf])
    faces = faces[(faces >= 0).all(1) & (faces < nv).all(1)]
    return verts, faces, tsdf


def reconstruct(disparity, cams: CameraBatch, *, grid: int = 128,
                min_dsp: float = 1e-4, max_dsp: float = 1e4,
                trunc_cells: float = 3.0, margin: float = 0.05,
                bounds: Tuple[np.ndarray, np.ndarray] | None = None):
    """Convenience wrapper: pick grid bounds from the unprojected points,
    fuse, extract, return compacted numpy (vertices, faces).

    Equivalent pipeline position to GeometryRec::RunPoisson ->
    Result/Model.obj (Processor.cpp:1042-1062)."""
    from ..core.cameras import unproject_depth_map

    if bounds is None:
        mins = np.full(3, np.inf)
        maxs = np.full(3, -np.inf)
        for i in range(disparity.shape[0]):
            pts, valid = unproject_depth_map(cams[i], disparity[i],
                                             min_dsp, max_dsp)
            p = np.asarray(pts)[np.asarray(valid)]
            if len(p):
                mins = np.minimum(mins, p.min(0))
                maxs = np.maximum(maxs, p.max(0))
        span = maxs - mins
        mins -= margin * span
        maxs += margin * span
    else:
        mins, maxs = bounds
    spacing = float((maxs - mins).max() / (grid - 1))
    origin = jnp.asarray(mins, jnp.float32)

    tsdf = fuse_tsdf(jnp.asarray(disparity), cams, origin,
                     jnp.asarray(spacing, jnp.float32), grid=grid,
                     trunc=trunc_cells, min_dsp=min_dsp, max_dsp=max_dsp)
    mesh = surface_nets(tsdf)
    nv = int(mesh.num_vertices)
    nf = int(mesh.num_faces)
    verts = np.asarray(mesh.vertices[:nv])
    faces = np.asarray(mesh.faces[:nf])
    faces = faces[(faces >= 0).all(1) & (faces < nv).all(1)]
    return verts, faces, tsdf

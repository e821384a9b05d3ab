"""Non-rigid surface deformation: ARAP local-global solve in JAX.

Re-design of Deformation/Deformation.{h,cpp} (674 LoC + CGAL): the reference
builds a CGAL halfedge mesh, picks control vertices by greedy decimation
(UniformSampling, Deformation.cpp:63-106), finds a target position per
control by a kd-tree radius search + normal/projection filters
(Deform, Deformation.cpp:232-356), smooths control displacements twice over
8-NN uniform weights (358-381), and hands everything to CGAL
``Surface_mesh_deformation`` (ARAP: preprocess() factorization +
deform(5, 1e-4), 383-400).

Here the whole solve runs in JAX (BASELINE: "embedded-deformation-graph
Gauss-Newton ... as a JAX sparse solver"):
  - correspondence search = chunked distance matmuls + masked
    top-k (exact, replaces the approximate FLANN radius search)
  - ARAP = classic local-global (Sorkine-Alexa 2007), the same energy CGAL
    minimizes: local rotation fitting via batched 3x3 SVDs, global step a
    Laplacian solve by Jacobi-preconditioned CG with edge scatter matvecs —
    static shapes, fully jitted, scales to graph-block sharding (parallel/).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# control sampling + knn weights (host-side graph construction)
# ---------------------------------------------------------------------------

def uniform_sampling(points: np.ndarray, k: int = 16) -> np.ndarray:
    """Greedy decimation (UniformSampling, Deformation.cpp:63-106): walk
    vertices in index order; keep a vertex unless already removed, then
    remove its k nearest neighbors. Returns kept indices (sampIdx)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    removed = np.zeros(len(points), bool)
    keep = []
    _, knn = tree.query(points, k=min(k, len(points)))
    for i in range(len(points)):
        if not removed[i]:
            keep.append(i)
            removed[knn[i]] = True
            removed[i] = False
    return np.asarray(keep, np.int64)


def knn_graph(points: np.ndarray, k: int = 8
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(K+1)-NN (self included) with uniform 1/(K+1) weights — the
    reference's KNearestNeighbor(8) (Deformation.cpp:108-153)."""
    from scipy.spatial import cKDTree

    kk = min(k + 1, len(points))
    tree = cKDTree(points)
    _, idx = tree.query(points, k=kk)
    if idx.ndim == 1:
        idx = idx[:, None]
    w = np.full(idx.shape, 1.0 / (k + 1), np.float32)
    return idx.astype(np.int32), w


# ---------------------------------------------------------------------------
# correspondence search
# ---------------------------------------------------------------------------

class Correspondences(NamedTuple):
    targets: jnp.ndarray   # [C,3] target positions (controls when invalid)
    valid: jnp.ndarray     # [C] bool


@partial(jax.jit, static_argnames=("max_neighbors",))
def find_correspondences(
    controls: jnp.ndarray,          # [C,3] control positions
    control_normals: jnp.ndarray,   # [C,3]
    tpts: jnp.ndarray,              # [T,3] scan points
    tnormals: jnp.ndarray,          # [T,3]
    *,
    proj_len_err: float = 100.0,
    proj_dist_err: float = 100.0,
    max_neighbors: int = 8,
) -> Correspondences:
    """Per-control target search (Deform, Deformation.cpp:266-356):
    candidates within sqrt(2)*nearest distance, same-facing normals, ranked
    by (projDist, |projLen|), best <=8 averaged; reject by mean projections
    and near-perpendicular displacement direction."""
    # distance matrix by matmul
    d2 = (jnp.sum(controls ** 2, -1, keepdims=True)
          - 2.0 * jnp.dot(controls, tpts.T,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
          + jnp.sum(tpts ** 2, -1)[None, :])               # [C,T]
    d2 = jnp.maximum(d2, 0.0)
    d2min = jnp.min(d2, axis=1, keepdims=True)
    in_radius = d2 <= 2.0 * d2min + 1e-12                  # flann squared-L2

    nrm = control_normals / jnp.maximum(
        jnp.linalg.norm(control_normals, axis=-1, keepdims=True), 1e-12)
    facing = jnp.dot(nrm, tnormals.T, preferred_element_type=jnp.float32,
                     precision="highest") > 0
    ok = in_radius & facing                                # [C,T]

    dirs = tpts[None, :, :] - controls[:, None, :]         # [C,T,3]
    proj_len = jnp.einsum("ctk,ck->ct", dirs, nrm, precision="highest")
    proj_dist = jnp.sqrt(jnp.maximum(
        jnp.sum(dirs * dirs, -1) - proj_len ** 2, 0.0))

    # rank: smallest projDist first, |projLen| tie-break
    score = proj_dist + 1e-6 * jnp.abs(proj_len)
    score = jnp.where(ok, score, jnp.inf)
    k = min(max_neighbors, score.shape[1])
    top_score, top_idx = jax.lax.top_k(-score, k)
    top_ok = jnp.isfinite(-top_score)
    cnt = jnp.maximum(top_ok.sum(-1), 1)

    def gather(c_mat):
        return jnp.take_along_axis(c_mat, top_idx, axis=1)

    m_len = jnp.where(top_ok, gather(proj_len), 0.0).sum(-1) / cnt
    m_dist = jnp.where(top_ok, gather(proj_dist), 0.0).sum(-1) / cnt
    m_pts = (jnp.where(top_ok[..., None], tpts[top_idx], 0.0).sum(-2) /
             cnt[:, None])

    has_any = top_ok.any(-1)
    accept = has_any & (m_len < proj_len_err) & (m_dist < proj_dist_err)
    disp = m_pts - controls
    cosang = jnp.abs(jnp.einsum("ck,ck->c", disp, nrm, precision="highest") /
                     jnp.maximum(jnp.linalg.norm(disp, axis=-1), 1e-12))
    accept &= cosang >= 0.1                                # (Deform:352)
    targets = jnp.where(accept[:, None], m_pts, controls)
    return Correspondences(targets, accept)


@partial(jax.jit, static_argnames=("iters",))
def smooth_displacements(controls, orig, nbr_idx, nbr_w, *, iters: int = 2):
    """Control-displacement smoothing (Deformation.cpp:358-381):
    c_i <- orig_i + sum_j w_ij (c_j - orig_j), `iters` rounds."""
    c = controls
    for _ in range(iters):
        disp = c - orig
        c = orig + jnp.einsum("ck,ckd->cd", nbr_w, disp[nbr_idx],
                              precision="highest")
    return c


# ---------------------------------------------------------------------------
# ARAP local-global solve
# ---------------------------------------------------------------------------

def mesh_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges [E,2] from a face list."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0).astype(np.int32)


def cotangent_weights(verts: np.ndarray, faces: np.ndarray,
                      edges: np.ndarray) -> np.ndarray:
    """Cotangent edge weights (CGAL Surface_mesh_deformation's default ARAP
    weighting), clamped to >= 1e-3 for robustness. Fully vectorized: the
    per-face Python loop was O(F) host time (minutes at 100k faces)."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces)
    # the three (i, j, opposite) rotations of every face, flattened
    i = f[:, [0, 1, 2]].ravel()
    j = f[:, [1, 2, 0]].ravel()
    o = f[:, [2, 0, 1]].ravel()
    a = v[i] - v[o]
    b = v[j] - v[o]
    cos = np.einsum("ni,ni->n", a, b)
    sin = np.linalg.norm(np.cross(a, b), axis=1)
    cot = 0.5 * cos / np.maximum(sin, 1e-9)
    # accumulate onto undirected edges via a sorted-pair key
    V = int(max(i.max(initial=0), j.max(initial=0))) + 1
    lo = np.minimum(i, j).astype(np.int64)
    hi = np.maximum(i, j).astype(np.int64)
    key = lo * V + hi
    ekey = (np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64) * V +
            np.maximum(edges[:, 0], edges[:, 1]))
    order = np.argsort(ekey)
    pos = np.searchsorted(ekey[order], key)
    acc = np.zeros(len(edges) + 1, np.float64)
    hit = (pos < len(edges)) & (ekey[order][np.minimum(
        pos, len(edges) - 1)] == key)
    np.add.at(acc, np.where(hit, order[np.minimum(pos, len(edges) - 1)],
                            len(edges)), np.where(hit, cot, 0.0))
    return np.maximum(acc[:len(edges)], 1e-3).astype(np.float32)


class ARAPProblem(NamedTuple):
    rest: jnp.ndarray        # [V,3] rest positions
    edges: jnp.ndarray       # [E,2]
    weights: jnp.ndarray     # [E]
    constrained: jnp.ndarray  # [V] bool
    targets: jnp.ndarray     # [V,3] target for constrained verts


def _laplacian_matvec(p, edges, w, free):
    """(L p) restricted to free rows; L = sum_e w_e (e_i - e_j)(e_i - e_j)^T."""
    i, j = edges[:, 0], edges[:, 1]
    diff = w[:, None] * (p[i] - p[j])
    out = jnp.zeros_like(p)
    out = out.at[i].add(diff)
    out = out.at[j].add(-diff)
    return jnp.where(free[:, None], out, 0.0)


def _det3(A):
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] -
                            A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] -
                              A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] -
                              A[..., 1, 1] * A[..., 2, 0]))


def fit_rotation(S, squarings: int = 7):
    """Nearest proper rotation R = argmax_R tr(R S) for batched 3x3
    covariances S [...,3,3] — the ARAP local step (R = V diag(1,1,det) U^T
    for S = U Sigma V^T), WITHOUT an SVD.

    Method: Horn's quaternion form (tr(R S) = q^T K(S^T) q for unit
    quaternion q), dominant eigenvector of the symmetric 4x4 K by a shifted
    squared power iteration: B = (K + sqrt(3)||K||-shift) normalized, then
    B <- B^2 seven times (effective power 128); the dominant column (argmax
    diagonal of the rank-1 limit, selected by one-hot matmul) is q. All
    batched 4x4 matmuls + elementwise work, no iterative LAPACK kernel
    (a batched jnp.linalg.svd over 3k blocks costs several times the rest
    of an ARAP outer iteration).

    Unlike the det-gated Newton-polar iteration this is CORRECT on rank-2
    (planar one-ring) and reflective (det<0) covariances: the quaternion
    optimum IS the SVD answer with the det-sign fix (round-2 advisor
    finding; validated against the SVD oracle in tests/test_deformation.py).
    S == 0 (fro norm < 1e-20) returns identity — any rotation is optimal.

    Shared by all three ARAP paths (this module, parallel/arap_dist.py,
    parallel/arap_blocks.py) so sharded == unsharded holds exactly.
    """
    # build K from A = S^T (tr(R A^T) = q^T K(A) q), batched
    A = jnp.swapaxes(S, -1, -2)
    fro = jnp.sqrt(jnp.maximum(
        jnp.sum(S * S, axis=(-2, -1), keepdims=True), 1e-40))
    A = A / fro
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    row0 = jnp.stack([a00 + a11 + a22, a21 - a12, a02 - a20, a10 - a01], -1)
    row1 = jnp.stack([a21 - a12, a00 - a11 - a22, a01 + a10, a02 + a20], -1)
    row2 = jnp.stack([a02 - a20, a01 + a10, a11 - a00 - a22, a12 + a21], -1)
    row3 = jnp.stack([a10 - a01, a02 + a20, a12 + a21, a22 - a00 - a11], -1)
    K = jnp.stack([row0, row1, row2, row3], -2)           # [...,4,4]

    # shift makes K PD (|lambda| <= sig1+sig2+sig3 <= sqrt(3)||A||_F = sqrt3)
    eye4 = jnp.eye(4, dtype=S.dtype)
    B = K + (jnp.sqrt(3.0) * 1.0001) * eye4
    hi = jax.lax.Precision.HIGHEST
    for _ in range(squarings):
        B = B / jnp.sqrt(jnp.maximum(
            jnp.sum(B * B, axis=(-2, -1), keepdims=True), 1e-40))
        B = jnp.matmul(B, B, precision=hi)
    # dominant eigenvector = largest column of the rank-1 limit; pick by
    # argmax diagonal (diag_i -> q_i^2, max entry >= 1/4) via one-hot
    diag = jnp.diagonal(B, axis1=-2, axis2=-1)            # [...,4]
    sel = (jnp.argmax(diag, axis=-1)[..., None] ==
           jnp.arange(4)).astype(S.dtype)
    q = jnp.einsum("...ij,...j->...i", B, sel, precision="highest")
    q = q / jnp.sqrt(jnp.maximum(jnp.sum(q * q, -1, keepdims=True), 1e-40))

    w_, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w_ * z),
                   2 * (x * z + w_ * y)], -1),
        jnp.stack([2 * (x * y + w_ * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w_ * x)], -1),
        jnp.stack([2 * (x * z - w_ * y), 2 * (y * z + w_ * x),
                   1 - 2 * (x * x + y * y)], -1)], -2)
    # S ~ 0: any rotation optimal -> identity (and guards the normalize)
    degenerate = fro[..., 0, 0] < 1e-18
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=S.dtype), R.shape)
    return jnp.where(degenerate[..., None, None], eye3, R)


def _fit_rotations(p, q, edges, w, nv):
    """Per-vertex rotation best aligning rest edge vectors to current ones:
    R_i = argmax tr(R S_i), S_i = sum_j w_ij (g_i-g_j)(p_i-p_j)^T."""
    i, j = edges[:, 0], edges[:, 1]
    gd = p[i] - p[j]                         # rest
    pd = q[i] - q[j]                         # deformed
    contrib = w[:, None, None] * gd[:, :, None] * pd[:, None, :]
    S = jnp.zeros((nv, 3, 3)).at[i].add(contrib).at[j].add(contrib)
    # R maps rest -> deformed
    return fit_rotation(S)


def _cg(matvec, b, x0, iters: int, tol: float, precond):
    def body(state):
        x, r, z, pdir, rz, k = state
        Ap = matvec(pdir)
        alpha = rz / jnp.maximum(jnp.vdot(pdir, Ap), 1e-20)
        x = x + alpha * pdir
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        pdir = z + beta * pdir
        return x, r, z, pdir, rz_new, k + 1

    def cond(state):
        _, r, _, _, _, k = state
        return (k < iters) & (jnp.linalg.norm(r) > tol)

    r0 = b - matvec(x0)
    z0 = precond(r0)
    state = (x0, r0, z0, z0, jnp.vdot(r0, z0), 0)
    x, *_ = jax.lax.while_loop(cond, body, state)
    return x


@partial(jax.jit, static_argnames=("outer_iters", "cg_iters", "dense"))
def arap_solve(prob: ARAPProblem, *, outer_iters: int = 5,
               cg_iters: int = 200, tol: float = 1e-4,
               dense: Optional[bool] = None) -> jnp.ndarray:
    """ARAP local-global iterations (the CGAL deform(5, 1e-4) equivalent,
    Deformation.cpp:393-398): constrained vertices pinned to their targets,
    free vertices solved from the rotation-augmented Poisson system.

    ``dense`` (default: auto, V <= 4096) solves the global step DIRECTLY:
    the free-free Laplacian is constant across all outer iterations (and
    across deform passes — the weights never change), so it is materialized
    and Cholesky-factorized ONCE per solve and each outer iteration is two
    triangular solves. This is CGAL's own preprocess()-then-deform strategy
    (Deformation.cpp:393-398) and it is matmul-shaped (blocked Cholesky /
    triangular solves), unlike ~60 sequential CG matvecs per outer which
    make the solve launch-latency bound at the reference's ~3k-vertex
    template scale. Above the
    threshold the edge-scatter CG keeps memory O(E)."""
    rest = prob.rest
    nv = rest.shape[0]
    free = ~prob.constrained
    edges, w = prob.edges, prob.weights
    i, j = edges[:, 0], edges[:, 1]
    if dense is None:
        dense = nv <= 4096

    deg = (jnp.zeros(nv).at[i].add(w).at[j].add(w))

    if dense:
        # A = free-masked Laplacian + identity rows on constrained verts:
        # solving A x = [b_f; p_c] pins constrained rows to their targets
        # and solves the free block exactly. SPD as long as every free
        # region touches a constraint (the control set covers the mesh);
        # tiny diagonal jitter guards float rank.
        fm = free.astype(jnp.float32)
        Ld = (jnp.zeros((nv, nv)).at[i, j].add(-w).at[j, i].add(-w)
              .at[jnp.arange(nv), jnp.arange(nv)].add(deg))
        hi = jax.lax.Precision.HIGHEST
        A = Ld * (fm[:, None] * fm[None, :])
        jitter = 1e-6 * jnp.mean(deg)
        A = A + jnp.diag((1.0 - fm) + fm * jitter)
        chol = jax.lax.linalg.cholesky(A)

        def full_L(x):
            return jnp.matmul(Ld, x, precision=hi)

        def global_solve(b, p):
            rhs = jnp.where(free[:, None], b, p)
            y = jax.lax.linalg.triangular_solve(
                chol, rhs, left_side=True, lower=True)
            return jax.lax.linalg.triangular_solve(
                chol, y, left_side=True, lower=True, transpose_a=True)
    else:
        # diagonal (Jacobi) preconditioner of the free-free Laplacian block
        dinv = jnp.where(free, 1.0 / jnp.maximum(deg, 1e-9), 1.0)

        def full_L(x):
            return _laplacian_matvec(x, edges, w,
                                     jnp.ones_like(free))

        def mv(x):
            return _laplacian_matvec(
                jnp.where(free[:, None], x, 0.0), edges, w, free)

        def global_solve(b, p):
            pre = lambda r: dinv[:, None] * r
            x0 = jnp.where(free[:, None], p, 0.0)
            x = _cg(mv, b, x0, cg_iters, tol, pre)
            return jnp.where(free[:, None], x, p)

    p = jnp.where(prob.constrained[:, None], prob.targets, rest)

    def outer(it, p):
        R = _fit_rotations(rest, p, edges, w, nv)
        # rhs_i = sum_j w/2 (R_i + R_j)(g_i - g_j)
        gd = rest[i] - rest[j]
        Rij = 0.5 * (R[i] + R[j])
        rot_gd = w[:, None] * jnp.einsum("eab,eb->ea", Rij, gd,
                                         precision="highest")
        b = jnp.zeros_like(p).at[i].add(rot_gd).at[j].add(-rot_gd)
        # move constrained contribution to the rhs
        b = b - full_L(jnp.where(prob.constrained[:, None], p, 0.0))
        b = jnp.where(free[:, None], b, 0.0)
        return global_solve(b, p)

    p = jax.lax.fori_loop(0, outer_iters, outer, p)
    return p


# ---------------------------------------------------------------------------
# full pipeline wrapper (the reference's Deformation class)
# ---------------------------------------------------------------------------

@dataclass
class Deformer:
    """Mirror of the reference Deformation object lifecycle: construct with
    a mesh, call deform(scan_points, scan_normals, ...) repeatedly; the
    deformed geometry becomes the new rest state (overwrite_initial_geometry,
    Deformation.cpp:399)."""
    vertices: np.ndarray
    faces: np.ndarray
    normals: np.ndarray
    sample_idx: np.ndarray = None
    _edges: np.ndarray = None
    _weights: np.ndarray = None

    def __post_init__(self):
        from ..ops.mesh_normals import vertex_normals
        if self.normals is None:
            self.normals = np.asarray(vertex_normals(
                jnp.asarray(self.vertices), jnp.asarray(self.faces)))
        if self.sample_idx is None:
            self.sample_idx = uniform_sampling(self.vertices)
        self._edges = mesh_edges(self.faces)
        self._weights = cotangent_weights(self.vertices, self.faces,
                                          self._edges)

    def deform(self, tpts: np.ndarray, tnormals: np.ndarray,
               proj_len_err: float = 100.0, proj_dist_err: float = 100.0,
               outer_iters: int = 5) -> np.ndarray:
        """One full Deform() pass (Deformation.cpp:232-401). Returns and
        stores the deformed vertices."""
        sidx = self.sample_idx
        controls = self.vertices[sidx]
        cnorms = self.normals[sidx]

        corr = find_correspondences(
            jnp.asarray(controls), jnp.asarray(cnorms),
            jnp.asarray(tpts, np.float32), jnp.asarray(tnormals, np.float32),
            proj_len_err=proj_len_err, proj_dist_err=proj_dist_err)

        nbr_idx, nbr_w = knn_graph(controls, 8)
        smoothed = smooth_displacements(
            corr.targets, jnp.asarray(controls),
            jnp.asarray(nbr_idx), jnp.asarray(nbr_w))

        constrained = np.zeros(len(self.vertices), bool)
        constrained[sidx] = True
        targets = jnp.asarray(self.vertices).at[jnp.asarray(sidx)].set(
            smoothed)

        prob = ARAPProblem(jnp.asarray(self.vertices),
                           jnp.asarray(self._edges),
                           jnp.asarray(self._weights),
                           jnp.asarray(constrained), targets)
        out = np.asarray(arap_solve(prob, outer_iters=outer_iters))
        self.vertices = out
        # recompute normals for the next pass (exportOBJ also recomputes,
        # Deformation.h:174-221)
        from ..ops.mesh_normals import vertex_normals
        self.normals = np.asarray(vertex_normals(
            jnp.asarray(out), jnp.asarray(self.faces)))
        return out

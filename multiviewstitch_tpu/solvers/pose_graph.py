"""Global similarity pose-graph refinement over the sequence view graph.

The reference chains sequences greedily: ONE keyframe pair per consecutive
sequence pair decides the whole transform (Processor.cpp:746-826); every
other surviving match is discarded. This solver performs the global
refinement SURVEY §7 step 6 calls for: jointly optimize all per-sequence
similarities {s_k, R_k, t_k} (last sequence gauge-fixed to identity)
against ALL inlier matches of ALL sequence pairs:

    min Σ_pairs(k,l) Σ_i  | T_k(p_i) - T_l(q_i) |²

Parametrization: (log s, axis-angle r, t) per sequence — 7 dof each, so the
whole problem is a few dozen parameters: one dense damped-GN with autodiff
Jacobians (jacfwd over the stacked residual vector), fully jitted. The
greedy chain provides the initialization, exactly as SURVEY prescribes
("keeping SRT as initialization").
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .ba import rodrigues
from ..core.transforms import Similarity


class PoseGraphData(NamedTuple):
    seq_k: jnp.ndarray    # [E] int32 first-sequence index per match block
    seq_l: jnp.ndarray    # [E] int32 second-sequence index
    p: jnp.ndarray        # [E,M,3] points in sequence k's frame (padded)
    q: jnp.ndarray        # [E,M,3] matched points in sequence l's frame
    mask: jnp.ndarray     # [E,M]


def build_data(pairs: List[Tuple[int, int, np.ndarray, np.ndarray,
                                 np.ndarray]],
               max_matches: int = 2048) -> PoseGraphData:
    """pairs: list of (k, l, p [M,3], q [M,3], mask [M])."""
    E = len(pairs)
    sk = np.zeros(E, np.int32)
    sl = np.zeros(E, np.int32)
    P = np.zeros((E, max_matches, 3), np.float32)
    Q = np.zeros((E, max_matches, 3), np.float32)
    Mk = np.zeros((E, max_matches), bool)
    for e, (k, l, p, q, m) in enumerate(pairs):
        n = min(len(p), max_matches)
        sk[e], sl[e] = k, l
        P[e, :n] = p[:n]
        Q[e, :n] = q[:n]
        Mk[e, :n] = m[:n]
    return PoseGraphData(jnp.asarray(sk), jnp.asarray(sl), jnp.asarray(P),
                         jnp.asarray(Q), jnp.asarray(Mk))


def _params_to_sim(params):
    """params [S,7] = (log s, rvec, t) -> (s [S], R [S,3,3], t [S,3])."""
    s = jnp.exp(params[:, 0])
    R = rodrigues(params[:, 1:4])
    t = params[:, 4:7]
    return s, R, t


def _residuals(params, data: PoseGraphData, delta=None):
    """Stacked (optionally Huber-weighted) match residuals.

    With ``delta``, each match's 3D residual is scaled by the sqrt-Huber
    IRLS weight min(1, delta/|r|)^0.5 (weights stop-gradiented, standard
    IRLS): surviving outlier matches — the RANSAC cascade keeps a few —
    otherwise drag the global optimum away from an exact init by far more
    than the inlier noise floor."""
    s, R, t = _params_to_sim(params)
    sk, sl = data.seq_k, data.seq_l
    Tp = (s[sk][:, None, None] *
          jnp.einsum("eij,emj->emi", R[sk], data.p,
                     precision="highest") + t[sk][:, None, :])
    Tq = (s[sl][:, None, None] *
          jnp.einsum("eij,emj->emi", R[sl], data.q,
                     precision="highest") + t[sl][:, None, :])
    r = (Tp - Tq) * data.mask[..., None]
    if delta is not None:
        n = jnp.linalg.norm(r, axis=-1)
        w = jnp.sqrt(jnp.minimum(1.0, delta / jnp.maximum(n, 1e-12)))
        r = r * jax.lax.stop_gradient(w)[..., None]
    return r.reshape(-1)


@partial(jax.jit, static_argnames=("num_seqs",))
def _gn_step(params, data: PoseGraphData, lam, delta, *, num_seqs: int):
    flat = params.reshape(-1)

    def res_flat(x):
        return _residuals(x.reshape(num_seqs, 7), data, delta)

    r = res_flat(flat)
    J = jax.jacfwd(res_flat)(flat)                 # [R, 7S]
    # gauge: last sequence fixed -> zero its columns
    free = jnp.ones((num_seqs, 7)).at[num_seqs - 1].set(0.0).reshape(-1)
    J = J * free[None, :]
    H = jnp.matmul(J.T, J, precision="highest") + lam * jnp.eye(J.shape[1])
    g = jnp.matmul(J.T, r, precision="highest")
    delta = jnp.linalg.solve(H, -g) * free
    return (flat + delta).reshape(num_seqs, 7), (r ** 2).sum()


def refine_pose_graph(init: List[Similarity], data: PoseGraphData, *,
                      iters: int = 20, lam0: float = 1e-4,
                      stagnation_rtol: float = 1e-6
                      ) -> Tuple[List[Similarity], float]:
    """Damped-GN refinement from the greedy-chain initialization.

    Termination is convergence-aware: a candidate step is accepted only if
    it lowers the total cost, and the loop stops as soon as an accepted
    step improves the cost by less than ``stagnation_rtol`` relative — so
    an init that already sits at (or within noise of) the optimum of the
    match-residual objective is left essentially untouched rather than
    being walked around its noise basin for all ``iters`` iterations.
    """
    S = len(init)
    params = np.zeros((S, 7), np.float32)
    for k, T in enumerate(init):
        params[k, 0] = np.log(max(float(np.asarray(T.s)), 1e-9))
        R = np.asarray(T.R, np.float64)
        # log map (axis-angle from matrix)
        cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
        ang = np.arccos(cos)
        if ang > 1e-9:
            ax = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                           R[1, 0] - R[0, 1]]) / (2 * np.sin(ang))
            params[k, 1:4] = (ax * ang).astype(np.float32)
        params[k, 4:7] = np.asarray(T.t)

    p = jnp.asarray(params)
    lam = lam0

    # Huber scale from the INIT residual distribution: 3x the masked-median
    # match error (floored at a tiny abs value so an exactly-zero init
    # doesn't zero every weight). Fixed across iterations so accepted-step
    # costs are comparable.
    r0 = _residuals(p, data).reshape(-1, 3)
    n0 = jnp.linalg.norm(r0, axis=-1)
    m = data.mask.reshape(-1)
    med = jnp.nanquantile(jnp.where(m, n0, jnp.nan), 0.5)
    delta = jnp.maximum(3.0 * jnp.nan_to_num(med, nan=0.0), 1e-6)

    best_cost = float(jnp.sum(_residuals(p, data, delta) ** 2))
    for _ in range(iters):
        cand, _ = _gn_step(p, data, jnp.asarray(lam, jnp.float32), delta,
                           num_seqs=S)
        cost = float(jnp.sum(_residuals(cand, data, delta) ** 2))
        if cost < best_cost:
            rel_gain = (best_cost - cost) / max(best_cost, 1e-30)
            p, best_cost = cand, cost
            lam = max(lam * 0.5, 1e-8)
            if rel_gain < stagnation_rtol:
                break
        else:
            lam = min(lam * 4.0, 1e4)
        if lam >= 1e4:
            break

    s, R, t = _params_to_sim(p)
    out = [Similarity(s[k], R[k], t[k]) for k in range(S)]
    n = jnp.maximum(data.mask.sum(), 1)
    # report the UNWEIGHTED rmse (the metric callers compare across runs)
    rmse = float(jnp.sqrt(jnp.sum(_residuals(p, data) ** 2) / n))
    return out, rmse

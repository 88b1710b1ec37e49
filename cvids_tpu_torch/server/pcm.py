"""Pairwise-consistency maximization (PCM) outlier rejection for inter-agent
loop closures (port of ``cvids_tpu/server/pcm.py``).

Inter-agent loop edges are bucketed per client pair; the O(E²) pairwise
cycle-consistency errors are one batched 4-DoF composition over an (E, E)
grid on the device; the consistency matrix feeds a max-clique search on the
host (the port's C++ solver, `native`, when it builds; the Python search
otherwise).

Cycle error (4-DoF semantics, `pcm_graph.cpp:195-268`): for edges
e1 = (i1→j1, T1) and e2 = (i2→j2, T2) between clients a (i's) and b (j's),
the composed loop  T1⁻¹ · odo_a(i1→i2) · T2 · odo_b(j2→j1)  should be
identity; its (yaw, t) magnitude, whitened, is the pairwise error;
threshold gamma = 5 (`pcm_graph.cpp:8`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..geometry import rot_z, wrap_angle

__all__ = ["pairwise_consistency", "max_clique", "pcm_filter", "FourDof",
           "chain_cov", "native_max_clique_available"]


class FourDof(NamedTuple):
    """Batch of 4-DoF transforms (yaw, t); composition is yaw-additive."""

    yaw: torch.Tensor  # (...,)
    t: torch.Tensor    # (..., 3)


def _compose(a: FourDof, b: FourDof) -> FourDof:
    return FourDof(wrap_angle(a.yaw + b.yaw),
                   a.t + torch.einsum("...ij,...j->...i", rot_z(a.yaw), b.t))


def _inverse(a: FourDof) -> FourDof:
    return FourDof(wrap_angle(-a.yaw),
                   -torch.einsum("...ij,...j->...i", rot_z(-a.yaw), a.t))


def _take(x: FourDof, idx) -> FourDof:
    return FourDof(x.yaw[idx], x.t[idx])


def chain_cov(pose: FourDof, idx_a: torch.Tensor, idx_b: torch.Tensor,
              step_sigma_t: float, step_sigma_yaw: float,
              rot_to_frame_a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Odometry-chain covariance of the relative 4-DoF transform between
    keyframes `idx_a` and `idx_b` of one client, from prefix sums:

      Σ_t(a,b) = σ_t²·n·I + σ_y²· ẑ× M ×ẑᵀ ,  σ_yaw²(a,b) = σ_y²·n
      M = Σ_k (t_b - t_k)(t_b - t_k)ᵀ  (k over the chain)

    with M from S1 = Σ t_k and S2 = Σ t_k t_kᵀ, so each pair is O(1) after
    one cumulative sum; the ẑ× projection is applied in frame a via
    `rot_to_frame_a` (..., 3, 3). Returns (cov_t (..., 3, 3), var_yaw (...,))."""
    t = pose.t                                                   # (N, 3)
    s1 = torch.cumsum(t, dim=0)
    s2 = torch.cumsum(t[:, :, None] * t[:, None, :], dim=0)      # (N, 3, 3)
    lo = torch.minimum(idx_a, idx_b)
    hi = torch.maximum(idx_a, idx_b)
    n_steps = (hi - lo).to(t.dtype)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)

    def seg(s, a, b):     # sum over k in [a, b): S(b-1) - S(a-1)
        lead = (a > 0).reshape(a.shape + (1,) * (s.ndim - 1))
        sa = torch.where(lead, s[torch.clamp(a - 1, min=0)], zero)
        return s[torch.clamp(b - 1, min=0)] - sa

    s1_seg = seg(s1, lo, hi)
    s2_seg = seg(s2, lo, hi)
    t_b = t[hi]
    m = (n_steps[..., None, None] * t_b[..., :, None] * t_b[..., None, :]
         - t_b[..., :, None] * s1_seg[..., None, :]
         - s1_seg[..., :, None] * t_b[..., None, :] + s2_seg)
    # ẑ× M ×ẑᵀ in frame a: rotate M, then the hat(z) sandwich, whose entries
    # are [[M11, -M10, 0], [-M01, M00, 0], [0, 0, 0]]
    m_a = torch.einsum("...ij,...jk,...lk->...il", rot_to_frame_a, m, rot_to_frame_a)
    z0 = torch.zeros_like(m_a[..., 0, 0])
    yaw_term = torch.stack([m_a[..., 1, 1], -m_a[..., 1, 0], z0,
                            -m_a[..., 0, 1], m_a[..., 0, 0], z0,
                            z0, z0, z0], dim=-1).reshape(m_a.shape)
    n1 = torch.clamp(n_steps, min=1.0)
    cov_t = (step_sigma_t ** 2 * n1[..., None, None] * torch.eye(3, dtype=t.dtype, device=t.device)
             + step_sigma_yaw ** 2 * yaw_term)
    var_yaw = step_sigma_yaw ** 2 * n1
    return cov_t, var_yaw


def pairwise_consistency(edge_T: FourDof, pose_i: FourDof, pose_j: FourDof,
                         valid: torch.Tensor, sigma_t: float = 0.1,
                         sigma_yaw: float = 0.05, gamma: float = 5.0,
                         chain: tuple | None = None) -> torch.Tensor:
    """(E, E) bool consistency matrix of E edges i -> j (edge_T: measured
    relative transforms; pose_i / pose_j: the endpoints' odometry poses in
    their clients' local frames).

    Whitening: with `chain=None`, fixed sigmas. With `chain=(all_pose_a,
    idx_i, all_pose_b, idx_j, step_sigma_t, step_sigma_yaw)`, the cycle error
    is whitened by both legs' odometry-chain covariance (`chain_cov`), the
    reference's Mahalanobis PCM. The batched 3×3 solve skips torch's error
    check, which would wait for the card."""
    e_count = edge_T.yaw.shape[0]
    ii = torch.arange(e_count, device=edge_T.yaw.device)
    a_idx, b_idx = ii[:, None], ii[None, :]
    t1, t2 = _take(edge_T, a_idx), _take(edge_T, b_idx)
    odo_a = _compose(_inverse(_take(pose_i, a_idx)), _take(pose_i, b_idx))
    odo_b = _compose(_inverse(_take(pose_j, b_idx)), _take(pose_j, a_idx))
    cycles = _compose(_compose(_compose(_inverse(t1), odo_a), t2), odo_b)

    if chain is None:
        errs = (torch.sum((cycles.t / sigma_t) ** 2, dim=-1)
                + (cycles.yaw / sigma_yaw) ** 2)
    else:
        all_pose_a, idx_i, all_pose_b, idx_j, st_sig, sy_sig = chain
        r_a = rot_z(-pose_i.yaw)   # into the frame of endpoint i1
        cov_a, vy_a = chain_cov(all_pose_a, idx_i[:, None], idx_i[None, :],
                                st_sig, sy_sig, r_a[:, None])
        cov_b, vy_b = chain_cov(all_pose_b, idx_j[:, None], idx_j[None, :],
                                st_sig, sy_sig, r_a[:, None])
        eye = torch.eye(3, dtype=cycles.t.dtype, device=cycles.t.device)
        cov = cov_a + cov_b + 2.0 * sigma_t ** 2 * eye
        vyaw = vy_a + vy_b + 2.0 * sigma_yaw ** 2
        sol = torch.linalg.solve_ex(cov, cycles.t[..., None])[0][..., 0]
        errs = torch.sum(cycles.t * sol, dim=-1) + cycles.yaw ** 2 / vyaw
    ok = (errs < gamma ** 2) & valid[:, None] & valid[None, :]
    return ok & ok.T


def native_max_clique_available() -> bool:
    """Whether `max_clique` runs the port's C++ solver (`native`, built on
    first use) rather than the Python search."""
    return native.available()


def max_clique(adj: np.ndarray, exact_threshold: int = 18) -> np.ndarray:
    """Indices of a (near-)maximum clique of a boolean adjacency matrix.

    The native C++ solver (the fmc-library equivalent) when it builds;
    otherwise exact branch-and-bound for small graphs and the greedy
    degree-guided heuristic (Pattabiraman et al., the reference's
    `maxCliqueHeu`) for larger ones."""
    if native.available():
        out = native.max_clique_native(adj)
        if out is not None:
            return out
    n = adj.shape[0]
    a = np.asarray(adj, bool).copy()
    np.fill_diagonal(a, False)
    if n == 0:
        return np.zeros(0, np.int64)

    if n <= exact_threshold:
        best: list[int] = []

        def expand(r: list[int], cand: np.ndarray):
            nonlocal best
            if len(r) + cand.sum() <= len(best):
                return
            idxs = np.nonzero(cand)[0]
            if len(idxs) == 0:
                if len(r) > len(best):
                    best = list(r)
                return
            for v in idxs:
                if len(r) + cand.sum() <= len(best):
                    return
                cand2 = cand & a[v]
                cand2[: v + 1] = False
                expand(r + [int(v)], cand2)
                cand[v] = False

        expand([], np.ones(n, bool))
        return np.asarray(best, np.int64)

    # greedy heuristic: seed from each high-degree vertex, extend by degree
    deg = a.sum(1)
    order = np.argsort(-deg)
    best = []
    for seed in order[: min(n, 30)]:
        clique = [int(seed)]
        cand = a[seed].copy()
        while cand.any():
            idxs = np.nonzero(cand)[0]
            sub_deg = a[np.ix_(idxs, idxs)].sum(1)
            v = int(idxs[np.argmax(sub_deg)])
            clique.append(v)
            cand &= a[v]  # removes v itself (the diagonal is False)
        if len(clique) > len(best):
            best = clique
    return np.asarray(sorted(best), np.int64)


def pcm_filter(edge_T: FourDof, pose_i: FourDof, pose_j: FourDof,
               valid: np.ndarray, min_edges: int = 20,
               sigma_t: float = 0.1, sigma_yaw: float = 0.05,
               gamma: float = 5.0, chain: tuple | None = None) -> np.ndarray:
    """Full PCM pass for one client pair: consistency matrix (device) + max
    clique (host). Returns the (E,) bool mask of surviving edges. Below
    `min_edges` valid edges every valid edge passes (`pcm_graph.cpp:71`)."""
    valid = np.asarray(valid, bool)
    if valid.sum() < min_edges:
        return valid
    dev = edge_T.yaw.device
    adj = pairwise_consistency(edge_T, pose_i, pose_j,
                               torch.from_numpy(valid).to(dev),
                               sigma_t, sigma_yaw, gamma, chain).cpu().numpy()
    clique = max_clique(adj)
    out = np.zeros_like(valid)
    out[clique] = True
    return out & valid

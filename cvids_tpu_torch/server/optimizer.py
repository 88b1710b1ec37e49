"""4-DoF (yaw + translation) pose-graph optimizer, matrix-free Gauss-Newton
(port of ``cvids_tpu/server/optimizer.py``).

Per-keyframe yaw (angle-wrapped) + translation blocks, pitch/roll frozen from
VIO. Residuals and hand-coded edge Jacobians are evaluated for all edges at
once (gathers over node tensors), H·v products are two batched edge sweeps
plus a segment sum (`torch.segment_reduce` over the edges sorted once a
solve by node: each node's edges are added in edge order on the card as on
the CPU, so a solve's bits do not depend on the order of atomic adds, as
they would with `index_add_`), and the linear solve is Jacobi-preconditioned
conjugate gradients inside an LM loop. Everything stays on the nodes'
device: no value is read back to the host and none is copied from it, so
an LM iteration can be captured. `optimize_pose_graph_graphed` replays that
capture, one CUDA graph per tier shape and `cg_iters`: the counterpart of
the reference's `lax.scan` body with its CG `fori_loop` under `jax.jit`
(`cvids_tpu/server/optimizer.py:228,241`), which the server pads to
power-of-two tiers so that it is captured O(log n) times.

Cost semantics mirror `FourDOFError` / `FourDOFWeightError`
(`server_pose_graph.h:313-401`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..geometry import wrap_angle, ypr_to_r

__all__ = ["PoseGraphNodes", "PoseGraphEdges", "optimize_pose_graph",
           "optimize_pose_graph_graphed", "edge_residuals", "make_sequential_edges"]


class PoseGraphNodes(NamedTuple):
    yaw: torch.Tensor      # (N,) radians
    pr: torch.Tensor       # (N, 2) frozen (pitch, roll) radians
    t: torch.Tensor        # (N, 3)
    valid: torch.Tensor    # (N,) bool
    fixed: torch.Tensor    # (N,) bool — gauge: first client's first KF


class PoseGraphEdges(NamedTuple):
    """Relative 4-DoF constraints i -> j (t_ij in frame i, yaw_ij)."""

    i: torch.Tensor          # (E,) int64
    j: torch.Tensor          # (E,) int64
    t_ij: torch.Tensor       # (E, 3)
    yaw_ij: torch.Tensor     # (E,)
    t_weight: torch.Tensor   # (E,)
    yaw_weight: torch.Tensor  # (E,)
    valid: torch.Tensor      # (E,) bool
    huber: torch.Tensor      # (E,) huber delta (inf => quadratic)


def _rot_i(yaw, pr):
    return ypr_to_r(torch.stack([yaw, pr[..., 0], pr[..., 1]], dim=-1))


def _drot_dyaw(yaw, pr):
    """d R(yaw,p,r) / d yaw = dRz/dyaw Ry Rx."""
    eps_rot = ypr_to_r(torch.stack([torch.zeros_like(yaw), pr[..., 0], pr[..., 1]],
                                   dim=-1))
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(yaw)
    drz = torch.stack([-s, -c, z, c, -s, z, z, z, z], dim=-1).reshape(yaw.shape + (3, 3))
    return drz @ eps_rot


class _Segments(NamedTuple):
    """Edges grouped by node: `perm` sorts them by node (stably, so in edge
    order within a node) and node v's run is perm[offsets[v]:offsets[v + 1]]."""
    perm: torch.Tensor       # (E,) int64
    offsets: torch.Tensor    # (N + 1,) int64


def _segments(idx: torch.Tensor, n: int) -> _Segments:
    """The grouping of edges by `idx` (values in [0, n)), on the device
    with no read-back."""
    key, perm = torch.sort(idx, stable=True)
    return _Segments(perm, torch.searchsorted(
        key, torch.arange(n + 1, dtype=key.dtype, device=key.device)))


def _seg_sum(vals: torch.Tensor, seg: _Segments) -> torch.Tensor:
    """Per node, the sum of its edges' `vals` rows in edge order (the bits
    of `index_add_` on the CPU; 0 for a node without edges)."""
    return torch.segment_reduce(vals[seg.perm], "sum", offsets=seg.offsets, axis=0,
                                unsafe=True)


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return _seg_sum(vals, _segments(idx, n))


def _weighted_residuals(nodes: PoseGraphNodes, edges: PoseGraphEdges):
    """(unhubered weighted residuals (E, 4), edge ok (E,))."""
    yaw_i = nodes.yaw[edges.i]
    r_i = _rot_i(yaw_i, nodes.pr[edges.i])
    rt = torch.einsum("eij,ei->ej", r_i, nodes.t[edges.j] - nodes.t[edges.i]) - edges.t_ij
    ry = wrap_angle(nodes.yaw[edges.j] - yaw_i - edges.yaw_ij)
    r = torch.cat([rt * edges.t_weight[:, None],
                   (ry * edges.yaw_weight)[:, None]], dim=-1)
    ok = edges.valid & nodes.valid[edges.i] & nodes.valid[edges.j]
    return r, ok


def _huber_weight(rn: torch.Tensor, huber: torch.Tensor) -> torch.Tensor:
    """Branch-free Huber sqrt-weight."""
    return torch.where(rn > huber, torch.sqrt(huber / torch.clamp(rn, min=1e-12)),
                       torch.ones_like(rn))


def edge_residuals(nodes: PoseGraphNodes, edges: PoseGraphEdges) -> torch.Tensor:
    """(E, 4) whitened residuals [t(3), yaw] with Huber scaling."""
    r, ok = _weighted_residuals(nodes, edges)
    rn = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    w = _huber_weight(rn, edges.huber[:, None])
    return torch.where(ok[:, None], r * w, torch.zeros((), device=r.device))


def _edge_jacobians(nodes: PoseGraphNodes, edges: PoseGraphEdges):
    """Analytic Jacobians of the unweighted, un-Hubered residual:
    (jt_ti (E,3,3), jt_tj, jt_yi (E,3)); the yaw rows are constant (-1 on
    yaw_i, +1 on yaw_j). Weights, Huber and validity are row scales."""
    yaw_i = nodes.yaw[edges.i]
    pr_i = nodes.pr[edges.i]
    r_i = _rot_i(yaw_i, pr_i)
    dr = _drot_dyaw(yaw_i, pr_i)
    dt = nodes.t[edges.j] - nodes.t[edges.i]
    jt_tj = torch.transpose(r_i, -1, -2)          # d rt / d t_j = R_i^T
    jt_ti = -jt_tj
    jt_yi = torch.einsum("eji,ej->ei", dr, dt)     # (dR/dyaw)^T dt
    return jt_ti, jt_tj, jt_yi


def _row_scales(nodes: PoseGraphNodes, edges: PoseGraphEdges):
    """Per-edge IRLS row scales (E,) for the t-rows and the yaw-row,
    including validity, weights and frozen-Huber scaling."""
    rw, ok = _weighted_residuals(nodes, edges)
    hw = _huber_weight(torch.linalg.vector_norm(rw, dim=-1), edges.huber)
    zero = torch.zeros((), device=rw.device)
    scale_t = torch.where(ok, edges.t_weight * hw, zero)
    scale_y = torch.where(ok, edges.yaw_weight * hw, zero)
    return scale_t, scale_y


def _jvp(nodes, edges, jt_ti, jt_tj, jt_yi, scale_t, scale_y, dyaw, dt):
    """J @ [dyaw, dt] -> (E, 4) residual-space vector."""
    d_yi = dyaw[edges.i]
    d_yj = dyaw[edges.j]
    rt = (torch.einsum("eij,ej->ei", jt_ti, dt[edges.i])
          + torch.einsum("eij,ej->ei", jt_tj, dt[edges.j])
          + jt_yi * d_yi[:, None]) * scale_t[:, None]
    ry = (d_yj - d_yi) * scale_y
    return torch.cat([rt, ry[:, None]], dim=-1)


def _vjp(jt_ti, jt_tj, jt_yi, scale_t, scale_y, r, seg_i, seg_j):
    """J^T @ r -> (dyaw (N,), dt (N, 3)) via segment sums over the edges'
    i and j ends (each end's translation and yaw rows summed in one pass)."""
    rt = r[:, :3] * scale_t[:, None]
    ry = r[:, 3] * scale_y
    gt_i = torch.einsum("eji,ej->ei", jt_ti, rt)
    gt_j = torch.einsum("eji,ej->ei", jt_tj, rt)
    gy_i = torch.einsum("ei,ei->e", jt_yi, rt) - ry
    at_i = _seg_sum(torch.cat([gt_i, gy_i[:, None]], 1), seg_i)
    at_j = _seg_sum(torch.cat([gt_j, ry[:, None]], 1), seg_j)
    return at_i[:, 3] + at_j[:, 3], at_i[:, :3] + at_j[:, :3]


def optimize_pose_graph(nodes: PoseGraphNodes, edges: PoseGraphEdges,
                        lm_iters: int = 12, cg_iters: int = 50,
                        init_lambda: float = 1e-4,
                        reduce: Callable[[torch.Tensor], torch.Tensor] | None = None
                        ) -> PoseGraphNodes:
    """LM with Jacobi-preconditioned CG on the 4-DoF graph.

    Fixed/invalid nodes get unit diagonal and zero updates. A step is kept
    only if it lowers the cost; lambda shrinks by 0.33 on success and grows
    by 4 otherwise (the accept test is a tensor select, not a host branch).

    `reduce`, when given, sums a tensor in place across the ranks that each
    hold a block of `edges` (`parallel.shard_posegraph_solve`); every
    segment sum and cost goes through it, packed into
    1 + lm_iters * (cg_iters + 2) calls: the first cost, then per LM
    iteration the gradient with the Jacobi diagonal (one (N, 8) buffer), one
    (N, 4) buffer a CG step (the two segment sums of `_vjp`) and the trial
    cost. None: this process holds every edge.
    """
    return _lm_loop(_lm_step, nodes, edges, lm_iters, cg_iters, init_lambda, reduce)


def _lm_loop(step, nodes, edges, lm_iters, cg_iters, init_lambda=1e-4, reduce=None):
    """The solve: `_solve_start` eagerly, then `step` (`_lm_step`, or a CUDA
    graph of it) `lm_iters` times."""
    seg_i, seg_j, lam, cost = _solve_start(nodes, edges, init_lambda, reduce)
    nd = nodes
    for _ in range(lm_iters):
        nd, lam, cost = step(nd, lam, cost, edges, seg_i, seg_j, cg_iters, reduce)
    return nd


def _total_cost(nd: PoseGraphNodes, edges: PoseGraphEdges, reduce=None) -> torch.Tensor:
    cost = 0.5 * torch.sum(edge_residuals(nd, edges) ** 2)
    return cost if reduce is None else reduce(cost.reshape(1))[0]


def _solve_start(nodes, edges, init_lambda, reduce=None):
    """(segments of the i and j ends, the first lambda, the first cost)."""
    n = nodes.yaw.shape[0]
    lam = torch.full((), init_lambda, dtype=nodes.t.dtype, device=nodes.t.device)
    return (_segments(edges.i, n), _segments(edges.j, n), lam,
            _total_cost(nodes, edges, reduce))


def _lm_step(nd: PoseGraphNodes, lam: torch.Tensor, cost: torch.Tensor,
             edges: PoseGraphEdges, seg_i: _Segments, seg_j: _Segments, cg_iters: int,
             reduce=None) -> tuple[PoseGraphNodes, torch.Tensor, torch.Tensor]:
    """One LM iteration (`cg_iters` PCG steps, the accept test, the lambda
    update): (nodes, lambda, cost) -> the next three, with no read-back."""
    free = nd.valid & ~nd.fixed
    zero = torch.zeros((), dtype=nd.t.dtype, device=nd.t.device)

    def dot(a, b):
        return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

    jt_ti, jt_tj, jt_yi = _edge_jacobians(nd, edges)
    scale_t, scale_y = _row_scales(nd, edges)
    r = edge_residuals(nd, edges)

    g_yaw, g_t = _vjp(jt_ti, jt_tj, jt_yi, scale_t, scale_y, r, seg_i, seg_j)

    # Jacobi preconditioner: diag(J^T J) per node from edge blocks
    st2 = scale_t ** 2
    sy2 = scale_y ** 2
    d_t = (_seg_sum(torch.einsum("eij,eij->ej", jt_ti, jt_ti) * st2[:, None], seg_i)
           + _seg_sum(torch.einsum("eij,eij->ej", jt_tj, jt_tj) * st2[:, None], seg_j))
    d_yaw = (_seg_sum(torch.sum(jt_yi ** 2, -1) * st2 + sy2, seg_i)
             + _seg_sum(sy2, seg_j))
    if reduce is not None:
        packed = reduce(torch.cat([g_yaw[:, None], g_t, d_yaw[:, None], d_t], 1))
        g_yaw, g_t, d_yaw, d_t = packed[:, 0], packed[:, 1:4], packed[:, 4], packed[:, 5:]
    g_yaw = torch.where(free, g_yaw, zero)
    g_t = torch.where(free[:, None], g_t, zero)
    d_t = torch.where(free[:, None], d_t, torch.ones((), device=d_t.device)) + 1e-8
    d_yaw = torch.where(free, d_yaw, torch.ones((), device=d_yaw.device)) + 1e-8
    lam_d_t = d_t * (1.0 + lam)
    lam_d_yaw = d_yaw * (1.0 + lam)

    def hvp(dyaw, dt):
        dyaw = torch.where(free, dyaw, zero)
        dt = torch.where(free[:, None], dt, zero)
        jv = _jvp(nd, edges, jt_ti, jt_tj, jt_yi, scale_t, scale_y, dyaw, dt)
        hy, ht = _vjp(jt_ti, jt_tj, jt_yi, scale_t, scale_y, jv, seg_i, seg_j)
        if reduce is not None:
            packed = reduce(torch.cat([hy[:, None], ht], 1))
            hy, ht = packed[:, 0], packed[:, 1:]
        hy = torch.where(free, hy + lam * d_yaw * dyaw, zero)
        ht = torch.where(free[:, None], ht + lam * d_t * dt, zero)
        return hy, ht

    # PCG solve H dx = -g
    rr = (-g_yaw, -g_t)
    x = (torch.zeros_like(g_yaw), torch.zeros_like(g_t))
    z = (rr[0] / lam_d_yaw, rr[1] / lam_d_t)
    p = z
    rz = dot(rr, z)
    for _ in range(cg_iters):
        hp = hvp(*p)
        alpha = rz / torch.clamp(dot(p, hp), min=1e-20)
        x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        rr = (rr[0] - alpha * hp[0], rr[1] - alpha * hp[1])
        z = (rr[0] / lam_d_yaw, rr[1] / lam_d_t)
        rz_new = dot(rr, z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p = (z[0] + beta * p[0], z[1] + beta * p[1])
        rz = rz_new
    dyaw, dt = x
    nd_new = nd._replace(yaw=wrap_angle(nd.yaw + torch.where(free, dyaw, zero)),
                         t=nd.t + torch.where(free[:, None], dt, zero))
    cost_new = _total_cost(nd_new, edges, reduce)
    accept = cost_new < cost
    nd = PoseGraphNodes(*(torch.where(accept, a, b) for a, b in zip(nd_new, nd)))
    lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-9),
                      torch.clamp(lam * 4.0, max=1e6))
    cost = torch.where(accept, cost_new, cost)
    return nd, lam, cost


_GRAPHED = None


def optimize_pose_graph_graphed(nodes: PoseGraphNodes, edges: PoseGraphEdges,
                                lm_iters: int = 12, cg_iters: int = 50,
                                init_lambda: float = 1e-4) -> PoseGraphNodes:
    """`optimize_pose_graph` on one process's edges (`reduce` None) with its
    LM iteration (`cg_iters` PCG steps and the accept test, ~4,400 kernels
    at 60 CG steps) replayed as a CUDA graph `lm_iters` times: the
    reference's `lax.scan` body compiled once. One graph per node and edge
    shape and `cg_iters`, shared by every caller in the process
    (`utils.cuda_graph.GraphedCall`: thread-local captures, calls
    serialized), so a new tier costs the capture of one iteration, not of
    the whole loop. The same kernels in the same order as the eager solve,
    so its bits. On the CPU, and inside `disable_graphs()`, the eager
    solve."""
    global _GRAPHED
    if _GRAPHED is None:
        from ..utils.cuda_graph import GraphedCall
        _GRAPHED = GraphedCall(_lm_step)
    return _lm_loop(_GRAPHED, nodes, edges, lm_iters, cg_iters, init_lambda)


def make_sequential_edges(yaw, pr, t, client_id, valid, max_back: int = 6,
                          t_weight: float = 1.0, yaw_weight: float = 1.0):
    """Sequential odometry edges: each node connects to up to `max_back`
    same-client predecessors (`server_pose_graph.cpp:1527-1581`), with
    measurements taken from the current (VIO/world) poses.

    Returns a PoseGraphEdges of shape (N * max_back,).
    """
    n = yaw.shape[0]
    dev = yaw.device
    idx = torch.arange(n, device=dev)
    js = torch.repeat_interleave(idx, max_back)
    backs = torch.arange(1, max_back + 1, device=dev).repeat(n)
    is_ = js - backs
    is_c = is_.clamp(0, n - 1)
    ok = (is_ >= 0) & valid[js] & valid[is_c]
    ok = ok & (client_id[js] == client_id[is_c])
    r_i = _rot_i(yaw[is_c], pr[is_c])
    t_ij = torch.einsum("eij,ei->ej", r_i, t[js] - t[is_c])
    yaw_ij = wrap_angle(yaw[js] - yaw[is_c])
    e = n * max_back
    return PoseGraphEdges(
        i=is_c, j=js, t_ij=t_ij, yaw_ij=yaw_ij,
        t_weight=torch.full((e,), t_weight, dtype=yaw.dtype, device=dev),
        yaw_weight=torch.full((e,), yaw_weight, dtype=yaw.dtype, device=dev),
        valid=ok, huber=torch.full((e,), float("inf"), dtype=yaw.dtype, device=dev))

"""Relaxation-based 4-DoF smoother — the reference's alternative optimizer
(port of ``cvids_tpu/server/smooth_optimizer.py``).

Parity component for `SmoothEulerOptimizer` (`smooth_euler_optimizer.h:
59-153`): instead of a Gauss-Newton solve, each sweep re-estimates every
node as the average of its neighbours' predictions through the connecting
edges. The reference sweeps back to front (Gauss-Seidel); here the sweep is
Jacobi-style — all nodes update at once from neighbour predictions summed
per node with `index_add_` — the parallel form of the same fixed-point
iteration.
"""

from __future__ import annotations

import torch

from ..geometry import wrap_angle
from .optimizer import PoseGraphEdges, PoseGraphNodes, _rot_i, _segment_sum

__all__ = ["smooth_euler_relax"]


def smooth_euler_relax(nodes: PoseGraphNodes, edges: PoseGraphEdges,
                       sweeps: int = 5, mix: float = 0.8) -> PoseGraphNodes:
    """Run `sweeps` relaxation passes (reference default: 5).

    mix blends the averaged neighbour prediction with the current estimate
    (1.0 = pure replacement, as the reference's in-place overwrite).
    """
    n = nodes.yaw.shape[0]
    ok = edges.valid & nodes.valid[edges.i] & nodes.valid[edges.j]
    w_edge = torch.where(ok, edges.t_weight, torch.zeros_like(edges.t_weight))
    upd = nodes.valid & ~nodes.fixed
    nd = nodes
    for _ in range(sweeps):
        r_i = _rot_i(nd.yaw[edges.i], nd.pr[edges.i])
        # forward prediction of node j from node i through the edge
        t_j_pred = nd.t[edges.i] + torch.einsum("eij,ej->ei", r_i, edges.t_ij)
        yaw_j_pred = nd.yaw[edges.i] + edges.yaw_ij
        # backward prediction of node i from node j
        r_i_from_j = _rot_i(nd.yaw[edges.j] - edges.yaw_ij, nd.pr[edges.i])
        t_i_pred = nd.t[edges.j] - torch.einsum("eij,ej->ei", r_i_from_j, edges.t_ij)
        yaw_i_pred = nd.yaw[edges.j] - edges.yaw_ij

        wsum = _segment_sum(w_edge, edges.j, n) + _segment_sum(w_edge, edges.i, n)
        t_acc = (_segment_sum(t_j_pred * w_edge[:, None], edges.j, n)
                 + _segment_sum(t_i_pred * w_edge[:, None], edges.i, n))
        # average yaw via unit-vector embedding (safe around ±pi)
        cy_acc = (_segment_sum(torch.cos(yaw_j_pred) * w_edge, edges.j, n)
                  + _segment_sum(torch.cos(yaw_i_pred) * w_edge, edges.i, n))
        sy_acc = (_segment_sum(torch.sin(yaw_j_pred) * w_edge, edges.j, n)
                  + _segment_sum(torch.sin(yaw_i_pred) * w_edge, edges.i, n))
        has = wsum > 1e-9
        t_new = torch.where(has[:, None], t_acc / torch.clamp(wsum, min=1e-9)[:, None], nd.t)
        yaw_new = torch.where(has, torch.atan2(sy_acc, cy_acc), nd.yaw)
        t_out = torch.where(upd[:, None], (1 - mix) * nd.t + mix * t_new, nd.t)
        yaw_out = torch.where(upd, wrap_angle(nd.yaw + mix * wrap_angle(yaw_new - nd.yaw)),
                              nd.yaw)
        nd = nd._replace(t=t_out, yaw=yaw_out)
    return nd

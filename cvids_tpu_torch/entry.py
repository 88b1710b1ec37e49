"""The port's counterpart of ``__graft_entry__.entry()``: one collaborative
server compute step on the card, with example inputs.

`dryrun_multichip`, the multi-device dry run beside it in the JAX package,
waits for the port's multi-GPU slice.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["entry"]


def entry(device=None):
    """(step, args): fuse a measurement frame into the dense depth state at
    the reference's full geometry (640x480x128) and run a 4-DoF pose-graph
    pass (2 LM x 10 CG) over a 256-keyframe graph — the two device-side hot
    paths of the server, on `device` (None: the card). The inputs are drawn
    as `__graft_entry__.entry()` draws them. `step(*args)` returns (the
    filter's mean inverse depth, the solved translations); like the port's
    `fuse_measurement` it updates the state's cost volumes in place. The
    measurement's warp is the identity, inside the banded warp's band, so
    the banded warp runs (the server's host gate decides so)."""
    from .dense import estimator
    from .ops.costvolume import warp_shift_bounds_np
    from .server import optimizer as opt

    dev = resolve_device(device)
    cfg = estimator.DenseConfig()  # 480 x 640 x 128
    rng = np.random.default_rng(0)
    ref = torch.as_tensor(rng.uniform(0, 255, (cfg.height, cfg.width)), dtype=torch.float32,
                          device=dev)
    meas = torch.as_tensor(rng.uniform(0, 255, (cfg.height, cfg.width)), dtype=torch.float32,
                           device=dev)
    k = np.array([[461.0, 0, 320], [0, 461.0, 240], [0, 0, 1]], np.float32)
    a_np = k @ np.linalg.inv(k)
    a_mat = torch.as_tensor(a_np, device=dev)
    b_vec = torch.as_tensor(k @ np.array([-0.11, 0, 0], np.float32), device=dev)
    # the server's gate (`server/pipeline.py`): 96/48 px bands, 8 px margin
    dx, dy = warp_shift_bounds_np(a_np, cfg.height, cfg.width, step=4)
    banded = bool(dx < 88.0 and dy < 40.0)
    state = estimator.init_reference(cfg, ref)

    n = 256
    nodes = opt.PoseGraphNodes(
        yaw=torch.as_tensor(rng.uniform(-3, 3, n), dtype=torch.float32, device=dev),
        pr=torch.zeros((n, 2), device=dev),
        t=torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=dev),
        valid=torch.ones(n, dtype=torch.bool, device=dev),
        fixed=torch.arange(n, device=dev) == 0)
    edges = opt.make_sequential_edges(nodes.yaw, nodes.pr, nodes.t,
                                      torch.zeros(n, dtype=torch.int64, device=dev), nodes.valid)

    def step(state, meas, a_mat, b_vec, nodes, edges):
        new_state = estimator.fuse_measurement(cfg, state, meas, a_mat, b_vec,
                                               banded_warp=banded)
        new_nodes = opt.optimize_pose_graph(nodes, edges, lm_iters=2, cg_iters=10)
        return new_state.filt.mu, new_nodes.t

    return step, (state, meas, a_mat, b_vec, nodes, edges)

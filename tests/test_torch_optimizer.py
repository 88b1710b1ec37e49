"""Port parity for the 4-DoF pose-graph optimizer: `make_sequential_edges`,
`edge_residuals` and `optimize_pose_graph` against `cvids_tpu` on a ~32-node
drifting loop with loop-closure edges (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.server import optimizer as jopt
from cvids_tpu_torch import interop
from cvids_tpu_torch.server import optimizer as topt

N = 32


def _graph(rng, huber):
    """A circle with drifting odometry (sequential edges from the noisy
    estimate) plus three exact loop edges; optional Huber on the loops."""
    ang = np.linspace(0, 2 * np.pi, N)
    t_gt = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0.2 * np.sin(2 * ang)], -1)
    yaw_gt = ang + np.pi / 2
    yaw = (yaw_gt + np.cumsum(rng.normal(0, 0.01, N))).astype(np.float32)
    t = (t_gt + np.cumsum(rng.normal(0, 0.05, (N, 3)), 0)).astype(np.float32)
    pr = rng.normal(0, 0.02, (N, 2)).astype(np.float32)
    nodes = jopt.PoseGraphNodes(yaw=jnp.asarray(yaw), pr=jnp.asarray(pr),
                                t=jnp.asarray(t), valid=jnp.ones(N, bool),
                                fixed=jnp.arange(N) == 0)
    client = jnp.asarray((np.arange(N) >= N // 2).astype(np.int32))
    seq = jopt.make_sequential_edges(nodes.yaw, nodes.pr, nodes.t, client,
                                     nodes.valid)
    li = np.array([0, 3, 6], np.int32)
    lj = np.array([N - 1, N - 4, N - 7], np.int32)
    t_ij = np.stack([np.array([[np.cos(yaw_gt[a]), np.sin(yaw_gt[a]), 0],
                               [-np.sin(yaw_gt[a]), np.cos(yaw_gt[a]), 0],
                               [0, 0, 1]]) @ (t_gt[b] - t_gt[a])
                     for a, b in zip(li, lj)]).astype(np.float32)
    loops = jopt.PoseGraphEdges(
        i=jnp.asarray(li), j=jnp.asarray(lj), t_ij=jnp.asarray(t_ij),
        yaw_ij=jnp.asarray((yaw_gt[lj] - yaw_gt[li]).astype(np.float32)),
        t_weight=jnp.ones(3), yaw_weight=jnp.full(3, 0.1),
        valid=jnp.asarray([True, True, False]),
        huber=jnp.full(3, 0.1 if huber else jnp.inf))
    edges = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]), seq, loops)
    return nodes, edges, client


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def test_make_sequential_edges(rng):
    nodes, _, client = _graph(rng, False)
    ref = jopt.make_sequential_edges(nodes.yaw, nodes.pr, nodes.t, client, nodes.valid)
    tn = interop.nodes_to_torch(_np_tree(nodes), "cpu")
    out = interop.edges_to_numpy(topt.make_sequential_edges(
        tn.yaw, tn.pr, tn.t, interop.array_to_torch(client, "cpu"), tn.valid))
    for name, r, o in zip(topt.PoseGraphEdges._fields, ref, out):
        r = np.asarray(r)
        assert o.dtype == r.dtype, name
        # rotations and differences of the same fp32 values
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("huber", [False, True])
def test_optimize_pose_graph(rng, huber):
    nodes, edges, _ = _graph(rng, huber)
    tn = interop.nodes_to_torch(_np_tree(nodes), "cpu")
    te = interop.edges_to_torch(_np_tree(edges), "cpu")
    # residuals: the same fp32 expressions
    np.testing.assert_allclose(topt.edge_residuals(tn, te).numpy(),
                               np.asarray(jopt.edge_residuals(nodes, edges)),
                               rtol=1e-5, atol=1e-5)
    ref = jopt.optimize_pose_graph(nodes, edges, lm_iters=4, cg_iters=20)
    out = interop.nodes_to_numpy(topt.optimize_pose_graph(tn, te, lm_iters=4,
                                                          cg_iters=20))
    # 4 LM x 20 CG steps: segment sums and dot products add in a different
    # order than XLA's, and CG amplifies rounding a little; 1e-3 rad / 1e-3 m
    # is far below the loop's correction (~0.1 m)
    np.testing.assert_allclose(out.yaw, np.asarray(ref.yaw), atol=1e-3)
    np.testing.assert_allclose(out.t, np.asarray(ref.t), atol=1e-3)
    np.testing.assert_array_equal(out.valid, np.asarray(ref.valid))
    # the solve moved the graph and lowered the cost
    assert np.abs(out.t - np.asarray(nodes.t)).max() > 0.05
    cost = lambda nd, ed: float(torch.sum(topt.edge_residuals(nd, ed) ** 2))
    assert cost(interop.nodes_to_torch(out, "cpu"), te) < cost(tn, te)
    # the gauge node is fixed
    np.testing.assert_array_equal(out.t[0], np.asarray(nodes.t)[0])

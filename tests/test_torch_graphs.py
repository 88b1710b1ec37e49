"""The port's compiled programs on the CPU: `estimator.DenseStep`'s buffers
reused across references against fresh allocations and the JAX package's
`fuse_measurement`, the graphed 4-DoF solve's eager path against the JAX
solve at a 64-node tier, `disable_graphs()`, the launch counts of a capture,
and `utils.tracing`'s process-wide tracer against the JAX package's.

On the CPU a `GraphedCall` is its function; the replays themselves are held
to the eager calls on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`). Sizes are small: 24x32x32 volumes, a 64-node graph.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.dense import estimator as je
from cvids_tpu.server import optimizer as jopt
from cvids_tpu.utils import tracing as jtracing
from cvids_tpu_torch import interop
from cvids_tpu_torch.dense import estimator as te
from cvids_tpu_torch.ops import cuda_kernels as ck
from cvids_tpu_torch.server import optimizer as topt
from cvids_tpu_torch.utils import cuda_graph
from cvids_tpu_torch.utils import tracing as ttracing

H, W, D = 24, 32, 32


def _cfg_kw():
    # fp32 volumes: in bf16 the JAX package's CPU path carries the SGM
    # recurrence in bf16 and the port in fp32 (see test_torch_dense.py)
    inv = np.linspace(1.0 / 8.0, 1.0 / 0.8, D).astype(np.float32)
    return dict(height=H, width=W, num_depths=D, dep_sample=float(inv[1] - inv[0]),
                tau2_scale=0.5, pi1=2.0, pi2=8.0, dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _scene(rng, n_refs=3, frames=2, depth=2.0):
    """References and measurement frames of a textured fronto-parallel
    plane: reference r sits at x = 0.1 r, its frames further along x."""
    k = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
    pad = 24
    tex = rng.uniform(0, 255, (H, W + 2 * pad)).astype(np.float32)
    tex = 0.5 * (tex + np.roll(tex, 1, 1))

    def view(x):
        s = int(round(k[0, 0] * x / depth))
        return tex[:, pad + s:pad + s + W]

    refs = []
    for r in range(n_refs):
        x0 = 0.1 * r
        meas = [(view(x0 + b), (k @ np.linalg.inv(k)).astype(np.float32),
                 (k @ np.array([-b, 0.0, 0.0], np.float32)).astype(np.float32))
                for b in (0.1 * (i + 1) for i in range(frames))]
        refs.append((view(x0), meas))
    return refs, k


def _to_jax(st: te.DenseState):
    """A port `DenseState` as the JAX package's, through numpy."""
    from cvids_tpu.ops import depth_filter as jdf
    n = interop.dense_state_to_numpy(st)
    f = jnp.asarray
    return je.DenseState(
        ref_img=f(n.ref_img), grad=f(n.grad), mean_cost=f(n.mean_cost), count=f(n.count),
        sparse_bias=None if n.sparse_bias is None else f(n.sparse_bias),
        penalty=f(n.penalty), filt=jdf.FilterState(*(f(x) for x in n.filt)),
        num_frames=f(n.num_frames))


def _states_equal(a: te.DenseState, b: te.DenseState) -> None:
    for name, x, y in zip(te.DenseState._fields, a, b):
        if name == "filt":
            for fx, fy in zip(x, y):
                assert torch.equal(fx, fy), name
        elif x is None or y is None:
            assert x is None and y is None, name
        else:
            assert torch.equal(x, y), name


def _agrees_with_jax(out: te.DenseState, js) -> None:
    """The tolerances of test_torch_dense.py's chain."""
    n = interop.dense_state_to_numpy(out)
    np.testing.assert_array_equal(n.count, np.asarray(js.count))
    np.testing.assert_allclose(n.mean_cost, np.asarray(js.mean_cost), atol=1e-3)
    for name in ("mu", "sigma2", "a", "b"):
        np.testing.assert_allclose(getattr(n.filt, name), np.asarray(getattr(js.filt, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert int(n.num_frames) == int(js.num_frames)


def test_dense_step_buffers_over_three_references(rng):
    """One client's buffers reused over `init`, `propagate` with a sparse
    bias and `propagate` without one give, frame for frame, the states of
    fresh allocations, and each frame is the JAX package's
    `fuse_measurement` of the same state."""
    cfg, jc = te.DenseConfig(**_cfg_kw()), je.DenseConfig(**_cfg_kw())
    refs, k = _scene(rng)
    gy, gx = np.mgrid[3:H - 3:6, 3:W - 3:6]
    uv = _t(np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32))
    bias = te.splat_sparse(cfg, uv, torch.full((len(uv),), 0.5),
                           torch.ones(len(uv), dtype=torch.bool))
    r_no, t_no = torch.eye(3), torch.tensor([-0.1, 0.0, 0.0])

    step = te.DenseStep(cfg)
    buffers = None
    fresh = None
    for r, (ref, frames) in enumerate(refs):
        if r == 0:
            st = step.init_reference(_t(ref))
            fresh = te.init_reference(cfg, _t(ref))
        else:
            b = bias if r == 1 else None
            st = step.propagate_reference(_t(ref), r_no, t_no, _t(k), sparse_bias=b)
            fresh = te.propagate_reference(cfg, fresh, _t(ref), r_no, t_no, _t(k),
                                           sparse_bias=b)
        assert (st.sparse_bias is None) == (r != 1)
        ptrs = [x.data_ptr() for x in (st.mean_cost, st.count, *st.filt, st.num_frames)]
        assert buffers is None or ptrs == buffers       # the same buffers throughout
        buffers = ptrs
        _states_equal(st, fresh)
        for meas, a, b_vec in frames:
            js = je.fuse_measurement(jc, _to_jax(fresh), jnp.asarray(meas), jnp.asarray(a),
                                     jnp.asarray(b_vec))
            st = step.fuse(_t(meas), _t(a), _t(b_vec), banded_warp=False)
            fresh = te.fuse_measurement(cfg, fresh, _t(meas), _t(a), _t(b_vec),
                                        banded_warp=False)
            _states_equal(st, fresh)
            _agrees_with_jax(st, js)
    assert int(st.num_frames) == len(refs[-1][1])
    assert float(st.filt.a.max()) > 15.0      # the frames were fused


def _graph64(rng):
    """A 64-node tier: 60 keyframes on a drifting circle, 4 padding nodes,
    sequential edges and two loop edges (one Hubered) padded to 64."""
    n, m = 64, 60
    ang = np.linspace(0, 2 * np.pi, m)
    yaw = np.zeros(n, np.float32)
    t = np.zeros((n, 3), np.float32)
    yaw[:m] = ang + np.pi / 2 + np.cumsum(rng.normal(0, 0.01, m))
    t[:m] = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0 * ang], -1) \
        + np.cumsum(rng.normal(0, 0.05, (m, 3)), 0)
    valid = np.arange(n) < m
    nodes = jopt.PoseGraphNodes(yaw=jnp.asarray(yaw), pr=jnp.zeros((n, 2)), t=jnp.asarray(t),
                                valid=jnp.asarray(valid), fixed=jnp.arange(n) == 0)
    seq = jopt.make_sequential_edges(nodes.yaw, nodes.pr, nodes.t,
                                     jnp.zeros(n, jnp.int32), nodes.valid)
    lt = 64
    li, lj = np.zeros(lt, np.int32), np.zeros(lt, np.int32)
    li[:2], lj[:2] = [0, 5], [m - 1, m - 6]
    lyaw = np.zeros(lt, np.float32)
    lyaw[:2] = ang[lj[:2]] - ang[li[:2]]
    lt_ij = np.zeros((lt, 3), np.float32)
    for e in range(2):
        c, s = np.cos(ang[li[e]] + np.pi / 2), np.sin(ang[li[e]] + np.pi / 2)
        d = 5 * np.array([np.cos(ang[lj[e]]) - np.cos(ang[li[e]]),
                          np.sin(ang[lj[e]]) - np.sin(ang[li[e]]), 0.0])
        lt_ij[e] = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]) @ d
    loops = jopt.PoseGraphEdges(
        i=jnp.asarray(li), j=jnp.asarray(lj), t_ij=jnp.asarray(lt_ij), yaw_ij=jnp.asarray(lyaw),
        t_weight=jnp.ones(lt), yaw_weight=jnp.full(lt, 0.1), valid=jnp.arange(lt) < 2,
        huber=jnp.asarray(np.where(np.arange(lt) == 1, 0.1, np.inf).astype(np.float32)))
    edges = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]), seq, loops)
    return nodes, edges


def test_graphed_solve_on_cpu_is_the_solve(rng):
    """`optimize_pose_graph_graphed` on CPU tensors is `optimize_pose_graph`
    (bit for bit) and agrees with the JAX solve at a 64-node tier within
    test_torch_optimizer.py's 1e-3."""
    nodes, edges = _graph64(rng)
    np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)   # noqa: E731
    tn = interop.nodes_to_torch(np_tree(nodes), "cpu")
    tedges = interop.edges_to_torch(np_tree(edges), "cpu")
    out = topt.optimize_pose_graph_graphed(tn, tedges, lm_iters=4, cg_iters=20)
    eager = topt.optimize_pose_graph(tn, tedges, lm_iters=4, cg_iters=20)
    for name, x, y in zip(topt.PoseGraphNodes._fields, out, eager):
        assert torch.equal(x, y), name
    ref = jopt.optimize_pose_graph(nodes, edges, lm_iters=4, cg_iters=20)
    np.testing.assert_allclose(out.yaw.numpy(), np.asarray(ref.yaw), atol=1e-3)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-3)
    assert np.abs(out.t.numpy() - np.asarray(nodes.t)).max() > 0.05


def test_segment_sum_is_index_add_on_cpu(rng):
    """The accumulating `index_put_` of the solve's segment sums adds in
    `index_add_`'s order on the CPU: the same bits."""
    vals = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, 500))
    want = torch.zeros((40, 3)).index_add_(0, idx, vals)
    assert torch.equal(topt._segment_sum(vals, idx, 40), want)
    assert torch.equal(topt._segment_sum(vals[:, 0], idx, 40), want[:, 0])


def test_disable_graphs_nests_and_restores():
    assert not cuda_graph.graphs_disabled()
    with cuda_graph.disable_graphs():
        assert cuda_graph.graphs_disabled()
        with cuda_graph.disable_graphs():
            assert cuda_graph.graphs_disabled()
        assert cuda_graph.graphs_disabled()
        seen = []
        other = threading.Thread(target=lambda: seen.append(cuda_graph.graphs_disabled()))
        other.start()
        other.join()
        assert seen == [False]          # per thread, as jax.disable_jit
    assert not cuda_graph.graphs_disabled()
    with pytest.raises(RuntimeError), cuda_graph.disable_graphs():
        raise RuntimeError("inside")
    assert not cuda_graph.graphs_disabled()
    # inside it a GraphedCall is its function
    call = cuda_graph.GraphedCall(lambda x: x + 1)
    with cuda_graph.disable_graphs():
        assert torch.equal(call(torch.ones(2)), torch.full((2,), 2.0))
    assert call.graphs == {} and call.replays == 0


def test_capture_launches_are_added_once_per_replay():
    """What a capture's wrapper calls count goes to its own tally (nothing
    ran) and `add_launches` adds it once per replay; tallies nest per
    thread."""
    saved = dict(ck.launches)
    try:
        ck.reset_launches()
        with ck.counted_apart() as outer:
            ck._count("wta")
            with ck.counted_apart() as inner:
                ck._count("sgm_scan")
                ck._count("sgm_scan")
            ck._count("plane_sweep")
        assert ck.launches == dict.fromkeys(ck.launches, 0)
        assert (outer["wta"], outer["plane_sweep"], outer["sgm_scan"]) == (1, 1, 0)
        assert inner["sgm_scan"] == 2
        for _ in range(3):             # three replays
            ck.add_launches(outer)
        assert ck.launches["wta"] == ck.launches["plane_sweep"] == 3
        ck._count("wta")               # outside a capture: counted at once
        assert ck.launches["wta"] == 4
    finally:
        ck.launches.update(saved)


def test_global_tracer_and_span_match_reference(monkeypatch):
    """`global_tracer()` and `span()` as the JAX package's: one tracer per
    process, and the same totals and counts keys after the same spans."""
    assert ttracing.global_tracer() is ttracing.global_tracer()
    assert {"global_tracer", "span"} <= set(ttracing.__all__)
    for mod in (ttracing, jtracing):
        monkeypatch.setattr(mod, "_GLOBAL", mod.Tracer())
    for mod in (ttracing, jtracing):
        for name in ("ingest", "ingest", "fuse", "optimize"):
            with mod.span(name):
                pass
        mod.global_tracer().count("loop", 3)
    t, j = ttracing.global_tracer(), jtracing.global_tracer()
    assert sorted(t.totals) == sorted(j.totals) == ["fuse", "ingest", "optimize"]
    assert dict(t.counts) == dict(j.counts) == {"ingest": 2, "fuse": 1, "optimize": 1,
                                                "loop": 3}
    assert t.mean_ms("loop") == j.mean_ms("loop") == 0.0
    assert len(t.report().splitlines()) == len(j.report().splitlines()) == 3

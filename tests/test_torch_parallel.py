"""Port parity for the multi-GPU slice: `cvids_tpu_torch.parallel` (mesh,
`launch`, the edge-sharded 4-DoF solve, the agent-sharded dense step, the
landmark-sharded window Schur solve, the collective audit) and the
chunk-sharded TSDF.

The JAX side runs on a mesh of 4 of conftest's 8 virtual CPU devices. The
port runs once for the module on 4 gloo ranks on the CPU (`launch`, one
intra-op thread a rank), every sharded function in one `_ranks` call that
returns numpy; both sides get the same numpy inputs from a seed. The ranks
import this module to find `_ranks`, so JAX and the JAX package are
imported inside the functions that use them, never at the top.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cvids_tpu_torch import interop, parallel
from cvids_tpu_torch.dense import estimator as te
from cvids_tpu_torch.mapping import tsdf
from cvids_tpu_torch.server import optimizer as topt
from cvids_tpu_torch.vio import window_ba as tba

N_RANKS = 4
N_AGENTS = 8            # two a rank
LM_ITERS, CG_ITERS = 8, 40
WINDOW_ITERS = 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree) -> dict:
    """A NamedTuple of arrays as a dict of numpy arrays (picklable without
    the JAX package)."""
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _nodes(d, dev="cpu"):
    return interop.nodes_to_torch(SimpleNamespace(**d), dev)


def _edges(d, dev="cpu"):
    return interop.edges_to_torch(SimpleNamespace(**d), dev)


def _window(state, meas, dev="cpu"):
    st = interop.window_state_to_torch(SimpleNamespace(**state), dev)
    m = dict(meas)
    m["pre"] = interop.preintegrated_to_torch(SimpleNamespace(**m["pre"]), dev)
    for k in ("obs", "vis", "pre_valid", "r_cb", "p_bc", "anchor_p", "anchor_yaw"):
        m[k] = torch.from_numpy(np.array(m[k], copy=True))
    return st, tba.WindowMeasurements(prior=None, **m)


def _gather(mesh, local: torch.Tensor, n: int) -> np.ndarray:
    """The ranks' blocks of an axis of `n`, assembled on every rank."""
    buf = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype)
    buf[mesh.block(n)] = local
    return mesh.all_reduce(buf).numpy()


def _ranks(mesh, inp):
    """Every sharded function of the port on this rank; rank 0's return
    value comes back to the test."""
    out = {"mesh": (mesh.rank, mesh.size, str(mesh.device), mesh.axis)}
    logs = {}

    solved = parallel.shard_posegraph_solve(mesh, LM_ITERS, CG_ITERS)(
        _nodes(inp["nodes"]), _edges(inp["edges_padded"]))
    out["solve"] = {"t": solved.t.numpy(), "yaw": solved.yaw.numpy()}
    logs["solve"] = mesh.take_log()

    d = inp["dense"]
    cfg = te.DenseConfig(**d["cfg"])
    mine = mesh.block(N_AGENTS)
    states = [te.init_reference(cfg, torch.from_numpy(r)) for r in d["refs"][mine]]
    fused = parallel.sharded_dense_fuse(mesh, cfg)(
        states, [torch.from_numpy(m) for m in d["meas"][mine]],
        [torch.from_numpy(d["a"])] * len(states), [torch.from_numpy(d["b"])] * len(states))
    logs["dense"] = mesh.take_log()
    out["dense"] = {
        "num_frames": _gather(mesh, torch.stack([s.num_frames for s in fused]), N_AGENTS),
        "mean_cost": _gather(mesh, torch.stack([s.mean_cost for s in fused]), N_AGENTS),
        **{f: _gather(mesh, torch.stack([getattr(s.filt, f) for s in fused]), N_AGENTS)
           for f in ("mu", "sigma2", "a", "b")}}

    mesh.take_log()      # the gathers above
    st, meas = _window(*inp["window"])
    w_out, w_cost = parallel.solve_window_schur_sharded(mesh, st, meas, iters=WINDOW_ITERS)
    logs["window"] = mesh.take_log()
    out["window"] = {"p": w_out.p.numpy(), "lm": w_out.lm.numpy(), "cost": float(w_cost)}

    t = inp["tsdf"]
    cfg = tsdf.TsdfConfig(**t["cfg"])
    cap = len(t["coords"])
    mine = mesh.block(cap)
    pool = tsdf.shard_pool(tsdf._empty_pool(cap, cfg.chunk_size, torch.device("cpu")), mesh)
    pool = tsdf.sharded_integrate(cfg, pool, torch.from_numpy(t["coords"])[mine],
                                  torch.from_numpy(t["active"])[mine],
                                  *(torch.from_numpy(t[k]) for k in ("depth", "color", "k",
                                                                     "r_cw", "t_cw")), mesh)
    logs["tsdf"] = mesh.take_log()
    out["tsdf"] = {f: _gather(mesh, getattr(pool, f), cap) for f in pool._fields}
    out["logs"] = logs
    return out


def _sum_rank(mesh):
    """test_distributed.py's psum: each rank holds its rows of a (4, 2)
    array, and the all-reduce of their column sums is the whole array's."""
    x = torch.arange(8.0).reshape(4, 2)
    return mesh.all_reduce(x[mesh.block(4)].sum(0))


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("planted failure on rank 1")
    return mesh.all_reduce(torch.ones(1))     # rank 0 waits here for rank 1


def _problems() -> dict:
    """The module's inputs as numpy, built with the JAX package's helpers."""
    import jax.numpy as jnp
    from test_parallel import build_graph
    from test_torch_dense import _cfg_kw, _views
    from test_tsdf import H, K, W, look_at, render_sphere_depth
    from test_vio import _build_problem, make_seq
    from cvids_tpu.parallel import pad_edges_for_sharding

    nodes, edges, _ = build_graph(np.random.default_rng(0))
    rng = np.random.default_rng(1)
    refs, meas = [], []
    for _ in range(N_AGENTS):          # a texture an agent, the first view's warp
        ref, views, _ = _views(rng)
        refs.append(ref)
        meas.append(views[0][0])
    seq = make_seq(duration=5.0, num_landmarks=40, seed=3)
    w_state, w_meas = _build_problem(seq, perturb=0.1, rng=np.random.default_rng(0))
    w_state = w_state._replace(q=w_state.q / jnp.linalg.norm(w_state.q, axis=-1, keepdims=True))
    w_meas_np = {f: getattr(w_meas, f) for f in w_meas._fields if f != "prior"}
    w_meas_np = {k: (_np(v) if k == "pre" else v if isinstance(v, float) else np.asarray(v))
                 for k, v in w_meas_np.items()}
    # the TSDF: frame 0 of test_tsdf.py's sphere, 4 x 4 x 3 chunks of 8
    # voxels of 5 cm around it, every fifth inactive
    center = np.array([0.0, 0.0, 1.0])
    eye = center + 1.8 * np.array([1.0, 0.0, 0.3])
    r_wc = look_at(eye, center)
    gx, gy, gz = np.meshgrid(np.arange(-2, 2), np.arange(-2, 2), np.arange(1, 4), indexing="ij")
    coords = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1).astype(np.int64)
    return {
        "nodes": _np(nodes), "edges": _np(edges),
        "edges_padded": _np(pad_edges_for_sharding(edges, N_RANKS)),
        "dense": {"cfg": _cfg_kw(), "refs": np.stack(refs), "meas": np.stack(meas),
                  "a": views[0][1], "b": views[0][2]},
        "window": (_np(w_state), w_meas_np),
        "tsdf": {"cfg": dict(voxel_size=0.05, chunk_size=8, carving=True), "coords": coords,
                 "active": np.arange(len(coords)) % 5 != 4,
                 "depth": np.nan_to_num(render_sphere_depth(center, 0.4, r_wc, eye),
                                        nan=0.0).astype(np.float32),
                 "color": np.full((H, W, 3), 128.0, np.float32), "k": K,
                 "r_cw": r_wc.T.astype(np.float32),
                 "t_cw": (-r_wc.T @ eye).astype(np.float32)},
    }


def _jax_solve(problems, mesh) -> dict:
    from cvids_tpu.parallel import shard_posegraph_solve
    from cvids_tpu.server import optimizer as jopt

    solved = shard_posegraph_solve(mesh, lm_iters=LM_ITERS, cg_iters=CG_ITERS)(
        jopt.PoseGraphNodes(**problems["nodes"]), jopt.PoseGraphEdges(**problems["edges_padded"]))
    return {"t": np.asarray(solved.t), "yaw": np.asarray(solved.yaw)}


def _jax_dense(problems, mesh) -> dict:
    import jax
    import jax.numpy as jnp
    from cvids_tpu.dense import estimator as je
    from cvids_tpu.parallel import sharded_dense_fuse

    d = problems["dense"]
    cfg = je.DenseConfig(**d["cfg"])
    states = jax.vmap(lambda r: je.init_reference(cfg, r))(jnp.asarray(d["refs"]))
    tile = lambda x: jnp.tile(jnp.asarray(x)[None], (N_AGENTS,) + (1,) * x.ndim)  # noqa: E731
    fused = sharded_dense_fuse(mesh, cfg)(states, jnp.asarray(d["meas"]), tile(d["a"]),
                                          tile(d["b"]))
    return {"num_frames": np.asarray(fused.num_frames), "mean_cost": np.asarray(fused.mean_cost),
            **{f: np.asarray(getattr(fused.filt, f)) for f in ("mu", "sigma2", "a", "b")}}


def _jax_window(problems, mesh) -> dict:
    """On its own mesh axis name, as test_parallel.py's case."""
    from cvids_tpu.parallel import make_mesh, solve_window_schur_sharded
    from cvids_tpu.vio import imu as jimu
    from cvids_tpu.vio import window_ba as jba

    state, meas = problems["window"]
    m = dict(meas, pre=jimu.Preintegrated(**meas["pre"]))
    w_out, w_cost = solve_window_schur_sharded(
        make_mesh(N_RANKS, axis="lms"), jba.WindowState(**state),
        jba.WindowMeasurements(prior=None, **m), iters=WINDOW_ITERS)
    return {"p": np.asarray(w_out.p), "lm": np.asarray(w_out.lm), "cost": float(w_cost)}


def _jax_tsdf(problems, mesh) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from cvids_tpu.mapping import tsdf as jtsdf

    t = problems["tsdf"]
    tcfg = jtsdf.TsdfConfig(capacity=len(t["coords"]), **t["cfg"])
    axis = mesh.axis_names[0]
    shard = NamedSharding(mesh, P(axis))
    fn, args = jtsdf.sharded_integrate(
        tcfg, jtsdf.shard_pool(jtsdf._empty_pool(tcfg), mesh, axis),
        jax.device_put(jnp.asarray(t["coords"], jnp.int32), shard),
        jax.device_put(jnp.asarray(t["active"]), shard),
        *(jnp.asarray(t[k]) for k in ("depth", "color", "k", "r_cw", "t_cw")), mesh, axis)
    return {f: np.asarray(v) for f, v in fn(*args)._asdict().items()}


@pytest.fixture(scope="module")
def problems():
    return _problems()


@pytest.fixture(scope="module")
def results(problems):
    """"port": rank 0's results of `_ranks` on 4 gloo ranks on the CPU;
    "jax": the JAX package's sharded functions on the same inputs, on a
    mesh of 4 of conftest's 8 virtual CPU devices, as numpy; "sum" and
    "fail": the futures of the two-rank launches of `_sum_rank` and
    `_fail_on_rank_1`. Everything runs at once, in threads."""
    from cvids_tpu.parallel import make_mesh

    mesh = make_mesh(N_RANKS)
    with ThreadPoolExecutor(7) as pool:
        port = pool.submit(parallel.launch, _ranks, N_RANKS, "gloo", "cpu", problems)
        two = {name: pool.submit(parallel.launch, fn, 2, "gloo", "cpu")
               for name, fn in (("sum", _sum_rank), ("fail", _fail_on_rank_1))}
        jax_side = {name: pool.submit(fn, problems, mesh) for name, fn in (
            ("solve", _jax_solve), ("dense", _jax_dense), ("window", _jax_window),
            ("tsdf", _jax_tsdf))}
        return {"port": port.result(), "jax": {k: f.result() for k, f in jax_side.items()},
                **two}


@pytest.fixture(scope="module")
def port(results):
    return results["port"]


# ---------- test_parallel.py's five cases, on the port ----------

def test_mesh_uses_all_devices(port):
    assert port["mesh"] == (0, N_RANKS, "cpu", "agents")


def test_sharded_solve_matches_single_device(port, problems):
    ref = topt.optimize_pose_graph(_nodes(problems["nodes"]), _edges(problems["edges"]),
                                   lm_iters=LM_ITERS, cg_iters=CG_ITERS)
    np.testing.assert_allclose(port["solve"]["t"], ref.t.numpy(), atol=2e-3)
    np.testing.assert_allclose(port["solve"]["yaw"], ref.yaw.numpy(), atol=2e-3)


def test_pad_edges_invalid_padding(problems):
    nodes, edges = _nodes(problems["nodes"]), _edges(problems["edges"])
    e0 = edges.i.shape[0]
    padded = parallel.pad_edges_for_sharding(edges, 8)
    assert padded.i.shape[0] % 8 == 0 and padded.i.shape[0] > e0
    assert not padded.valid[e0:].any()
    r0 = topt.edge_residuals(nodes, edges).numpy()
    r1 = topt.edge_residuals(nodes, padded).numpy()
    np.testing.assert_array_equal(r1[:e0], r0)
    np.testing.assert_array_equal(r1[e0:], 0.0)


def test_sharded_dense_fuse_agents(port):
    assert port["dense"]["num_frames"].tolist() == [1] * N_AGENTS
    assert np.isfinite(port["dense"]["mu"]).all()


def test_sharded_window_schur_matches_single_device(port, problems):
    """Against the port's single-device Schur solve, `solve_window_fast`."""
    st, meas = _window(*problems["window"])
    ref_out, ref_cost = tba.solve_window_fast(st, meas, iters=WINDOW_ITERS)
    got = port["window"]
    assert got["cost"] < 1.2 * float(ref_cost) + 5.0
    np.testing.assert_allclose(got["p"], ref_out.p.numpy(), atol=5e-2)
    lmv = st.lm_valid.numpy()
    np.testing.assert_allclose(got["lm"][lmv], ref_out.lm.numpy()[lmv], atol=1e-1)


# ---------- the port against the JAX package ----------

def test_pad_edges_matches_jax(problems):
    from cvids_tpu.parallel import pad_edges_for_sharding
    from cvids_tpu.server import optimizer as jopt

    for n in (3, 4, 8):
        want = pad_edges_for_sharding(jopt.PoseGraphEdges(**problems["edges"]), n)
        got = parallel.pad_edges_for_sharding(_edges(problems["edges"]), n)
        for f in topt.PoseGraphEdges._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f)


def test_sharded_solve_matches_jax(results):
    for f in ("t", "yaw"):
        np.testing.assert_allclose(results["port"]["solve"][f], results["jax"]["solve"][f],
                                   atol=2e-3, err_msg=f)


def test_sharded_dense_matches_jax(results):
    """Per agent, at test_torch_dense.py's tolerances (fp32 volumes)."""
    got, want = results["port"]["dense"], results["jax"]["dense"]
    np.testing.assert_array_equal(got["num_frames"], want["num_frames"])
    np.testing.assert_allclose(got["mean_cost"], want["mean_cost"], atol=1e-3)
    for f in ("mu", "sigma2", "a", "b"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-5, err_msg=f)


def test_window_schur_matches_jax(results, problems):
    """At test_parallel.py's bounds. The JAX body differentiates
    `jnp.linalg.norm` at each residual (NaN at an exactly zero one, ROADMAP
    F6); this problem has none, so both solves descend."""
    got, want = results["port"]["window"], results["jax"]["window"]
    assert np.isfinite(want["cost"])
    assert got["cost"] < 1.2 * want["cost"] + 5.0
    assert want["cost"] < 1.2 * got["cost"] + 5.0
    np.testing.assert_allclose(got["p"], want["p"], atol=5e-2)
    lmv = problems["window"][0]["lm_valid"]
    np.testing.assert_allclose(got["lm"][lmv], want["lm"][lmv], atol=1e-1)


def test_sharded_tsdf_matches_jax(results, problems):
    """At test_torch_mapping.py's SDF_ATOL; weights exact; the inactive
    chunks untouched."""
    from test_torch_mapping import SDF_ATOL

    got, want = results["port"]["tsdf"], results["jax"]["tsdf"]
    active = problems["tsdf"]["active"]
    np.testing.assert_array_equal(got["weight"], want["weight"])
    for f in ("sdf", "color"):
        np.testing.assert_allclose(got[f], want[f], atol=SDF_ATOL, err_msg=f)
    assert got["weight"][active].sum() > 0
    assert not got["weight"][~active].any()


# ---------- one rank, no process group: the single-device functions ----------

@pytest.mark.parametrize("path", ["solve", "dense", "tsdf"])
def test_one_rank_mesh_is_single_device(path, problems):
    """Without a process group `make_mesh` is one rank on the device asked
    for, issuing no collective, and each sharded function gives the bits of
    the single-device one."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    if path == "solve":
        nodes, edges = _nodes(problems["nodes"]), _edges(problems["edges"])
        got = parallel.shard_posegraph_solve(mesh, 3, 10)(nodes, edges)
        want = topt.optimize_pose_graph(nodes, edges, lm_iters=3, cg_iters=10)
        pairs = list(zip(got, want))
    elif path == "dense":
        d = problems["dense"]
        cfg = te.DenseConfig(**d["cfg"])
        a, b = torch.from_numpy(d["a"]), torch.from_numpy(d["b"])
        got = parallel.sharded_dense_fuse(mesh, cfg)(
            [te.init_reference(cfg, torch.from_numpy(d["refs"][0]))],
            [torch.from_numpy(d["meas"][0])], [a], [b])
        want = [te.fuse_measurement(cfg, te.init_reference(cfg, torch.from_numpy(d["refs"][0])),
                                    torch.from_numpy(d["meas"][0]), a, b)]
        pairs = [(x, y) for g, w in zip(got, want)
                 for x, y in zip((g.mean_cost, g.count, *g.filt), (w.mean_cost, w.count, *w.filt))]
    else:
        t = problems["tsdf"]
        cfg = tsdf.TsdfConfig(**t["cfg"])
        cap = len(t["coords"])
        frame = [torch.from_numpy(t[k]) for k in ("depth", "color", "k", "r_cw", "t_cw")]
        coords = torch.from_numpy(t["coords"])
        got = tsdf.sharded_integrate(
            cfg, tsdf.shard_pool(tsdf._empty_pool(cap, 8, torch.device("cpu")), mesh), coords,
            torch.ones(cap, dtype=torch.bool), *frame, mesh)
        want = tsdf._empty_pool(cap, 8, torch.device("cpu"))
        tsdf.integrate_chunks(cfg, want, torch.arange(cap), coords, *frame)
        pairs = list(zip(got, want))
    assert all(torch.equal(x, y) for x, y in pairs)
    assert mesh.log == []


# ---------- the audit ----------

def test_audit_counts_calls(port, problems):
    """The calls each sharded function issues, by the docstrings' formulas:
    the solve 1 + LM x (CG + 2), the window 3 x LM + 2, the dense step and
    the TSDF none."""
    from cvids_tpu_torch.parallel import collective_payloads, summarize_collectives

    logs = port["logs"]
    n = len(problems["nodes"]["yaw"])
    assert collective_payloads(logs["solve"]) == [{
        "op": "all-reduce", "count": 1 + LM_ITERS * (CG_ITERS + 2),
        "bytes": 4 * (1 + LM_ITERS * (CG_ITERS * 4 * n + 8 * n + 1))}]
    k, l = problems["window"][0]["p"].shape[0], problems["window"][0]["lm"].shape[0]
    pc, l_pad = 15 * k, l + (-l) % N_RANKS
    assert collective_payloads(logs["window"]) == [{
        "op": "all-reduce", "count": 3 * WINDOW_ITERS + 2,
        "bytes": 4 * (1 + WINDOW_ITERS * (2 * pc * pc + 2 * pc + 1 + 1 + 3) + 3 * l_pad)}]
    assert logs["dense"] == [] and logs["tsdf"] == []
    assert summarize_collectives(logs["tsdf"], "TSDF") == "TSDF: no cross-device collectives"
    line = summarize_collectives(logs["solve"], "solve")
    assert line.startswith(f"solve: all-reduce x{1 + LM_ITERS * (CG_ITERS + 2)} = ")
    assert line.endswith(f"in {1 + LM_ITERS * (CG_ITERS + 2)} calls issued)")


# ---------- launch ----------

def test_two_process_sum(results):
    """test_distributed.py's two-process sum, on two gloo ranks."""
    np.testing.assert_array_equal(results["sum"].result().numpy(), [12.0, 16.0])


def test_a_failing_rank_fails_launch(results):
    """The launch raises with the failing rank's traceback; rank 0, waiting
    in a collective for it, is stopped."""
    with pytest.raises(Exception, match="planted failure on rank 1"):
        results["fail"].result()


def test_make_mesh_needs_ranks():
    with pytest.raises(ValueError, match="launch"):
        parallel.make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        parallel.launch(_sum_rank, 2, "mpi", "cpu")


def test_parallel_imports_no_jax():
    """`cvids_tpu_torch.parallel` and the entry points load no module of
    jax or cvids_tpu."""
    res = subprocess.run([sys.executable, "-c", "import sys\n"
                          "import cvids_tpu_torch.parallel, cvids_tpu_torch.entry\n"
                          "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                          "('jax', 'cvids_tpu')))"],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stdout + res.stderr

"""The port's counterparts of ``__graft_entry__``: `entry()`, one
collaborative server compute step on the card with example inputs, and
`dryrun_multichip`, the sharded server step on N ranks at the JAX dry run's
toy and production shapes, with the collective audit.
"""

from __future__ import annotations

import hashlib
import json
import math
import time

import numpy as np
import torch

from . import resolve_device

__all__ = ["entry", "dryrun_multichip", "dryrun_problems", "tensor_digest"]


def entry(device=None):
    """(step, args): fuse a measurement frame into the dense depth state at
    the reference's full geometry (640x480x128) and run a 4-DoF pose-graph
    pass (2 LM x 10 CG) over a 256-keyframe graph — the two device-side hot
    paths of the server, on `device` (None: the card). The inputs are drawn
    as `__graft_entry__.entry()` draws them. `step(*args)` returns (the
    filter's mean inverse depth, the solved translations) and updates the
    dense state in place. On the card both halves are replayed CUDA graphs,
    as the server runs them (`estimator.fuse_graphs`,
    `optimizer.optimize_pose_graph_graphed`): the reference jits this step.
    The measurement's warp is the identity, inside the banded warp's band,
    so the banded warp runs (the server's host gate decides so)."""
    from .dense import estimator
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
    banded = _banded_gate(a_np, cfg.height, cfg.width)
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

    dense = estimator.fuse_graphs()

    def step(state, meas, a_mat, b_vec, nodes, edges):
        dense(cfg, state, meas, a_mat, b_vec, banded)
        new_nodes = opt.optimize_pose_graph_graphed(nodes, edges, lm_iters=2, cg_iters=10)
        return state.filt.mu.clone(), new_nodes.t

    return step, (state, meas, a_mat, b_vec, nodes, edges)


def _banded_gate(a_np: np.ndarray, h: int, w: int) -> bool:
    """The server's gate (`server/pipeline.py`): 96/48 px bands, 8 px margin."""
    from .ops.costvolume import warp_shift_bounds_np

    dx, dy = warp_shift_bounds_np(a_np, h, w, step=4)
    return bool(dx < 88.0 and dy < 40.0)


def tensor_digest(*tensors: torch.Tensor) -> str:
    """SHA-256 of the tensors' dtypes, shapes and bytes: equal digests mean
    equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the multi-GPU dry run

def _graph(yaw: np.ndarray, t: np.ndarray, dev, loops=None):
    """(nodes, edges): the nodes with node 0 fixed, their sequential edges
    and, when given, the loop edges (i, j, t_ij, yaw_ij) of the dry run."""
    from .server import optimizer as opt

    n = len(yaw)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    nodes = opt.PoseGraphNodes(yaw=f32(yaw), pr=torch.zeros((n, 2), device=dev), t=f32(t),
                               valid=torch.ones(n, dtype=torch.bool, device=dev),
                               fixed=torch.arange(n, device=dev) == 0)
    edges = opt.make_sequential_edges(nodes.yaw, nodes.pr, nodes.t,
                                      torch.zeros(n, dtype=torch.int64, device=dev), nodes.valid)
    if loops is not None:
        li, lj, t_ij, yaw_ij = loops
        nl = len(li)
        idx = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev)  # noqa: E731
        lp = opt.PoseGraphEdges(i=idx(li), j=idx(lj), t_ij=f32(t_ij), yaw_ij=f32(yaw_ij),
                                t_weight=f32(np.ones(nl)), yaw_weight=f32(np.full(nl, 0.1)),
                                valid=torch.ones(nl, dtype=torch.bool, device=dev),
                                huber=f32(np.full(nl, 0.1)))
        edges = opt.PoseGraphEdges(*(torch.cat([a, b]) for a, b in zip(edges, lp)))
    return nodes, edges


def _window(p: np.ndarray, lm: np.ndarray, obs: np.ndarray, vis: np.ndarray, n_imu: int,
            pix_weight: float, bias_weight: float, dev):
    """(state, meas): a window at rest facing +z, identity quaternions and
    extrinsics, between keyframes the same `n_imu`-sample preintegration of
    gravity alone (as the JAX dry run builds it)."""
    from .vio import imu
    from .vio import window_ba as ba

    kk, ll = p.shape[0], lm.shape[0]
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    z3 = torch.zeros(3, device=dev)
    pre = imu.preintegrate(torch.zeros((kk - 1, n_imu, 3), device=dev),
                           f32(np.tile([0.0, 0.0, 9.81], (kk - 1, n_imu, 1))),
                           torch.full((kk - 1, n_imu), 0.05, device=dev), z3, z3)
    state = ba.WindowState(
        p=f32(p), q=f32(np.tile([1.0, 0, 0, 0], (kk, 1))), v=torch.zeros((kk, 3), device=dev),
        bg=torch.zeros((kk, 3), device=dev), ba=torch.zeros((kk, 3), device=dev), lm=f32(lm),
        kf_valid=torch.ones(kk, dtype=torch.bool, device=dev),
        lm_valid=torch.ones(ll, dtype=torch.bool, device=dev))
    meas = ba.WindowMeasurements(
        obs=f32(obs), vis=torch.as_tensor(vis, device=dev), pre=pre,
        pre_valid=torch.ones(kk - 1, dtype=torch.bool, device=dev),
        r_cb=torch.eye(3, device=dev), p_bc=z3, pix_weight=pix_weight, huber_delta=5.0,
        bias_weight=bias_weight, prior=None, anchor_p=z3,
        anchor_yaw=torch.zeros((), device=dev))
    return state, meas


def _tsdf(voxel: float, chunk: int, capacity: int, side: int, z: int, h: int, w: int,
          k: np.ndarray, dev) -> dict:
    """A plane of `capacity` chunks, `side` to a row at chunk height `z`, and
    an identity camera seeing a flat depth of 2 m and mid-grey."""
    from .mapping import tsdf

    m = np.arange(capacity)
    coords = np.stack([m % side - side // 2, m // side - side // 2, np.full(capacity, z)], -1)
    return dict(cfg=tsdf.TsdfConfig(voxel_size=voxel, chunk_size=chunk, capacity=capacity),
                coords=torch.as_tensor(coords, dtype=torch.int64, device=dev),
                depth=torch.full((h, w), 2.0, device=dev),
                color=torch.full((h, w, 3), 128.0, device=dev),
                k=torch.as_tensor(k, device=dev), r=torch.eye(3, device=dev),
                t=torch.zeros(3, device=dev))


def dryrun_problems(n_devices: int, device=None, production: bool = True) -> dict:
    """The dry run's problems on `device` (None: the card), drawn from
    `np.random.default_rng(0)` in the order of
    `__graft_entry__.dryrun_multichip`. Keys: "toy_dense", "toy_graph",
    "toy_window", "toy_tsdf" and, with `production`, "graph", "dense",
    "window", "tsdf". A dense problem holds its config, the agents' images
    as numpy (n_devices, H, W), the warp (a, b) and the host gate; a graph
    (nodes, edges padded to a multiple of `n_devices`); a window (state,
    meas); a TSDF its config, chunk coordinates and frame.

    Two departures. The toy dense step has 32 hypotheses where the JAX dry
    run has 8: the CUDA kernels take D a multiple of 32. And the JAX dry
    run's graphs start at their optimum (every edge is measured from the
    poses it starts from), so its solves have nothing to do; here the poses
    are then perturbed (yaw by 0.02 rad, t by 5 cm, drawn from
    `default_rng(1)`, so the draws of `default_rng(0)` stay the JAX run's)."""
    from .dense import estimator
    from .parallel import pad_edges_for_sharding

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    jitter = np.random.default_rng(1)
    n = n_devices
    out = {}

    def perturbed(nodes, edges):
        m = len(nodes.yaw)
        f32 = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)  # noqa: E731
        return nodes._replace(yaw=nodes.yaw + f32(jitter.normal(0, 0.02, m)),
                              t=nodes.t + f32(jitter.normal(0, 0.05, (m, 3)))), \
            pad_edges_for_sharding(edges, n)

    def dense(cfg, k, baseline):
        refs = rng.uniform(0, 255, (n, cfg.height, cfg.width)).astype(np.float32)
        meas = rng.uniform(0, 255, (n, cfg.height, cfg.width)).astype(np.float32)
        a = (k @ np.linalg.inv(k)).astype(np.float32)
        return dict(cfg=cfg, refs=refs, meas=meas, a=a,
                    b=(k @ np.array([-baseline, 0, 0], np.float32)).astype(np.float32),
                    gate=_banded_gate(a, cfg.height, cfg.width))

    k_toy = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32)
    out["toy_dense"] = dense(estimator.DenseConfig(height=32, width=32, num_depths=32), k_toy,
                             0.1)
    out["toy_graph"] = perturbed(*_graph(rng.uniform(-3, 3, 64), rng.normal(size=(64, 3)), dev))
    kk, ll = 4, 2 * n
    p = rng.normal(0, 0.1, (kk, 3))
    lm = rng.normal(0, 1.0, (ll, 3)) + np.array([0, 0, 4.0])
    obs = rng.normal(0, 0.2, (kk, ll, 2))
    out["toy_window"] = _window(p, lm, obs, np.ones((kk, ll), bool), 4, 100.0, 10.0, dev)
    out["toy_tsdf"] = _tsdf(0.25, 4, 4 * n, 4, 1, 32, 32, k_toy, dev)
    if not production:
        return out

    # the 1024-keyframe / 6400-edge graph: sequential edges and 256 loops
    n_kf, nl = 1024, 256
    yaw_m = np.cumsum(rng.normal(0, 0.01, n_kf)).astype(np.float32)
    t_m = np.cumsum(rng.normal(0, 0.1, (n_kf, 3)), 0).astype(np.float32)
    li = rng.integers(0, n_kf // 2, nl)
    lj = (li + rng.integers(n_kf // 4, n_kf // 2, nl)) % n_kf
    dt = t_m[lj] - t_m[li]
    c, s = np.cos(-yaw_m[li]), np.sin(-yaw_m[li])
    t_ij = np.concatenate([np.stack([c * dt[:, 0] - s * dt[:, 1],
                                     s * dt[:, 0] + c * dt[:, 1]], -1), dt[:, 2:]], 1)
    out["graph"] = perturbed(*_graph(yaw_m, t_m, dev, (li, lj, t_ij, yaw_m[lj] - yaw_m[li])))
    k_prod = np.array([[461.0, 0, 320], [0, 461.0, 240], [0, 0, 1]], np.float32)
    out["dense"] = dense(estimator.DenseConfig(), k_prod, 0.11)     # 480 x 640 x 128, bf16
    # the agent's window: K = 21 keyframes, 600 landmark slots
    kk, ll = 21, 600
    lm_w = rng.normal(0, 2.0, (ll, 3)) + np.array([0, 0, 6.0])
    p_w = np.cumsum(rng.normal(0, 0.05, (kk, 3)), 0)
    obs = (lm_w[None, :, :2] - p_w[:, None, :2]) / (lm_w[None, :, 2:] - p_w[:, None, 2:])
    obs = obs + rng.normal(0, 2e-3, obs.shape)
    vis = rng.uniform(size=(kk, ll)) < 0.6
    out["window"] = _window(p_w, lm_w, obs, vis, 8, 460.0, 50.0, dev)
    out["tsdf"] = _tsdf(0.1, 8, 2048, math.ceil(math.sqrt(2048)), 2, 480, 640, k_prod, dev)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tensors(x):
    """Every tensor in nested tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _gather_json(mesh, obj) -> list:
    """Every rank's `obj` (JSON), gathered on every rank: each rank writes
    its bytes into its row of a zero-filled (W, 16 KiB) buffer and the mesh
    all-reduces it."""
    width = 1 << 14
    data = json.dumps(obj).encode()
    if len(data) > width:
        raise ValueError(f"a rank's report of {len(data)} bytes exceeds {width}")
    buf = torch.zeros((mesh.size, width), dtype=torch.int32, device=mesh.device)
    buf[mesh.rank, :len(data)] = torch.as_tensor(np.frombuffer(data, np.uint8).astype(np.int32),
                                                 device=mesh.device)
    rows = mesh.all_reduce(buf).cpu().numpy().astype(np.uint8)
    return [json.loads(row.tobytes().rstrip(b"\0")) for row in rows]


def _dryrun_rank(mesh, production: bool) -> dict:
    """One rank of `dryrun_multichip`."""
    from .dense import estimator
    from .mapping import tsdf
    from .ops import cuda_kernels as ck
    from .parallel import (collective_payloads, shard_posegraph_solve, sharded_dense_fuse,
                           solve_window_schur_sharded, summarize_collectives)
    from .utils.cuda_graph import disable_graphs

    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    probs = dryrun_problems(mesh.size, dev, production)
    phases, report, touched = {}, {"rank": mesh.rank}, [probs]

    def run(name, label, fn):
        mesh.take_log()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        log = mesh.take_log()
        phases[name] = {"seconds": time.perf_counter() - t0, "label": label,
                        "collectives": collective_payloads(log),
                        "audit": summarize_collectives(log, label), "calls": log}
        touched.append(out)
        for t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise RuntimeError(f"rank {mesh.rank}: {name} gave a non-finite value")
        return out

    def dense(name, d):
        cfg = d["cfg"]
        mine = mesh.block(len(d["refs"]))
        as_dev = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        states = [estimator.init_reference(cfg, as_dev(r)) for r in d["refs"][mine]]
        fuse = sharded_dense_fuse(mesh, cfg)
        ck.reset_launches()
        fused = run(name, f"dense fuse {cfg.height}x{cfg.width}x{cfg.num_depths} "
                          f"x{mesh.size} agents",
                    lambda: fuse(states, [as_dev(m) for m in d["meas"][mine]],
                                 [as_dev(d["a"])] * len(states), [as_dev(d["b"])] * len(states),
                                 banded_warp=d["gate"]))
        report[name] = {"launches": dict(ck.launches),
                        "agents": list(range(len(d["refs"])))[mine],
                        "digests": [tensor_digest(s.filt.mu, s.filt.sigma2, s.filt.a, s.filt.b,
                                                  s.mean_cost, s.count) for s in fused]}

    def graphed_and_eager(name, label, fn, fields):
        """`fn` as phase `name`; where the mesh captures (NCCL ranks), again
        as `name`_replayed (its graphs captured) and under
        `disable_graphs()` as `name`_eager. `fields` picks the result's
        tensors; the reruns' go under "replayed" and "eager"."""
        out = fields(run(name, label, fn))
        if mesh.graphs_allowed():
            out["replayed"] = fields(run(name + "_replayed", label, fn))
            with disable_graphs():
                out["eager"] = fields(run(name + "_eager", label, fn))
        return out

    def graph(name, lm_iters, cg_iters):
        nodes, edges = probs[name]
        solve = shard_posegraph_solve(mesh, lm_iters=lm_iters, cg_iters=cg_iters)
        return graphed_and_eager(
            name, f"4-DoF solve {len(nodes.yaw)} KF / {len(edges.i)} edges "
                  f"({lm_iters} LM x {cg_iters} CG)", lambda: solve(nodes, edges),
            lambda nd: {"t": nd.t, "yaw": nd.yaw})

    def window(name, iters, audit):
        state, meas = probs[name]
        label = f"window Schur K={state.p.shape[0]} L={state.lm.shape[0]} ({iters} LM)"
        return graphed_and_eager(name, label, lambda: solve_window_schur_sharded(
            mesh, state, meas, iters=iters,     # the audit line for the first run only
            audit_label=label if audit and name not in phases else None),
            lambda r: {"p": r[0].p, "q": r[0].q, "lm": r[0].lm, "cost": r[1]})

    def chunks(name):
        d = probs[name]
        cfg, mine = d["cfg"], mesh.block(d["cfg"].capacity)
        pool = tsdf.shard_pool(tsdf._empty_pool(cfg.capacity, cfg.chunk_size, dev), mesh)
        active = torch.ones(cfg.capacity, dtype=torch.bool, device=dev)
        ck.reset_launches()
        pool = run(name, f"TSDF integrate {cfg.capacity} chunks x {cfg.chunk_size}^3 "
                         f"@ {d['depth'].shape[1]}x{d['depth'].shape[0]}",
                   lambda: tsdf.sharded_integrate(cfg, pool, d["coords"][mine], active[mine],
                                                  d["depth"], d["color"], d["k"], d["r"],
                                                  d["t"], mesh))
        report[name] = {"digest": tensor_digest(*pool), "weight": float(pool.weight.sum()),
                        "launches": dict(ck.launches)}

    result = {"n_devices": mesh.size, "production": production}
    dense("toy_dense", probs["toy_dense"])
    result["toy_graph"] = graph("toy_graph", 2, 8)
    result["toy_window"] = window("toy_window", 2, False)
    chunks("toy_tsdf")
    if production:
        result["graph"] = graph("graph", 12, 60)
        dense("dense", probs["dense"])
        result["window"] = window("window", 8, True)
        chunks("tsdf")
    # the latency of one all-reduce of the production solve's CG buffer
    # alone, with no work between the calls
    buf = torch.zeros((1024, 4), device=dev)
    for i in range(70):
        if i == 20:
            _sync(dev)
            t0 = time.perf_counter()
        mesh.all_reduce(buf)
    _sync(dev)
    result["all_reduce_ms"] = (time.perf_counter() - t0) / 50 * 1e3
    mesh.take_log()
    report["graphs"] = {fn.__name__: [g.captures, g.replays] for fn, g in mesh.graphs.items()}
    report["devices"] = sorted({str(t.device) for t in _tensors(touched)})
    report["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                          if dev.type == "cuda" else None)
    result["ranks"] = _gather_json(mesh, report)
    result["phases"] = phases
    return result


def dryrun_multichip(n_devices: int, backend: str = "nccl", device=None,
                     production: bool = True) -> dict:
    """The sharded server step on `n_devices` ranks (`parallel.launch`):
    `backend="nccl"` puts rank r on card r; `"gloo"` puts every rank on
    `device` (None: the card; "cpu" for a rehearsal, where
    `production=False` keeps to the toy shapes).

    Follows `__graft_entry__.dryrun_multichip` phase by phase on
    `dryrun_problems`: toy shapes (n agents x 32x32x32 dense, a 64-node
    solve of 2 LM x 8 CG, the window at K=4 / L=2n for 2 LM, the TSDF at
    4n chunks x 4^3), then production shapes (the 1024-KF / 6400-edge solve
    of 12 LM x 60 CG, one agent a rank at 480x640x128 in bf16, the window at
    K=21 / L=600 for 8 LM, the TSDF at 2048 x 8^3 with a 640x480 frame).
    On NCCL the sharded solves and windows replay CUDA graphs of one LM
    iteration (`Mesh.graphed`); each then runs again (its graphs captured,
    phase "<name>_replayed") and eagerly under `disable_graphs()` ("<name>_eager"),
    for the bits and times to compare.
    Prints the JAX function's lines with the port's audit (calls issued),
    and returns rank 0's results: "toy_graph"/"graph" (t, yaw),
    "toy_window"/"window" (p, q, lm, cost), on NCCL each with the reruns'
    under "replayed" and "eager", "phases" (host-clock seconds,
    collectives, audit line and the calls issued of each phase on rank 0),
    "all_reduce_ms"
    (one all-reduce of a (1024, 4) fp32 buffer alone, the mean of 50 after
    20, the calls not in any phase's audit) and "ranks" (each rank's
    report: devices of its tensors, peak memory, the dense steps' launches
    and digests, the TSDF blocks' digests and weights, and "graphs", each
    captured function's [captures, replays])."""
    from .parallel import launch

    res = launch(_dryrun_rank, n_devices, backend, device, production)
    ph, ranks = res["phases"], res["ranks"]
    toy_w = sum(r["toy_tsdf"]["weight"] for r in ranks)
    print(f"dryrun_multichip toy phases OK on {n_devices} ranks ({backend}): dense "
          f"({n_devices}, 32, 32), posegraph {tuple(res['toy_graph']['t'].shape)}, sharded "
          f"window BA cost {float(res['toy_window']['cost']):.2f}, sharded TSDF integrate "
          f"weight {toy_w:.0f} over {4 * n_devices} chunks; one all-reduce of 16.4 kB alone "
          f"{res['all_reduce_ms']:.3f} ms", flush=True)
    if production:
        print(f"dryrun_multichip PRODUCTION shapes OK on {n_devices} ranks ({backend}):",
              flush=True)
        print(f"  dense ({n_devices}, 480, 640) in {ph['dense']['seconds']:.1f}s; "
              f"{ph['dense']['audit']}", flush=True)
        print(f"  posegraph {tuple(res['graph']['t'].shape)} in {ph['graph']['seconds']:.1f}s; "
              f"{ph['graph']['audit']}", flush=True)
        print(f"  window Schur K=21/L=600 cost {float(res['window']['cost']):.1f} in "
              f"{ph['window']['seconds']:.1f}s (audit above)", flush=True)
        print(f"  TSDF 2048x8^3 weight {sum(r['tsdf']['weight'] for r in ranks):.0f} in "
              f"{ph['tsdf']['seconds']:.1f}s; {ph['tsdf']['audit']}", flush=True)
    return res

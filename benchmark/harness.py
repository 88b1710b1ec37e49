"""One run of one cell: set-up, the measured window, the correctness check
and the result line. Everything a cell is made of is found by name:

- the cell (`workloads`), its configuration and the metrics in
  `BENCHMARK.json`;
- the configuration's file (`configs/<name>.json`, its `file` entry);
- the traffic mix (`traffic/<traffic>.json`), whose `driver` names the loop
  that submits it (`drivers/<driver>.py`);
- each metric's reader (`metrics/<name>.py`, a `read(run)` that returns a
  number or None when it finds nothing to read).
"""

from __future__ import annotations

import functools
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import check, generator, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _entry(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(bench: dict, cell_name: str):
    """(cell, configuration, traffic) of a cell, read from their files."""
    cell = _entry(bench["workloads"], cell_name, "workload")
    cfg_entry = _entry(bench["configs"], cell["config"], "configuration")
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def cell_metrics(bench: dict, cell: dict, kind: str) -> list:
    """The `end_to_end` or `per_layer` metrics a cell reports: an end-to-end
    metric unless it lists other cells, a per-layer one where it lists this
    cell."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    return [m for m in bench["per_layer"] if cell["name"] in m["workloads"]]


def reader(name: str):
    """`metrics/<name>.py`'s `read`."""
    return importlib.import_module(f"benchmark.metrics.{name}").read


def driver(name: str):
    """`drivers/<name>.py`."""
    return importlib.import_module(f"benchmark.drivers.{name}")


def build_server(config: dict, traffic: dict, voc, seed: int, device):
    """The program's collaborative server at the configuration, its RANSAC
    noise drawn from the seed, each client's camera set."""
    from cvids_tpu_torch import camera
    from cvids_tpu_torch.dense.estimator import DenseConfig
    from cvids_tpu_torch.mapping.tsdf import TsdfConfig
    from cvids_tpu_torch.ops import ransac
    from cvids_tpu_torch.server.pipeline import CollaborativeServer, PipelineConfig
    from cvids_tpu_torch.server.posegraph import ServerConfig

    cfg = PipelineConfig(server=ServerConfig(**config["server"]),
                         dense=DenseConfig(**config["dense"]), tsdf=TsdfConfig(**config["tsdf"]),
                         dense_enabled=bool(traffic["images"]), **config["pipeline"])
    noise = functools.partial(ransac.gumbel_noise,
                              generator=torch.Generator().manual_seed(seed % (1 << 63)),
                              device=device)
    server = CollaborativeServer(voc, cfg, device=device, noise=noise)
    c = config["camera"]
    for cid in range(config["agents"]):
        server.set_client_camera(cid, camera.PinholeCamera.create(
            c["fx"], c["fy"], c["cx"], c["cy"], tuple(c["dist"]), c["width"], c["height"],
            device=device))
    return server


def warm_solver_tiers(server, tiers: dict, device) -> None:
    """Capture the 4-DoF solve's LM step (one CUDA graph a node tier and
    loop tier, `CollaborativePoseGraph._solve`) at every pair of the
    traffic's `solver_tiers` that the window can reach, on an empty graph
    of those shapes, so that the solver thread captures nothing inside the
    window."""
    from cvids_tpu_torch.server import optimizer as opt
    f32 = dict(dtype=torch.float32, device=device)
    back = server.graph.cfg.seq_back
    for n in tiers["nodes"]:
        nodes = opt.PoseGraphNodes(
            yaw=torch.zeros(n, **f32), pr=torch.zeros((n, 2), **f32), t=torch.zeros((n, 3), **f32),
            valid=torch.zeros(n, dtype=torch.bool, device=device),
            fixed=torch.zeros(n, dtype=torch.bool, device=device))
        for lt in tiers["loops"]:
            e = n * back + lt
            edges = opt.PoseGraphEdges(
                i=torch.zeros(e, dtype=torch.int64, device=device),
                j=torch.zeros(e, dtype=torch.int64, device=device),
                t_ij=torch.zeros((e, 3), **f32), yaw_ij=torch.zeros(e, **f32),
                t_weight=torch.ones(e, **f32), yaw_weight=torch.ones(e, **f32),
                valid=torch.zeros(e, dtype=torch.bool, device=device),
                huber=torch.ones(e, **f32))
            opt.optimize_pose_graph_graphed(nodes, edges, 1, server.graph.cfg.cg_iters)


def captures(server) -> dict:
    """CUDA graphs captured so far by the server's graphed programs."""
    from cvids_tpu_torch.server import optimizer as opt
    g = server.graph
    calls = {"solver": opt._GRAPHED, "dense": server._dense_graphs, "verify": g._verify,
             "bow": getattr(g.db, "_query_insert", None)}
    return {k: getattr(v, "captures", 0) for k, v in calls.items()}


def _window_outputs(server, loops_before: int, window_start: int, published: list,
                    recorders: list, tsdf_before) -> check.Outputs:
    g = server.graph
    st = g.store
    n = st.count
    k = g.loop_count
    vol = server.volume
    return check.Outputs(
        n_keyframes=n, loops_before=loops_before, window_start=window_start,
        loop_i=g.loop_i[:k].copy(), loop_j=g.loop_j[:k].copy(), loop_t=g.loop_t[:k].copy(),
        loop_yaw=g.loop_yaw[:k].copy(), loop_valid=g.loop_valid[:k].copy(),
        loop_pcm_ok=g.loop_pcm_ok[:k].copy(), world_p=st.world_p[:n].copy(),
        world_yaw=st.world_yaw[:n].copy(),
        aligned=np.array([g.clients[a].aligned for a in range(int(st.client[:n].max()) + 1)]),
        published=published, cycles=[r.rec for r in recorders if r.state == "done"],
        tsdf_before=tsdf_before,
        tsdf_after=(vol.pool.sdf, vol.pool.weight, vol.pool.color, dict(vol.slot_of))
        if tsdf_before is not None else None)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, traced: bool,
             device="cuda", t0: float | None = None, control: bool = False,
             config_patch=None) -> tuple[dict, list]:
    """One run: returns (the result object, the check lines). `config_patch`
    (tests only) edits the configuration and traffic before set-up."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cell, config, traffic = cell_files(bench, cell_name)
    if config_patch is not None:
        config_patch(config, traffic)

    # ---- set-up: kernels, vocabulary, session, server, warm-up
    from cvids_tpu_torch.server import vocab
    if cuda:
        from cvids_tpu_torch import _build
        _build.load()
    voc = vocab.synthesize_tree_vocabulary(config["vocabulary"]["k"],
                                           config["vocabulary"]["levels"], seed=seed % (1 << 32))
    session = generator.make_session(config, traffic, seed, dev, traffic["session_keyframes"])
    server = build_server(config, traffic, voc, seed, dev)
    loop = driver(traffic["driver"])
    warm = traffic["warmup_keyframes"]
    loop.warm_up(server, session.packets[:warm], dev)
    if cuda:
        warm_solver_tiers(server, traffic["solver_tiers"], dev)
    tsdf_before = None
    if traffic["images"]:
        pool = server.volume.pool
        tsdf_before = (pool.sdf.clone(), pool.weight.clone(), pool.color.clone(),
                       dict(server.volume.slot_of))
    rng = np.random.default_rng(seed)
    clients = rng.permutation(config["agents"])[:traffic["check_cycles"]]
    recorders = [check.CycleRecorder(int(c), int(rng.integers(0, max(1, int(10 * seconds)))))
                 for c in clients]
    loops_before, window_start = server.graph.loop_count, server.graph.store.count
    server.tracer.reset()
    server.tracer.use_profiler = False
    if traced:
        trace.warm_up()
    loop.finish_queued(dev)
    solves0, captured0 = (server.graph.solve_count, server.graph.discarded_solves), captures(server)
    setup_s = time.perf_counter() - t0

    # ---- the measured window
    win = loop.window(server, session.packets, warm, seconds, dev, recorders,
                      trace_slice=traffic["trace_slice"] if traced else None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    captured = {k: v - captured0[k] for k, v in captures(server).items()}
    solves = (server.graph.solve_count - solves0[0], server.graph.discarded_solves - solves0[1])
    given_up = sum(r.given_up for r in recorders)

    # ---- the program's answers, then its state freed
    server.graph.flush(final=True)
    out = _window_outputs(server, loops_before, window_start, win.published, recorders,
                          tsdf_before)
    # the server's spans over the window, less the profiled slice's
    spans = {name: (server.tracer.totals[name] - win.slice_spans.get(name, (0.0, 0))[0],
                    server.tracer.counts[name] - win.slice_spans.get(name, (0.0, 0))[1])
             for name in server.tracer.totals}
    server.close()
    del server, recorders
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the check
    judge = check.Judge(session, config, dev)
    judge.posegraph(out, control)
    if traffic["images"]:
        judge.dense(out, control)
        judge.tsdf(out, control)
    correct, numbers = judge.verdict()

    # ---- the metrics
    run = SimpleNamespace(window=win, setup_s=setup_s, spans=spans, config=config,
                          traffic=traffic, trace=win.trace, map_work=judge.map_work)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, kind):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win.attempted), "failed": int(win.failed),
              "metrics": metrics, "device": device_info}
    if traced and win.trace is not None:
        device_info["busy_s"] = win.trace.busy_s
        device_info["window_s"] = win.trace.window_s
        result["breakdown"] = trace.breakdown(win.trace)
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in numbers.items()}
    lat = np.asarray(win.latencies_s)
    lines = [f"window: {win.attempted} keyframes in {win.elapsed_s:.3f} s "
             f"(+ {win.slice_s:.3f} s profiled), store at {out.n_keyframes}, "
             f"{solves[0]} solves ({solves[1]} discarded), graphs captured {captured}, "
             f"dense cycles given up {given_up}"]
    if len(lat):
        tail = lat >= np.percentile(lat, 95)
        pub = np.asarray(win.publishing, bool)
        lines.append(f"tail: {int(tail.sum())} keyframes at or above the p95, "
                     f"{int((tail & pub).sum())} of them publishing a map; "
                     f"{int(pub.sum())} of {len(lat)} keyframes published")
    lines += [f"check {k}: {v['value']!r} ({'at most' if v['bound'] == 'max' else 'at least'} "
             f"{v['limit']!r})" for k, v in numbers.items()]
    return result, lines


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is that of JAX or of the JAX
    package (compared whole: `cvids_tpu_torch` is not `cvids_tpu`)."""
    bad = {"jax", "jaxlib", "flax", "cvids_tpu"}
    return sorted({m.split(".")[0] for m in sys.modules} & bad)

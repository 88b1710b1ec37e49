"""Probe: the sharded programs' CUDA graphs on two NCCL ranks, step by
step. Each step runs in a process group of its own under a time limit, so a
capture that hangs costs its limit and the next step still runs.

    python3 dev/torch_probe_sharded_graphs.py [--steps a,b] [--limit S] [--env K=V,...]

Steps (each on ranks 0 and 1, a card each):
- graph_api: PyTorch's own pattern, `torch.cuda.graph` around one
  `dist.all_reduce` after an eager one (global capture mode, the device
  synchronized first);
- graphed_call: `GraphedCall` (thread-local capture on a side stream after
  a warm-up call, no synchronization) of a kernel, an all-reduce and a
  kernel, replayed 3 times against the eager call;
- solve: `shard_posegraph_solve` at the dry run's toy shape, graphed and
  under `disable_graphs()`, bits and calls compared;
- window: `solve_window_schur_sharded` at the toy shape, the same.

`--env` sets variables for every step's processes (e.g. NCCL_DEBUG=WARN);
`--patch sync` synchronizes the device before each capture begins,
`--patch global` captures in CUDA's global mode instead of the thread-local
one, and `--patch trace` prints each rank's capture_begin, capture_end and
replay as they return (all in the ranks, around `torch.cuda.CUDAGraph`).
`--together` runs the steps one after another in one process group.
Prints one line a step: ok, failed (a rank's traceback is printed) or hung
(killed at the limit), and the step's last output lines.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STEPS = ("graph_api", "graphed_call", "solve", "window")


def _patch() -> None:
    """The capture variants of `--patch`, passed to the ranks in
    PROBE_PATCH."""
    kinds = [k for k in os.environ.get("PROBE_PATCH", "").split(",") if k]
    if not kinds:
        return
    graph = torch.cuda.CUDAGraph
    begin, end, replay = graph.capture_begin, graph.capture_end, graph.replay
    t0 = time.perf_counter()

    def say(what):
        if "trace" in kinds:
            print(f"  [{time.perf_counter() - t0:8.3f} s] rank {torch.cuda.current_device()}: "
                  f"{what}", flush=True)

    def capture_begin(self, *args, **kwargs):
        if "sync" in kinds:
            torch.cuda.synchronize()
        if "global" in kinds:
            kwargs["capture_error_mode"] = "global"
        say("capture_begin ...")
        out = begin(self, *args, **kwargs)
        say("capture_begin returned")
        return out

    def capture_end(self):
        out = end(self)
        say("capture_end returned")
        return out

    def replay_(self):
        out = replay(self)
        say("replay returned")
        return out
    graph.capture_begin, graph.capture_end, graph.replay = capture_begin, capture_end, replay_


def _graph_api(mesh):
    import torch.distributed as dist

    x = torch.ones(4096, device=mesh.device)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        dist.all_reduce(x)
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    return {"value": float(x[0]), "want": 2.0 * 2 * 2}


def _reduce_between(mesh, x):
    y = x * 2.0
    mesh.all_reduce(y)
    return y + 1.0


def _graphed_call(mesh):
    from cvids_tpu_torch.utils.cuda_graph import GraphedCall

    x = torch.arange(4096.0, device=mesh.device) + mesh.rank
    mesh.all_reduce(torch.zeros(1, device=mesh.device))       # the communicator, eagerly
    call = GraphedCall(_reduce_between, effects=mesh)
    mesh.take_log()
    outs = [call(mesh, x) for _ in range(3)]
    torch.cuda.synchronize()
    log = mesh.take_log()
    want = _reduce_between(mesh, x)
    return {"same": all(torch.equal(o, want) for o in outs), "log": log,
            "captures": call.captures, "replays": call.replays}


def _problem(mesh, name):
    from cvids_tpu_torch.entry import dryrun_problems
    return dryrun_problems(2, mesh.device, production=False)[name]


def _solve(mesh):
    from cvids_tpu_torch.parallel import shard_posegraph_solve
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs

    nodes, edges = _problem(mesh, "toy_graph")
    solve = shard_posegraph_solve(mesh, 2, 8)
    runs = {}
    for kind in ("graphed", "replayed", "eager"):
        mesh.take_log()
        t0 = time.perf_counter()
        with disable_graphs() if kind == "eager" else _null():
            out = solve(nodes, edges)
        _sync(mesh)
        runs[kind] = (out, mesh.take_log(), time.perf_counter() - t0)
    return _compare(runs, ("t", "yaw"), mesh)


def _window(mesh):
    from cvids_tpu_torch.parallel import solve_window_schur_sharded
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs

    state, meas = _problem(mesh, "toy_window")
    runs = {}
    for kind in ("graphed", "replayed", "eager"):
        mesh.take_log()
        t0 = time.perf_counter()
        with disable_graphs() if kind == "eager" else _null():
            out, cost = solve_window_schur_sharded(mesh, state, meas, iters=2)
        _sync(mesh)
        runs[kind] = ({"p": out.p, "lm": out.lm, "cost": cost}, mesh.take_log(),
                      time.perf_counter() - t0)
    return _compare(runs, ("p", "lm", "cost"), mesh)


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _null():
    import contextlib
    return contextlib.nullcontext()


def _compare(runs, fields, mesh):
    get = (lambda r, f: r[f]) if isinstance(runs["eager"][0], dict) else getattr
    g, e = runs["graphed"][0], runs["eager"][0]
    return {"same": all(torch.equal(get(g, f), get(e, f)) and
                        torch.equal(get(runs["replayed"][0], f), get(e, f)) for f in fields),
            "max_diff": max(float((get(g, f).double() - get(e, f).double()).abs().max())
                            for f in fields),
            "calls_equal": runs["graphed"][1] == runs["replayed"][1] == runs["eager"][1],
            "calls": len(runs["graphed"][1]),
            "seconds": {k: round(v[2], 4) for k, v in runs.items()},
            "graphs": {fn.__name__: [c.captures, c.replays] for fn, c in mesh.graphs.items()}}


def _child(steps: str) -> None:
    from cvids_tpu_torch.parallel import launch

    print(f"{steps}: {launch(_rank, 2, 'nccl', None, steps)}", flush=True)


def _rank(mesh, steps):
    """Each step of `steps` on this rank; a rank that raises prints its
    traceback and leaves at once (a rank stuck in a collective would keep
    the launch from seeing the error)."""
    import traceback

    _patch()
    out = {}
    try:
        for step in steps.split(","):
            out[step] = {"graph_api": _graph_api, "graphed_call": _graphed_call,
                         "solve": _solve, "window": _window}[step](mesh)
            if mesh.rank == 0:
                print(f"  {step} done: {out[step]}", flush=True)
    except BaseException:
        print(f"rank {mesh.rank} raised:\n{traceback.format_exc()}", flush=True)
        os._exit(1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default=",".join(STEPS))
    ap.add_argument("--limit", type=float, default=60.0)
    ap.add_argument("--env", default="")
    ap.add_argument("--patch", default="")
    ap.add_argument("--together", action="store_true")
    ap.add_argument("--child")
    a = ap.parse_args()
    if a.child:
        _child(a.child)
        return 0
    if torch.cuda.device_count() < 2:
        print(f"needs two CUDA devices, has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, NCCL {torch.cuda.nccl.version()}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    from cvids_tpu_torch import _build
    _build.build()
    env = dict(os.environ, PROBE_PATCH=a.patch,
               **dict(kv.split("=", 1) for kv in a.env.split(",") if kv))
    failed = False
    for step in [a.steps] if a.together else a.steps.split(","):
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, __file__, "--child", step], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=a.limit)
            verdict = "ok" if proc.returncode == 0 else f"failed (rc {proc.returncode})"
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            verdict = f"hung (killed at {a.limit:.0f} s)"
        failed |= verdict != "ok"
        lines = [ln for ln in out.splitlines() if "hostname of the client socket" not in ln]
        print(f"== {step} {a.env or '(default env)'} {a.patch or '(no patch)'}: {verdict} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print("\n".join(lines[-40:]), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

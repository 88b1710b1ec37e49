"""Where the background 4-DoF solves of `chip_smoke.py` phase 5 spend their
time, on one CUDA card: phase 5's stream (4 agents x 126 keyframes, the
10^6-word tree, background solves) in a fresh process, with each solve's
PCM, each graphed-solve call (a capture of a new tier or a replay, with its
node and edge shapes) and each writeback timed on the host clock with the
thread that ran it, and the keyframes whose ingest took over 200 ms.

    python3 dev/torch_probe_solve_captures.py   # from the repo's root; needs nvcc and a card
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cvids_tpu_torch import _build  # noqa: E402
from cvids_tpu_torch.server import optimizer as opt  # noqa: E402
from cvids_tpu_torch.server import posegraph, vocab  # noqa: E402

LOG = []


def timed(name, fn):
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        LOG.append((name, threading.current_thread().name, time.perf_counter() - t0,
                    time.perf_counter()))
        return out
    return call


def main() -> None:
    _build.build()
    _build.load()
    dev = torch.device("cuda", 0)
    graph_cls = posegraph.CollaborativePoseGraph
    for name in ("_run_pcm", "_writeback"):
        setattr(graph_cls, name, timed(name.strip("_"), getattr(graph_cls, name)))
    real = opt.optimize_pose_graph_graphed

    def graphed(nodes, edges, *args):
        before = len(opt._GRAPHED.graphs) if opt._GRAPHED is not None else 0
        t0 = time.perf_counter()
        out = real(nodes, edges, *args)
        torch.cuda.current_stream().synchronize()
        kind = "capture" if len(opt._GRAPHED.graphs) > before else "replay"
        LOG.append((f"solve {kind} {tuple(nodes.yaw.shape)} {tuple(edges.i.shape)}",
                    threading.current_thread().name, time.perf_counter() - t0,
                    time.perf_counter()))
        return out

    opt.optimize_pose_graph_graphed = graphed
    tree = vocab.synthesize_tree_vocabulary(*cs.SERVER_TREE, seed=0)
    packets, _ = cs.server_stream(cs.SERVER_AGENTS, cs.SERVER_DURATION)
    t_start = time.perf_counter()
    _, stats = cs.server_run(dev, packets, tree)
    ingest = np.asarray(stats["ingest_ms"])
    print(f"stream {stats['stream_s']:.2f} s; ingest ms median {np.median(ingest):.3f}; "
          f"solve ms {[round(x) for x in stats['solve_ms']]}")
    for name, thread, dt, t_end in LOG:
        print(f"{t_end - t_start:8.2f} s  {thread:14s} {name:40s} {dt:8.3f} s")
    print("keyframes ingested in > 200 ms (index, ms):",
          [(k, round(v)) for k, v in enumerate(ingest) if v > 200])


if __name__ == "__main__":
    main()

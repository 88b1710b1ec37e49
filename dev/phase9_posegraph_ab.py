"""Phase 9's pose graph taken apart on the CPU: the reference's pose graph
and the port's on the same packets, in the same ingest orders.

    python3 dev/phase9_posegraph_ab.py FILE [--orders N]

FILE is what `dev/torch_probe_topology.py --save FILE` wrote on the card:
the ground truth, the agents' keyframe packets of its first run, and each
run's ingest order, ATE, loop edges and keyframe store. This script prints
one JSON line:

- a row per agent, "vio": the ATE sim3 (cm) of the packets' own poses (the
  front-end's VIO, before any loop);
- a row per card run, "card": its ATE and its loop edges, each with the
  error of its translation t_ij against the ground truth's (cm);
- for the timestamp order and the first `--orders` card runs' orders, a
  row each of "port" (`cvids_tpu_torch.server.posegraph` on the CPU) and
  "jax" (`cvids_tpu.server.posegraph`, the reference, on the CPU): the
  packets added in that order with inline solves, then `flush()` (a final
  solve), scored as phase 9 scores.

The two pose graphs on the CPU differ from each other and from the card
only at the float level; what the rows show is how far the loop edges'
errors, and with them the ATE, move with the order and the arithmetic.
About 10 s a row on 2 CPU cores.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cvids_tpu_torch.geometry.hostmath import quat_to_matrix_np  # noqa: E402
from cvids_tpu_torch.io import codec  # noqa: E402
from cvids_tpu_torch.utils.metrics import ate_rmse  # noqa: E402


def truth_pose(truth, cid, t):
    """Body rotation (nearest sample) and position (interpolated) at t."""
    g = truth[cid]
    k = int(np.argmin(np.abs(g["gt_t"] - t)))
    return quat_to_matrix_np(g["gt_q"][k]), np.array(
        [np.interp(t, g["gt_t"], g["gt_p"][:, a]) for a in range(3)])


def ate_cm(truth, cid, t, p) -> float:
    gt_p = np.stack([np.interp(t, truth[cid]["gt_t"], truth[cid]["gt_p"][:, a])
                     for a in range(3)], -1)
    return ate_rmse(np.asarray(p, np.float64), gt_p, "sim3") * 100


def loop_errors(truth, rec) -> list[str]:
    """'client:local<-client:local (t_ij error cm)' for each loop edge."""
    cl, ts, li = rec["client"], rec["timestamp"], rec["local_index"]
    out = []
    for e, (i, j) in enumerate(zip(rec["loop_i"], rec["loop_j"])):
        r_i, p_i = truth_pose(truth, cl[i], ts[i])
        _, p_j = truth_pose(truth, cl[j], ts[j])
        err = np.linalg.norm(np.asarray(rec["loop_t"][e], np.float64) - r_i.T @ (p_j - p_i))
        out.append(f"{cl[i]}:{li[i]}<-{cl[j]}:{li[j]} ({err * 100:.1f})")
    return out


def graph_rows(graph, truth, n_agents) -> dict:
    st, k = graph.store, graph.loop_count
    rec = {"client": np.asarray(st.client), "timestamp": np.asarray(st.timestamp),
           "local_index": np.asarray(st.local_index), "loop_i": np.asarray(graph.loop_i[:k]),
           "loop_j": np.asarray(graph.loop_j[:k]), "loop_t": np.asarray(graph.loop_t[:k])}
    ates = []
    for cid in range(n_agents):
        tr = np.asarray(graph.trajectory(cid))
        ates.append(round(ate_cm(truth, cid, tr[:, 0], tr[:, 1:4]), 3))
    return {"ate_cm": ates, "loops": loop_errors(truth, rec)}


def run_graph(package: str, packets, order, fx: float):
    """The packets through one package's pose graph (phase 9's server
    settings, inline solves) in `order`, then flush()."""
    if package == "port":
        from cvids_tpu_torch.server import posegraph, vocab
        graph = posegraph.CollaborativePoseGraph(
            vocab.generic_vocabulary(10, 4, device="cpu"),
            posegraph.ServerConfig(kf_capacity=256, optimize_every=20, pnp_thresh=10.0 / fx),
            device="cpu")
        convert = codec.decode_packet
    else:
        from cvids_tpu.io.msgs import KeyframePacket
        from cvids_tpu.server import posegraph, vocab
        graph = posegraph.CollaborativePoseGraph(
            vocab.generic_vocabulary(k=10, levels=4),
            posegraph.ServerConfig(kf_capacity=256, optimize_every=20, pnp_thresh=10.0 / fx))
        names = [f.name for f in dataclasses.fields(KeyframePacket)]

        def convert(d):
            p = codec.decode_packet(d)
            return KeyframePacket(**{n: getattr(p, n) for n in names})
    it = [iter(per) for per in packets]
    for cid in order:
        graph.add_keyframe(convert(dict(next(it[cid]))))
    graph.flush()
    if hasattr(graph, "close"):
        graph.close()
    return graph


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file")
    ap.add_argument("--orders", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(2)
    saved = pickle.loads(Path(args.file).read_bytes())
    truth, packets = saved["truth"], saved["packets"]
    n_agents = len(packets)
    fx = float(cs.agent_config().camera.fx)
    for cid, per in enumerate(packets):
        t = np.array([float(d["timestamp"]) for d in per])
        p = np.stack([d["p_wb"] for d in per])
        print(json.dumps({"row": "vio", "agent": cid, "keyframes": len(per),
                          "ate_cm": round(ate_cm(truth, cid, t, p), 3)}), flush=True)
    for n, run in enumerate(saved["runs"]):
        print(json.dumps({"row": "card", "run": n, "order": run["order"],
                          "ate_cm": [round(a, 3) for a in run["ate_cm"]],
                          "loops": loop_errors(truth, run)}), flush=True)
    stamps = sorted((float(d["timestamp"]), cid) for cid, per in enumerate(packets) for d in per)
    orders = [("timestamp", [cid for _, cid in stamps])]
    orders += [(f"card run {n}", [int(c) for c in run["order"]])
               for n, run in enumerate(saved["runs"][:args.orders])]
    for name, order in orders:
        for package in ("port", "jax"):
            graph = run_graph(package, packets, order, fx)
            print(json.dumps({"row": package, "order": name,
                              **graph_rows(graph, truth, n_agents)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

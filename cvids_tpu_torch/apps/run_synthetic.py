"""End-to-end collaborative SLAM demo on a synthetic multi-agent world
(port of ``examples/run_synthetic.py``).

The `collaborative_server_node` equivalent (`server_pose_graph/src/
collaborative_server_node.cpp` + the multi-agent launch): N agents stream
keyframes into the collaborative server, which aligns their submaps,
optimizes the global 4-DoF graph in the background, and reports ATE against
ground truth. Runs on the card unless given `--device cpu`.

    python -m cvids_tpu_torch.apps.run_synthetic --agents 3 --duration 30
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--duration", type=float, default=25.0)
    ap.add_argument("--kf-rate", type=float, default=1.0)
    ap.add_argument("--landmarks", type=int, default=300)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--plot", type=str, default=None,
                    help="write a trajectory PNG here (needs matplotlib)")
    ap.add_argument("--tum-prefix", type=str, default=None,
                    help="write pose<cid>.txt TUM trajectories")
    ap.add_argument("--viewer", type=str, default=None,
                    help="write the interactive WebGL viewer HTML here")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the card; cpu for a CPU run")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..io import multiagent
    from ..io.synthetic import Trajectory
    from ..server import posegraph, vocab
    from ..utils.metrics import ate_rmse

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    landmarks = np.stack([
        rng.uniform(-14, 14, args.landmarks),
        rng.uniform(-14, 14, args.landmarks),
        rng.uniform(0.2, 4.0, args.landmarks)], -1)
    descs = multiagent.landmark_descriptors(args.landmarks)
    voc = vocab.train_vocabulary(descs, k=8, levels=2, seed=0, device=dev)

    agents = []
    for a in range(args.agents):
        agents.append(multiagent.AgentSim(
            Trajectory.circle(radius=5.0 - 0.3 * a, omega=0.45, phase=2.0 * a,
                              center=(1.0 * a, 0.5 * a, 1.5)),
            yaw_offset=0.4 * a,
            t_offset=np.array([2.0 * a, -1.0 * a, 0.1 * a]),
            drift_yaw_rate=0.0005, drift_t_rate=0.002))
    packets, gt = multiagent.generate_packets(
        agents, landmarks, descs, duration=args.duration,
        kf_rate=args.kf_rate, max_feats=60)

    # async_optimize: the overlapped Optimize4DoF worker is the flagship
    # operating mode (`server_pose_graph.cpp:16,1811-1812`)
    cfg = posegraph.ServerConfig(kf_capacity=1024, max_win=64, max_ext=128,
                                 max_loops=512, optimize_every=20,
                                 min_loop_matches=12, pcm_min_edges=10,
                                 async_optimize=True)
    server = posegraph.CollaborativePoseGraph(voc, cfg, device=dev)
    t0 = time.time()
    try:
        for _, cid, ki, pkt in packets:
            server.add_keyframe(pkt)
        server.flush()
        dt = time.time() - t0
    finally:
        server.close()
    print(f"background solves: {server.solve_count} "
          f"(discarded {server.discarded_solves})")

    print(f"processed {len(packets)} keyframes from {args.agents} agents "
          f"in {dt:.1f}s ({len(packets) / dt:.1f} kf/s)")
    print(f"aligned: {[server.clients[c].aligned for c in range(args.agents)]}"
          f"  loops: {server.loop_count} "
          f"(pcm-kept {int(server.loop_pcm_ok[:server.loop_count].sum())})")
    for cid in range(args.agents):
        st = server.store
        n = st.count
        sel = np.nonzero(st.client[:n] == cid)[0]
        est = st.world_p[sel]
        ref = np.asarray([gt[(cid, int(st.local_index[k]))][0] for k in sel])
        print(f"  agent {cid}: ATE {ate_rmse(est, ref, 'none') * 100:.1f} cm "
              f"(raw, no alignment) over {len(sel)} keyframes")
        if args.tum_prefix:
            from ..io import tum
            tum.write_tum(f"{args.tum_prefix}{cid}.txt", server.trajectory(cid))
    if args.plot:
        from ..utils import visualization as viz
        if viz.plot_trajectories(args.plot, server, gt):
            print(f"wrote {args.plot}")
        else:
            print(f"nothing written to {args.plot}: matplotlib is not installed")
    if args.viewer:
        from ..utils.viewer import export_viewer_html
        export_viewer_html(args.viewer, server)
        print(f"wrote {args.viewer} (open in a browser; 's' exports TUM)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

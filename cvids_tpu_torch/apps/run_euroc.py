"""Collaborative SLAM on EuRoC sequences (port of ``examples/run_euroc.py``;
needs a dataset on disk, or one written by `io.euroc_synth`).

Replaces the reference's rosbag replay (`roslaunch server_pose_graph
collaborative.launch` against EuRoC bags): each `--seq` directory becomes one
agent whose front-end runs on the images + IMU, streaming keyframes into the
collaborative pose-graph server (background solves). Scores ATE against the
dataset's ground truth. Runs on the card unless given `--device cpu`.

    python -m cvids_tpu_torch.apps.run_euroc --seq /data/MH_01 --seq /data/MH_02
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", action="append", required=True,
                    help="EuRoC sequence root (contains mav0/)")
    ap.add_argument("--kf-stride", type=int, default=0,
                    help="0 (default): camera-rate tracking — the front-end "
                         "tracks EVERY frame and selects keyframes by "
                         "rotation-compensated parallax (the reference "
                         "contract: tracker at 20 Hz, keyframes at ~freq "
                         "Hz, euroc_config.yaml:44-46). N>0: legacy mode, "
                         "every Nth frame fed directly as a keyframe")
    ap.add_argument("--max-kf", type=int, default=200)
    ap.add_argument("--tum-prefix", type=str, default=None)
    ap.add_argument("--vocab", type=str, default=None,
                    help="pretrained DBoW2 binary vocabulary (the reference "
                         "ships brief_k10L6.bin). Default: a HELD-OUT "
                         "generic vocabulary trained on descriptors from "
                         "procedurally rendered worlds disjoint from any "
                         "evaluation sequence — never on the sequence "
                         "itself (self-trained vocabularies overfit loop "
                         "recall)")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the card; cpu for a CPU run")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..io import euroc

    dev = resolve_device(args.device)
    for root in args.seq:
        if not euroc.available(root):
            print(f"EuRoC sequence not found at {root} (need mav0/imu0/"
                  f"data.csv)", file=sys.stderr)
            return 2

    from ..server import posegraph, vocab
    from ..utils.config import AgentConfig
    from ..utils.metrics import ate_rmse
    from ..vio.frontend import AgentFrontend
    from .agent_process import imu_batches

    seqs = [euroc.load_euroc(r) for r in args.seq]
    # per-agent calibration from the dataset's own sensor.yaml when present
    # (the role of the reference's per-agent config_file_i params)
    cfgs = [euroc.load_agent_config(r) or AgentConfig() for r in args.seq]
    frontends = [AgentFrontend(cfg, cid, device=dev) for cid, cfg in enumerate(cfgs)]

    all_packets = [[] for _ in seqs]
    for cid, (seq, fe) in enumerate(zip(seqs, frontends)):
        stride = max(args.kf_stride, 0)
        if stride == 0:
            frame_ids = range(0, min(len(seq.cam_t), args.max_kf * 10))
            feed = fe.process_frame
        else:
            frame_ids = range(0, min(len(seq.cam_t), args.max_kf * stride), stride)
            feed = fe.process_keyframe
        for fi, t, gyr, acc, dts in imu_batches(seq, frame_ids):
            pkt = feed(t, seq.load_image(fi), gyr, acc, dts)
            if pkt is not None:
                all_packets[cid].append(pkt)
        print(f"agent {cid}: {len(all_packets[cid])} keyframes "
              f"({fe.kf_count} selected, {len(frame_ids)} frames)")

    # vocabulary: pretrained binary when given (the reference's
    # brief_k10L6.bin path, `collaborative_server_node.cpp:76-91`),
    # otherwise the HELD-OUT generic vocabulary — never trained on the
    # evaluation sequences themselves
    if args.vocab:
        voc = vocab.load_dbow_binary(args.vocab)
    else:
        voc = vocab.generic_vocabulary(k=10, levels=4, device=dev)
    # the reference's PnP threshold is 10 px at EuRoC's ~460 focal
    # (`server_keyframe.cpp:418-497`); keep the same *pixel* tolerance on
    # whatever camera the agents actually carry
    fx = float(cfgs[0].camera.fx)
    # overlapped background optimization is the flagship operating mode
    # (the reference's Optimize4DoF thread, `server_pose_graph.cpp:16,
    # 1811-1812`)
    server = posegraph.CollaborativePoseGraph(
        voc, posegraph.ServerConfig(kf_capacity=2048, pnp_thresh=10.0 / fx,
                                    async_optimize=True), device=dev)
    # interleave by timestamp
    merged = sorted([p for pkts in all_packets for p in pkts], key=lambda p: p.timestamp)
    try:
        for p in merged:
            server.add_keyframe(p)
        server.flush()
    finally:
        server.close()
    print(f"background solves: {server.solve_count} "
          f"(discarded {server.discarded_solves})")
    print(f"loops: {server.loop_count}, aligned: "
          f"{[server.clients[c].aligned for c in range(len(seqs))]}")
    for cid, seq in enumerate(seqs):
        tr = server.trajectory(cid)
        if args.tum_prefix:
            from ..io import tum
            tum.write_tum(f"{args.tum_prefix}{cid}.txt", tr)
        if seq.gt_t is not None and len(tr):
            gt_p = np.stack([np.interp(tr[:, 0], seq.gt_t, seq.gt_p[:, k])
                             for k in range(3)], -1)
            print(f"agent {cid}: ATE (sim3) "
                  f"{ate_rmse(tr[:, 1:4], gt_p, 'sim3') * 100:.1f} cm")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The JAX package on `chip_smoke.py` phase 8's frames, on the CPU.

Renders phase 8's two agents (752x480 EuRoC radtan frames at 20 Hz with
200 Hz IMU in test_full_system.py's room, `chip_smoke.agent_sequences`,
the same seeds) and runs them through one package's `AgentFrontend`s on
the CPU (`--front-end jax`, the reference, or `port`). The packets go
through the JAX package's `CollaborativeServer` on the CPU
(`generic_vocabulary(10, 4)`, each client's radtan camera,
test_full_system.py's TSDF settings), scored as phase 8 scores
(`chip_smoke.agents_score`: ATE sim3 per agent, median and per-map
inverse-depth RMS, mesh median scene distance): one JSON line. The packets
are also written to build/phase8_packets/<front-end>_<tuning>_s<seed>.pkl,
where `dev/torch_probe_agents.py` (step `packets`) sends them through the
port's server on the card.

The questions it answers: does the reference meet phase 8's bounds at this
size with a given tuning, on the same frames as the port; do the port's
front-ends' packets score as the reference's in the reference's server;
and (with the probe) does the port's server give the reference's scores on
the reference's packets. Each run swaps one component against the all-JAX
run.

    python3 dev/phase8_jax_reference.py --tuning defaults   # AgentConfig(), DenseConfig(480, 752)
    python3 dev/phase8_jax_reference.py --tuning phase8 [--seed N] [--front-end port]

~15-25 minutes on 4 CPU cores (the dense steps at 480x752x128 in
bfloat16 on the CPU take most of it); `--duration` shortens the sequences
for a quick look.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cvids_tpu_torch import interop  # noqa: E402


def jax_front_ends(cfg_t, seqs) -> list:
    """Every frame through the JAX package's front-ends, as
    `chip_smoke.agents_run` feeds the port's; the packets per agent."""
    from cvids_tpu.utils.config import AgentConfig, CameraConfig
    from cvids_tpu.vio.frontend import AgentFrontend
    from cvids_tpu.vio.imu import ImuNoise

    d = interop.agent_config_to_dict(cfg_t)
    cam_d, imu_d = d.pop("camera"), d.pop("imu")
    cfg = AgentConfig(camera=CameraConfig(**cam_d), imu=ImuNoise(**imu_d), **d)
    packets = []
    for cid, seq in enumerate(seqs):
        fe, out, prev_t = AgentFrontend(cfg, cid), [], None
        for fi, t in enumerate(seq["cam_t"]):
            if prev_t is None:
                sel = (seq["imu_t"] >= t - 0.1) & (seq["imu_t"] < t)
                imu = (np.zeros((0, 3)), seq["acc"][sel], np.zeros(0))
            else:
                sel = (seq["imu_t"] >= prev_t) & (seq["imu_t"] < t)
                imu = (seq["gyr"][sel], seq["acc"][sel],
                       np.diff(np.append(seq["imu_t"][sel], t)))
            prev_t = t
            pkt = fe.process_frame(t, seq["images"][fi], *imu)
            if pkt is not None:
                out.append(pkt)
        packets.append(out)
    return packets


def jax_server(cfg_t, tuning):
    from cvids_tpu.camera.pinhole import PinholeCamera
    from cvids_tpu.dense import estimator
    from cvids_tpu.io.msgs import KeyframePacket
    from cvids_tpu.mapping.tsdf import TsdfConfig
    from cvids_tpu.server import pipeline, posegraph, vocab

    c = cfg_t.camera
    if tuning == "defaults":
        dense = estimator.DenseConfig(height=c.height, width=c.width)
    else:   # chip_smoke.agent_dense's fields
        dn = cs.agent_dense(c)
        dense = estimator.DenseConfig(height=dn.height, width=dn.width, num_depths=dn.num_depths,
                                      dep_sample=dn.dep_sample, tau2_scale=dn.tau2_scale)
    pcfg = pipeline.PipelineConfig(
        server=posegraph.ServerConfig(kf_capacity=256, optimize_every=20,
                                      pnp_thresh=10.0 / float(c.fx)),
        dense=dense, tsdf=TsdfConfig(voxel_size=0.1, capacity=2048, carving=False),
        min_fused_frames=2, ref_advance=3)
    server = pipeline.CollaborativeServer(vocab.generic_vocabulary(k=10, levels=4), pcfg)
    for cid in range(cs.AGENTS):
        server.set_client_camera(cid, PinholeCamera.create(
            c.fx, c.fy, c.cx, c.cy, (c.k1, c.k2, c.p1, c.p2), c.width, c.height))
    return server, dense, KeyframePacket


def serve(server, packet_cls, packets) -> float:
    """The packets in time order, each as `packet_cls` (the server's own
    package's class, the same fields), then a final solve; seconds."""
    t0 = time.perf_counter()
    names = [f.name for f in dataclasses.fields(packet_cls)]
    try:
        for p in sorted([p for pk in packets for p in pk], key=lambda p: p.timestamp):
            server.submit(packet_cls(**{n: getattr(p, n) for n in names}))
            server.process()
        server.optimize()
    finally:
        if hasattr(server, "close"):
            server.close()
    return time.perf_counter() - t0


def score(server, seqs, cfg, dense) -> dict:
    ates, rmses, _, dist, n_tri = cs.agents_score(server, seqs, cfg, dense.height, dense.width,
                                                  len(seqs))
    g = server.graph
    return {"aligned": [bool(cl.aligned) for cl in g.clients[:len(seqs)]],
            "loops": g.loop_count, "ate_cm": [a * 100 for a in ates],
            "depth_maps": server.depth_maps_published,
            "rms_median": float(np.median(rmses)) if rmses else None, "rms_maps": len(rmses),
            "rms_per_map": [round(r, 4) for r in rmses], "mesh_m": dist, "triangles": n_tri}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tuning", choices=("defaults", "phase8"), default="defaults")
    ap.add_argument("--front-end", choices=("jax", "port"), default="jax")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=cs.AGENT_DURATION)
    ap.add_argument("--workers", type=int, default=4, help="render processes")
    args = ap.parse_args()
    torch.set_num_threads(4)     # two runs side by side share 8 cores

    cfg_t = cs.agent_config(defaults=args.tuning == "defaults")
    t0 = time.perf_counter()
    seqs = cs.agent_sequences(cfg_t, duration=args.duration, seed=args.seed,
                              workers=args.workers)
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if args.front_end == "jax":
        packets = jax_front_ends(cfg_t, seqs)
    else:
        _, packets, _, _, _, _ = cs.agents_run("cpu", seqs, cfg_t)
    head = {"tuning": args.tuning, "seed": args.seed, "front_ends": args.front_end + " (CPU)",
            "frames": [len(s["cam_t"]) for s in seqs], "packets": [len(p) for p in packets],
            "seconds_render": render_s, "seconds_front_ends": time.perf_counter() - t0}
    out = ROOT / "build" / "phase8_packets" / f"{args.front_end}_{args.tuning}_s{args.seed}.pkl"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("wb") as f:
        pickle.dump({"tuning": args.tuning, "seed": args.seed, "front_end": args.front_end,
                     "truth": [{k: s[k] for k in ("gt_t", "gt_p", "gt_q")} for s in seqs],
                     "packets": [[{k: np.asarray(v) if hasattr(v, "shape") else v
                                   for k, v in vars(p).items()} for p in pk]
                                 for pk in packets]}, f)
    server, dense, packet_cls = jax_server(cfg_t, args.tuning)
    srv_s = serve(server, packet_cls, packets)
    print(json.dumps({"server": "cvids_tpu (JAX, CPU)", **head, **score(server, seqs, cfg_t, dense),
                      "seconds_server": srv_s, "packets_file": str(out.relative_to(ROOT))}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase 8 of `chip_smoke.py` on the card, and around it: the spread of its
scores over other seeds, `AgentConfig()`'s own tuning, the eager
front-end, and the port's server on the JAX package's packets.

    python3 dev/torch_probe_agents.py [--steps phase8 seeds defaults eager packets] [--seeds 1 2 3]

Steps (all by default, in this order):

- `phase8`: `chip_smoke.agents_phase` as the script runs it (seed 0, its
  checks);
- `seeds`: each of `--seeds`, phase 8's front-ends and server on another
  world, IMU noise and nuisances (`agent_sequences(seed=...)`), scores
  only;
- `defaults`: seed 0 with `AgentConfig()`'s own tuning (FAST 20, 10 Hz
  keyframes) and the server at `DenseConfig(480, 752)`, then the same
  packets at four other dense settings;
- `eager`: seed 0, agent 0, with the KLT call and the window solve eager (no
  CUDA graphs): frame and keyframe times;
- `packets`: every file that `dev/phase8_jax_reference.py` wrote under
  build/phase8_packets/ (packets of the JAX front-ends, made on the CPU)
  through the port's server on the card, scored as phase 8 scores.

Prints one JSON line a run (also appended to chiprun_out/agents_probe.jsonl).
All steps ~13 minutes on an H100.
"""

from __future__ import annotations

import argparse
import json
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "chiprun_out" / "agents_probe.jsonl"


def emit(row: dict) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    OUT.parent.mkdir(exist_ok=True)
    with OUT.open("a") as f:
        f.write(line + "\n")


def serve(dev, cams, packets, seqs, cfg, dense, tree) -> dict:
    """The agents' packets through `CollaborativeServer` as phase 8 sends
    them; phase 8's scores."""
    from cvids_tpu_torch.server.pipeline import CollaborativeServer

    server = CollaborativeServer(tree, cs.agent_pipeline_config(cfg.camera, dense), device=dev)
    for cid, cam in enumerate(cams):
        server.set_client_camera(cid, cam)
    t0 = time.perf_counter()
    try:
        for p in sorted([p for pk in packets for p in pk], key=lambda p: p.timestamp):
            server.submit(p)
            server.process()
        server.optimize()
        cs._sync(dev)
    finally:
        server.close()
    srv_s = time.perf_counter() - t0
    ates, rmses, _, dist, n_tri = cs.agents_score(server, seqs, cfg, dense.height, dense.width,
                                                  len(seqs))
    g = server.graph
    return {"aligned": [bool(cl.aligned) for cl in g.clients[:len(seqs)]],
            "loops": g.loop_count, "ate_cm": [a * 100 for a in ates],
            "depth_maps": server.depth_maps_published,
            "rms_median": float(np.median(rmses)) if rmses else None, "rms_maps": len(rmses),
            "mesh_m": dist, "triangles": n_tri, "server_s": srv_s}


def front_ends(dev, seqs, cfg) -> tuple:
    t0 = time.perf_counter()
    fes, packets, rows, tracer, _, _ = cs.agents_run(dev, seqs, cfg)
    frame = [r[3] for r in rows if not r[2]]
    kf = [r[3] for r in rows if r[2]]
    stats = {"packets": [len(p) for p in packets],
             "vi_initialized": [bool(f.vi_initialized) for f in fes],
             "frame_ms": [float(np.median(frame)), float(np.percentile(frame, 90))],
             "keyframe_ms": [float(np.median(kf)), float(np.percentile(kf, 90))] if kf else None,
             "spans_median_ms": {n: float(np.median(v)) * 1e3 for n, v in tracer.samples.items()},
             "front_ends_s": time.perf_counter() - t0}
    return fes, packets, stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    steps = ("phase8", "seeds", "defaults", "eager", "packets")
    ap.add_argument("--steps", nargs="*", choices=steps, default=steps)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2, 3])
    args = ap.parse_args()

    from cvids_tpu_torch import _build
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.vio import frontend

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    _build.build()
    _build.load()
    ok = True
    if "phase8" in args.steps:
        t0 = time.perf_counter()
        try:
            cs.agents_phase(dev)
            emit({"run": "phase 8", "seed": 0, "ok": True, "card": card,
                  "seconds": time.perf_counter() - t0})
        except Exception:       # the probe goes on to its other runs
            traceback.print_exc()
            emit({"run": "phase 8", "seed": 0, "ok": False, "card": card})
            ok = False
    tree = vocab.generic_vocabulary(10, 4, device=dev)
    cfg = cs.agent_config()
    for seed in args.seeds if "seeds" in args.steps else ():
        seqs = cs.agent_sequences(cfg, seed=seed)
        fes, packets, stats = front_ends(dev, seqs, cfg)
        emit({"run": "phase 8 tuning", "seed": seed, "card": card, **stats,
              **serve(dev, [fe.cam for fe in fes], packets, seqs, cfg,
                       cs.agent_dense(cfg.camera), tree)})

    if "defaults" in args.steps:
        defaults_step(dev, tree, card)
    if "eager" in args.steps:
        seqs = cs.agent_sequences(cfg, n_agents=1)
        with mock.patch.object(frontend, "GraphedCall", lambda fn: fn):
            _, _, stats = front_ends(dev, seqs, cfg)
        emit({"run": "eager front-end, agent 0", "seed": 0, "card": card, **stats})
    if "packets" in args.steps:
        packets_step(dev, tree, card)
    return 0 if ok else 1


def defaults_step(dev, tree, card) -> None:
    from cvids_tpu_torch.dense.estimator import DenseConfig

    cfg_d = cs.agent_config(defaults=True)
    seqs = cs.agent_sequences(cfg_d)
    fes, packets, stats = front_ends(dev, seqs, cfg_d)
    c = cfg_d.camera
    for name, dense in (("DenseConfig(480, 752)", DenseConfig(height=c.height, width=c.width)),
                        ("tau2_scale 0.5", DenseConfig(height=c.height, width=c.width,
                                                       tau2_scale=0.5)),
                        ("step 1/128", DenseConfig(height=c.height, width=c.width,
                                                   dep_sample=1.0 / 128, tau2_scale=0.5)),
                        ("64 x 0.015", DenseConfig(height=c.height, width=c.width, num_depths=64,
                                                   dep_sample=0.015, tau2_scale=0.5)),
                        ("agent_dense", cs.agent_dense(c))):
        emit({"run": "AgentConfig() tuning", "dense": name, "seed": 0, "card": card, **stats,
              **serve(dev, [fe.cam for fe in fes], packets, seqs, cfg_d, dense, tree)})


def packets_step(dev, tree, card) -> None:
    from cvids_tpu_torch.camera import make_camera
    from cvids_tpu_torch.dense.estimator import DenseConfig
    from cvids_tpu_torch.io.msgs import KeyframePacket

    for path in sorted((ROOT / "build" / "phase8_packets").glob("*.pkl")):
        with path.open("rb") as f:
            saved = pickle.load(f)
        cfg = cs.agent_config(defaults=saved["tuning"] == "defaults")
        c = cfg.camera
        dense = (DenseConfig(height=c.height, width=c.width) if saved["tuning"] == "defaults"
                 else cs.agent_dense(c))
        seqs = saved["truth"]      # per agent the ground truth that agents_score reads
        packets = [[KeyframePacket(**p) for p in pk] for pk in saved["packets"]]
        emit({"run": "the port's server on saved packets", "file": path.name,
              "front_ends": saved["front_end"], "tuning": saved["tuning"], "seed": saved["seed"],
              "card": card, "packets": [len(p) for p in packets],
              **serve(dev, [make_camera(c, device=dev)] * len(packets), packets, seqs, cfg, dense,
                       tree)})


if __name__ == "__main__":
    sys.exit(main())

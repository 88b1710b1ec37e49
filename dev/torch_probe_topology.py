"""`chip_smoke.py` phase 9 on the card, repeated and taken apart: where its
scores part from phase 8's on the same frames.

Phase 9 differs from phase 8 in three ways at once: the agents read their
frames and IMU back from EuRoC files (lossless PNGs, times as integer
nanoseconds, IMU values with 17 significant digits as in phase 9, or with
the JAX writer's 9 decimals under `--imu-decimals`); the server solves in
the background; and it ingests the packets in the order they arrive from
two processes, not in timestamp order. This probe renders phase 8's seed-0
sequences, writes them once, and then:

- `--repeats` runs of the deployment (`chip_smoke.topology_run`), scored as
  phase 9 scores (`topology_score`), with each run's ingest order and
  whether the agents sent the same packets as in the first run;
- the first run's packets through the server again in one thread, in
  timestamp order, once with inline solves (phase 8's server) and once with
  background solves.

One JSON line a run on standard output, with each agent's host ms a plain
frame and a keyframe (medians). `--no-replays` skips the replays;
`--package DIR` imports `cvids_tpu_torch` from DIR (an unpacked `git
archive` of another commit; the agent processes inherit it) and `--cache
FILE` keeps the rendered sequences, so that two trees run in turns in one
call:

    python3 dev/torch_probe_topology.py [--repeats 3] [--imu-decimals] [--no-replays]
        [--package DIR] [--cache build/frames.pkl]

About 4 minutes on an H100 (one repeat without replays: ~1.5 minutes after
the rendering).
"""

from __future__ import annotations

import argparse
import json
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def scores(server, roots, cfg, dense) -> dict:
    sc = cs.topology_score(server, roots, cfg, dense)
    g = server.graph
    return {"ate_cm": [round(a * 100, 3) for a in sc["ates"]], "rms": round(sc["rms"], 4),
            "mesh_m": round(sc["mesh_m"], 4), "loops": g.loop_count, "solves": g.solve_count,
            "aligned": [bool(c.aligned) for c in g.clients[:len(roots)]],
            "depth_maps": server.depth_maps_published}


def replay(dev, sent, roots, cfg, dense, async_optimize) -> dict:
    """The agents' packets (codec dicts) through a fresh server in one
    thread, in timestamp order, then a final solve."""
    from cvids_tpu_torch.camera import make_camera
    from cvids_tpu_torch.io import codec
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.server.pipeline import CollaborativeServer

    server = CollaborativeServer(vocab.generic_vocabulary(10, 4, device=dev),
                                 cs.agent_pipeline_config(cfg.camera, dense, async_optimize),
                                 device=dev)
    for cid in range(len(roots)):
        server.set_client_camera(cid, make_camera(cfg.camera, device=dev))
    packets = sorted((codec.decode_packet(dict(d)) for per in sent for d in per),
                     key=lambda p: p.timestamp)
    try:
        for p in packets:
            server.submit(p)
            server.process()
        server.graph.flush()
    finally:
        server.close()
    return scores(server, roots, cfg, dense)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--imu-decimals", action="store_true",
                    help="write the IMU with the JAX writer's 9 decimals instead of 17 "
                         "significant digits (phase 9's default)")
    ap.add_argument("--no-replays", action="store_true")
    ap.add_argument("--package", default=None)
    ap.add_argument("--cache", default=None)
    args = ap.parse_args()
    if args.package:
        sys.path.insert(0, str(Path(args.package).resolve()))
    import numpy as np
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = cs.agent_config()
    dense = cs.agent_dense(cfg.camera)
    t0 = time.perf_counter()
    cache = Path(args.cache) if args.cache else None
    if cache is not None and cache.exists():
        seqs = pickle.loads(cache.read_bytes())
    else:
        seqs = cs.agent_sequences(cfg)
        for s_ in seqs:
            s_["images"] = [im.astype(np.uint8) for im in s_["images"]]
        if cache is not None:
            cache.parent.mkdir(parents=True, exist_ok=True)
            cache.write_bytes(pickle.dumps(seqs))
    for s_ in seqs:
        s_["images"] = [im.astype(np.float32) for im in s_["images"]]
    import cvids_tpu_torch
    emit({"card": smi, "package": str(Path(cvids_tpu_torch.__file__).parent),
          "rendered_s": time.perf_counter() - t0,
          "imu": "9 decimals" if args.imu_decimals else "17 significant digits"})
    with tempfile.TemporaryDirectory(prefix="cvids_topology_probe_") as root:
        roots = cs.write_sequences(seqs, cfg, root, exact=not args.imu_decimals)
        first = None
        for rep in range(args.repeats):
            t0 = time.perf_counter()
            run = cs.topology_run(dev, roots, cfg, dense)
            sent = [[dict(d) for d in per] for per in run["sent"]]
            same = first is not None and all(
                len(a) == len(b) and all(cs.same_codec_dicts(x, y) for x, y in zip(a, b))
                for a, b in zip(sent, first))
            first = first or sent
            emit({"run": f"topology {rep}", "card": smi, **scores(run["server"], roots, cfg, dense),
                  "packets": [len(p) for p in sent], "same_packets_as_run_0": same if rep else None,
                  "order": "".join(map(str, run["order"])), "stream_s": run["stream_s"],
                  "agent_plain_ms": [float(np.median(np.asarray(f)[~np.asarray(k, bool)]))
                                     for f, k in zip(run["frame_ms"], run["keyframe"])],
                  "agent_keyframe_ms": [float(np.median(np.asarray(f)[np.asarray(k, bool)]))
                                        for f, k in zip(run["frame_ms"], run["keyframe"])],
                  "wall_s": time.perf_counter() - t0})
        for async_optimize in (() if args.no_replays else (False, True)):
            emit({"run": f"run 0's packets in timestamp order, one thread, "
                         f"{'background' if async_optimize else 'inline'} solves", "card": smi,
                  **replay(dev, first, roots, cfg, dense, async_optimize)})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase 8's accuracy over seeds: the two agents' front-ends and the server
scored as `chip_smoke.agents_phase` scores them, once a seed (ROADMAP F8).

    python3 dev/torch_probe_klt_seeds.py [--seeds 0 1 2 3 4] [--package DIR]
        [--cache-dir build/klt_seeds]

For each seed, renders phase 8's sequences (`chip_smoke.agent_sequences(cfg,
seed=s)`; with `--cache-dir` kept there as 8-bit frames and read back by
later runs, so that two trees run on the same pixels), feeds every frame of
both agents through `AgentFrontend` on the card (`chip_smoke.agents_run`),
then their packets in time order through phase 8's `CollaborativeServer`
and scores it (`chip_smoke.agents_score`). With `--package DIR` it imports
`cvids_tpu_torch` from DIR (an unpacked `git archive` of another commit),
so that trees are compared on the same frames in one call:

    for t in build/parent .; do
        python3 dev/torch_probe_klt_seeds.py --package $t --cache-dir build/klt_seeds; done

One JSON line a seed: the package, the card, ATE sim3 per agent (cm), the
median inverse-depth RMS, the mesh's median scene distance (m), loops,
packets per agent, and whether phase 8's bounds hold (ATE < 10 cm, RMS <
0.12, mesh < 0.15 m, >= 1 loop, >= 8 packets an agent). About 1 minute a
seed and tree on an H100, plus ~1 minute a seed to render.
"""

from __future__ import annotations

import argparse
import json
import pickle
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--package", default=None)
    ap.add_argument("--cache-dir", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.package:
        sys.path.insert(0, str(Path(args.package).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    import cvids_tpu_torch
    from cvids_tpu_torch import _build
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.server.pipeline import CollaborativeServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    _build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = cs.agent_config()
    dense = cs.agent_dense(cfg.camera)
    for seed in args.seeds:
        cache = Path(args.cache_dir) / f"seed{seed}.pkl" if args.cache_dir else None
        if cache is not None and cache.exists():
            seqs = pickle.loads(cache.read_bytes())
        else:
            seqs = cs.agent_sequences(cfg, seed=seed)
            for s in seqs:
                s["images"] = [im.astype(np.uint8) for im in s["images"]]
            if cache is not None:
                cache.parent.mkdir(parents=True, exist_ok=True)
                cache.write_bytes(pickle.dumps(seqs))
        for s in seqs:
            s["images"] = [im.astype(np.float32) for im in s["images"]]
        fes, packets, _, _, _, _ = cs.agents_run(dev, seqs, cfg)
        server = CollaborativeServer(vocab.generic_vocabulary(10, 4, device=dev),
                                     cs.agent_pipeline_config(cfg.camera, dense), device=dev)
        for cid, fe in enumerate(fes):
            server.set_client_camera(cid, fe.cam)
        try:
            for p in sorted([p for pk in packets for p in pk], key=lambda p: p.timestamp):
                server.submit(p)
                server.process()
            server.optimize()
            torch.cuda.synchronize()
        finally:
            server.close()
        ates, rmses, _, dist, _ = cs.agents_score(server, seqs, cfg, dense.height, dense.width,
                                                  len(seqs))
        rms = float(np.median(rmses)) if rmses else float("inf")
        n_pk = [len(p) for p in packets]
        g = server.graph
        ok = (all(a < 0.10 for a in ates) and len(rmses) >= 2 and rms < 0.12 and dist < 0.15
              and g.loop_count >= 1 and min(n_pk) >= 8
              and all(cl.aligned for cl in g.clients[:len(seqs)]))
        print(json.dumps({"probe": "klt_seeds",
                          "package": str(Path(cvids_tpu_torch.__file__).parent), "card": smi,
                          "seed": seed, "ate_cm": [a * 100 for a in ates], "rms": rms, "mesh_m": dist, "loops": g.loop_count, "packets": n_pk,
                          "phase8_bounds_hold": ok}), flush=True)
        del seqs, fes, packets, server
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

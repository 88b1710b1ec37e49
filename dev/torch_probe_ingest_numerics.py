"""Phase 8 with the RANSAC linear algebra of the PnP and the essential pose
switched (`ops.ransac`'s `jacobi`): which calls the scores move with.

    python3 dev/torch_probe_ingest_numerics.py

Renders phase 8's seed-0 sequences once, then runs both agents' front-ends
and phase 8's server once a variant:

- "committed": as committed (the front-end's `pnp_ransac` in
  `_visual_pose_init` with `jacobi=False`, float32 LAPACK; its
  `essential_pose` and the server's cascade on the Jacobi kernel);
- "front-end pnp jacobi": the front-end's `pnp_ransac` with `jacobi=True`
  too (every call on the card's float64 Jacobi path);
- "front-end pnp+essential lapack": both of the front-end's calls with
  `jacobi=False` (the essential pose's 8-point F then float32 LAPACK too);
- "server dlt lapack": the server's cascade with `jacobi=False` (run
  eagerly: LAPACK waits for the card), the front-ends as committed.

The front-end's calls are switched through a stand-in for its `ransac`
module, so the server's cascade keeps its own. One JSON line a variant:
ATE sim3 per agent (cm), median inverse-depth RMS, mesh distance, loops,
packets, the front-ends' pre-init PnP and essential calls. About 5 minutes
on an H100.
"""

from __future__ import annotations

import contextlib
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    import chip_smoke as cs
    from cvids_tpu_torch import _build
    from cvids_tpu_torch.ops import ransac
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.server.pipeline import CollaborativeServer
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs
    from cvids_tpu_torch.vio import frontend

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    _build.load()
    cfg = cs.agent_config()
    dense = cs.agent_dense(cfg.camera)
    seqs = cs.agent_sequences(cfg)
    calls = {"pnp": 0, "essential": 0}

    def counted(name, fn, **fixed):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **{**kwargs, **fixed})
        return call

    variants = (("committed", {}, {}, False),
                ("front-end pnp jacobi", {"jacobi": True}, {}, False),
                ("front-end pnp+essential lapack", {"jacobi": False}, {"jacobi": False}, False),
                ("server dlt lapack", {}, {}, True))
    for name, pnp_kw, ess_kw, server_lapack in variants:
        calls.update(pnp=0, essential=0)
        frontend.ransac = types.SimpleNamespace(**{
            **vars(ransac), "pnp_ransac": counted("pnp", ransac.pnp_ransac, **pnp_kw),
            "essential_pose": counted("essential", ransac.essential_pose, **ess_kw)})
        try:
            fes, packets, _, _, _, _ = cs.agents_run(dev, seqs, cfg)
            server = CollaborativeServer(vocab.generic_vocabulary(10, 4, device=dev),
                                         cs.agent_pipeline_config(cfg.camera, dense), device=dev)
            if server_lapack:
                server.graph._jacobi = False
            for cid, fe in enumerate(fes):
                server.set_client_camera(cid, fe.cam)
            try:
                with disable_graphs() if server_lapack else contextlib.nullcontext():
                    for p in sorted([p for pk in packets for p in pk], key=lambda p: p.timestamp):
                        server.submit(p)
                        server.process()
                    server.optimize()
                torch.cuda.synchronize()
            finally:
                server.close()
        finally:
            frontend.ransac = ransac
        ates, rmses, _, dist, _ = cs.agents_score(server, seqs, cfg, dense.height, dense.width,
                                                  len(seqs))
        print(json.dumps({"variant": name, "ate_cm": [a * 100 for a in ates],
                          "rms": float(np.median(rmses)), "mesh_m": dist,
                          "loops": server.graph.loop_count,
                          "packets": [len(p) for p in packets],
                          "frontend_calls": dict(calls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

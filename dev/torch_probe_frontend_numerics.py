"""Phase 8 with the 8-point F's arithmetic switched: which eigensolver and
which precision the scores move with.

    python3 dev/torch_probe_frontend_numerics.py

Renders phase 8's seed-0 sequences once, then runs both agents' front-ends
and phase 8's server once a variant of `ransac._eight_point`:

- "fp64 jacobi": as committed, float64 through the Jacobi kernel, graphed;
- "fp64 library": the same float64 systems through torch.linalg.eigh
  (which waits for the card, so the front-end runs eagerly);
- "fp32 jacobi": the float64 systems rounded to float32 for the Jacobi
  kernel, graphed;
- "fp32 library": `jacobi=False`, the CPU's float32 arithmetic through
  torch.linalg (the JAX package's; eager).

The first two can differ only where a sample does not determine F (points
on one plane, a pure image translation: AᵀA's null space has more than one
dimension and the two eigensolvers pick different vectors of it). One JSON
line a variant: ATE sim3 per agent, median inverse-depth RMS, mesh
distance, loops, packets, track stats. About 8 minutes on an H100 (the
eager variants are the slow ones).
"""

from __future__ import annotations

import contextlib
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    import chip_smoke as cs
    from cvids_tpu_torch import _build
    from cvids_tpu_torch.ops import cuda_kernels as ck
    from cvids_tpu_torch.ops import ransac
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.server.pipeline import CollaborativeServer
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    _build.load()
    cfg = cs.agent_config()
    dense = cs.agent_dense(cfg.camera)
    seqs = cs.agent_sequences(cfg)
    eight_point, small_eigh = ransac._eight_point, ck.small_eigh

    def fp32(eigh):
        return lambda a: tuple(x.double() for x in eigh(a.float()))

    variants = (("fp64 jacobi", eight_point, small_eigh, False),
                ("fp64 library", eight_point, torch.linalg.eigh, True),
                ("fp32 jacobi", eight_point, fp32(small_eigh), False),
                ("fp32 library", functools.partial(eight_point, jacobi=False), small_eigh, True))
    for name, f, eigh, eager in variants:
        # the agents and the server's cascade both take the variant's F
        ransac._eight_point, ck.small_eigh = f, eigh
        try:
            with disable_graphs() if eager else contextlib.nullcontext():
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
        finally:
            ransac._eight_point, ck.small_eigh = eight_point, small_eigh
        ates, rmses, _, dist, _ = cs.agents_score(server, seqs, cfg, dense.height, dense.width,
                                                  len(seqs))
        print(json.dumps({"variant": name, "ate_cm": [a * 100 for a in ates],
                          "rms": float(np.median(rmses)), "mesh_m": dist,
                          "loops": server.graph.loop_count,
                          "packets": [len(p) for p in packets],
                          "track_stats": [fe.track_stats for fe in fes]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

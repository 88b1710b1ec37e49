"""How many sweeps the parallel-order Jacobi of `small_eig` needs, and how
close it comes to float64 `torch.linalg.eigh` on the path's inputs.

    python3 dev/torch_probe_small_eig.py [--device cpu|cuda] [--sweeps 10]

Runs the kernel's twin (`cuda_kernels.small_eig_rotate` /
`small_eigh_twin`, the kernel's operations in its order) in float64 on:
random positive semi-definite batches at n = 3..12; rank-deficient AᵀA
(degenerate 8-point samples: a repeated correspondence, a two-dimensional
null space, and coplanar points, three; a 12×12 with a one-dimensional
one); and the path's own systems
as `chip_smoke.py` phase 3 builds them (`eight_point_systems`,
`dlt_systems`). Prints one JSON line a case:

- `offdiag`: the largest over the batch of ‖off(A rotated)‖_F / ‖A‖_F
  after each sweep 0..N (the rotated matrix as the kernel holds it);
- `eig_rel`: max |λ - λ_ref| / max |λ_ref| against float64 eigh;
- `orth`: max |VᵀV - I|; `resid`: max ‖A V - V Λ‖_max / ‖A‖_max;
- `null`: for the rank-deficient cases, max ‖A v‖ / ‖A‖_F of the returned
  null vectors (the eigenvectors of the least eigenvalues);
- the same for the cyclic order that the kernel ran before (rows p < q in
  turn, one rotation at a time, through `small_eig_rotate`'s `schedule`),
  for comparison.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cvids_tpu_torch.ops import cuda_kernels as ck  # noqa: E402


def cyclic_rotate(a: torch.Tensor, sweeps: int):
    """The earlier kernel's order: every pair (p, q), p < q, row by row,
    one rotation a round."""
    n = a.shape[-1]
    return ck.small_eig_rotate(a, sweeps, [[(p, q)] for p in range(n) for q in range(p + 1, n)])


def offdiag(m: torch.Tensor, a: torch.Tensor) -> float:
    off = m - torch.diag_embed(torch.diagonal(m, dim1=-2, dim2=-1))
    return float((off.flatten(1).norm(dim=1) / a.flatten(1).norm(dim=1)).max())


def sorted_pairs(m: torch.Tensor, v: torch.Tensor):
    d = torch.diagonal(m, dim1=-2, dim2=-1)
    order = torch.argsort(d, dim=-1, stable=True)
    n = d.shape[-1]
    return d.gather(1, order), v.gather(2, order[:, None, :].expand(-1, n, n))


def accuracy(a: torch.Tensor, w: torch.Tensor, v: torch.Tensor, nullity: int) -> dict:
    wr = torch.linalg.eigh(a)[0]
    n = a.shape[-1]
    scale = wr.abs().amax(-1)
    out = {"eig_rel": float(((w - wr).abs().amax(-1) / scale).max()),
           "orth": float((v.transpose(-1, -2) @ v - torch.eye(n, dtype=a.dtype)).abs().max()),
           "resid": float(((a @ v - v * w[:, None, :]).abs().amax((-1, -2))
                           / a.abs().amax((-1, -2))).max())}
    if nullity:
        nv = v[..., :nullity]
        out["null"] = float(((a @ nv).flatten(1).norm(dim=1) / a.flatten(1).norm(dim=1)).max())
    return out


def cases(device) -> list:
    import chip_smoke as cs
    rng = np.random.default_rng(0)
    out = []
    for n in range(3, 13):
        x = torch.from_numpy(rng.normal(size=(128, n, n))).to(device)
        out.append((f"psd {n}x{n}", x @ x.transpose(-1, -2), 0))
    # degenerate 8-point samples, null space 2 or 3
    for kind in ("duplicate", "planar"):
        _, ata, nullity = cs.degenerate_eight_point_systems(rng, device, kind, k=128)
        out.append((f"{kind} 8-point AᵀA 9x9", ata, nullity))
    b = torch.from_numpy(rng.normal(size=(128, 11, 12))).to(device)
    out.append(("rank-11 AᵀA 12x12", b.transpose(-1, -2) @ b, 1))
    dev = torch.device(device)
    ata, ftf, _ = cs.eight_point_systems(np.random.default_rng(1), dev)
    out += [("phase 3 8-point AᵀA 9x9", ata, 0), ("phase 3 FᵀF 3x3", ftf, 0)]
    dlt_ata, dlt_mtm, _ = cs.dlt_systems(np.random.default_rng(1), dev)
    out += [("phase 3 DLT AᵀA 12x12", dlt_ata, 0), ("phase 3 DLT MᵀM 3x3", dlt_mtm, 0)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--sweeps", type=int, default=10)
    args = ap.parse_args()
    for what, a, nullity in cases(args.device):
        a = a.double().contiguous().cpu()
        row = {"case": what, "batch": a.shape[0], "n": a.shape[-1]}
        for order, rotate in (("round_robin", ck.small_eig_rotate), ("cyclic", cyclic_rotate)):
            row[order] = {"offdiag": [offdiag(rotate(a, k)[0], a) for k in range(args.sweeps + 1)]}
            for k in (5, 6, ck.SMALL_EIG_SWEEPS):
                row[order][f"at_{k}"] = accuracy(a, *sorted_pairs(*rotate(a, k)), nullity)
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())

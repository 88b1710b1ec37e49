"""Pyramidal Lucas-Kanade optical-flow tracking, batched over points (port of
``cvids_tpu/ops/klt.py``).

The agent front-end tracks features between frames as the reference's
`cv::calcOpticalFlowPyrLK` does: every LK iteration samples all N patches
with one gather, solves all N 2×2 systems in closed form and updates all
positions, with no per-feature loop. The JAX package runs the iterations as
one jitted `fori_loop`; here they are a Python loop of a fixed count whose
every step is a handful of batched tensor operations, with no read back to
the host (eagerly on a card this is launch-bound: ~40 small launches an
iteration). The template's zero-mean patch and the 2×2 inverse are computed
once per level; the two projections onto the gradients are one batched
product. The forward-backward check reuses the forward pass's pyramids.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .image import bilinear_sample, build_pyramid

__all__ = ["track_points", "TrackResult"]


class TrackResult(NamedTuple):
    xy: torch.Tensor        # (N, 2) tracked positions in the new image
    valid: torch.Tensor     # (N,) bool
    residual: torch.Tensor  # (N,) mean abs photometric error at convergence


def _patch_coords(radius: int, device) -> torch.Tensor:
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)   # (P, 2) as (x, y)


def track_points(img0: torch.Tensor, img1: torch.Tensor, xy0: torch.Tensor,
                 valid0: torch.Tensor | None = None,
                 radius: int = 10, levels: int = 3, iters: int = 10,
                 max_residual: float = 25.0,
                 min_eig: float = 1e-3,
                 init_xy: torch.Tensor | None = None,
                 fb_thresh: float | None = None) -> TrackResult:
    """Track (N, 2) points from img0 to img1.

    Window (2*radius+1)², `levels` pyramid levels, `iters` Gauss-Newton
    iterations per level. `init_xy` (N, 2) seeds the search at predicted
    positions (the VINS front-end's IMU-predicted flow). `fb_thresh` enables
    the forward-backward check: the tracked point is re-tracked img1 -> img0
    and must land within `fb_thresh` px of its start."""
    if valid0 is None:
        valid0 = torch.ones(xy0.shape[0], dtype=torch.bool, device=xy0.device)
    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)
    offs = _patch_coords(radius, xy0.device)
    res = _track(pyr0, pyr1, xy0, valid0, offs, radius, iters, max_residual, min_eig,
                 xy0 if init_xy is None else init_xy)
    if fb_thresh is None:
        return res
    back = _track(pyr1, pyr0, res.xy, res.valid, offs, radius, iters, max_residual,
                  min_eig, xy0)
    dist = torch.linalg.vector_norm(back.xy - xy0, dim=-1)
    ok = res.valid & back.valid & (dist < fb_thresh)
    return TrackResult(res.xy, ok, res.residual)


def _track(pyr0, pyr1, xy0, valid0, offs, radius, iters, max_residual, min_eig,
           init_xy) -> TrackResult:
    flow = init_xy - xy0
    n_pix = offs.shape[0]
    residual = torch.zeros(xy0.shape[0], dtype=torch.float32, device=xy0.device)
    conditioned = torch.ones(xy0.shape[0], dtype=torch.bool, device=xy0.device)
    # the half-pixel steps of the central differences, made on the device
    # (no host copy: the tracker is capturable in a CUDA graph)
    half = torch.zeros((2, 2), device=xy0.device)
    half.diagonal().fill_(0.5)
    ex, ey = half[0], half[1]

    for lvl in reversed(range(len(pyr0))):
        scale = 2.0 ** lvl
        i0, i1 = pyr0[lvl], pyr1[lvl]
        p0 = xy0 / scale
        coords0 = p0[:, None, :] + offs[None]                      # (N, P, 2)
        t = bilinear_sample(i0, coords0)                           # template (N, P)
        gx = bilinear_sample(i0, coords0 + ex) - bilinear_sample(i0, coords0 - ex)
        gy = bilinear_sample(i0, coords0 + ey) - bilinear_sample(i0, coords0 - ey)
        grad = torch.stack([gx, gy], dim=-1)                       # (N, P, 2)
        gram = grad.transpose(1, 2) @ grad                         # (N, 2, 2)
        gxx, gxy, gyy = gram[:, 0, 0], gram[:, 0, 1], gram[:, 1, 1]
        det = gxx * gyy - gxy * gxy
        trace = gxx + gyy
        mineig = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det, min=0.0))) * 0.5
        conditioned = conditioned & (mineig / n_pix > min_eig)
        inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, torch.zeros_like(det))
        # flow -= scale * inv(G) b, inv(G) = adj(G) / det
        step = torch.stack([torch.stack([gyy, -gxy], -1), torch.stack([-gxy, gxx], -1)], -2) \
            * (inv_det * scale)[:, None, None]
        t_zm = t - torch.mean(t, dim=1, keepdim=True)

        for _ in range(iters):
            w = bilinear_sample(i1, (p0 + flow / scale)[:, None, :] + offs[None])
            e = (w - torch.mean(w, dim=1, keepdim=True)) - t_zm    # (N, P)
            b = (e[:, None, :] @ grad)[:, 0]                       # (N, 2): sum gx e, sum gy e
            flow = flow - (step @ b[..., None])[..., 0]

        coords1 = (p0 + flow / scale)[:, None, :] + offs[None]
        residual = torch.mean(torch.abs(bilinear_sample(i1, coords1) - t), dim=1)

    xy1 = xy0 + flow
    h, w = pyr1[0].shape[-2:]
    inb = ((xy1[:, 0] >= radius) & (xy1[:, 0] <= w - 1 - radius)
           & (xy1[:, 1] >= radius) & (xy1[:, 1] <= h - 1 - radius))
    valid = valid0 & inb & conditioned & (residual < max_residual)
    return TrackResult(xy1, valid, residual)

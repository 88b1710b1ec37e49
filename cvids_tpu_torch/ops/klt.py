"""Pyramidal Lucas-Kanade optical-flow tracking, batched over points (port of
``cvids_tpu/ops/klt.py``).

The agent front-end tracks features between frames as the reference's
`cv::calcOpticalFlowPyrLK` does, every feature at once. The JAX package
compiles the forward (and backward) tracking into one program; here it is
one call of `cuda_kernels.klt_track` on the two images' pyramids: on the
card one kernel launch (one block a point, both directions and the
forward-backward gate), on the CPU its PyTorch twin. Building the pyramids
is plain PyTorch, a few launches an image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .image import build_pyramid

__all__ = ["track_points", "TrackResult"]


class TrackResult(NamedTuple):
    xy: torch.Tensor        # (N, 2) tracked positions in the new image
    valid: torch.Tensor     # (N,) bool
    residual: torch.Tensor  # (N,) mean abs photometric error at convergence


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
    from . import cuda_kernels

    if valid0 is None:
        valid0 = torch.ones(xy0.shape[0], dtype=torch.bool, device=xy0.device)
    if init_xy is None:
        init_xy = xy0
    pyr0 = [lv.contiguous() for lv in build_pyramid(img0, levels)]
    pyr1 = [lv.contiguous() for lv in build_pyramid(img1, levels)]
    xy, valid, residual = cuda_kernels.klt_track(
        pyr0, pyr1, xy0.to(torch.float32).contiguous(), valid0.to(torch.bool).contiguous(),
        init_xy.to(torch.float32).contiguous(), radius, iters, max_residual, min_eig, fb_thresh)
    return TrackResult(xy, valid, residual)

"""Pinhole + radial-tangential camera model, batched (port of
``cvids_tpu/camera/pinhole.py``).

A camera is a plain tuple of intrinsics (0-d tensors and a (4,) distortion
vector, all on one device) with vectorized project / lift operations. The
iterative undistortion is the fixed-count recursive scheme of
`ServerCamera::LiftProject` (`server_camera.cpp:21-59`), run on whole point
batches at once. `create` puts the intrinsics on the card unless the caller
names a device; points must live where the camera does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device

__all__ = ["PinholeCamera", "distort", "undistort_iterative"]


def as_scalars(device, dtype, *values):
    """Each value as a 0-d (or, for a sequence, 1-d) tensor on `device`."""
    return tuple(torch.as_tensor(v, dtype=dtype, device=device) for v in values)


class PinholeCamera(NamedTuple):
    """fx, fy, cx, cy scalars; dist = (k1, k2, p1, p2)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # (4,)
    width: int = 752
    height: int = 480

    @staticmethod
    def create(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0), width=752, height=480,
               dtype=torch.float32, device=None) -> "PinholeCamera":
        dev = resolve_device(device)
        return PinholeCamera(*as_scalars(dev, dtype, fx, fy, cx, cy, dist),
                             int(width), int(height))

    @property
    def k_matrix(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx]),
            torch.stack([z, self.fy, self.cy]),
            torch.stack([z, z, o]),
        ])

    def project(self, pts_cam: torch.Tensor) -> torch.Tensor:
        """Camera-frame 3D points (..., 3) -> distorted pixel coords (..., 2).

        Mirrors `ServerCamera::Project` (`server_camera.cpp:70-103`).
        """
        z = pts_cam[..., 2:3]
        norm = pts_cam[..., :2] / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
        return self.project_normalized(norm)

    def project_normalized(self, norm: torch.Tensor) -> torch.Tensor:
        """Normalized (undistorted) coords (..., 2) -> distorted pixels."""
        dn = norm + distort(norm, self.dist)
        return torch.stack(
            [self.fx * dn[..., 0] + self.cx, self.fy * dn[..., 1] + self.cy], dim=-1
        )

    def lift(self, px: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Pixel coords (..., 2) -> undistorted normalized coords (..., 2).

        Mirrors `ServerCamera::LiftProject` (`server_camera.cpp:21-59`):
        fixed-count recursive undistortion.
        """
        pd = torch.stack(
            [(px[..., 0] - self.cx) / self.fx, (px[..., 1] - self.cy) / self.fy],
            dim=-1,
        )
        return undistort_iterative(pd, self.dist, iters)

    def lift_to_ray(self, px: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Pixels -> unit-z rays (..., 3)."""
        n = self.lift(px, iters)
        return torch.cat([n, torch.ones_like(n[..., :1])], dim=-1)

    def in_view(self, px: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        """Boolean mask (...,) of pixels inside the image bounds."""
        return (
            (px[..., 0] >= margin)
            & (px[..., 0] <= self.width - 1 - margin)
            & (px[..., 1] >= margin)
            & (px[..., 1] <= self.height - 1 - margin)
        )


def distort(norm: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Additive radial-tangential distortion term d(p) with p normalized.

    Same polynomial as `ServerCamera::Distortion` (`server_camera.cpp:105-121`).
    """
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = norm[..., 0], norm[..., 1]
    mx2 = x * x
    my2 = y * y
    mxy = x * y
    rho2 = mx2 + my2
    rad = k1 * rho2 + k2 * rho2 * rho2
    dx = x * rad + 2.0 * p1 * mxy + p2 * (rho2 + 2.0 * mx2)
    dy = y * rad + 2.0 * p2 * mxy + p1 * (rho2 + 2.0 * my2)
    return torch.stack([dx, dy], dim=-1)


def undistort_iterative(pd: torch.Tensor, dist: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert `distort` by fixed-point iteration: u_{k+1} = pd - d(u_k)."""
    u = pd
    for _ in range(iters):
        u = pd - distort(u, dist)
    return u

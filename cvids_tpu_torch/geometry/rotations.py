"""Yaw-pitch-roll helpers of the 4-DoF solver (port of the matching functions
in ``cvids_tpu/geometry/rotations.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["ypr_to_r", "rot_z", "wrap_angle"]


def ypr_to_r(ypr: torch.Tensor) -> torch.Tensor:
    """(yaw, pitch, roll) radians -> R = Rz(y) Ry(p) Rx(r); `server_utility.h:158-183`."""
    y, p, r = torch.movedim(ypr, -1, 0)
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    m = torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return m.reshape(ypr.shape[:-1] + (3, 3))


def rot_z(yaw: torch.Tensor) -> torch.Tensor:
    """Rz(yaw) for (...,) yaw in radians."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    m = torch.stack([c, -s, z, s, c, z, z, z, o], dim=-1)
    return m.reshape(yaw.shape + (3, 3))


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))

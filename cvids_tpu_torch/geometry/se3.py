"""Batched rigid-body (SE(3)) transforms as (quat, translation) pairs (port
of ``cvids_tpu/geometry/se3.py``): a pose is a pair of ``q`` (..., 4) and
``t`` (..., 3) tensors."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rotations import (
    matrix_to_quat,
    quat_inverse,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
    so3_exp,
    so3_log,
)

__all__ = ["Pose", "pose_identity", "compose", "inverse", "between", "transform_points",
           "pose_from_matrix", "pose_to_matrix", "se3_exp", "se3_log"]


class Pose(NamedTuple):
    """Rigid transform: x_world = R(q) @ x_local + t."""

    q: torch.Tensor  # (..., 4) wxyz
    t: torch.Tensor  # (..., 3)

    @property
    def matrix(self) -> torch.Tensor:
        return pose_to_matrix(self)


def pose_identity(batch_shape=(), dtype=torch.float32, device=None) -> Pose:
    """The identity pose; tensors on `device` (None: torch's default, the
    CPU), as torch's own factories place them."""
    batch_shape = tuple(batch_shape)
    q = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device).expand(batch_shape + (4,))
    return Pose(q.clone(), torch.zeros(batch_shape + (3,), dtype=dtype, device=device))


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: apply b first, then a."""
    return Pose(quat_normalize(quat_multiply(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    qinv = quat_inverse(p.q)
    return Pose(qinv, -quat_rotate(qinv, p.t))


def between(a: Pose, b: Pose) -> Pose:
    """Relative pose a^{-1} ∘ b."""
    return compose(inverse(a), b)


def transform_points(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose to (..., 3) points (pose batch dims broadcast)."""
    return quat_rotate(p.q[..., None, :], pts) + p.t[..., None, :]


def pose_to_matrix(p: Pose) -> torch.Tensor:
    m = torch.zeros(p.q.shape[:-1] + (4, 4), dtype=p.q.dtype, device=p.q.device)
    m[..., :3, :3] = quat_to_matrix(p.q)
    m[..., :3, 3] = p.t
    m[..., 3, 3] = 1.0
    return m


def pose_from_matrix(m: torch.Tensor) -> Pose:
    return Pose(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def se3_exp(xi: torch.Tensor) -> Pose:
    """Exp map with (..., 6) = (rho, phi); first-order-coupled (V matrix) version."""
    rho, phi = xi[..., :3], xi[..., 3:]
    q = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-10
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-24))
    cross1 = _cross(phi, rho)
    cross2 = _cross(phi, cross1)
    return Pose(q, rho + a * cross1 + b * cross2)


def se3_log(p: Pose) -> torch.Tensor:
    """Log map -> (..., 6) = (rho, phi); inverse of `se3_exp`."""
    phi = so3_log(p.q)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-10
    half = 0.5 * theta
    # V^{-1} = I - 0.5 phî + c * phî², c = (1 - θ cot(θ/2)/2)/θ²
    cot_term = half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-24)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - cot_term) / torch.clamp(theta2, min=1e-24))
    cross1 = _cross(phi, p.t)
    cross2 = _cross(phi, cross1)
    rho = p.t - 0.5 * cross1 + c * cross2
    return torch.cat([rho, phi], dim=-1)

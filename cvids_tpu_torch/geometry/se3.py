"""Rigid-body (SE(3)) transforms as (quat, translation) pairs (port of
``Pose``, ``compose``, ``inverse`` and ``between`` in
``cvids_tpu/geometry/se3.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rotations import quat_inverse, quat_multiply, quat_normalize, quat_rotate

__all__ = ["Pose", "compose", "inverse", "between"]


class Pose(NamedTuple):
    """Rigid transform: x_world = R(q) @ x_local + t."""

    q: torch.Tensor  # (..., 4) wxyz
    t: torch.Tensor  # (..., 3)


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: apply b first, then a."""
    return Pose(quat_normalize(quat_multiply(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    qinv = quat_inverse(p.q)
    return Pose(qinv, -quat_rotate(qinv, p.t))


def between(a: Pose, b: Pose) -> Pose:
    """Relative pose a^{-1} ∘ b."""
    return compose(inverse(a), b)

"""4-DoF (yaw + translation) pose algebra (port of
``cvids_tpu/geometry/fourdof.py``).

The server's optimization runs in a reduced state space: per keyframe only
yaw and translation are free, pitch and roll are frozen at their VIO values.
A 4-DoF pose is ``(yaw, pitch_roll, t)`` where ``pitch_roll`` is a constant
per node.

All angles radians. Rotation convention R = Rz(yaw) Ry(pitch) Rx(roll).
"""

from __future__ import annotations

import torch

from .rotations import rot_z, wrap_angle, ypr_to_r

__all__ = [
    "fourdof_rotation",
    "relative_edge",
    "edge_residual",
    "apply_drift",
]


def fourdof_rotation(yaw: torch.Tensor, pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """R(yaw, pitch, roll) with yaw free, pitch/roll frozen."""
    return ypr_to_r(torch.stack([yaw, pitch, roll], dim=-1))


def relative_edge(yaw_i, pr_i, t_i, yaw_j, t_j):
    """Measured sequential edge between node i and j.

    Matches `FourDOFError` construction (`server_pose_graph.cpp:1527-1581`):
    relative translation expressed in frame i (using i's full rotation),
    relative yaw as a plain difference.

    Returns (t_ij (...,3), yaw_ij (...,)).
    """
    r_i = fourdof_rotation(yaw_i, pr_i[..., 0], pr_i[..., 1])
    t_ij = torch.einsum("...ij,...i->...j", r_i, t_j - t_i)  # R_i^T (t_j - t_i)
    return t_ij, wrap_angle(yaw_j - yaw_i)


def edge_residual(yaw_i, pr_i, t_i, yaw_j, t_j, t_ij_meas, yaw_ij_meas,
                  t_weight=1.0, yaw_weight=1.0):
    """Residual of a 4-DoF relative edge; mirrors `FourDOFError::operator()`
    (`server_pose_graph.h:313-401`).

    Returns (..., 4) residual [t_x, t_y, t_z, yaw] * weights.
    """
    t_pred, yaw_pred = relative_edge(yaw_i, pr_i, t_i, yaw_j, t_j)
    rt = (t_pred - t_ij_meas) * t_weight
    ry = wrap_angle(yaw_pred - yaw_ij_meas) * yaw_weight
    return torch.cat([rt, ry[..., None]], dim=-1)


def apply_drift(yaw_drift, t_drift, yaw, t):
    """Apply a yaw-only drift correction to poses, as the server does when it
    propagates optimization results to un-optimized keyframes
    (`server_pose_graph.cpp:1720-1796`):  t' = Rz(yaw_drift) t + t_drift,
    yaw' = yaw + yaw_drift.
    """
    r = rot_z(yaw_drift)
    t_new = torch.einsum("...ij,...j->...i", r, t) + t_drift
    return wrap_angle(yaw + yaw_drift), t_new

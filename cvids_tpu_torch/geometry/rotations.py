"""Rotation helpers (port of ``cvids_tpu/geometry/rotations.py``): batched
SO(3) / quaternion / Euler utilities, shape-polymorphic over leading batch
dimensions and differentiable (the small-angle branches are selected with
`where` over guarded values, so values and gradients at 0 stay finite).

Quaternions are ``(..., 4)`` tensors in ``(w, x, y, z)`` order (Hamilton
convention); rotation matrices are ``(..., 3, 3)``; ``ypr`` is
yaw-pitch-roll in radians with ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["ypr_to_r", "rot_z", "wrap_angle", "quat_normalize",
           "quat_multiply", "quat_conjugate", "quat_inverse", "quat_rotate",
           "quat_to_matrix", "matrix_to_quat", "quat_from_axis_angle", "so3_hat",
           "so3_exp", "so3_log", "r_to_ypr", "r_to_ypr_deg", "ypr_deg_to_r",
           "yaw_of", "quat_slerp", "g2r"]


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


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm, keeping w >= 0."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 (applies q2's rotation first)."""
    w1, x1, y1, z1 = torch.movedim(q1, -1, 0)
    w2, x2, y2, z2 = torch.movedim(q2, -1, 0)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    # no host-built constant: capturable in a CUDA graph
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse for unit quaternions (== conjugate)."""
    return quat_conjugate(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` (..., 3) by quaternion(s) ``q`` (..., 4)."""
    qvec = q[..., 1:]
    qvec, v = torch.broadcast_tensors(qvec, v)
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = torch.movedim(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w,x,y,z): branchless Shepperd's
    method, the best-conditioned of the four candidates (largest pivot)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)            # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_normalize(q)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors."""
    wx, wy, wz = torch.movedim(w, -1, 0)
    zeros = torch.zeros_like(wx)
    m = torch.stack([zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map R^3 -> SO(3) as quaternion (w,x,y,z), Taylor-safe at 0."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-10
    half = 0.5 * theta
    sin_half_over = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([cw, sin_half_over * w], dim=-1)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-12)
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) (unit quaternion) -> R^3, Taylor-safe at identity."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vec = q[..., 1:]
    sq = torch.sum(vec * vec, dim=-1, keepdim=True)
    small = sq < 1e-14                              # sin_half < 1e-7
    # the norm where the large branch uses it, 1 elsewhere: a norm's
    # derivative at 0 is NaN, and `where` passes a NaN gradient on even from
    # the branch it does not take
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = torch.atan2(sin_half, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12),
                        2.0 * half / torch.clamp(sin_half, min=1e-24))
    return scale * vec


def r_to_ypr(m: torch.Tensor) -> torch.Tensor:
    """R -> (yaw, pitch, roll) radians; mirrors `server_utility.h:70-85` math."""
    n, o, a = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    yaw = torch.atan2(n[..., 1], n[..., 0])
    pitch = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(yaw) + n[..., 1] * torch.sin(yaw))
    roll = torch.atan2(
        a[..., 0] * torch.sin(yaw) - a[..., 1] * torch.cos(yaw),
        -o[..., 0] * torch.sin(yaw) + o[..., 1] * torch.cos(yaw),
    )
    return torch.stack([yaw, pitch, roll], dim=-1)


def r_to_ypr_deg(m: torch.Tensor) -> torch.Tensor:
    return torch.rad2deg(r_to_ypr(m))


def ypr_deg_to_r(ypr_deg: torch.Tensor) -> torch.Tensor:
    return ypr_to_r(torch.deg2rad(ypr_deg))


def yaw_of(q_or_m: torch.Tensor) -> torch.Tensor:
    """Yaw (radians) of a rotation given as quaternion (...,4) or matrix (...,3,3)."""
    m = q_or_m if q_or_m.shape[-1] == 3 else quat_to_matrix(q_or_m)
    return torch.atan2(m[..., 1, 0], m[..., 0, 0])


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation, shortest arc, safe near q0==q1."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    # acos has an infinite slope at 1, where the small branch is taken: keep
    # the argument inside for the branch that is not
    sin_theta_sq = 1.0 - d * d
    small = sin_theta_sq < 1e-12                    # sin_theta < 1e-6
    theta = torch.acos(torch.where(small, torch.zeros_like(d), d))
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=d.dtype, device=d.device)
    if t.ndim < d.ndim:
        t = t[..., None]
    w0 = torch.where(small, 1.0 - t,
                     torch.sin((1.0 - t) * theta) / torch.clamp(sin_theta, min=1e-12))
    w1 = torch.where(small, t, torch.sin(t * theta) / torch.clamp(sin_theta, min=1e-12))
    return quat_normalize(w0 * q0 + w1 * q1)


def g2r(g: torch.Tensor) -> torch.Tensor:
    """Gravity-aligning rotation: R @ ĝ = (0,0,1) with zero yaw.

    Mirrors `server_utility.cpp` `g2R` (used by VIO initialization): rotate the
    normalized gravity estimate onto +z, then remove the induced yaw.
    """
    ng1 = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-12)
    ng2 = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device).expand(ng1.shape)
    axis = torch.linalg.cross(ng1, ng2)
    axis_norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    cosang = torch.clamp(torch.sum(ng1 * ng2, dim=-1), -1.0, 1.0)
    angle = torch.atan2(axis_norm[..., 0], cosang)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=g.dtype, device=g.device).expand(ng1.shape)
    safe_axis = torch.where(axis_norm > 1e-8, axis / torch.clamp(axis_norm, min=1e-12), x_axis)
    r0 = quat_to_matrix(quat_from_axis_angle(safe_axis, angle))
    yaw = yaw_of(r0)
    return rot_z(-yaw) @ r0

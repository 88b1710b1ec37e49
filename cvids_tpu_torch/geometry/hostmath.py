"""Batched NumPy rotation helpers for the server's host-side bookkeeping
(numpy-only port of ``cvids_tpu/geometry/hostmath.py``).

Drift application, yaw extraction and chain assembly in
``server/posegraph.py`` are host-side control logic over a few scalars per
keyframe; float64 numpy keeps them off the device. The functions mirror
``geometry.rotations`` (``server_utility.h:70-183`` semantics).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "quat_to_matrix_np", "matrix_to_quat_np", "yaw_of_quat_np",
    "r_to_ypr_np", "ypr_to_r_np", "rot_z_np", "wrap_angle_np",
]


def quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """(..., 4) unit quaternion (w,x,y,z) -> (..., 3, 3)."""
    q = np.asarray(q, np.float64)
    w, x, y, z = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = np.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat_np(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) (w,x,y,z); branchless Shepperd like the jnp twin."""
    m = np.asarray(m, np.float64)
    t = np.trace(m, axis1=-2, axis2=-1)
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    cand = np.stack([
        np.stack([1 + t,
                  m[..., 2, 1] - m[..., 1, 2],
                  m[..., 0, 2] - m[..., 2, 0],
                  m[..., 1, 0] - m[..., 0, 1]], axis=-1),
        np.stack([m[..., 2, 1] - m[..., 1, 2],
                  1 + m00 - m11 - m22,
                  m[..., 0, 1] + m[..., 1, 0],
                  m[..., 0, 2] + m[..., 2, 0]], axis=-1),
        np.stack([m[..., 0, 2] - m[..., 2, 0],
                  m[..., 0, 1] + m[..., 1, 0],
                  1 - m00 + m11 - m22,
                  m[..., 1, 2] + m[..., 2, 1]], axis=-1),
        np.stack([m[..., 1, 0] - m[..., 0, 1],
                  m[..., 0, 2] + m[..., 2, 0],
                  m[..., 1, 2] + m[..., 2, 1],
                  1 - m00 - m11 + m22], axis=-1),
    ], axis=-2)  # (..., 4 candidates, 4)
    pivots = np.stack([1 + t, 1 + m00 - m11 - m22,
                       1 - m00 + m11 - m22, 1 - m00 - m11 + m22], axis=-1)
    best = np.argmax(pivots, axis=-1)
    q = np.take_along_axis(cand, best[..., None, None].repeat(4, -1),
                           axis=-2)[..., 0, :]
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    # canonical sign: w >= 0
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def yaw_of_quat_np(q: np.ndarray) -> np.ndarray:
    """Yaw (radians) of (..., 4) quaternions — R[1,0], R[0,0] directly."""
    q = np.asarray(q, np.float64)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.arctan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))


def r_to_ypr_np(m: np.ndarray) -> np.ndarray:
    """R -> (yaw, pitch, roll) radians; mirrors `server_utility.h:70-85`."""
    m = np.asarray(m, np.float64)
    n, o, a = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    yaw = np.arctan2(n[..., 1], n[..., 0])
    pitch = np.arctan2(-n[..., 2],
                       n[..., 0] * np.cos(yaw) + n[..., 1] * np.sin(yaw))
    roll = np.arctan2(a[..., 0] * np.sin(yaw) - a[..., 1] * np.cos(yaw),
                      -o[..., 0] * np.sin(yaw) + o[..., 1] * np.cos(yaw))
    return np.stack([yaw, pitch, roll], axis=-1)


def ypr_to_r_np(ypr: np.ndarray) -> np.ndarray:
    """(yaw, pitch, roll) radians -> R = Rz Ry Rx; `server_utility.h:158-183`."""
    ypr = np.asarray(ypr, np.float64)
    y, p, r = np.moveaxis(ypr, -1, 0)
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    m = np.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], axis=-1)
    return m.reshape(ypr.shape[:-1] + (3, 3))


def rot_z_np(yaw) -> np.ndarray:
    yaw = np.asarray(yaw, np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    z = np.zeros_like(yaw)
    o = np.ones_like(yaw)
    m = np.stack([c, -s, z, s, c, z, z, z, o], axis=-1)
    return m.reshape(yaw.shape + (3, 3))


def wrap_angle_np(a):
    a = np.asarray(a, np.float64)
    return a - 2.0 * np.pi * np.floor((a + np.pi) / (2.0 * np.pi))

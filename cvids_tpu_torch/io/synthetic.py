"""Closed-form trajectories for synthetic worlds (the part of
``cvids_tpu/io/synthetic.py`` that the server's multi-agent streams use,
copied so that the port runs without the JAX package).

Smooth closed-form paths with a velocity-following heading: the ground truth
of the synthetic multi-agent streams (`io.multiagent`). The IMU sequences of
the JAX module belong to the VIO front-end, which is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

__all__ = ["Trajectory", "quat_from_matrix_np"]


def _normalize(v):
    return v / np.linalg.norm(v)


def _look_rotation(forward, up=np.array([0.0, 0.0, 1.0])):
    """World-from-body rotation with x = forward, z ≈ up (FLU body frame)."""
    x = _normalize(forward)
    y = _normalize(np.cross(up, x))
    z = np.cross(x, y)
    return np.stack([x, y, z], axis=1)


def quat_from_matrix_np(m):
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = np.argmax(np.diag(m))
    if i == 0:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif i == 1:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q if q[0] >= 0 else -q


@dataclass
class Trajectory:
    """Closed-form trajectory: position fn of t, heading from velocity."""

    pos_fn: Callable[[np.ndarray], np.ndarray]

    def pose(self, t: float | np.ndarray):
        t = np.atleast_1d(np.asarray(t, np.float64))
        eps = 1e-5
        p = self.pos_fn(t)
        v = (self.pos_fn(t + eps) - self.pos_fn(t - eps)) / (2 * eps)
        rs = np.stack([_look_rotation(vi) for vi in v])
        return p, rs, v

    @staticmethod
    def circle(radius=5.0, omega=0.4, height_amp=0.5, phase=0.0,
               center=(0.0, 0.0, 1.5), speed_mod=0.0, speed_mod_freq=0.9):
        """Circle with optional along-track speed modulation
        (a = omega*t + speed_mod*sin(f*t)), which makes metric scale
        observable to a visual-inertial front-end."""
        c = np.asarray(center)

        def f(t):
            a = omega * t + phase + speed_mod * np.sin(speed_mod_freq * t)
            return np.stack([
                c[0] + radius * np.cos(a),
                c[1] + radius * np.sin(a),
                c[2] + height_amp * np.sin(2 * a),
            ], axis=-1)

        return Trajectory(f)

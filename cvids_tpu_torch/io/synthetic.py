"""Synthetic visual-inertial worlds (copy of ``cvids_tpu/io/synthetic.py``,
numpy, so that the port runs without the JAX package).

Smooth closed-form paths with a velocity-following heading (the ground truth
of the synthetic multi-agent streams, `io.multiagent`), and one agent's
sequence on such a path: exact IMU (gyro/accel) measurements derived by
finite differences at the IMU rate with noise and bias, a landmark cloud and
its projected feature tracks (`generate_sequence`, `imu_slices`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

__all__ = ["Trajectory", "quat_from_matrix_np", "SyntheticSequence",
           "generate_sequence", "imu_slices", "GRAVITY_W"]

GRAVITY_W = np.array([0.0, 0.0, -9.81])


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


@dataclass
class SyntheticSequence:
    """One agent's ground truth + measurements."""

    times_kf: np.ndarray          # (K,) keyframe timestamps
    p_gt: np.ndarray              # (K, 3) body position (world)
    q_gt: np.ndarray              # (K, 4) body orientation (world<-body)
    v_gt: np.ndarray              # (K, 3)
    imu_t: np.ndarray             # (M,) imu timestamps (full sequence)
    gyr: np.ndarray               # (M, 3) measured (with noise+bias)
    acc: np.ndarray               # (M, 3)
    bg_true: np.ndarray           # (3,)
    ba_true: np.ndarray           # (3,)
    landmarks: np.ndarray         # (L, 3) world points
    obs: np.ndarray               # (K, L, 2) normalized image coords (NaN if unseen)
    vis: np.ndarray               # (K, L) bool visibility


def generate_sequence(
    traj: Trajectory,
    duration: float = 20.0,
    kf_rate: float = 2.0,
    imu_rate: float = 200.0,
    num_landmarks: int = 150,
    seed: int = 0,
    gyr_noise: float = 0.004,
    acc_noise: float = 0.08,
    bg: tuple = (0.003, -0.002, 0.004),
    ba: tuple = (0.02, -0.03, 0.05),
    pix_noise_norm: float = 0.5 / 460.0,
    fov_cos: float = 0.45,
    max_range: float = 18.0,
    landmark_box: float = 12.0,
) -> SyntheticSequence:
    rng = np.random.default_rng(seed)
    k = int(duration * kf_rate) + 1
    times_kf = np.arange(k) / kf_rate
    p_kf, r_kf, v_kf = traj.pose(times_kf)
    q_kf = np.stack([quat_from_matrix_np(r) for r in r_kf])

    # IMU: exact kinematics by central differences at imu rate
    m = int(duration * imu_rate) + 1
    imu_t = np.arange(m) / imu_rate
    eps = 1e-4
    p0, r0, v0 = traj.pose(imu_t)
    _, r_plus, v_plus = traj.pose(imu_t + eps)
    _, r_minus, v_minus = traj.pose(imu_t - eps)
    a_w = (v_plus - v_minus) / (2 * eps)
    # gyro: Log(R(t)^T R(t+eps))/eps (body rates)
    gyr_true = np.empty((m, 3))
    for i in range(m):
        dr = r_minus[i].T @ r_plus[i]
        # rotation vector of dr
        ang = np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1))
        if ang < 1e-12:
            w = np.zeros(3)
        else:
            w = ang / (2 * np.sin(ang)) * np.array(
                [dr[2, 1] - dr[1, 2], dr[0, 2] - dr[2, 0], dr[1, 0] - dr[0, 1]])
        gyr_true[i] = w / (2 * eps)
    acc_true = np.einsum("nij,nj->ni", r0.transpose(0, 2, 1), a_w - GRAVITY_W)

    bg = np.asarray(bg)
    ba = np.asarray(ba)
    gyr = gyr_true + bg + rng.normal(0, gyr_noise * np.sqrt(imu_rate), (m, 3))
    acc = acc_true + ba + rng.normal(0, acc_noise * np.sqrt(imu_rate), (m, 3))

    # landmarks around the trajectory volume
    center = p_kf.mean(axis=0)
    landmarks = center + rng.uniform(-landmark_box, landmark_box, (num_landmarks, 3))
    landmarks[:, 2] = np.abs(landmarks[:, 2]) * 0.3 + 0.2

    # observations: body x-axis is forward (camera optical axis = body x here;
    # we use an ideal normalized camera looking along +x with y left, z up ->
    # standard camera frame: z_cam = x_body, x_cam = -y_body, y_cam = -z_body)
    r_bc = np.array([[0.0, -1.0, 0.0],
                     [0.0, 0.0, -1.0],
                     [1.0, 0.0, 0.0]]).T  # body->cam rotation: x_cam = R_cb x_body
    obs = np.full((k, num_landmarks, 2), np.nan)
    vis = np.zeros((k, num_landmarks), bool)
    for i in range(k):
        pc_body = (landmarks - p_kf[i]) @ r_kf[i]  # world->body
        pc_cam = pc_body @ r_bc  # body->cam (note: transposed convention folded in)
        z = pc_cam[:, 2]
        rng_ok = (z > 0.3) & (np.linalg.norm(pc_cam, axis=1) < max_range)
        dir_cos = z / np.maximum(np.linalg.norm(pc_cam, axis=1), 1e-9)
        in_fov = dir_cos > fov_cos
        good = rng_ok & in_fov
        proj = pc_cam[:, :2] / np.maximum(z[:, None], 1e-9)
        proj += rng.normal(0, pix_noise_norm, proj.shape)
        obs[i, good] = proj[good]
        vis[i] = good

    return SyntheticSequence(times_kf, p_kf, q_kf, v_kf, imu_t, gyr, acc,
                             bg, ba, landmarks, obs, vis)


def imu_slices(seq: SyntheticSequence, max_samples: int = 128):
    """Per-keyframe-interval IMU sample blocks, padded to `max_samples`.

    Returns (gyr (K-1, S, 3), acc (K-1, S, 3), dts (K-1, S), valid (K-1, S)).
    """
    k = len(seq.times_kf)
    out_g = np.zeros((k - 1, max_samples, 3))
    out_a = np.zeros((k - 1, max_samples, 3))
    out_dt = np.zeros((k - 1, max_samples))
    out_v = np.zeros((k - 1, max_samples), bool)
    for i in range(k - 1):
        t0, t1 = seq.times_kf[i], seq.times_kf[i + 1]
        sel = (seq.imu_t >= t0) & (seq.imu_t < t1)
        idx = np.nonzero(sel)[0]
        n = min(len(idx), max_samples)
        out_g[i, :n] = seq.gyr[idx[:n]]
        out_a[i, :n] = seq.acc[idx[:n]]
        ts = seq.imu_t[idx[:n]]
        ts_next = np.append(ts[1:], t1)
        out_dt[i, :n] = ts_next - ts
        out_v[i, :n] = True
    return out_g, out_a, out_dt, out_v

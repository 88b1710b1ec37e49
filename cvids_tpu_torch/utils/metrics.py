"""Trajectory accuracy metrics: ATE RMSE with SE(3)/Sim(3)/yaw-only
alignment (copy of ``cvids_tpu/utils/metrics.py``, numpy, so that the port
runs without the JAX package). Umeyama alignment + RMSE, plus the yaw-only
variant matching the server's 4-DoF gauge freedom."""

from __future__ import annotations

import numpy as np

__all__ = ["umeyama", "ate_rmse", "align_yaw_t", "rpe"]


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform: dst ≈ s R src + t.

    Returns (s, r (3,3), t (3,)).
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    if with_scale:
        var = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(d) @ s_mat) / var
    else:
        s = 1.0
    t = mu_d - s * r @ mu_s
    return s, r, t


def align_yaw_t(src: np.ndarray, dst: np.ndarray):
    """Yaw-only rigid alignment (the 4-DoF gauge): dst ≈ Rz(yaw) src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    a = (xs[:, 0] * xd[:, 1] - xs[:, 1] * xd[:, 0]).sum()
    b = (xs[:, 0] * xd[:, 0] + xs[:, 1] * xd[:, 1]).sum()
    yaw = np.arctan2(a, b)
    c, s = np.cos(yaw), np.sin(yaw)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    t = mu_d - r @ mu_s
    return yaw, r, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: str = "se3") -> float:
    """ATE RMSE after alignment. align: 'none' | 'se3' | 'sim3' | 'yaw'."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if align == "se3":
        s, r, t = umeyama(est, gt, with_scale=False)
        est = (s * (est @ r.T)) + t
    elif align == "sim3":
        s, r, t = umeyama(est, gt, with_scale=True)
        est = (s * (est @ r.T)) + t
    elif align == "yaw":
        _, r, t = align_yaw_t(est, gt)
        est = est @ r.T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over `delta`-step pairs."""
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    return float(np.sqrt(np.mean(np.sum((d_est - d_gt) ** 2, axis=1))))

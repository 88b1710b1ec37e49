"""Visual-inertial initialization: gyro-bias calibration and linear gravity /
velocity / scale alignment (port of ``cvids_tpu/vio/initializer.py``).

The VINS bootstrap the reference's agents presume (`euroc_config.yaml:44-63`):
visual structure-from-motion gives up-to-scale poses, then (1) the gyro bias
is calibrated by matching visual relative rotations against the IMU's
preintegrated rotations, and (2) a linear system recovers per-keyframe
velocity, the gravity direction and metric scale. Both are fixed-shape
masked least squares on the inputs' device; the JAX package's per-interval
`vmap`s of `dynamic_update_slice` become one batched assembly, and its
4-step `lax.scan` refinement a loop of 4. The solves use `solve_ex`, which
reads nothing back to the host, and no constant is copied from the host:
the front-end replays both functions as CUDA graphs.

Inputs are body-frame window poses (any consistent up-to-scale frame) and
the stacked `Preintegrated` deltas between consecutive keyframes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import quat_inverse, quat_multiply, quat_to_matrix
from .imu import Preintegrated

__all__ = ["calibrate_gyro_bias", "linear_alignment", "AlignmentResult"]


class AlignmentResult(NamedTuple):
    scale: torch.Tensor        # () metric scale of the visual positions
    gravity: torch.Tensor      # (3,) gravity vector in the visual world frame
    v: torch.Tensor            # (K, 3) world-frame velocities
    ok: torch.Tensor           # () bool: well-conditioned & scale positive
    g_free_norm: torch.Tensor  # () |g| of the free solve, the VINS quality gate
    # (`fabs(g.norm() - G.norm()) > 1.0` fails initialization)


def _solve(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(h, b[:, None])[0][:, 0]


def calibrate_gyro_bias(q_wb: torch.Tensor, pre: Preintegrated,
                        valid: torch.Tensor) -> torch.Tensor:
    """Gyro bias from visual vs preintegrated relative rotations.

    q_wb: (K, 4) visual body orientations; pre: stacked (K-1, ...)
    preintegrations at their linearization biases; valid: (K-1,) bool.
    Solves the VINS `solveGyroscopeBias` normal equations linearized at the
    preintegration bias and returns bg_lin + δbg (bg_lin the valid
    intervals' mean linearization bias)."""
    q_rel = quat_multiply(quat_inverse(q_wb[:-1]), q_wb[1:])          # (K-1, 4)
    err = quat_multiply(quat_inverse(pre.dq), q_rel)
    r = 2.0 * err[:, 1:] * torch.sign(err[:, :1])                    # small-angle vec
    w = valid.to(q_wb.dtype)
    a = pre.j_q_bg
    ata = torch.einsum("i,iba,ibc->ac", w, a, a)
    atb = torch.einsum("i,iba,ib->a", w, a, r)
    h = ata + 1e-8 * torch.eye(3, dtype=a.dtype, device=a.device)
    dbg = _solve(h, atb)
    bg_lin = torch.sum(pre.bg * w[:, None], dim=0) / torch.clamp(torch.sum(w), min=1.0)
    return bg_lin + dbg


def _alignment_system(p_vis, q_wb, pre, valid, k):
    """Masked normal equations for x = [v_0..v_{K-1} (3K), g (3), s (1)].

    Per interval i (VINS `LinearAlignment`, world-frame form):
      s·(p̄_{i+1} − p̄_i) = v_i Δt + ½ g Δt² + R_i Δp_i
      v_{i+1} − v_i = g Δt + R_i Δv_i
    """
    dev, f32 = p_vis.device, p_vis.dtype
    m = k - 1
    dt = pre.dt[:, None, None]                                       # (M, 1, 1)
    eye = torch.eye(3, dtype=f32, device=dev).expand(m, 3, 3)
    zero = torch.zeros_like(eye)
    ids = torch.arange(m, device=dev)
    sel_i = torch.nn.functional.one_hot(ids, k).to(f32)              # (M, K)
    sel_next = torch.nn.functional.one_hot(ids + 1, k).to(f32)
    v_cols = (torch.einsum("ik,irc->irkc", sel_i, torch.cat([-dt * eye, -eye], 1))
              + torch.einsum("ik,irc->irkc", sel_next, torch.cat([zero, eye], 1)))
    g_cols = torch.cat([-0.5 * dt * dt * eye, -dt * eye], 1)         # (M, 6, 3)
    s_col = torch.cat([p_vis[1:] - p_vis[:-1], torch.zeros_like(p_vis[1:])], 1)
    a = torch.cat([v_cols.reshape(m, 6, 3 * k), g_cols, s_col[..., None]], -1)   # (M, 6, n)
    r_k = quat_to_matrix(q_wb[:-1])
    b = torch.cat([(r_k @ pre.dp[..., None])[..., 0], (r_k @ pre.dv[..., None])[..., 0]], -1)
    w = valid.to(f32)
    return (torch.einsum("i,irn,irm->nm", w, a, a), torch.einsum("i,irn,ir->n", w, a, b))


def linear_alignment(p_vis: torch.Tensor, q_wb: torch.Tensor, pre: Preintegrated,
                     valid: torch.Tensor, gravity_mag: float = 9.81) -> AlignmentResult:
    """Velocity / gravity / scale from up-to-scale visual poses + IMU.

    p_vis: (K, 3) up-to-scale body positions; q_wb: (K, 4) body orientations;
    pre: stacked (K-1, ...) preintegrations; valid: (K-1,) bool. A
    free-gravity linear solve, then gravity refined on the ‖g‖ = 9.81
    sphere (4 rounds of a 2-DoF tangent re-solve, VINS `RefineGravity`). The
    visual frame is not rotated here."""
    dev, f32 = p_vis.device, p_vis.dtype
    k = p_vis.shape[0]
    n = 3 * k + 4
    ata, atb = _alignment_system(p_vis, q_wb, pre, valid, k)
    h = ata + 1e-6 * torch.eye(n, dtype=f32, device=dev)
    x = _solve(h, atb)
    g0 = x[3 * k:3 * k + 3]

    axes = torch.eye(3, dtype=f32, device=dev)        # made on the device: no host copy
    up, ex = axes[2], axes[0]
    eye_y = torch.eye(n - 1, dtype=f32, device=dev)
    g, y = g0, None
    for _ in range(4):
        ghat = g / torch.clamp(torch.linalg.vector_norm(g), min=1e-9)
        tmp = torch.where(torch.abs(ghat[2]) < 0.9, up, ex)
        b1 = torch.linalg.cross(ghat, tmp)
        b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1), min=1e-9)
        b2 = torch.linalg.cross(ghat, b1)
        bmat = torch.stack([b1, b2], dim=1)                           # (3, 2)
        # substitute g = m ĝ + B w: variables y = [v (3K), w (2), s (1)]
        t = torch.zeros((n, n - 1), dtype=f32, device=dev)
        t[:3 * k, :3 * k] = torch.eye(3 * k, dtype=f32, device=dev)
        t[3 * k:3 * k + 3, 3 * k:3 * k + 2] = bmat
        t[3 * k + 3:3 * k + 4, 3 * k + 2:3 * k + 3].fill_(1.0)   # a kernel, not a host copy
        c = torch.zeros(n, dtype=f32, device=dev)
        c[3 * k:3 * k + 3] = gravity_mag * ghat
        y = _solve(t.T @ h @ t + 1e-8 * eye_y, t.T @ (atb - ata @ c))
        g = gravity_mag * ghat + bmat @ y[3 * k:3 * k + 2]
    s = y[3 * k + 2]
    ok = (s > 1e-3) & torch.isfinite(s) & (torch.sum(valid) >= 3)
    return AlignmentResult(scale=s, gravity=g, v=y[:3 * k].reshape(k, 3), ok=ok,
                           g_free_norm=torch.linalg.vector_norm(g0))

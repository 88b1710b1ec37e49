"""IMU preintegration, VINS-style (port of ``cvids_tpu/vio/imu.py``).

Midpoint preintegration of gyro/accel samples between keyframes, with
first-order bias Jacobians and covariance propagation: the inputs of the
sliding-window BA's IMU factors. Gravity g_w = (0, 0, -9.81) in the world;
the accelerometer measures specific force in the body frame; quaternions are
(w, x, y, z).

The JAX module runs the recursion as a `lax.scan`, one step a sample. Run
eagerly on a card that is ~40 small launches a sample, ~10,000 for the
front-end's 256-sample buffer, so the port evaluates the same recursion in
closed form with scans of logarithmic depth:

- rotation: the inclusive prefix product of the per-step quaternions
  (Hillis-Steele, log2 N rounds of one batched 4x4 product), normalized after
  each round;
- velocity, position and the bias Jacobians: cumulative sums; the rotation
  Jacobian J_{k+1} = Rh_kᵀ J_k - dt_k I has the solution
  J_k = -Rc_kᵀ Σ_{j<k} dt_j Rc_{j+1}, Rc_k the rotation before step k;
- covariance: a tree reduction of the affine steps cov -> F cov Fᵀ + Q,
  (F_a, Q_a) then (F_b, Q_b) giving (F_b F_a, F_b Q_a F_bᵀ + Q_b).

The results equal the recursion's up to float32 rounding. Every function
takes leading batch dimensions (one preintegration per interval) and
allocates on its inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import (quat_inverse, quat_multiply, quat_normalize,
                        quat_to_matrix, so3_exp, so3_hat, so3_log)

__all__ = ["ImuNoise", "Preintegrated", "preintegrate", "imu_residual",
           "bias_corrected", "stack_preintegrated", "GRAVITY"]

GRAVITY = torch.tensor([0.0, 0.0, -9.81])


class ImuNoise(NamedTuple):
    """Continuous-time noise densities (EuRoC defaults from the reference
    config `euroc_config.yaml:58-62`)."""

    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 0.00004
    gyr_w: float = 2.0e-6


class Preintegrated(NamedTuple):
    """Preintegrated IMU between two keyframes, at linearization biases
    (leading batch dimensions allowed on every field)."""

    dp: torch.Tensor        # (3,) alpha: position delta in frame i
    dv: torch.Tensor        # (3,) beta: velocity delta in frame i
    dq: torch.Tensor        # (4,) gamma: rotation delta i->j
    dt: torch.Tensor        # () total time
    j_p_bg: torch.Tensor    # (3,3) d dp / d gyro bias
    j_p_ba: torch.Tensor    # (3,3) d dp / d accel bias
    j_v_bg: torch.Tensor    # (3,3)
    j_v_ba: torch.Tensor    # (3,3)
    j_q_bg: torch.Tensor    # (3,3) d Log(dq) / d gyro bias
    sqrt_info: torch.Tensor  # (9,9) sqrt information of the [p, q, v] residual
    bg: torch.Tensor        # (3,) linearization gyro bias
    ba: torch.Tensor        # (3,) linearization accel bias


def stack_preintegrated(pres) -> Preintegrated:
    """Stack a sequence of `Preintegrated` into one with a leading axis."""
    return Preintegrated(*(torch.stack(xs) for xs in zip(*pres)))


def _quat_left(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 16), the rows of L(q) with q1 ⊗ q2 = L(q1) q2
    (no constant tensor from the host: capturable in a CUDA graph)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([w, -x, -y, -z, x, w, -z, y, y, z, w, -x, z, -y, x, w], -1)


def _quat_prefix(h: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products h_0 ⊗ ... ⊗ h_k along axis -2 of (B, N, 4),
    normalized (w >= 0) after each of the log2 N rounds."""
    b, n = h.shape[:2]
    s = 1
    while s < n:
        left = _quat_left(h[:, :-s])                                   # L(h_{i-s})
        prod = (left.reshape(b, n - s, 4, 4) @ h[:, s:, :, None])[..., 0]
        h = torch.cat([h[:, :s], quat_normalize(prod)], dim=1)
        s *= 2
    return h


def _mv(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (m @ x[..., None])[..., 0]


def _exclusive(c: torch.Tensor) -> torch.Tensor:
    """Exclusive form of a cumulative sum along axis 1."""
    return torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)


def preintegrate(gyr: torch.Tensor, acc: torch.Tensor, dts: torch.Tensor,
                 bg: torch.Tensor, ba: torch.Tensor,
                 noise: ImuNoise = ImuNoise(),
                 sample_valid: torch.Tensor | None = None) -> Preintegrated:
    """Midpoint preintegration over (..., N, 3) gyro/accel samples with
    (..., N) dts; bg, ba (3,) or (..., 3). `sample_valid` masks padding
    samples (their dt counts as 0). A padded buffer's last valid sample
    pairs with the first padding sample, as in the JAX module."""
    batch = gyr.shape[:-2]
    n = gyr.shape[-2]
    dev, f32 = gyr.device, gyr.dtype
    g = gyr.reshape(-1, n, 3)
    a = acc.reshape(-1, n, 3)
    dt = dts.reshape(-1, n).to(f32)
    b = g.shape[0]
    if sample_valid is not None:
        dt = torch.where(sample_valid.reshape(-1, n), dt, torch.zeros((), dtype=f32, device=dev))
    bg_b = torch.broadcast_to(bg, batch + (3,)).reshape(b, 1, 3)
    ba_b = torch.broadcast_to(ba, batch + (3,)).reshape(b, 1, 3)
    g_unb = g - bg_b
    a_unb = a - ba_b
    # the last sample's rate is halved, as the JAX module's
    # `0.5 * (g + roll(g)).at[-1].set(g[-1])` evaluates (`.at` binds first)
    w_mid = 0.5 * torch.cat([g_unb[:, :-1] + g_unb[:, 1:], g_unb[:, -1:]], dim=1)
    a0 = a_unb
    a1 = torch.cat([a_unb[:, 1:], a_unb[:, -1:]], dim=1)

    # rotation before (r0) and after (r1) each step
    q_after = _quat_prefix(so3_exp(w_mid * dt[..., None]))
    ident = torch.nn.functional.pad(torch.ones((b, 1, 1), dtype=f32, device=dev), (0, 3))
    r0 = quat_to_matrix(torch.cat([ident, q_after[:, :-1]], dim=1))
    r1 = quat_to_matrix(q_after)
    dtv = dt[..., None]
    dtm = dt[..., None, None]

    a_w = 0.5 * (_mv(r0, a0) + _mv(r1, a1))
    dv_all = torch.cumsum(a_w * dtv, dim=1)
    dp = torch.sum(_exclusive(dv_all) * dtv + 0.5 * a_w * dtv * dtv, dim=1)

    # bias Jacobians
    s_incl = torch.cumsum(dtm * r1, dim=1)
    jq_old = -(r0.transpose(-1, -2) @ _exclusive(s_incl))
    jq_new = -(r1.transpose(-1, -2) @ s_incl)
    a0_hat = so3_hat(a0)
    a1_hat = so3_hat(a1)
    da_dbg = -0.5 * (r0 @ a0_hat @ jq_old + r1 @ a1_hat @ jq_new)
    da_dba = -0.5 * (r0 + r1)
    jv_bg_all = torch.cumsum(da_dbg * dtm, dim=1)
    jv_ba_all = torch.cumsum(da_dba * dtm, dim=1)
    jp_bg = torch.sum(_exclusive(jv_bg_all) * dtm + 0.5 * da_dbg * dtm * dtm, dim=1)
    jp_ba = torch.sum(_exclusive(jv_ba_all) * dtm + 0.5 * da_dba * dtm * dtm, dim=1)

    # covariance on [dp, dtheta, dv]: per-step F and noise, tree-reduced
    i3 = torch.eye(3, dtype=f32, device=dev)
    rot_step = i3 - so3_hat(w_mid) * dtm
    a_term = r0 @ a0_hat + r1 @ a1_hat @ rot_step
    z3 = torch.zeros_like(r0)
    eye_n = i3.expand_as(r0)
    f = torch.cat([torch.cat([eye_n, -0.25 * a_term * dtm * dtm, eye_n * dtm], -1),
                   torch.cat([z3, rot_step, z3], -1),
                   torch.cat([z3, -0.5 * a_term * dtm, eye_n], -1)], -2)       # (B, N, 9, 9)
    r_mid = 0.5 * (r0 + r1)
    g_mat = torch.cat([torch.cat([r_mid * 0.5 * dtm * dtm, z3], -1),
                       torch.cat([z3, eye_n * dtm], -1),
                       torch.cat([r_mid * dtm, z3], -1)], -2)                 # (B, N, 9, 6)
    q_diag = torch.cat([torch.full((3,), noise.acc_n ** 2, dtype=f32, device=dev),
                        torch.full((3,), noise.gyr_n ** 2, dtype=f32, device=dev)])
    q = (g_mat * q_diag / torch.clamp(dtm, min=1e-9)) @ g_mat.transpose(-1, -2)
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:       # identity steps pad the tree
        f = torch.cat([f, torch.eye(9, dtype=f32, device=dev).expand(b, width - n, 9, 9)], 1)
        q = torch.cat([q, torch.zeros((b, width - n, 9, 9), dtype=f32, device=dev)], 1)
    while f.shape[1] > 1:
        fa, fb = f[:, 0::2], f[:, 1::2]
        q = fb @ q[:, 0::2] @ fb.transpose(-1, -2) + q[:, 1::2]
        f = fb @ fa
    eye9 = torch.eye(9, dtype=f32, device=dev)
    f_tot = f[:, 0]
    cov = (f_tot * 1e-12) @ f_tot.transpose(-1, -2) + q[:, 0] + eye9 * 1e-10
    # sqrt information inv(chol(cov)); cholesky_ex: no error check on the host
    chol = torch.linalg.cholesky_ex(cov)[0]
    sqrt_info = torch.linalg.solve_triangular(chol, eye9.expand_as(cov), upper=False)

    def out(x, tail):
        return x.reshape(batch + tail)

    return Preintegrated(
        out(dp, (3,)), out(dv_all[:, -1], (3,)), out(q_after[:, -1], (4,)),
        out(torch.sum(dt, dim=1), ()),
        out(jp_bg, (3, 3)), out(jp_ba, (3, 3)),
        out(jv_bg_all[:, -1], (3, 3)), out(jv_ba_all[:, -1], (3, 3)),
        out(jq_new[:, -1], (3, 3)), out(sqrt_info, (9, 9)),
        out(bg_b[:, 0], (3,)), out(ba_b[:, 0], (3,)))


def imu_residual(pre: Preintegrated,
                 p_i, q_i, v_i, bg_i, ba_i,
                 p_j, q_j, v_j, bg_j, ba_j,
                 gravity: torch.Tensor | None = None,
                 weight_bias: float = 1.0) -> torch.Tensor:
    """15-D IMU factor residual [r_p(3), r_q(3), r_v(3), r_bg(3), r_ba(3)]
    (leading batch dimensions allowed). The [p, q, v] block is whitened by
    the preintegration's sqrt-information, the bias random walk by the
    scalar `weight_bias`."""
    # gravity made on the device (no host copy: capturable in a CUDA graph)
    grav = (torch.nn.functional.pad(torch.full((1,), -9.81, dtype=p_i.dtype, device=p_i.device),
                                    (2, 0)) if gravity is None else gravity)
    dt = pre.dt[..., None]
    dbg = bg_i - pre.bg
    dba = ba_i - pre.ba
    r_iw = quat_to_matrix(quat_inverse(q_i))

    dp_corr = pre.dp + _mv(pre.j_p_bg, dbg) + _mv(pre.j_p_ba, dba)
    dv_corr = pre.dv + _mv(pre.j_v_bg, dbg) + _mv(pre.j_v_ba, dba)
    dq_corr = quat_multiply(pre.dq, so3_exp(_mv(pre.j_q_bg, dbg)))

    r_p = _mv(r_iw, p_j - p_i - v_i * dt - 0.5 * grav * dt * dt) - dp_corr
    r_v = _mv(r_iw, v_j - v_i - grav * dt) - dv_corr
    r_q = so3_log(quat_multiply(quat_inverse(dq_corr),
                                quat_multiply(quat_inverse(q_i), q_j)))
    r_pqv = _mv(pre.sqrt_info, torch.cat([r_p, r_q, r_v], dim=-1))
    r_bias = torch.cat([bg_j - bg_i, ba_j - ba_i], dim=-1) * weight_bias
    return torch.cat([r_pqv, r_bias], dim=-1)


def bias_corrected(pre: Preintegrated, bg: torch.Tensor,
                   ba: torch.Tensor) -> Preintegrated:
    """First-order re-linearization of the deltas at a new bias pair (the
    correction `imu_residual` applies inside the residual), for consumers
    that need the deltas themselves, e.g. the VI bootstrap's alignment."""
    dbg = bg - pre.bg
    dba = ba - pre.ba
    return pre._replace(
        dp=pre.dp + _mv(pre.j_p_bg, dbg) + _mv(pre.j_p_ba, dba),
        dv=pre.dv + _mv(pre.j_v_bg, dbg) + _mv(pre.j_v_ba, dba),
        dq=quat_normalize(quat_multiply(pre.dq, so3_exp(_mv(pre.j_q_bg, dbg)))),
        bg=torch.broadcast_to(bg, pre.bg.shape), ba=torch.broadcast_to(ba, pre.ba.shape))

"""Sliding-window visual-inertial bundle adjustment (port of
``cvids_tpu/vio/window_ba.py``).

Fixed-capacity state tensors with validity masks, the whole factor graph
evaluated as batched residual functions, and Levenberg-Marquardt with a
fixed iteration count whose accept/reject is a `torch.where` on the carried
state: nothing inside the loop reads a value back to the host.

States per keyframe: p, q, v, bg, ba (15 DoF on-manifold, q ⊗ Exp(dθ));
landmarks are 3-D world points. Factors: masked Huber reprojection, IMU
preintegration (`imu.imu_residual`), an optional linearized prior from
marginalization, weak bias priors and anchors that pin the gauge (first
position + yaw).

Jacobians. The front-end's solver, `solve_window_fast`, eliminates the
landmarks exactly (Schur complement on 3×3 blocks): the reprojection
Jacobians are closed form, per observation a 2×6 pose block and a 2×3
landmark block (Huber weight included), held to `torch.func.jacfwd` in the
tests; the camera-only factors (IMU, anchors, bias priors, prior) are
differentiated by `torch.func.jacfwd` over the 15K camera tangent. The
camera-only marginalization (`marginalize_prior_cam`) assembles its normal
equations the same way (`marg_normal_equations`), held to `jacfwd` over the
whole tangent in the tests, and eliminates the landmarks block by block.
The full-tangent marginalization and the dense and Schur reference solvers
differentiate by `jacfwd` over a flat tangent, in the JAX package's
`ravel_pytree` order (dba, dbg, dlm, dp, dth, dv) for the full tangent and
[dp, dth, dv, dbg, dba] for the camera tangent. Positive-definite solves use `cholesky_ex`; a
failed factorization gives a NaN step, which the cost test rejects, as the
JAX package's Cholesky does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..geometry import (quat_inverse, quat_multiply, quat_normalize,
                        quat_to_matrix, so3_exp, so3_hat, so3_log, yaw_of)
from ..ops import cuda_kernels
from .imu import Preintegrated, imu_residual

__all__ = ["WindowState", "WindowMeasurements", "PriorFactor",
           "CamPriorFactor", "solve_window", "solve_window_schur",
           "solve_window_fast", "triangulate", "reprojection_residuals",
           "reprojection_jacobians", "landmark_quality",
           "marginalize_prior", "marginalize_prior_cam", "marg_normal_equations",
           "marg_schur_cam", "sqrt_prior", "retract", "retract_cam"]


class WindowState(NamedTuple):
    p: torch.Tensor         # (K, 3)
    q: torch.Tensor         # (K, 4)
    v: torch.Tensor         # (K, 3)
    bg: torch.Tensor        # (K, 3)
    ba: torch.Tensor        # (K, 3)
    lm: torch.Tensor        # (L, 3) world landmarks
    kf_valid: torch.Tensor  # (K,) bool
    lm_valid: torch.Tensor  # (L,) bool


class PriorFactor(NamedTuple):
    """Linearized prior: r(dx) = j @ dx + r0, dx = state ⊖ x_lin over the
    full flat tangent."""

    j: torch.Tensor     # (P, D)
    r0: torch.Tensor    # (P,)
    p: torch.Tensor     # linearization point
    q: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    lm: torch.Tensor


class CamPriorFactor(NamedTuple):
    """Camera-only linearized prior: r(dc) = j @ dc + r0 with dc the 15K
    camera tangent in [dp, dth, dv, dbg, dba] block order (each block K x 3
    row-major). The VINS marginalization design
    (`marginalization_factor.cpp`): the prior never spans landmarks, so the
    window solve's H_ll stays 3x3 block-diagonal."""

    j: torch.Tensor     # (P, 15K)
    r0: torch.Tensor    # (P,)
    p: torch.Tensor     # linearization camera states
    q: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor


class WindowMeasurements(NamedTuple):
    obs: torch.Tensor         # (K, L, 2) normalized camera coords
    vis: torch.Tensor         # (K, L) bool
    pre: Preintegrated        # stacked (K-1, ...) preintegrated IMU factors
    pre_valid: torch.Tensor   # (K-1,) bool
    r_cb: torch.Tensor        # (3, 3) body->camera rotation (x_cam = R_cb x_body)
    p_bc: torch.Tensor        # (3,) camera origin in body frame
    pix_weight: float         # 1 / sigma of normalized-coordinate noise
    huber_delta: float        # Huber threshold on the whitened residual norm
    bias_weight: float        # whitening of the bias random-walk residual
    prior: PriorFactor | CamPriorFactor | None
    anchor_p: torch.Tensor    # (3,) gauge: pin p[0] here
    anchor_yaw: torch.Tensor  # () gauge: pin the yaw of q[0] here
    # weak absolute bias priors (1/sigma): bound a free accelerometer bias so
    # it cannot absorb the specific force and collapse monocular scale
    ba_prior_weight: float = 10.0   # sigma 0.1 m/s^2
    bg_prior_weight: float = 100.0  # sigma 0.01 rad/s


# the JAX package's ravel_pytree order of the full tangent (sorted dict keys)
_FULL_KEYS = ("dba", "dbg", "dlm", "dp", "dth", "dv")


def _unravel(flat: torch.Tensor, k: int, l: int) -> dict:
    out, off = {}, 0
    for key in _FULL_KEYS:
        n = l if key == "dlm" else k
        out[key] = flat[off:off + 3 * n].reshape(n, 3)
        off += 3 * n
    return out


def _ravel(delta: dict) -> torch.Tensor:
    return torch.cat([delta[key].reshape(-1) for key in _FULL_KEYS])


def retract(state: WindowState, delta: dict) -> WindowState:
    """Apply a tangent update: q' = q ⊗ Exp(dθ), everything else additive."""
    return state._replace(
        p=state.p + delta["dp"],
        q=quat_normalize(quat_multiply(state.q, so3_exp(delta["dth"]))),
        v=state.v + delta["dv"],
        bg=state.bg + delta["dbg"],
        ba=state.ba + delta["dba"],
        lm=state.lm + delta["dlm"])


def _cam_delta(dc: torch.Tensor, k: int) -> dict:
    return dict(dp=dc[0:3 * k].reshape(k, 3), dth=dc[3 * k:6 * k].reshape(k, 3),
                dv=dc[6 * k:9 * k].reshape(k, 3), dbg=dc[9 * k:12 * k].reshape(k, 3),
                dba=dc[12 * k:15 * k].reshape(k, 3))


def retract_cam(state: WindowState, dc: torch.Tensor) -> WindowState:
    """Apply a camera-block tangent in the [dp, dth, dv, dbg, dba] layout
    (landmarks untouched)."""
    d = _cam_delta(dc, state.p.shape[0])
    return state._replace(
        p=state.p + d["dp"],
        q=quat_normalize(quat_multiply(state.q, so3_exp(d["dth"]))),
        v=state.v + d["dv"], bg=state.bg + d["dbg"], ba=state.ba + d["dba"])


def _rel_log(q: torch.Tensor, ref_q: torch.Tensor) -> torch.Tensor:
    return so3_log(quat_multiply(quat_inverse(ref_q), q))


def local_diff(state: WindowState, ref_p, ref_q, ref_v, ref_bg, ref_ba, ref_lm) -> torch.Tensor:
    """state ⊖ reference as a flat tangent (the `retract` layout)."""
    return _ravel(dict(dp=state.p - ref_p, dth=_rel_log(state.q, ref_q),
                       dv=state.v - ref_v, dbg=state.bg - ref_bg,
                       dba=state.ba - ref_ba, dlm=state.lm - ref_lm))


def cam_local_diff(state: WindowState, prior: CamPriorFactor) -> torch.Tensor:
    """state ⊖ prior linearization over the camera blocks, in the
    [dp, dth, dv, dbg, dba] layout of `CamPriorFactor.j`."""
    return torch.cat([(state.p - prior.p).reshape(-1),
                      _rel_log(state.q, prior.q).reshape(-1),
                      (state.v - prior.v).reshape(-1), (state.bg - prior.bg).reshape(-1),
                      (state.ba - prior.ba).reshape(-1)])


def _prior_residual(state: WindowState, prior) -> torch.Tensor:
    if isinstance(prior, CamPriorFactor):
        return prior.j @ cam_local_diff(state, prior) + prior.r0
    dx = local_diff(state, prior.p, prior.q, prior.v, prior.bg, prior.ba, prior.lm)
    return prior.j @ dx + prior.r0


def _project(state: WindowState, meas: WindowMeasurements):
    """Camera-frame points (K, L, 3) of every landmark in every keyframe,
    the body-frame points, and the rotations R_wb (K, 3, 3)."""
    r_wb = quat_to_matrix(state.q)
    pts_b = torch.einsum("kji,klj->kli", r_wb, state.lm[None, :, :] - state.p[:, None, :])
    pts_c = torch.einsum("ij,klj->kli", meas.r_cb, pts_b - meas.p_bc)
    return pts_c, pts_b, r_wb


def _safe(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) > 1e-6, z, torch.full((), 1e-6, dtype=z.dtype, device=z.device))


def reprojection_residuals(state: WindowState, meas: WindowMeasurements) -> torch.Tensor:
    """Whitened, Huber-scaled reprojection residuals, shape (K, L, 2); zero
    where unobserved, behind the camera (z <= 0.05) or invalid."""
    pts_c, _, _ = _project(state, meas)
    z = pts_c[..., 2]
    proj = pts_c[..., :2] / _safe(z)[..., None]
    valid = meas.vis & (z > 0.05) & state.kf_valid[:, None] & state.lm_valid[None, :]
    r = (proj - torch.nan_to_num(meas.obs)) * meas.pix_weight
    rn = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    w = torch.sqrt(torch.clamp(meas.huber_delta / torch.clamp(rn, min=1e-9), max=1.0))
    return torch.where(valid[..., None], r * w, torch.zeros((), dtype=r.dtype, device=r.device))


def reprojection_jacobians(state: WindowState, meas: WindowMeasurements):
    """Closed-form Jacobians of `reprojection_residuals`: (r (K, L, 2),
    J_pose (K, L, 2, 6) over [dp_k, dθ_k] of the observing keyframe,
    J_lm (K, L, 2, 3) over the landmark), zero where the residual is.

    With pts_b = R_wbᵀ (lm - p): d pts_b / d lm = R_wbᵀ, d / d p = -R_wbᵀ,
    d / d dθ = [pts_b]_× (R' = R Exp(dθ)); the Huber scaling
    s = sqrt(min(1, δ/|r|)) contributes s (I - ½ r rᵀ / |r|²) where |r| > δ."""
    pts_c, pts_b, r_wb = _project(state, meas)
    x, y, z = pts_c[..., 0], pts_c[..., 1], pts_c[..., 2]
    zs = _safe(z)
    proj = pts_c[..., :2] / zs[..., None]
    valid = meas.vis & (z > 0.05) & state.kf_valid[:, None] & state.lm_valid[None, :]
    pixw = meas.pix_weight
    r = (proj - torch.nan_to_num(meas.obs)) * pixw
    rn = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    s = torch.sqrt(torch.clamp(meas.huber_delta / torch.clamp(rn, min=1e-9), max=1.0))
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    r_out = torch.where(valid[..., None], r * s, zero)

    inv_z = 1.0 / zs
    zz = torch.zeros_like(inv_z)
    d_proj = torch.stack([torch.stack([inv_z, zz, -x * inv_z * inv_z], -1),
                          torch.stack([zz, inv_z, -y * inv_z * inv_z], -1)], -2)   # (K, L, 2, 3)
    big = (rn > meas.huber_delta)[..., None]                                     # (K, L, 1, 1)
    outer = r[..., :, None] * r[..., None, :] / torch.clamp(rn * rn, min=1e-18)[..., None]
    eye2 = torch.eye(2, dtype=r.dtype, device=r.device)
    hub = s[..., None] * (eye2 - torch.where(big, 0.5 * outer, zero))            # (K, L, 2, 2)
    j_b = pixw * (hub @ d_proj @ meas.r_cb)                                      # d r / d pts_b
    j_lm = j_b @ r_wb.transpose(-1, -2)[:, None]
    j_pose = torch.cat([-j_lm, j_b @ so3_hat(pts_b)], dim=-1)
    mask = valid[..., None, None]
    return r_out, torch.where(mask, j_pose, zero), torch.where(mask, j_lm, zero)


def _cam_residuals(state: WindowState, meas: WindowMeasurements,
                   anchor_weight: float = 1e3) -> torch.Tensor:
    """All residuals that do not touch landmarks: the IMU factors between
    consecutive keyframes, the gauge anchors (position + yaw of the first
    keyframe), the bias priors and the optional linearized prior."""
    r_imu = imu_residual(meas.pre, state.p[:-1], state.q[:-1], state.v[:-1], state.bg[:-1],
                         state.ba[:-1], state.p[1:], state.q[1:], state.v[1:],
                         state.bg[1:], state.ba[1:], weight_bias=meas.bias_weight)
    ok = meas.pre_valid & state.kf_valid[:-1] & state.kf_valid[1:]
    r_imu = torch.where(ok[:, None], r_imu, torch.zeros((), dtype=r_imu.dtype,
                                                         device=r_imu.device)).reshape(-1)
    # `wrap_angle` with its floor taken off the tape: forward-mode AD gives
    # a 0-d floor a zero tangent that promotes the result to float64
    d_yaw = yaw_of(state.q[0]) - meas.anchor_yaw
    yaw_err = d_yaw - 2.0 * math.pi * torch.floor((d_yaw.detach() + math.pi) / (2.0 * math.pi))
    r_anchor = torch.cat([(state.p[0] - meas.anchor_p) * anchor_weight,
                          yaw_err[None] * anchor_weight])
    kf_mask = state.kf_valid.to(state.p.dtype)[:, None]
    r_bias_prior = torch.cat([(state.ba * kf_mask).reshape(-1) * meas.ba_prior_weight,
                              (state.bg * kf_mask).reshape(-1) * meas.bg_prior_weight])
    parts = [r_imu, r_anchor, r_bias_prior]
    if meas.prior is not None:
        parts.append(_prior_residual(state, meas.prior))
    return torch.cat(parts)


def _all_residuals(state: WindowState, meas: WindowMeasurements,
                   anchor_weight: float = 1e3) -> torch.Tensor:
    return torch.cat([reprojection_residuals(state, meas).reshape(-1),
                      _cam_residuals(state, meas, anchor_weight)])


def _pos_solve(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h x = b for symmetric positive-definite h (Jacobi-equilibrated by the
    callers); NaN where the factorization fails. No host read."""
    chol, info = torch.linalg.cholesky_ex(h)
    x = torch.cholesky_solve(b[:, None], chol)[:, 0]
    return torch.where(info == 0, x, torch.full((), float("nan"), dtype=x.dtype, device=x.device))


def _equilibrated_solve(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx = -h⁻¹ g with Jacobi equilibration (float32 Cholesky needs the
    ~1e6 range between anchor/pixel and bias blocks squeezed out)."""
    d = 1.0 / torch.sqrt(torch.diagonal(h) + 1e-12)
    return d * _pos_solve(h * d[:, None] * d[None, :], -(g * d))


def _lm_update(accept, st_new, st, lam, cost_new, cost, pred):
    """Nielsen gain-ratio damping: shrink lambda by how well the quadratic
    model predicted the reduction, grow it on rejection."""
    rho = (cost - cost_new) / torch.clamp(pred, min=1e-12)
    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    st_out = WindowState(*(torch.where(accept, a, b) for a, b in zip(st_new, st)))
    lam_out = torch.where(accept, torch.clamp(lam * shrink, min=1e-10),
                          torch.clamp(lam * 4.0, max=1e8))
    return st_out, lam_out, torch.where(accept, cost_new, cost)


def solve_window(state: WindowState, meas: WindowMeasurements,
                 iters: int = 8, init_lambda: float = 1e-3,
                 anchor_weight: float = 1e3) -> tuple[WindowState, torch.Tensor]:
    """Damped Gauss-Newton (LM) over the full flat tangent, dense Jacobian
    by `jacfwd`, fixed iteration count (the agent's 8-iteration solver
    budget, `euroc_config.yaml:54-55`). Returns (state, final cost)."""
    k, l = state.p.shape[0], state.lm.shape[0]
    flat0 = torch.zeros(15 * k + 3 * l, dtype=state.p.dtype, device=state.p.device)
    lam = torch.full((), init_lambda, dtype=state.p.dtype, device=state.p.device)
    cost = 0.5 * torch.sum(_all_residuals(state, meas, anchor_weight) ** 2)
    st = state
    for _ in range(iters):
        def res_of_dx(dx, st=st):
            return _all_residuals(retract(st, _unravel(dx, k, l)), meas, anchor_weight)
        r0 = res_of_dx(flat0)
        jmat = jacfwd(res_of_dx)(flat0)
        h = jmat.T @ jmat
        g = jmat.T @ r0
        h_damped = h + torch.diag(lam * (torch.diagonal(h) + 1e-6))
        dx = _equilibrated_solve(h_damped, g)
        st_new = retract(st, _unravel(dx, k, l))
        cost_new = 0.5 * torch.sum(_all_residuals(st_new, meas, anchor_weight) ** 2)
        pred = -(g @ dx) - 0.5 * (dx @ (h @ dx))
        st, lam, cost = _lm_update(cost_new < cost, st_new, st, lam, cost_new, cost, pred)
    return st, cost


def solve_window_schur(state: WindowState, meas: WindowMeasurements,
                       iters: int = 8, init_lambda: float = 1e-3,
                       anchor_weight: float = 1e3) -> tuple[WindowState, torch.Tensor]:
    """LM with Schur-complement landmark elimination, Jacobians by `jacfwd`
    over the camera tangent and the landmark tangent separately:

      H_red = H_cc − H_cl H_ll⁻¹ H_lc      (reduced camera system, 15K wide)
      dc    = solve(H_red, −g_red)
      dl_l  = H_ll,l⁻¹ (−g_l − H_cl,lᵀ dc)  (batched 3×3 back-substitution)

    Same contract as `solve_window`."""
    k, l = state.p.shape[0], state.lm.shape[0]
    pc = 15 * k
    dev, f32 = state.p.device, state.p.dtype
    zc = torch.zeros(pc, dtype=f32, device=dev)
    zl = torch.zeros(3 * l, dtype=f32, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)

    def split_res(dc, dl, st):
        st2 = retract_cam(st, dc)
        return _all_residuals(st2._replace(lm=st2.lm + dl.reshape(l, 3)), meas, anchor_weight)

    lam = torch.full((), init_lambda, dtype=f32, device=dev)
    cost = 0.5 * torch.sum(split_res(zc, zl, state) ** 2)
    st = state
    for _ in range(iters):
        r0 = split_res(zc, zl, st)
        j_c = jacfwd(lambda dc, st=st: split_res(dc, zl, st))(zc)             # (R, Pc)
        j_l3 = jacfwd(lambda dl, st=st: split_res(zc, dl, st))(zl).reshape(-1, l, 3)
        h_cc = j_c.T @ j_c
        g_c = j_c.T @ r0
        h_ll = torch.einsum("rla,rlb->lab", j_l3, j_l3)
        g_l = torch.einsum("rla,r->la", j_l3, r0)
        h_cl = torch.einsum("rc,rla->cla", j_c, j_l3)
        h_cc_d = h_cc + torch.diag(lam * (torch.diagonal(h_cc) + 1e-6))
        h_ll_d = h_ll + lam * (torch.diag_embed(torch.diagonal(h_ll, dim1=-2, dim2=-1))
                               + 1e-6 * eye3)
        observed = torch.einsum("lab->l", torch.abs(h_ll)) > 1e-12
        h_ll_d = torch.where(observed[:, None, None], h_ll_d, eye3)
        h_ll_inv = torch.linalg.inv_ex(h_ll_d)[0]
        w_mat = torch.einsum("cla,lab->clb", h_cl, h_ll_inv)
        h_red = h_cc_d - torch.einsum("clb,dlb->cd", w_mat, h_cl)
        g_red = g_c - torch.einsum("clb,lb->c", w_mat, g_l)
        dc = _equilibrated_solve(h_red, g_red)
        rhs = -g_l - torch.einsum("cla,c->la", h_cl, dc)
        dl = torch.where(observed[:, None], torch.einsum("lab,lb->la", h_ll_inv, rhs),
                         torch.zeros((), dtype=f32, device=dev))
        st_new = retract_cam(st, dc)._replace(lm=st.lm + dl)
        cost_new = 0.5 * torch.sum(split_res(zc, zl, st_new) ** 2)
        g_term = g_c @ dc + torch.sum(g_l * dl)
        q_cc = dc @ (h_cc @ dc)
        q_cl = 2.0 * torch.einsum("c,cla,la->", dc, h_cl, dl)
        q_ll = torch.einsum("la,lab,lb->", dl, h_ll, dl)
        pred = -g_term - 0.5 * (q_cc + q_cl + q_ll)
        st, lam, cost = _lm_update(cost_new < cost, st_new, st, lam, cost_new, cost, pred)
    return st, cost


def triangulate(p_w: torch.Tensor, q_w: torch.Tensor, obs: torch.Tensor, vis: torch.Tensor,
                r_cb: torch.Tensor, p_bc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear multi-view (DLT) triangulation.

    p_w (K,3), q_w (K,4): body poses; obs (K, 2) or (K, L, 2) normalized
    coords; vis (K,) or (K, L). Returns (points (3,) or (L, 3), ok) from the
    eigenvector of the smallest eigenvalue of AᵀA (its sign cancels in the
    dehomogenization), rows [u P_3 - P_1; v P_3 - P_2] per observing view,
    P = [R_cw | t_cw]."""
    single = obs.ndim == 2
    if single:
        obs, vis = obs[:, None], vis[:, None]
    r_wb = quat_to_matrix(q_w)
    r_cw = r_cb @ r_wb.transpose(-1, -2)                               # (K, 3, 3)
    t_cw = -(r_cw @ p_w[..., None])[..., 0] - r_cb @ p_bc               # (K, 3)
    proj = torch.cat([r_cw, t_cw[..., None]], dim=-1)[:, None]          # (K, 1, 3, 4)
    visf = vis.to(obs.dtype)[..., None]
    rows = torch.cat([(obs[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]) * visf,
                      (obs[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]) * visf], 0)   # (2K, L, 4)
    ata = torch.einsum("rli,rlj->lij", rows, rows)
    _, vecs = torch.linalg.eigh(ata)
    x = vecs[..., :, 0]                                                 # (L, 4)
    big = torch.abs(x[:, 3]) > 1e-9
    ok = big & (torch.sum(vis, dim=0) >= 2)
    pt = x[:, :3] / torch.where(big, x[:, 3], torch.full((), 1e-9, dtype=x.dtype,
                                                          device=x.device))[:, None]
    return (pt[0], ok[0]) if single else (pt, ok)


def landmark_quality(p_w: torch.Tensor, q_w: torch.Tensor, kf_valid: torch.Tensor,
                     obs: torch.Tensor, vis: torch.Tensor, lm: torch.Tensor,
                     r_cb: torch.Tensor, p_bc: torch.Tensor):
    """Per-landmark geometric quality over the window.

    Returns (min_depth (L,), max_res (L,), parallax (L,)): the smallest z
    over observing cameras (+inf if none), the worst reprojection residual
    (normalized coords) over observing views, and the largest angle (rad)
    between the rays from two observing camera centers to the point."""
    r_wb = quat_to_matrix(q_w)
    diff = lm[None, :, :] - p_w[:, None, :]
    pts_b = torch.einsum("kji,klj->kli", r_wb, diff)
    pts_c = torch.einsum("ij,klj->kli", r_cb, pts_b - p_bc)
    z = pts_c[..., 2]
    see = vis & kf_valid[:, None]
    inf = torch.full((), float("inf"), dtype=z.dtype, device=z.device)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    min_depth = torch.amin(torch.where(see, z, inf), dim=0)
    proj = pts_c[..., :2] / _safe(z)[..., None]
    res = torch.linalg.vector_norm(proj - torch.nan_to_num(obs), dim=-1)
    max_res = torch.amax(torch.where(see, res, zero), dim=0)
    centers = p_w + torch.einsum("kij,j->ki", r_wb, p_bc)
    rays = lm[None, :, :] - centers[:, None, :]
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-9)
    cosang = torch.einsum("kli,mli->kml", rays, rays)
    pair_ok = see[:, None, :] & see[None, :, :]
    one = torch.ones((), dtype=z.dtype, device=z.device)
    parallax = torch.arccos(torch.clamp(
        torch.amin(torch.where(pair_ok, cosang, one), dim=(0, 1)), -1.0, 1.0))
    return min_depth, max_res, parallax


def _slot0_imu_and_bias(state: WindowState, meas: WindowMeasurements) -> list:
    pre0 = Preintegrated(*(x[0] for x in meas.pre))
    r_imu = imu_residual(pre0, state.p[0], state.q[0], state.v[0], state.bg[0], state.ba[0],
                         state.p[1], state.q[1], state.v[1], state.bg[1], state.ba[1],
                         weight_bias=meas.bias_weight)
    ok = meas.pre_valid[0] & state.kf_valid[0] & state.kf_valid[1]
    r_imu = torch.where(ok, r_imu, torch.zeros((), dtype=r_imu.dtype, device=r_imu.device))
    w0 = state.kf_valid[0].to(state.p.dtype)
    r_bp = torch.cat([state.ba[0] * (meas.ba_prior_weight * w0),
                      state.bg[0] * (meas.bg_prior_weight * w0)])
    parts = [r_imu, r_bp]
    if meas.prior is not None:
        parts.append(_prior_residual(state, meas.prior))
    return parts


def _marg_residuals(state: WindowState, meas: WindowMeasurements) -> torch.Tensor:
    """Residuals of only the factors connected to the leaving keyframe (slot
    0) plus the previous prior: the factor subset a fixed-lag
    marginalization may absorb (no factor among the surviving states is
    counted twice; the gauge anchor stays out)."""
    k = state.p.shape[0]
    vis0 = meas.vis & (torch.arange(k, device=meas.vis.device)[:, None] == 0)
    r_proj = reprojection_residuals(state, meas._replace(vis=vis0)).reshape(-1)
    return torch.cat([r_proj] + _slot0_imu_and_bias(state, meas))


def _schur_prior(h, g, m, eig_floor, keep_cols=None):
    """Masked Schur complement of the columns `m` out of (h, g), then the
    square-root factor by eigenvalue flooring: (j, r0) with jᵀj = H_new and
    jᵀ r0 = g_new on the kept space. `keep_cols` compresses to a leading
    block before the eigendecomposition."""
    keep = ~m
    eye = torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    h_mm = torch.where(m[:, None] & m[None, :], h, eye)
    # a small Tikhonov diagonal on the marginalized block: a dying landmark
    # may leave with a single observation (a rank-deficient 3x3 block)
    mm_scale = torch.clamp(torch.amax(torch.abs(torch.diagonal(h_mm))), min=1.0)
    h_mm = h_mm + (1e-7 * mm_scale) * torch.diag(m.to(h.dtype))
    h_km = torch.where(keep[:, None] & m[None, :], h, zero)
    h_kk = torch.where(keep[:, None] & keep[None, :], h, zero)
    g_m = torch.where(m, g, zero)
    g_k = torch.where(keep, g, zero)
    sol = torch.linalg.solve_ex(h_mm, torch.cat([h_km.T, g_m[:, None]], dim=1))[0]
    h_new = h_kk - h_km @ sol[:, :-1]
    g_new = g_k - h_km @ sol[:, -1]
    if keep_cols is not None:
        h_new, g_new = h_new[:keep_cols, :keep_cols], g_new[:keep_cols]
    return sqrt_prior(h_new, g_new, eig_floor)


def sqrt_prior(h_new: torch.Tensor, g_new: torch.Tensor, eig_floor: float = 1e-8
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A prior's square root (j, r0) from its Schur-complemented normal
    equations: jᵀj = h_new and jᵀ r0 = g_new on the range of h_new, by
    eigenvalue flooring. The float64 `eigh` checks its errors on the host:
    after `marg_schur_cam`'s graph on the card, this is the eager step."""
    # the eigendecomposition in float64: float32 `syevd` fails to converge
    # on some of these matrices (rows of zeros beside a 1e6 anchor scale);
    # where float64 fails too, the prior is NaN and the caller drops it
    try:
        w, v = torch.linalg.eigh(0.5 * (h_new + h_new.T).to(torch.float64))
    except torch.linalg.LinAlgError:
        nan = torch.full_like(h_new, float("nan"))
        return nan, nan[:, 0]
    sqrt_w = torch.sqrt(torch.clamp(w, min=0.0))
    j_prior = (v * sqrt_w[None, :]) @ v.T
    inv_sqrt = torch.where(sqrt_w > eig_floor, 1.0 / torch.clamp(sqrt_w, min=eig_floor),
                           torch.zeros((), dtype=w.dtype, device=w.device))
    r0 = (v * inv_sqrt[None, :]) @ (v.T @ g_new.to(torch.float64))
    return j_prior.to(h_new.dtype), r0.to(h_new.dtype)


def marginalize_prior(state: WindowState, meas: WindowMeasurements,
                      marg_mask_flat: torch.Tensor, anchor_weight: float = 1e3,
                      eig_floor: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Schur-marginalize a subset of the full flat tangent (True in
    `marg_mask_flat` = marginalize) out of `_marg_residuals`, returning a
    dense sqrt-information prior (j, r0) over the full tangent layout
    (marginalized columns zero), linearized at `state`. j and r0 are one
    square root of the prior's information: its eigenvectors' signs are
    free, so compare jᵀj and jᵀr0."""
    k, l = state.p.shape[0], state.lm.shape[0]
    flat0 = torch.zeros(15 * k + 3 * l, dtype=state.p.dtype, device=state.p.device)

    def res_of_dx(dx):
        return _marg_residuals(retract(state, _unravel(dx, k, l)), meas)

    r0 = res_of_dx(flat0)
    jmat = jacfwd(res_of_dx)(flat0)
    return _schur_prior(jmat.T @ jmat, jmat.T @ r0, marg_mask_flat, eig_floor)


def _slot0_state(state: WindowState, meas: WindowMeasurements, dying: torch.Tensor):
    """The window cut to slot 0 with only the dying landmarks' observations:
    `reprojection_residuals` of it are the marginalization's reprojection
    rows (slot-0 observations of the landmarks that leave with slot 0)."""
    st0 = state._replace(p=state.p[:1], q=state.q[:1], v=state.v[:1], bg=state.bg[:1],
                         ba=state.ba[:1], kf_valid=state.kf_valid[:1])
    return st0, meas._replace(obs=meas.obs[:1], vis=meas.vis[:1] & dying[None])


def marg_normal_equations(state: WindowState, meas: WindowMeasurements,
                          dying: torch.Tensor):
    """JᵀJ and Jᵀr0 of the VINS marginalization factor set over the camera
    tangent ([dp, dth, dv, dbg, dba], 15K) and every landmark, by blocks:
    (h_cc (15K, 15K), g_c (15K,), h_pl (6, L, 3), h_ll (L, 3, 3),
    g_l (L, 3)). The factors: slot-0 reprojections of the dying landmarks
    (2L rows, closed form by `reprojection_jacobians`, as the window solve
    takes them: they touch [dp_0, dθ_0] and their landmark), the slot-0/1
    preintegration factor, the slot-0 bias prior and the previous camera-only
    prior (`jacfwd` over the 15K camera tangent). h_pl couples the rows of
    [dp_0, dθ_0] (camera columns 0-2 and 3K..3K+2) with each landmark; no
    other camera column sees a landmark."""
    k = state.p.shape[0]
    zc = torch.zeros(15 * k, dtype=state.p.dtype, device=state.p.device)

    def cam_res(dc):
        return torch.cat(_slot0_imu_and_bias(retract_cam(state, dc), meas))

    r_cam = cam_res(zc)
    j_cam = jacfwd(cam_res)(zc)
    r, j_pose, j_lm = (x[0] for x in reprojection_jacobians(*_slot0_state(state, meas, dying)))
    h_cc = j_cam.T @ j_cam
    g_c = j_cam.T @ r_cam
    pose = _pose_columns(k, state.p.device)
    h_cc[pose[:, None], pose[None, :]] += torch.einsum("lra,lrb->ab", j_pose, j_pose)
    g_c[pose] += torch.einsum("lra,lr->a", j_pose, r)
    h_pl = torch.einsum("lra,lrb->alb", j_pose, j_lm)
    h_ll = torch.einsum("lra,lrb->lab", j_lm, j_lm)
    g_l = torch.einsum("lra,lr->la", j_lm, r)
    return h_cc, g_c, h_pl, h_ll, g_l


def _pose_columns(k: int, device) -> torch.Tensor:
    """Camera-tangent columns of [dp_0, dθ_0] (made on the device: a CUDA
    graph cannot capture a copy from host memory)."""
    i = torch.arange(3, device=device)
    return torch.cat([i, i + 3 * k])


def marg_schur_cam(state: WindowState, meas: WindowMeasurements,
                   dying: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Schur complement of slot 0's camera columns and every landmark
    out of `marg_normal_equations`: (H_new (15K, 15K), g_new (15K,)), zero in
    slot 0's rows and columns. No host read: on the card the front-end
    replays it as a CUDA graph, and `sqrt_prior` takes its square root.

    The reference eliminates all of them in one dense float32 solve with a
    Tikhonov diagonal τ = 1e-7 max(1, the largest marginalized diagonal
    entry); here the landmarks' 3×3 blocks go first (batched inverses; no
    kept column sees a landmark), then slot 0's 15 columns (one 15×15
    Cholesky): the same Schur complement with the same τ, in float64 (in
    float32 either order of elimination is ~1e-4 off the float64 result,
    the anchor and bias scales beside the pixel ones), rounded to the
    state's dtype at the end."""
    k = state.p.shape[0]
    pc = 15 * k
    h, g, h_pl, h_ll, g_l = (x.to(torch.float64)
                             for x in marg_normal_equations(state, meas, dying))
    dev, dt = h.device, h.dtype
    keep = torch.arange(pc, device=dev) % (3 * k) >= 3      # all but slot 0 of each block
    slot0 = (torch.arange(5, device=dev)[:, None] * (3 * k)
             + torch.arange(3, device=dev)[None, :]).reshape(15)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    tau = 1e-7 * torch.clamp(torch.maximum(
        torch.amax(torch.abs(torch.diagonal(h)[slot0])),
        torch.amax(torch.abs(torch.diagonal(h_ll, dim1=-2, dim2=-1)))), min=1.0)
    d_inv = torch.linalg.inv_ex(h_ll + tau * eye3)[0]
    w_pl = torch.einsum("alb,lbc->alc", h_pl, d_inv)
    pose = _pose_columns(k, dev)
    h = h.clone()
    g = g.clone()
    h[pose[:, None], pose[None, :]] -= torch.einsum("alc,dlc->ad", w_pl, h_pl)
    g[pose] -= torch.einsum("alc,lc->a", w_pl, g_l)
    a = h[slot0[:, None], slot0[None, :]] + tau * torch.eye(15, dtype=dt, device=dev)
    chol = torch.linalg.cholesky_ex(a)[0]
    sol = torch.cholesky_solve(torch.cat([h[slot0], g[slot0][:, None]], dim=1), chol)
    h_new = h - h[:, slot0] @ sol[:, :pc]
    g_new = g - h[:, slot0] @ sol[:, pc]
    zero = torch.zeros((), dtype=dt, device=dev)
    return (torch.where(keep[:, None] & keep[None, :], h_new, zero).to(state.p.dtype),
            torch.where(keep, g_new, zero).to(state.p.dtype))


def marginalize_prior_cam(state: WindowState, meas: WindowMeasurements,
                          dying: torch.Tensor, eig_floor: float = 1e-8
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Schur-marginalize slot 0 (and the landmarks dying with it) into a
    camera-only sqrt-information prior (j (15K, 15K), r0) over the
    [dp, dth, dv, dbg, dba] layout at the current window indexing (the
    caller shifts columns when it rolls the window): `marg_schur_cam`, then
    `sqrt_prior`. The eigenvectors' signs are free, so jᵀj and
    jᵀr0 are what is defined."""
    return sqrt_prior(*marg_schur_cam(state, meas, dying), eig_floor)


def _to_cam(x: torch.Tensor, k: int) -> torch.Tensor:
    """(K, 6) [dp_k, dθ_k] -> (6K,) in the camera layout's first two blocks."""
    return x.reshape(k, 2, 3).transpose(0, 1).reshape(6 * k)


def _from_cam(x: torch.Tensor, k: int) -> torch.Tensor:
    return x[:6 * k].reshape(2, k, 3).transpose(0, 1).reshape(k, 6)


def _pose_block_to_cam(m: torch.Tensor, k: int) -> torch.Tensor:
    """(K, 6, K, 6) pose-pose blocks -> (6K, 6K) in the camera layout."""
    return m.reshape(k, 2, 3, k, 2, 3).permute(1, 0, 2, 4, 3, 5).reshape(6 * k, 6 * k)


def solve_window_fast(state: WindowState, meas: WindowMeasurements,
                      iters: int = 8, init_lambda: float = 1e-3,
                      anchor_weight: float = 1e3) -> tuple[WindowState, torch.Tensor]:
    """LM with exact Schur landmark elimination, assembled from the
    closed-form per-observation Jacobians (`reprojection_jacobians`): the
    front-end's per-keyframe solve (the agent's 8-iteration / 0.04 s budget,
    `euroc_config.yaml:54-55`). Same semantics as `solve_window_schur`; a
    camera-only prior (`CamPriorFactor`) only: a full-tangent `PriorFactor`
    couples landmarks and breaks the Schur structure, and is rejected.

    On CUDA tensors the whole solve is one launch of the hand kernel
    `cuda_kernels.window_lm` (``csrc/window_lm.cu``, one thread-block
    cluster), which raises on what it does not take (K above 21, another
    dtype); on CPU tensors it is the body below."""
    if meas.prior is not None and not isinstance(meas.prior, CamPriorFactor):
        raise ValueError("solve_window_fast needs a camera-only prior "
                         "(CamPriorFactor): full-tangent priors couple "
                         "landmarks and break the Schur structure")
    if state.p.is_cuda:
        return cuda_kernels.window_lm(state, meas, iters, init_lambda, anchor_weight)
    k = state.p.shape[0]
    pc = 15 * k
    dev, f32 = state.p.device, state.p.dtype
    zc = torch.zeros(pc, dtype=f32, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye_k = torch.eye(k, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    def total_cost(st):
        return (0.5 * torch.sum(_cam_residuals(st, meas, anchor_weight) ** 2)
                + 0.5 * torch.sum(reprojection_residuals(st, meas) ** 2))

    lam = torch.full((), init_lambda, dtype=f32, device=dev)
    cost = total_cost(state)
    st = state
    for _ in range(iters):
        def cam_res_dc(dc, st=st):
            return _cam_residuals(retract_cam(st, dc), meas, anchor_weight)
        r_cam = cam_res_dc(zc)
        j_cam = jacfwd(cam_res_dc)(zc)
        r, j_pose, j_lm = reprojection_jacobians(st, meas)
        h_ll = torch.einsum("klra,klrb->lab", j_lm, j_lm)                # (L, 3, 3)
        g_l = torch.einsum("klra,klr->la", j_lm, r)
        h_pl = torch.einsum("klra,klrb->klab", j_pose, j_lm)             # (K, L, 6, 3)
        h_pp = torch.einsum("klra,klrb->kab", j_pose, j_pose)            # (K, 6, 6)
        g_p = torch.einsum("klra,klr->ka", j_pose, r)

        h_cc = j_cam.T @ j_cam
        h_cc[:6 * k, :6 * k] += _pose_block_to_cam(torch.einsum("kab,km->kamb", h_pp, eye_k), k)
        g_c = j_cam.T @ r_cam
        g_c[:6 * k] += _to_cam(g_p, k)

        h_ll_d = h_ll + lam * (torch.diag_embed(torch.diagonal(h_ll, dim1=-2, dim2=-1))
                               + 1e-6 * eye3)
        observed = torch.einsum("lab->l", torch.abs(h_ll)) > 1e-12
        h_ll_inv = torch.linalg.inv_ex(torch.where(observed[:, None, None], h_ll_d, eye3))[0]
        w_mat = h_pl @ h_ll_inv[None]                                     # (K, L, 6, 3)
        h_red = h_cc + torch.diag(lam * (torch.diagonal(h_cc) + 1e-6))
        h_red[:6 * k, :6 * k] -= _pose_block_to_cam(
            torch.einsum("klab,mlcb->kamc", w_mat, h_pl), k)
        g_red = g_c.clone()
        g_red[:6 * k] -= _to_cam(torch.einsum("klab,lb->ka", w_mat, g_l), k)
        dc = _equilibrated_solve(h_red, g_red)
        dc_pose = _from_cam(dc, k)                                        # (K, 6)
        rhs = -g_l - torch.einsum("klab,ka->lb", h_pl, dc_pose)
        dl = torch.where(observed[:, None], (h_ll_inv @ rhs[..., None])[..., 0], zero)

        st_new = retract_cam(st, dc)._replace(lm=st.lm + dl)
        cost_new = total_cost(st_new)
        g_term = g_c @ dc + torch.sum(g_l * dl)
        q_cc = dc @ (h_cc @ dc)
        q_cl = 2.0 * torch.einsum("ka,klab,lb->", dc_pose, h_pl, dl)
        q_ll = torch.einsum("la,lab,lb->", dl, h_ll, dl)
        pred = -g_term - 0.5 * (q_cc + q_cl + q_ll)
        st, lam, cost = _lm_update(cost_new < cost, st_new, st, lam, cost_new, cost, pred)
    return st, cost

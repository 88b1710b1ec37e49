"""Additional camera models: equidistant (Kannala-Brandt fisheye), MEI
(unified/catadioptric) and Scaramuzza (OCamCalib), plus intrinsic
calibration (port of ``cvids_tpu/camera/models.py``).

The projection models are batched functional ops on tensors; calibration is
a damped Gauss-Newton on reprojection residuals over the intrinsics and the
board poses, with the Jacobian from `torch.func.jacfwd`. Calibration is an
offline tool: it runs where its inputs live and has no CUDA kernel; on the
card its residuals and Jacobian replay as CUDA graphs.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..utils.cuda_graph import GraphedCall
from .pinhole import as_scalars, distort, undistort_iterative

__all__ = ["EquidistantCamera", "MeiCamera", "ScaramuzzaCamera",
           "calibrate_pinhole", "calibrate_equidistant", "calibrate_mei",
           "calibrate_scaramuzza", "fit_forward_poly"]


def _polyval(coef: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_i coef[i] x^i (coefficients lowest power first), by Horner."""
    out = torch.zeros_like(x) + coef[-1]
    for i in range(coef.shape[0] - 2, -1, -1):
        out = out * x + coef[i]
    return out


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the SVD, singular values below
    eps * max(M, N) of the largest cut: the ill-conditioned polynomial fits
    below depend on that cut, and it is the same on every device."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    inv = torch.where(s > rcond * s[0], 1.0 / s, torch.zeros_like(s))
    return vh.T @ (inv * (u.T @ b))


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt: r(θ) = θ + k2 θ³ + k3 θ⁵ + k4 θ⁷ + k5 θ⁹."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k: torch.Tensor  # (4,) = (k2, k3, k4, k5)
    width: int = 752
    height: int = 480

    @staticmethod
    def create(fx, fy, cx, cy, k=(0.0, 0.0, 0.0, 0.0), width=752, height=480,
               dtype=torch.float32, device=None):
        dev = resolve_device(device)
        return EquidistantCamera(*as_scalars(dev, dtype, fx, fy, cx, cy, k),
                                 int(width), int(height))

    def _theta_d(self, theta):
        t2 = theta * theta
        return theta * (1.0 + self.k[0] * t2 + self.k[1] * t2 ** 2
                        + self.k[2] * t2 ** 3 + self.k[3] * t2 ** 4)

    def project(self, pts_cam: torch.Tensor) -> torch.Tensor:
        """(..., 3) camera points -> (..., 2) pixels."""
        x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
        r = torch.sqrt(x * x + y * y)
        theta = torch.atan2(r, z)
        td = self._theta_d(theta)
        scale = torch.where(r > 1e-9, td / torch.clamp(r, min=1e-9), torch.ones_like(r))
        u = self.fx * x * scale + self.cx
        v = self.fy * y * scale + self.cy
        return torch.stack([u, v], dim=-1)

    def lift(self, px: torch.Tensor, iters: int = 10) -> torch.Tensor:
        """Pixels -> normalized coords (x/z, y/z) by Newton-inverting r(θ)."""
        mx = (px[..., 0] - self.cx) / self.fx
        my = (px[..., 1] - self.cy) / self.fy
        td = torch.sqrt(mx * mx + my * my)
        theta = td  # init
        for _ in range(iters):
            t2 = theta * theta
            f = theta * (1 + self.k[0] * t2 + self.k[1] * t2 ** 2
                         + self.k[2] * t2 ** 3 + self.k[3] * t2 ** 4) - td
            df = (1 + 3 * self.k[0] * t2 + 5 * self.k[1] * t2 ** 2
                  + 7 * self.k[2] * t2 ** 3 + 9 * self.k[3] * t2 ** 4)
            theta = theta - f / torch.clamp(df, min=1e-9)
        scale = torch.where(td > 1e-9, torch.tan(theta) / torch.clamp(td, min=1e-9),
                            torch.ones_like(td))
        return torch.stack([mx * scale, my * scale], dim=-1)


class MeiCamera(NamedTuple):
    """Unified (Mei) model: project via unit sphere with mirror offset xi,
    then pinhole + radtan distortion."""

    xi: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # (4,) k1 k2 p1 p2
    width: int = 752
    height: int = 480

    @staticmethod
    def create(xi, fx, fy, cx, cy, dist=(0, 0, 0, 0), width=752, height=480,
               dtype=torch.float32, device=None):
        dev = resolve_device(device)
        return MeiCamera(*as_scalars(dev, dtype, xi, fx, fy, cx, cy, dist),
                         int(width), int(height))

    def project(self, pts_cam: torch.Tensor) -> torch.Tensor:
        p = pts_cam / torch.linalg.vector_norm(pts_cam, dim=-1, keepdim=True)
        z = p[..., 2] + self.xi
        m = p[..., :2] / torch.clamp(z, min=1e-9)[..., None]
        md = m + distort(m, self.dist)
        return torch.stack([self.fx * md[..., 0] + self.cx,
                            self.fy * md[..., 1] + self.cy], dim=-1)

    def lift(self, px: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Pixels -> normalized coords on the z=1 plane."""
        mx = (px[..., 0] - self.cx) / self.fx
        my = (px[..., 1] - self.cy) / self.fy
        m = undistort_iterative(torch.stack([mx, my], -1), self.dist, iters)
        mx, my = m[..., 0], m[..., 1]
        r2 = mx * mx + my * my
        # invert the sphere projection (camodocal CataCamera::liftProjective)
        xi = self.xi
        disc = 1.0 + (1.0 - xi * xi) * r2
        zs = (xi + torch.sqrt(torch.clamp(disc, min=0.0))) / (1.0 + r2)
        x = zs * mx
        y = zs * my
        z = torch.clamp(zs - xi, min=1e-9)
        return torch.stack([x / z, y / z], dim=-1)


class ScaramuzzaCamera(NamedTuple):
    """Scaramuzza omnidirectional (OCamCalib) model.

    Behaviour matches camodocal's `OCAMCamera`: lift applies the inverse
    affine [[C,D],[E,1]] to the centered pixel, evaluates the forward
    polynomial at the sensor radius φ and returns (xc_x, xc_y, −poly(φ)) —
    centered coordinates, NOT affine-corrected, reproducing that convention;
    project maps θ = atan2(−z, ‖xy‖) through the inverse polynomial to a
    sensor radius.
    """

    poly: torch.Tensor      # (P,) forward polynomial coefficients (a0, a1, ...)
    inv_poly: torch.Tensor  # (Q,) inverse polynomial (ρ(θ))
    c: torch.Tensor         # affine C
    d: torch.Tensor         # affine D
    e: torch.Tensor         # affine E
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 752
    height: int = 480

    @staticmethod
    def create(poly, inv_poly=None, c=1.0, d=0.0, e=0.0, cx=376.0, cy=240.0,
               width=752, height=480, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        poly = torch.as_tensor(poly, dtype=dtype, device=dev)
        if inv_poly is None:
            inv_poly = ScaramuzzaCamera.fit_inverse_poly(
                poly, max_radius=0.6 * float(np.hypot(width, height)))
        return ScaramuzzaCamera(poly, *as_scalars(dev, dtype, inv_poly, c, d, e, cx, cy),
                                int(width), int(height))

    @staticmethod
    def fit_inverse_poly(poly, max_radius: float, degree: int = 12,
                         samples: int = 256):
        """Least-squares fit of ρ(θ) from the forward polynomial (the role of
        camodocal's inverse-poly estimation during calibration)."""
        phi = torch.linspace(0.0, max_radius, samples, dtype=poly.dtype, device=poly.device)
        z = _polyval(poly, phi)        # poly is (a0, a1, ...)
        theta = torch.atan2(z, phi)
        vand = theta[:, None] ** torch.arange(degree + 1, device=poly.device)[None, :]
        return _lstsq(vand, phi)

    def project(self, pts_cam: torch.Tensor) -> torch.Tensor:
        x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
        nrm = torch.sqrt(x * x + y * y)
        theta = torch.atan2(-z, nrm)
        rho = _polyval(self.inv_poly, theta)
        inv_n = 1.0 / torch.clamp(nrm, min=1e-9)
        xn = x * inv_n * rho
        yn = y * inv_n * rho
        u = xn * self.c + yn * self.d + self.cx
        v = xn * self.e + yn + self.cy
        return torch.stack([u, v], dim=-1)

    def lift(self, px: torch.Tensor) -> torch.Tensor:
        """Pixels -> projective ray (..., 3) (centered pixel coords for xy,
        −poly(φ) for z; NOT normalized)."""
        xc = px[..., 0] - self.cx
        yc = px[..., 1] - self.cy
        inv_scale = 1.0 / (self.c - self.d * self.e)
        xa = inv_scale * (xc - self.d * yc)
        ya = inv_scale * (-self.e * xc + self.c * yc)
        phi = torch.sqrt(xa * xa + ya * ya)
        z = _polyval(self.poly, phi)
        return torch.stack([xc, yc, -z], dim=-1)


def _residuals(project_fn, n_params: int, flat: torch.Tensor, obj_pts: torch.Tensor,
               img_pts: torch.Tensor, valid: torch.Tensor, prior) -> torch.Tensor:
    """The calibration's residual vector at `flat` = [params, poses (V, 6)]:
    each view's reprojection errors (zero where not `valid`), then the
    soft prior's weighted parameter offsets when `prior` = (indices,
    targets, weights) tensors is not None. Everything it reads is an
    argument, so one CUDA graph serves every call of a solve."""
    from ..geometry import quat_to_matrix, so3_exp

    params = flat[:n_params]
    poses = flat[n_params:].reshape(obj_pts.shape[0], 6)

    def one(pose, op, ip, vd):
        r = quat_to_matrix(so3_exp(pose[:3]))
        pc = op @ r.T + pose[3:]
        res = project_fn(params, pc) - ip
        return torch.where(vd[..., None], res, torch.zeros_like(res))

    res = torch.func.vmap(one)(poses, obj_pts, img_pts, valid).reshape(-1)
    if prior is not None:
        p_idx, p_tgt, p_wgt = prior
        res = torch.cat([res, (params[p_idx] - p_tgt) * p_wgt])
    return res


def _calibrate_gn(project_fn, n_params: int, obj_pts: torch.Tensor,
                  img_pts: torch.Tensor, valid: torch.Tensor,
                  init_params: torch.Tensor, poses0: torch.Tensor,
                  iters: int = 20, prior=None):
    """Joint intrinsics+poses Gauss-Newton over V planar-target views.

    `project_fn(params (n_params,), pts_cam (..., 3)) -> pixels (..., 2)` is
    the camera model; obj_pts (V, N, 3), img_pts (V, N, 2), valid (V, N),
    poses0 (V, 6) [rvec, tvec] board->camera. Levenberg-damped (relative
    diagonal, adapted by accepting only downhill steps) with Jacobi
    preconditioning and a 1e-8 ridge.

    prior: optional (param_indices, targets, weights) soft prior appended to
    the residual vector — pins gauge-like parameter valleys (e.g. the OCAM
    affine) without meaningfully biasing well-constrained solutions.

    The residuals and their `jacfwd` Jacobian are the JAX package's two
    `jax.jit` programs: on the card each replays as one CUDA graph,
    captured at its first call; the damping loop, its cost reads and its
    solve stay eager, as in the reference.
    Returns (params, poses, rms over data residuals only)."""
    dev = obj_pts.device
    f32 = torch.float32
    data = (obj_pts.to(f32), img_pts.to(f32), valid)
    if prior is not None:
        data += ((torch.as_tensor(np.asarray(prior[0]), dtype=torch.int64, device=dev),
                  torch.as_tensor(np.asarray(prior[1]), dtype=f32, device=dev),
                  torch.as_tensor(np.asarray(prior[2]), dtype=f32, device=dev)),)
    else:
        data += (None,)
    fn = functools.partial(_residuals, project_fn, n_params)
    residuals, jac = GraphedCall(fn), GraphedCall(torch.func.jacfwd(fn))

    n_data = 2 * obj_pts.shape[0] * obj_pts.shape[1]
    flat = torch.cat([torch.as_tensor(init_params, dtype=f32, device=dev).reshape(-1),
                      torch.as_tensor(poses0, dtype=f32, device=dev).reshape(-1)])
    eye = torch.eye(flat.shape[0], dtype=f32, device=dev)
    lam = 1e-3
    cost_prev = float(torch.sum(residuals(flat, *data) ** 2))
    for _ in range(iters):
        r = residuals(flat, *data)
        j = jac(flat, *data)
        h = j.T @ j
        g = j.T @ r
        accepted = False
        for _try in range(8):       # adaptive damping: reject uphill steps
            hd = h + lam * torch.diag(torch.diag(h)) + 1e-8 * eye
            d = 1.0 / torch.sqrt(torch.diag(hd) + 1e-12)
            step = d * torch.linalg.solve(hd * d[:, None] * d[None, :], -g * d)
            cand = flat + step
            cost_new = float(torch.sum(residuals(cand, *data) ** 2))
            if math.isfinite(cost_new) and cost_new < cost_prev:
                flat, cost_prev = cand, cost_new
                lam = max(lam * 0.3, 1e-8)
                accepted = True
                break
            lam = min(lam * 10.0, 1e8)
        if not accepted:
            break
    r = residuals(flat, *data)[:n_data]
    n_obs = torch.clamp(torch.sum(valid), min=1)
    rms = torch.sqrt(torch.sum(r ** 2) / n_obs)
    return flat[:n_params], flat[n_params:].reshape(obj_pts.shape[0], 6), rms


def _project_pinhole(params, pc):
    """[fx, fy, cx, cy, k1, k2, p1, p2]: pinhole + radtan."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    n = pc[..., :2] / z[..., None]
    nd = n + distort(n, params[4:8])
    return torch.stack([fx * nd[..., 0] + cx, fy * nd[..., 1] + cy], -1)


def _project_equidistant(params, pc):
    """[fx, fy, cx, cy, k2, k3, k4, k5]: Kannala-Brandt."""
    return EquidistantCamera(params[0], params[1], params[2], params[3], params[4:8]).project(pc)


def _project_mei(params, pc):
    """[xi, fx, fy, cx, cy, k1, k2, p1, p2]: the unified model."""
    return MeiCamera(params[0], params[1], params[2], params[3], params[4],
                     params[5:9]).project(pc)


def _project_scaramuzza(params, pc):
    """[b0..b_{Q-1}, C, D, E, cx, cy]: the inverse polynomial ρ(θ) and the
    affine [[C, D], [E, 1]] about the center."""
    nb = params.shape[0] - 5
    b = params[:nb]
    c, d, e = params[nb], params[nb + 1], params[nb + 2]
    cx, cy = params[nb + 3], params[nb + 4]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    nrm = torch.sqrt(x * x + y * y)
    theta = torch.atan2(-z, torch.clamp(nrm, min=1e-9))
    rho = _polyval(b, theta)
    inv_n = 1.0 / torch.clamp(nrm, min=1e-9)
    xn = x * inv_n * rho
    yn = y * inv_n * rho
    return torch.stack([xn * c + yn * d + cx, xn * e + yn + cy], dim=-1)


def calibrate_pinhole(obj_pts: torch.Tensor, img_pts: torch.Tensor,
                      valid: torch.Tensor, init_params: torch.Tensor,
                      poses0: torch.Tensor, iters: int = 20):
    """Pinhole+radtan intrinsic calibration from V views of a planar target.

    init_params (8,) = [fx, fy, cx, cy, k1, k2, p1, p2]. Returns
    (params (8,), poses (V, 6), rms)."""
    return _calibrate_gn(_project_pinhole, 8, obj_pts, img_pts, valid, init_params,
                         poses0, iters)


def calibrate_equidistant(obj_pts: torch.Tensor, img_pts: torch.Tensor,
                          valid: torch.Tensor, init_params: torch.Tensor,
                          poses0: torch.Tensor, iters: int = 25):
    """Kannala-Brandt fisheye calibration (camodocal
    `EquidistantCamera::estimateIntrinsics` + Ceres refinement role).

    init_params (8,) = [fx, fy, cx, cy, k2, k3, k4, k5]. Returns
    (params (8,), poses (V, 6), rms)."""
    return _calibrate_gn(_project_equidistant, 8, obj_pts, img_pts, valid, init_params,
                         poses0, iters)


def fit_forward_poly(inv_poly: torch.Tensor, theta_min: float = -np.pi / 2 + 0.02,
                     theta_max: float = -0.45, degree: int = 4,
                     samples: int = 256) -> torch.Tensor:
    """Forward polynomial z = poly(φ) from a calibrated inverse polynomial
    ρ(θ) (the Scaramuzza convention pair: θ = atan2(poly(φ), φ) at sensor
    radius φ = ρ(θ)). On the optical axis poly(0) = lim φ·tanθ = −f, which is
    the OCamCalib a0 < 0 convention."""
    theta = torch.linspace(theta_min, theta_max, samples, dtype=inv_poly.dtype,
                           device=inv_poly.device)
    phi = _polyval(inv_poly, theta)
    z = phi * torch.tan(theta)
    vand = phi[:, None] ** torch.arange(degree + 1, device=inv_poly.device)[None, :]
    return _lstsq(vand, z)


def calibrate_scaramuzza(obj_pts: torch.Tensor, img_pts: torch.Tensor,
                         valid: torch.Tensor, init_params: torch.Tensor,
                         poses0: torch.Tensor, iters: int = 30):
    """Scaramuzza omnidirectional calibration (camodocal
    `ScaramuzzaCamera.cc` estimateIntrinsics + Ceres refinement role).

    Parameterized directly in projection space — the inverse polynomial
    ρ(θ) plus the affine [[C,D],[E,1]] and center — so the joint GN is the
    plain reprojection problem; the forward polynomial the model stores is
    recovered afterwards with `fit_forward_poly`.

    init_params (Q+5,) = [b0..b_{Q-1} inverse-poly coefficients (ρ(θ) =
    Σ b_i θ^i), C, D, E, cx, cy]. Returns (params (Q+5,), poses (V, 6),
    rms)."""
    nb = int(init_params.shape[0]) - 5
    # the affine [[C,D],[E,1]] is near-degenerate with the polynomial and
    # the center over bounded board coverage; a weak identity prior pins
    # the valley (real OCAM affines are within ~1e-2 of identity) without
    # biasing well-constrained data
    prior = (np.array([nb, nb + 1, nb + 2]),
             np.array([1.0, 0.0, 0.0], np.float32),
             np.array([1000.0, 1000.0, 1000.0], np.float32))
    return _calibrate_gn(_project_scaramuzza, nb + 5, obj_pts, img_pts, valid,
                         init_params, poses0, iters, prior=prior)


def calibrate_mei(obj_pts: torch.Tensor, img_pts: torch.Tensor,
                  valid: torch.Tensor, init_params: torch.Tensor,
                  poses0: torch.Tensor, iters: int = 30):
    """Unified (Mei) catadioptric calibration (camodocal
    `CataCamera::estimateIntrinsics` + Ceres refinement role).

    init_params (9,) = [xi, fx, fy, cx, cy, k1, k2, p1, p2]. Returns
    (params (9,), poses (V, 6), rms)."""
    return _calibrate_gn(_project_mei, 9, obj_pts, img_pts, valid, init_params,
                         poses0, iters)

"""Plane-sweep absolute-difference cost volume (port of
``cvids_tpu/ops/costvolume.py``).

For every pixel and inverse-depth hypothesis ρ the measurement is sampled at
x₂ ~ A x₁ + b ρ (A = K₂R₂₁K₁⁻¹, b = K₂t₂₁). As in the reference, the
measurement is first aligned once, meas_aligned(x) = meas(A x), after which
each depth plane is a separable scale + translation of the aligned image:
    u₂ = (u + c₀ρ) s,  v₂ = (v + c₁ρ) s,  s = 1/(1 + c₂ρ),  c = A⁻¹ b.
The cost is the 3×3 box mean of |sample − ref| with a −1 sentinel where the
centre sample is out of view. On the card the per-sample work is the
`plane_sweep` kernel (a direct bilinear fetch per sample); the alignment warp
is the banded kernel or the exact two-pass warp, chosen by the caller.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_kernels
from .image import bilinear_sample, projective_warp_mxu

__all__ = ["plane_sweep_cost", "accumulate_cost", "warp_coords",
           "warp_shift_bounds_np", "plane_sweep_cost_gather"]


def warp_coords(a_mat: torch.Tensor, b_vec: torch.Tensor,
                inv_depths: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Warped pixel coordinates (D, H, W, 2) for each inverse-depth plane."""
    dev = a_mat.device
    u = torch.arange(width, dtype=torch.float32, device=dev)
    v = torch.arange(height, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")                 # (H, W)
    base = torch.einsum("ij,jhw->ihw", a_mat,
                        torch.stack([uu, vv, torch.ones_like(uu)]))
    p = base[None] + b_vec[None, :, None, None] * inv_depths[:, None, None, None]
    z = p[:, 2]
    safe = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
    return torch.stack([p[:, 0] / safe, p[:, 1] / safe], dim=-1)


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box filter over the last two dims (edge-replicated)."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    acc = torch.zeros_like(x)
    for dy in range(3):
        xs = torch.index_select(x, x.ndim - 2, (rows + dy - 1).clamp(0, h - 1))
        for dx in range(3):
            acc = acc + torch.index_select(xs, x.ndim - 1,
                                           (cols + dx - 1).clamp(0, w - 1))
    return acc / 9.0


def plane_sweep_cost_gather(ref: torch.Tensor, meas: torch.Tensor,
                            a_mat: torch.Tensor, b_vec: torch.Tensor,
                            inv_depths: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Direct per-(pixel, hypothesis) gather form of `plane_sweep_cost`;
    the semantic oracle of the tests."""
    h, w = ref.shape
    coords = warp_coords(a_mat, b_vec, inv_depths, h, w)         # (D, H, W, 2)
    warped = bilinear_sample(meas, coords, fill=float("nan"))    # (D, H, W)
    ad = torch.abs(warped - ref[None])
    valid = torch.isfinite(ad)
    ad = torch.where(valid, ad, torch.zeros((), device=ad.device))
    cost = _box3(ad)
    return torch.movedim(cost, 0, -1), torch.movedim(valid, 0, -1)


def _sweep_positions(a_mat: torch.Tensor, b_vec: torch.Tensor,
                     inv_depths: torch.Tensor, height: int, width: int):
    """Per-depth separable sweep positions + the affine quad-test coeffs.

    Returns pos_x (D, W), pos_y (D, H) fp32 (−1e9 where the plane is behind
    the camera, so every in-bounds test fails), and mx (D, 3, W), my (D, 3, H)
    with m_i(d, q, p) = mx[d, i, p] + my[d, i, q] — the aligned-image validity
    half-plane tests.
    """
    f32 = torch.float32
    dev = a_mat.device
    u = torch.arange(width, dtype=f32, device=dev)
    v = torch.arange(height, dtype=f32, device=dev)
    a = a_mat.to(f32)
    # solve_ex: no error check, so no host sync on the device
    c = torch.linalg.solve_ex(a, b_vec.to(f32))[0]
    rho = inv_depths.to(f32)
    den = 1.0 + c[2] * rho
    s = torch.where(torch.abs(den) > 1e-3, 1.0 / den, torch.zeros_like(den))
    depth_ok = den > 1e-3
    pos_x = (u[None, :] + (c[0] * rho)[:, None]) * s[:, None]
    pos_y = (v[None, :] + (c[1] * rho)[:, None]) * s[:, None]
    pos_x = torch.where(depth_ok[:, None], pos_x, torch.full_like(pos_x, -1e9))
    pos_y = torch.where(depth_ok[:, None], pos_y, torch.full_like(pos_y, -1e9))
    mx = a[:, 0][None, :, None] * pos_x[:, None, :] + a[:, 2][None, :, None]
    my = a[:, 1][None, :, None] * pos_y[:, None, :]
    return pos_x, pos_y, mx, my


def warp_shift_bounds_np(a_mat: np.ndarray, height: int, width: int,
                         step: int = 16) -> tuple[float, float]:
    """Host-side bound on the alignment warp's per-pass shifts (max |g - u|,
    max |y_in - v| over a coarse pixel grid): callers pick the banded warp
    kernel when it is within the bands, the exact warp otherwise."""
    m = np.asarray(a_mat, np.float64)
    u = np.arange(0, width, step, dtype=np.float64)
    v = np.arange(0, height, step, dtype=np.float64)
    r = v
    den_v = m[1, 1] - r * m[2, 1]
    deg = np.abs(den_v) < 1e-3
    safe = np.where(deg, 1.0, den_v)
    v_ur = ((r[:, None] * (m[2, 0] * u[None, :] + m[2, 2])
             - m[1, 0] * u[None, :] - m[1, 2]) / safe[:, None])
    zd = m[2, 0] * u[None, :] + m[2, 1] * v_ur + m[2, 2]
    zd = np.where(np.abs(zd) > 1e-6, zd, 1e-6)
    g = (m[0, 0] * u[None, :] + m[0, 1] * v_ur + m[0, 2]) / zd
    dx = np.abs(g - u[None, :])[~deg[:, None] & np.ones_like(g, bool)]
    zz = m[2, 0] * u[None, :] + m[2, 1] * v[:, None] + m[2, 2]
    zz = np.where(np.abs(zz) > 1e-6, zz, 1e-6)
    y_in = (m[1, 0] * u[None, :] + m[1, 1] * v[:, None] + m[1, 2]) / zz
    dy = np.abs(y_in - v[:, None])
    return (float(dx.max()) if dx.size else np.inf, float(dy.max()))


def plane_sweep_cost(ref: torch.Tensor, meas: torch.Tensor,
                     a_mat: torch.Tensor, b_vec: torch.Tensor,
                     inv_depths: torch.Tensor,
                     out_dtype: torch.dtype | None = None,
                     banded_warp: bool | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One measurement frame's cost slice.

    ref, meas: (H, W) intensity images. Returns (cost (H, W, D), valid
    (H, W, D)) where invalid = the warped centre sample is outside the
    measurement image (cost 0 there). `banded_warp` picks the banded
    alignment warp kernel; callers gate it on `warp_shift_bounds_np`, since
    it loses coverage for shifts beyond its band. Default: the exact warp.
    """
    h, w = ref.shape
    f32 = torch.float32
    cdt = f32 if out_dtype is None else out_dtype
    if banded_warp:
        meas_cov, cov_pw = cuda_kernels.projective_warp_banded(meas.to(f32), a_mat)
    else:
        meas_cov, cov_pw = projective_warp_mxu(meas.to(f32), a_mat)
    meas_al = (meas_cov / torch.clamp(cov_pw, min=1e-3)).contiguous()
    pos_x, pos_y, mx, my = _sweep_positions(a_mat, b_vec, inv_depths, h, w)
    cost = cuda_kernels.plane_sweep(ref.to(f32).contiguous(), meas_al,
                                    pos_x.contiguous(), pos_y.contiguous(),
                                    mx.contiguous(), my.contiguous(),
                                    out_dtype=cdt)
    return torch.clamp(cost, min=0), cost >= 0


def accumulate_cost(mean_cost: torch.Tensor, count: torch.Tensor,
                    new_cost: torch.Tensor, new_valid: torch.Tensor):
    """Running mean across measurement frames. Invalid samples don't count.

    Updates `mean_cost` and `count` (H, W, D) IN PLACE and returns them."""
    count.add_(new_valid.to(count.dtype))
    step = (new_cost - mean_cost) / torch.clamp(count, min=1.0)
    mean_cost.add_(torch.where(new_valid, step, torch.zeros((), dtype=step.dtype,
                                                            device=step.device)))
    return mean_cost, count

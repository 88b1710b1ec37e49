"""Per-pixel Gaussian×Beta (Vogiatzis/REMODE) inverse-depth filter (port of
``cvids_tpu/ops/depth_filter.py``).

Each pixel keeps a Gaussian inverse-depth estimate (mu, sigma²) and a Beta
inlier model (a, b); a new measurement (x, tau²) is fused by moment
matching. State can be reprojected into a new reference frame (forward
splat, nearest surface wins, variance inflated by (d'/d)⁴).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import resolve_device

__all__ = ["FilterState", "init_state", "update", "propagate", "converged_mask"]


class FilterState(NamedTuple):
    mu: torch.Tensor      # (H, W) inverse-depth mean
    sigma2: torch.Tensor  # (H, W) variance
    a: torch.Tensor       # (H, W) Beta inlier count
    b: torch.Tensor       # (H, W) Beta outlier count


def init_state(height: int, width: int, mu0: float = 0.5, sigma2_0: float = 100.0,
               a0: float = 15.0, b0: float = 15.0, dtype=torch.float32,
               device: torch.device | str | None = None) -> FilterState:
    """Defaults mirror the reference init (`depth_filter.cpp:98-110`).
    `device=None` means the card (`cvids_tpu_torch.default_device()`)."""
    device = resolve_device(device)

    def full(v):
        return torch.full((height, width), v, dtype=dtype, device=device)
    return FilterState(full(mu0), full(sigma2_0), full(a0), full(b0))


def update(state: FilterState, x: torch.Tensor, tau2: torch.Tensor,
           meas_valid: torch.Tensor,
           mu_range: tuple[float, float] = (0.01, 100.0)) -> FilterState:
    """Fuse measurement x (inverse depth) with variance tau2, masked.

    Out-of-range measurements only bump the Beta outlier count; soft
    outliers are down-weighted by the Beta-uniform mixture itself."""
    mu, s2, a, b = state
    norm_scale2 = s2 + tau2
    s = 1.0 / (1.0 / torch.clamp(s2, min=1e-12) + 1.0 / torch.clamp(tau2, min=1e-12))
    m = s * (mu / torch.clamp(s2, min=1e-12) + x / torch.clamp(tau2, min=1e-12))
    pdf = torch.exp(-0.5 * (x - mu) ** 2 / torch.clamp(norm_scale2, min=1e-12)) \
        / torch.sqrt(2 * math.pi * torch.clamp(norm_scale2, min=1e-12))
    uniform = 1.0 / (mu_range[1] - mu_range[0])
    c1 = a / (a + b) * pdf
    c2 = b / (a + b) * uniform
    denom = torch.clamp(c1 + c2, min=1e-12)
    c1, c2 = c1 / denom, c2 / denom
    f = c1 * (a + 1.0) / (a + b + 1.0) + c2 * a / (a + b + 1.0)
    e = c1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0)) \
        + c2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0))
    mu_new = c1 * m + c2 * mu
    s2_new = c1 * (s + m * m) + c2 * (s2 + mu * mu) - mu_new * mu_new
    a_new = (e - f) / (f - e / torch.clamp(f, min=1e-12))
    b_new = a_new * (1.0 - f) / torch.clamp(f, min=1e-12)

    hard_out = (x < mu_range[0]) | (x > mu_range[1]) | ~meas_valid

    def keep(new, old):
        return torch.where(hard_out, old, new)

    return FilterState(
        mu=keep(mu_new, mu),
        sigma2=torch.clamp(keep(s2_new, s2), min=1e-10),
        a=keep(a_new, a),
        b=keep(b_new, torch.where(meas_valid, b + 1.0, b)),
    )


def converged_mask(state: FilterState, ratio: float = 0.5,
                   max_sigma2: float | None = None,
                   min_support: float = 0.5, a0: float = 15.0) -> torch.Tensor:
    """Inlier-ratio mask (`depth_estimator.cpp:365-492`: a/(a+b) >= 0.5),
    plus a > a0 + min_support so that never-updated pixels (which sit at
    exactly 0.5 under the symmetric prior) do not pass."""
    ok = state.a / torch.clamp(state.a + state.b, min=1e-9) >= ratio
    if min_support > 0.0:
        ok = ok & (state.a > a0 + min_support)
    if max_sigma2 is not None:
        ok = ok & (state.sigma2 <= max_sigma2)
    return ok


def propagate(state: FilterState, r_no: torch.Tensor, t_no: torch.Tensor,
              k_new: torch.Tensor, k_old_inv: torch.Tensor,
              sigma_inflate: float = 1.2,
              init: FilterState | None = None) -> FilterState:
    """Reproject filter state from an old reference frame to a new one.

    r_no, t_no: transform old-cam -> new-cam. Forward splat (nearest pixel);
    collisions resolve toward the nearer surface (min depth); variance
    inflates by (d_new/d_old)⁴ × sigma_inflate. Unhit target pixels reset to
    `init` (fresh prior)."""
    h, w = state.mu.shape
    dt = state.mu.dtype
    dev = state.mu.device
    if init is None:
        init = init_state(h, w, dtype=dt, device=dev)
    u = torch.arange(w, dtype=dt, device=dev)
    v = torch.arange(h, dtype=dt, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rays = torch.einsum("ij,jhw->ihw", k_old_inv,
                        torch.stack([uu, vv, torch.ones_like(uu)]))
    depth_old = 1.0 / torch.clamp(state.mu, min=1e-6)
    pts_old = rays * depth_old[None]
    pts_new = torch.einsum("ij,jhw->ihw", r_no, pts_old) + t_no[:, None, None]
    z_new = pts_new[2]
    proj = torch.einsum("ij,jhw->ihw", k_new, pts_new)
    pu = proj[0] / torch.clamp(proj[2], min=1e-6)
    pv = proj[1] / torch.clamp(proj[2], min=1e-6)
    ok = (z_new > 1e-3) & (pu >= 0) & (pu <= w - 1) & (pv >= 0) & (pv <= h - 1)

    mu_new_val = 1.0 / torch.clamp(z_new, min=1e-6)
    ratio4 = (mu_new_val / torch.clamp(state.mu, min=1e-6)) ** 4
    s2_new_val = state.sigma2 * ratio4 * sigma_inflate

    n = h * w
    flat_idx = (torch.round(pv).to(torch.int64) * w + torch.round(pu).to(torch.int64))
    flat_idx = torch.where(ok, flat_idx, n).ravel()   # invalid -> overflow slot
    order_key = torch.where(ok, z_new, float("inf")).ravel()
    # segment-min of depth picks the winning source pixel per target
    seg_min = torch.full((n + 1,), float("inf"), dtype=dt, device=dev)
    seg_min.scatter_reduce_(0, flat_idx, order_key, reduce="amin")
    winner = (order_key == seg_min[flat_idx]) & ok.ravel()
    target = torch.where(winner, flat_idx, n)

    def scatter(values, default):
        out = torch.full((n + 1,), default, dtype=dt, device=dev)
        out[target] = torch.where(winner, values.ravel(),
                                  torch.full((), default, dtype=dt, device=dev))
        return out[:n].reshape(h, w)

    got = scatter(torch.ones_like(state.mu), 0.0) > 0.5
    return FilterState(
        mu=torch.where(got, scatter(mu_new_val, 0.0), init.mu),
        sigma2=torch.where(got, scatter(s2_new_val, 0.0), init.sigma2),
        a=torch.where(got, scatter(state.a, 0.0), init.a),
        b=torch.where(got, scatter(state.b, 0.0), init.b),
    )

"""Semi-global matching: 4 directional scans + WTA with subpixel refinement
(port of ``cvids_tpu/ops/sgm.py``).

The scans and the WTA run through the `cuda_kernels` wrappers: both
orientations of the bidirectional scan (fp32 carries, each direction
rounded to the cost dtype, pair-summed), then the fused WTA over the two
pair sums. `_scan_bidir` and `wta_depth` are the plain forms of the
reference's XLA path, carried in the cost dtype.

Penalties follow the reference semantics: P1 for ±1 depth moves, P2 (image-
gradient modulated) for larger jumps, and the min-normalization `- min_d
L(p-1, d)` keeping the carry bounded.
"""

from __future__ import annotations

import torch

from . import cuda_kernels

__all__ = ["sgm_aggregate", "sgm_aggregate_parts", "wta_depth", "sgm_depth"]


def _shift_d(l: torch.Tensor, s: int) -> torch.Tensor:
    """Shift along the last (depth) axis with +inf padding."""
    pad = torch.full_like(l[..., :1], float("inf"))
    if s == 1:
        return torch.cat([pad, l[..., :-1]], -1)
    return torch.cat([l[..., 1:], pad], -1)


def _sgm_update(l_prev: torch.Tensor, c: torch.Tensor, p2: torch.Tensor,
                p1: torch.Tensor) -> torch.Tensor:
    """One SGM recurrence step: L(p) = C(p) + min(...) − min_d L(p−1)."""
    min_prev = torch.amin(l_prev, dim=-1, keepdim=True)
    cand = torch.minimum(
        l_prev,
        torch.minimum(torch.minimum(_shift_d(l_prev, 1), _shift_d(l_prev, -1)) + p1,
                      min_prev + p2[..., None]))
    return c + cand - min_prev


def _scan_bidir(cost: torch.Tensor, p1: torch.Tensor,
                p2_eff: torch.Tensor) -> torch.Tensor:
    """Forward + backward directional passes along axis 0 of (S, X, D) cost,
    carried in the cost dtype (the reference's lax.scan form), returned
    pre-summed: agg_fwd + agg_bwd."""
    s = cost.shape[0]
    p1 = cuda_kernels._scalar(p1, cost.device).to(cost.dtype)

    def run(order):
        out = torch.empty_like(cost)
        lv = cost[order[0]]
        out[order[0]] = lv
        for i in order[1:]:
            lv = _sgm_update(lv, cost[i], p2_eff[i], p1)
            out[i] = lv
        return out

    return run(list(range(s))) + run(list(range(s - 1, -1, -1)))


def sgm_aggregate(cost: torch.Tensor, grad: torch.Tensor,
                  pi1: float = 16.0, pi2: float = 64.0,
                  tau_so: float = 8.0, q1: float = 1.0, q2: float = 1.0,
                  penalty_scale: torch.Tensor | None = None) -> torch.Tensor:
    """4-direction SGM aggregation of (H, W, D) cost (the sum of
    `sgm_aggregate_parts`)."""
    parts = sgm_aggregate_parts(cost, grad, pi1=pi1, pi2=pi2, tau_so=tau_so,
                                q1=q1, q2=q2, penalty_scale=penalty_scale)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def sgm_aggregate_parts(cost: torch.Tensor, grad: torch.Tensor,
                        pi1: float = 16.0, pi2: float = 64.0,
                        tau_so: float = 8.0, q1: float = 1.0, q2: float = 1.0,
                        penalty_scale: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two bidirectional parts (horizontal, vertical) of
    `sgm_aggregate`, not yet summed, so the fused WTA adds them in
    registers. Each is (H, W, D) in the cost dtype.

    Where the image gradient exceeds tau_so the penalties drop to pi/q;
    `penalty_scale` (H, W) multiplies both. P1 is the mean of its map."""
    big_jump = grad > tau_so
    dt = cost.dtype
    # device fills, not host copies: the frame runs inside a CUDA graph
    dev = cost.device
    p2_map = torch.where(big_jump, torch.full((), pi2 / q2, device=dev),
                         torch.full((), pi2, device=dev)).to(dt)
    p1_map = torch.where(big_jump, torch.full((), pi1 / q1, device=dev),
                         torch.full((), pi1, device=dev)).to(dt)
    if penalty_scale is not None:
        p2_map = p2_map * penalty_scale.to(dt)
        p1_map = p1_map * penalty_scale.to(dt)
    p1_s = p1_map.mean(dtype=torch.float32).to(dt)
    cost = cost.contiguous()
    p2_map = p2_map.contiguous()
    part_h = cuda_kernels.sgm_scan_bidir(cost, p2_map, p1_s, axis=1)
    part_v = cuda_kernels.sgm_scan_bidir(cost, p2_map, p1_s, axis=0)
    return part_h, part_v


def wta_depth(cost: torch.Tensor, valid_count: torch.Tensor | None = None,
              min_count: float = 1.0, peak_ratio: float = 0.98):
    """Winner-take-all over the depth axis + parabola subpixel refinement +
    peak-sharpness rejection (`filterCostKernel`, `calc_cost.cu:235-283`).

    Returns (idx_float (H, W), conf (H, W) bool)."""
    d = cost.shape[-1]
    c0 = torch.amin(cost, dim=-1)
    idx = torch.argmin(cost, dim=-1)   # first minimum, as jnp.argmin
    im = (idx - 1).clamp(0, d - 1)
    ip = (idx + 1).clamp(0, d - 1)
    cm = torch.gather(cost, -1, im[..., None])[..., 0]
    cp = torch.gather(cost, -1, ip[..., None])[..., 0]
    denom = cm + cp - 2.0 * c0
    delta = torch.where(denom > 1e-6, 0.5 * (cm - cp) / torch.clamp(denom, min=1e-6),
                        torch.zeros((), dtype=cost.dtype, device=cost.device))
    delta = torch.clamp(delta, -1.0, 1.0)
    idx_f = idx.to(cost.dtype) + delta
    lane = torch.arange(d, device=cost.device)
    masked = torch.where(torch.abs(lane - idx[..., None]) <= 1,
                         torch.full((), float("inf"), dtype=cost.dtype,
                                    device=cost.device), cost)
    c2 = torch.amin(masked, dim=-1)
    conf = (c0 < peak_ratio * c2) & (idx > 0) & (idx < d - 1)
    if valid_count is not None:
        conf = conf & (valid_count >= min_count)
    return idx_f, conf


def sgm_depth(cost: torch.Tensor, grad: torch.Tensor, inv_depths: torch.Tensor,
              valid_count: torch.Tensor | None = None, min_count: float = 1.0,
              **kw):
    """Aggregate + WTA + map to inverse depth. Returns (inv_depth, conf).

    The two pair-summed SGM parts go to the fused WTA kernel, which sums
    them in fp32; the valid_count gate is applied here on (H, W) maps."""
    parts = sgm_aggregate_parts(cost, grad, **kw)
    idx_f, conf = cuda_kernels.wta(*parts)
    if valid_count is not None:
        conf = conf & (valid_count >= min_count)
    step = inv_depths[1] - inv_depths[0]
    inv_depth = inv_depths[0] + idx_f * step
    return inv_depth, conf

"""Basic image ops: separable Gaussian blur, Sobel gradients, bilinear
sampling, pyramid construction and the exact two-pass projective warp (port
of ``cvids_tpu/ops/image.py``). Convolutions replicate the edge.

All functions take and return tensors and allocate on their inputs' device.
"""

from __future__ import annotations

import torch

__all__ = ["gaussian_kernel1d", "gaussian_blur", "sobel", "image_gradients",
           "bilinear_sample", "downsample2x", "build_pyramid",
           "warp_pass_positions", "projective_warp_mxu"]


def gaussian_kernel1d(sigma: float, radius: int | None = None,
                      dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _conv1d(img: torch.Tensor, k: torch.Tensor, axis: int) -> torch.Tensor:
    """Separable 'same' convolution with edge replication along one axis."""
    r = (k.shape[0] - 1) // 2
    n = img.shape[axis]
    idx = torch.arange(n, device=img.device)
    out = torch.zeros_like(img, dtype=torch.float32)
    for i in range(k.shape[0]):
        tap = torch.index_select(img, axis, (idx + i - r).clamp(0, n - 1))
        out = out + k[i] * tap
    return out.to(img.dtype)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Gaussian blur of (..., H, W) images, edge-replicated (sigma 2, radius 4
    is the BRIEF pre-blur)."""
    k = gaussian_kernel1d(sigma, radius, device=img.device)
    out = _conv1d(img.to(torch.float32), k, img.ndim - 2)
    return _conv1d(out, k, img.ndim - 1)


_SOBEL_TAPS: dict = {}


def _sobel_taps(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(smoothing, difference) taps on `device`, copied there once per
    device: their uploads block the host on a card (`tracing.sync`), and a
    captured reference roll may copy nothing from the host."""
    taps = _SOBEL_TAPS.get(device)
    if taps is None:
        from ..utils import tracing     # not at import: `utils` imports `dense`, which imports this
        with tracing.sync():
            taps = _SOBEL_TAPS[device] = (torch.tensor([1.0, 2.0, 1.0], device=device),
                                          torch.tensor([-1.0, 0.0, 1.0], device=device))
    return taps


def sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel gx, gy for (..., H, W) float images (standard 3x3, no scaling)."""
    img = img.to(torch.float32)
    smooth, diff = _sobel_taps(img.device)
    gx = _conv1d(_conv1d(img, diff, img.ndim - 1), smooth, img.ndim - 2)
    gy = _conv1d(_conv1d(img, diff, img.ndim - 2), smooth, img.ndim - 1)
    return gx, gy


def image_gradients(img: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude |∇I| from Sobel (used for SGM penalty modulation)."""
    gx, gy = sobel(img)
    return torch.sqrt(gx * gx + gy * gy)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Sample an (H, W) image at (..., 2) float pixel coords (x, y).

    Out-of-bounds coordinates return `fill`. Pure gather formulation: the
    four taps (each clamped to the image) are one gather from the flattened
    image, and the interpolation is the JAX package's, operation for
    operation; ~30 small launches a call on a card.
    """
    h, w = img.shape[-2], img.shape[-1]
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)
    cols = torch.stack([xi, xi + 1]).clamp_(0, w - 1)
    rows = torch.stack([yi, yi + 1]).clamp_(0, h - 1).mul_(w)
    v = img.reshape(-1)[rows[:, None] + cols[None]]     # (2 rows, 2 cols, ...)
    gx = 1 - fx
    top = v[0, 0] * gx + v[0, 1] * fx
    bot = v[1, 0] * gx + v[1, 1] * fx
    out = top * (1 - fy) + bot * fy
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return torch.where(inside, out, torch.full((), fill, dtype=out.dtype, device=out.device))


def warp_pass_positions(m: torch.Tensor, h: int, w: int,
                        eps: float = 1e-3) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-pass (Catmull-Smith) resampling positions for the projective map
    [x_in, y_in, 1] ~ m @ [u, v, 1].

    Returns (g (H, W), y_in (H, W)) fp32: pass 1 samples input row r at
    horizontal position g[r, u]; pass 2 samples the intermediate at vertical
    position y_in[v, u]. Degenerate pass-1 rows get g = -1e9 (no coverage).
    """
    f32 = torch.float32
    m = m.to(f32)
    u = torch.arange(w, dtype=f32, device=m.device)
    v = torch.arange(h, dtype=f32, device=m.device)
    r = v
    den_v = m[1, 1] - r * m[2, 1]                                  # (H,)
    deg = torch.abs(den_v) < eps
    safe_den = torch.where(deg, torch.ones_like(den_v), den_v)
    v_ur = ((r[:, None] * (m[2, 0] * u[None, :] + m[2, 2])
             - m[1, 0] * u[None, :] - m[1, 2]) / safe_den[:, None])  # (H, W)
    zd = m[2, 0] * u[None, :] + m[2, 1] * v_ur + m[2, 2]
    zd = torch.where(torch.abs(zd) > 1e-6, zd, torch.full_like(zd, 1e-6))
    g = (m[0, 0] * u[None, :] + m[0, 1] * v_ur + m[0, 2]) / zd       # (H, W)
    g = torch.where(deg[:, None], torch.full_like(g, -1e9), g)       # kill row
    zz = m[2, 0] * u[None, :] + m[2, 1] * v[:, None] + m[2, 2]
    zz = torch.where(torch.abs(zz) > 1e-6, zz, torch.full_like(zz, 1e-6))
    y_in = (m[1, 0] * u[None, :] + m[1, 1] * v[:, None] + m[1, 2]) / zz
    return g, y_in


def _resample_rows(vals: torch.Tensor, pos: torch.Tensor,
                   wdt: torch.dtype) -> torch.Tensor:
    """out[c, r, u] = sum_x vals[c, r, x] · hat(pos[r, u] - x) over x in
    [0, L-1], with the hat weight rounded to `wdt` and fp32 accumulation.

    A hat weight is nonzero only at the two integer taps around `pos`, so
    this gathers those two instead of contracting the (R, U, L) weight
    tensor; taps outside [0, L-1] are not in the sum."""
    length = vals.shape[-1]
    x0 = torch.floor(pos)
    x1 = x0 + 1.0
    w0 = torch.clamp(1.0 - torch.abs(pos - x0), min=0.0).to(wdt).to(torch.float32)
    w1 = torch.clamp(1.0 - torch.abs(pos - x1), min=0.0).to(wdt).to(torch.float32)
    in0 = (x0 >= 0) & (x0 <= length - 1)
    in1 = (x1 >= 0) & (x1 <= length - 1)
    i0 = x0.clamp(0, length - 1).to(torch.int64)
    i1 = x1.clamp(0, length - 1).to(torch.int64)
    c = vals.shape[0]
    v0 = torch.gather(vals, 2, i0.expand(c, -1, -1))
    v1 = torch.gather(vals, 2, i1.expand(c, -1, -1))
    zero = torch.zeros((), device=vals.device)
    return torch.where(in0, v0 * w0, zero) + torch.where(in1, v1 * w1, zero)


def projective_warp_mxu(img: torch.Tensor, m: torch.Tensor, eps: float = 1e-3,
                        weight_dtype: torch.dtype = torch.bfloat16
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact projective warp: out(u, v) = img(x_in(u, v), y_in(u, v)) with
    [x_in, y_in, 1] ~ m @ [u, v, 1], as two 1-D linear-interpolation passes
    (Catmull & Smith 1980 two-pass warping, exact for bilinear taps).

    Pass 1 resamples each input row r horizontally at g(u, r); pass 2
    resamples columns at y_in(u, v) (`warp_pass_positions`). Each pass is a
    two-tap gather. The rounding points are the reference's: the image, the
    coverage channel and the hat weights are rounded to `weight_dtype`, the
    sums are fp32, and the intermediate is rounded to `weight_dtype` before
    pass 2 — whatever the volume dtype of the caller.

    Returns (warped_times_coverage (H, W), coverage (H, W)): taps outside the
    image contribute zero weight, so dividing by the coverage renormalizes
    and coverage < 1 marks boundary/out-of-view pixels. Rows where the
    pass-1 inversion degenerates (|m11 - r·m21| < eps) get zero coverage.
    """
    wdt = weight_dtype
    f32 = torch.float32
    img = img.to(f32)
    h, w = img.shape
    g, y_in = warp_pass_positions(m, h, w, eps)
    stack = torch.stack([img, torch.ones_like(img)]).to(wdt).to(f32)  # (2, H, W)
    tmp = _resample_rows(stack, g, wdt)                                # (2, H, W)
    # pass 2 on the transposed intermediate: rows are image columns u
    tmp_t = tmp.to(wdt).to(f32).transpose(1, 2).contiguous()          # (2, W, H)
    out = _resample_rows(tmp_t, y_in.T.contiguous(), wdt)              # (2, W, H)
    return out[0].T, out[1].T


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2×2 average-pool downsample of (..., H, W); H, W must be even."""
    h, w = img.shape[-2] // 2, img.shape[-1] // 2
    x = img[..., : h * 2, : w * 2]
    x = x.reshape(x.shape[:-2] + (h, 2, w, 2))
    return torch.mean(x.to(torch.float32), dim=(-3, -1))


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Gaussian-ish pyramid: level 0 = input, each next = blur + 2x downsample."""
    pyr = [img.to(torch.float32)]
    for _ in range(levels - 1):
        pyr.append(downsample2x(gaussian_blur(pyr[-1], 1.0, 1)))
    return pyr

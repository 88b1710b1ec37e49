"""Plain PyTorch reference of the server's dense depth layer, frozen from
the program's plain (CPU) path as it stood when the benchmark was written:
the reference image's maps, the sparse-landmark cost bias, the banded and
exact alignment warps, the plane-sweep absolute-difference cost, its
running mean, the four SGM scans, the winner-take-all, the Gaussian x Beta
filter, the converged mask, the photometric validation and the filter's
propagation to the next reference (`cvids_tpu_torch/dense/estimator.py`,
`ops/costvolume.py`, `ops/sgm.py`, `ops/depth_filter.py`, `ops/image.py` and
the plain forms of the kernels in `ops/cuda_kernels.py`).

It imports nothing of the program. The volume precision is a parameter:
`Precision("bfloat16")` is the configuration's (bf16 tensors, as the
program stores its cost volumes); `Precision("float8_e5m2")` is the control,
each volume value rounded to fp8 after every operation that stores one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

BIG = 3.0e38


class Precision:
    """The cost volume's number format: the carrier dtype of the volume
    tensors and the rounding applied after each operation on them."""

    def __init__(self, name: str):
        self.name = name
        if name == "bfloat16":
            self.carrier, self._fmt = torch.bfloat16, None
        elif name == "float32":
            self.carrier, self._fmt = torch.float32, None
        else:
            self.carrier, self._fmt = torch.float32, getattr(torch, name)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x (in the carrier dtype) rounded to the format."""
        return x if self._fmt is None else x.to(self._fmt).to(torch.float32)

    def to(self, x: torch.Tensor) -> torch.Tensor:
        return self.q(x.to(self.carrier))


class Dense(NamedTuple):
    height: int
    width: int
    num_depths: int
    dep_sample: float
    pi1: float
    pi2: float
    tau_so: float
    sparse_ratio: float
    tau2_scale: float
    min_frames: int
    use_penalty_map: bool


def dense_params(cfg: dict) -> Dense:
    return Dense(*(cfg[k] for k in Dense._fields))


class Filter(NamedTuple):
    mu: torch.Tensor
    sigma2: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor


class State(NamedTuple):
    ref_img: torch.Tensor
    grad: torch.Tensor
    penalty: torch.Tensor
    bias: torch.Tensor | None
    mean_cost: torch.Tensor
    count: torch.Tensor
    filt: Filter
    num_frames: int


# ---------------------------------------------------------------- images

def _conv1d(img, k, axis):
    r = (k.shape[0] - 1) // 2
    n = img.shape[axis]
    idx = torch.arange(n, device=img.device)
    out = torch.zeros_like(img, dtype=torch.float32)
    for i in range(k.shape[0]):
        out = out + k[i] * torch.index_select(img, axis, (idx + i - r).clamp(0, n - 1))
    return out.to(img.dtype)


def gradient_magnitude(img: torch.Tensor) -> torch.Tensor:
    """|Sobel| of an (H, W) image, edge-replicated."""
    img = img.to(torch.float32)
    smooth = torch.tensor([1.0, 2.0, 1.0], device=img.device)
    diff = torch.tensor([-1.0, 0.0, 1.0], device=img.device)
    gx = _conv1d(_conv1d(img, diff, 1), smooth, 0)
    gy = _conv1d(_conv1d(img, diff, 0), smooth, 1)
    return torch.sqrt(gx * gx + gy * gy)


def bilinear(img: torch.Tensor, xy: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    h, w = img.shape[-2], img.shape[-1]
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xi, yi = x0.to(torch.int64), y0.to(torch.int64)
    cols = torch.stack([xi, xi + 1]).clamp_(0, w - 1)
    rows = torch.stack([yi, yi + 1]).clamp_(0, h - 1).mul_(w)
    v = img.reshape(-1)[rows[:, None] + cols[None]]
    gx = 1 - fx
    top = v[0, 0] * gx + v[0, 1] * fx
    bot = v[1, 0] * gx + v[1, 1] * fx
    out = top * (1 - fy) + bot * fy
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return torch.where(inside, out, torch.full((), fill, dtype=out.dtype, device=out.device))


def remap_grid(cam: dict, h: int, w: int, device) -> torch.Tensor | None:
    """Each dense-image pixel's source pixel in a radtan camera's image (the
    undistortion onto the pinhole of the same fx, fy, cx, cy), or None for
    an undistorted camera."""
    if not any(cam["dist"]):
        return None
    fx, fy, cx, cy = (float(cam[k]) for k in ("fx", "fy", "cx", "cy"))
    uu, vv = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                            torch.arange(h, dtype=torch.float32, device=device), indexing="xy")
    x, y = (uu - cx) / fx, (vv - cy) / fy
    k1, k2, p1, p2 = (float(d) for d in cam["dist"])
    r2 = x * x + y * y
    rad = k1 * r2 + k2 * r2 * r2
    dx = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * rad + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return torch.stack([fx * (x + dx) + cx, fy * (y + dy) + cy], -1).contiguous()


def dense_image(img: np.ndarray, grid: torch.Tensor | None, device) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(img, np.float32)).to(device)
    return t if grid is None else bilinear(t, grid, fill=0.0)


# ---------------------------------------------------------------- reference start

def penalty_map(grad):
    g = torch.abs(grad.to(torch.float32))
    rel = g / torch.clamp(torch.mean(g), min=1e-6)
    return (0.8 + 1.5 / (1.0 + rel ** 3)).to(torch.float32)


def inv_depths(p: Dense, device) -> torch.Tensor:
    return torch.as_tensor((np.arange(p.num_depths, dtype=np.float32) + 1.0) * p.dep_sample,
                           device=device)


def sparse_points(pkt, k: np.ndarray):
    """A packet's window landmarks as (pixel uv, inverse depth, valid) in its
    image, or None (`BindSparsePoints`)."""
    if pkt.win_pts3d is None or len(pkt.win_pts3d) == 0:
        return None
    w_, x, y, z = np.asarray(pkt.q_wb, np.float64)
    xx, yy, zz, wx, wy, wz = x * x, y * y, z * z, w_ * x, w_ * y, w_ * z
    xy, xz, yz = x * y, x * z, y * z
    r_wb = np.array([[1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
                     [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
                     [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]])
    pts_b = (pkt.win_pts3d - pkt.p_wb) @ r_wb
    pts_c = (pts_b - pkt.p_bc) @ np.asarray(pkt.r_cb).T
    zc = pts_c[:, 2]
    uv_h = pts_c @ k.T
    uv = uv_h[:, :2] / np.maximum(uv_h[:, 2:3], 1e-6)
    valid = np.asarray(pkt.win_valid, bool) & (zc > 0.3) & (zc < 50.0) & np.isfinite(uv).all(1)
    if not valid.any():
        return None
    return uv.astype(np.float32), (1.0 / np.maximum(zc, 1e-6)).astype(np.float32), valid


def splat_sparse(p: Dense, uv, inv_depth, valid, radius: int = 4) -> torch.Tensor:
    h, w = p.height, p.width
    dev = uv.device
    hyp = inv_depths(p, dev)
    n = h * w
    px = torch.round(uv[:, 0]).to(torch.int64)
    py = torch.round(uv[:, 1]).to(torch.int64)
    ok = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    flat = torch.where(ok, py * w + px, n)
    npts = uv.shape[0]
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, flat, torch.arange(npts, device=dev), "amax")
    winner = winner[:n]
    hit_b = winner >= 0
    padded = torch.cat([inv_depth.to(torch.float32), torch.zeros(1, device=dev)])
    depth_map = padded[torch.where(hit_b, winner, npts)].reshape(h, w)
    hit = hit_b.to(torch.float32).reshape(h, w)
    zero = torch.zeros((), device=dev)
    acc_d = torch.zeros((h, w), device=dev)
    acc_w = torch.zeros((h, w), device=dev)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            wgt = 1.0 / (1.0 + np.hypot(dy, dx))
            sd = torch.roll(depth_map, (dy, dx), (0, 1))
            sh = torch.roll(hit, (dy, dx), (0, 1))
            acc_d = acc_d + sd * sh * wgt
            acc_w = acc_w + sh * wgt
    mean_d = torch.where(acc_w > 0, acc_d / torch.clamp(acc_w, min=1e-9), zero)
    bias = torch.abs(hyp[None, None, :] - mean_d[..., None]) / p.dep_sample
    return bias * p.sparse_ratio * torch.clamp(acc_w, max=1.0)[..., None]


def reference_bias(p: Dense, pkt, k, device):
    sp = sparse_points(pkt, k)
    if sp is None:
        return None
    uv, inv_d, valid = (torch.from_numpy(np.asarray(a)).to(device) for a in sp)
    return splat_sparse(p, uv.to(torch.float32), inv_d.to(torch.float32), valid.to(torch.bool))


def init_filter(h, w, device):
    def full(v):
        return torch.full((h, w), v, dtype=torch.float32, device=device)
    return Filter(full(0.5), full(100.0), full(15.0), full(15.0))


def start(p: Dense, prec: Precision, img: torch.Tensor, bias, filt: Filter) -> State:
    """A reference's state: its image maps, its bias in the volume format,
    zeroed volumes and `filt`."""
    dev = img.device
    ref = img.to(torch.float32)
    grad = gradient_magnitude(ref)
    pen = (penalty_map(grad) if p.use_penalty_map
           else torch.ones((p.height, p.width), dtype=torch.float32, device=dev))
    shape = (p.height, p.width, p.num_depths)
    return State(ref, grad, pen, None if bias is None else prec.to(bias),
                 torch.zeros(shape, dtype=prec.carrier, device=dev),
                 torch.zeros(shape, dtype=prec.carrier, device=dev), filt, 0)


# ---------------------------------------------------------------- warps and cost

def warp_shift_bounds_np(a_mat, height, width, step=4):
    m = np.asarray(a_mat, np.float64)
    u = np.arange(0, width, step, dtype=np.float64)
    v = np.arange(0, height, step, dtype=np.float64)
    r = v
    den_v = m[1, 1] - r * m[2, 1]
    deg = np.abs(den_v) < 1e-3
    safe = np.where(deg, 1.0, den_v)
    v_ur = ((r[:, None] * (m[2, 0] * u[None, :] + m[2, 2]) - m[1, 0] * u[None, :] - m[1, 2])
            / safe[:, None])
    zd = m[2, 0] * u[None, :] + m[2, 1] * v_ur + m[2, 2]
    zd = np.where(np.abs(zd) > 1e-6, zd, 1e-6)
    g = (m[0, 0] * u[None, :] + m[0, 1] * v_ur + m[0, 2]) / zd
    dx = np.abs(g - u[None, :])[~deg[:, None] & np.ones_like(g, bool)]
    zz = m[2, 0] * u[None, :] + m[2, 1] * v[:, None] + m[2, 2]
    zz = np.where(np.abs(zz) > 1e-6, zz, 1e-6)
    y_in = (m[1, 0] * u[None, :] + m[1, 1] * v[:, None] + m[1, 2]) / zz
    dy = np.abs(y_in - v[:, None])
    return (float(dx.max()) if dx.size else np.inf, float(dy.max()))


def warp_pass_positions(m, h, w, eps=1e-3):
    f32 = torch.float32
    m = m.to(f32)
    u = torch.arange(w, dtype=f32, device=m.device)
    v = torch.arange(h, dtype=f32, device=m.device)
    r = v
    den_v = m[1, 1] - r * m[2, 1]
    deg = torch.abs(den_v) < eps
    safe_den = torch.where(deg, torch.ones_like(den_v), den_v)
    v_ur = ((r[:, None] * (m[2, 0] * u[None, :] + m[2, 2]) - m[1, 0] * u[None, :] - m[1, 2])
            / safe_den[:, None])
    zd = m[2, 0] * u[None, :] + m[2, 1] * v_ur + m[2, 2]
    zd = torch.where(torch.abs(zd) > 1e-6, zd, torch.full_like(zd, 1e-6))
    g = (m[0, 0] * u[None, :] + m[0, 1] * v_ur + m[0, 2]) / zd
    g = torch.where(deg[:, None], torch.full_like(g, -1e9), g)
    zz = m[2, 0] * u[None, :] + m[2, 1] * v[:, None] + m[2, 2]
    zz = torch.where(torch.abs(zz) > 1e-6, zz, torch.full_like(zz, 1e-6))
    y_in = (m[1, 0] * u[None, :] + m[1, 1] * v[:, None] + m[1, 2]) / zz
    return g, y_in


def _resample_rows(vals, pos, wdt):
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


def exact_warp(img, m, eps=1e-3, wdt=torch.bfloat16):
    f32 = torch.float32
    img = img.to(f32)
    h, w = img.shape
    g, y_in = warp_pass_positions(m, h, w, eps)
    stack = torch.stack([img, torch.ones_like(img)]).to(wdt).to(f32)
    tmp = _resample_rows(stack, g, wdt)
    tmp_t = tmp.to(wdt).to(f32).transpose(1, 2).contiguous()
    out = _resample_rows(tmp_t, y_in.T.contiguous(), wdt)
    return out[0].T, out[1].T


def _banded_pass(vals, pos, band, with_coverage):
    length = vals.shape[-1]
    u = torch.arange(pos.shape[-1], dtype=torch.float32, device=pos.device)
    delta = pos - u
    k0 = torch.floor(delta)
    zero = torch.zeros((), device=pos.device)
    acc = torch.zeros_like(vals)
    cov = torch.zeros_like(pos)
    for t in (0.0, 1.0):
        k = k0 + t
        wk = torch.clamp(1.0 - torch.abs(delta - k), min=0.0)
        x = u + k
        use = (torch.abs(k) <= band) & (x >= 0) & (x <= length - 1)
        xi = torch.where(use, x, zero).to(torch.int64)
        tap = torch.gather(vals, 2, xi.expand(vals.shape[0], -1, -1))
        acc = acc + torch.where(use, wk * tap, zero)
        if with_coverage:
            cov = cov + torch.where(use, wk, zero)
    return acc, cov


def banded_warp(img, m, band_x=96, band_y=48):
    h, w = img.shape
    g, y_in = warp_pass_positions(m, h, w)
    tmp, cov1 = _banded_pass(img.to(torch.float32)[None], g, band_x, True)
    cols = torch.stack([tmp[0].T, cov1.T])
    out, _ = _banded_pass(cols, y_in.T, band_y, False)
    return out[0].T.contiguous(), out[1].T.contiguous()


def sweep_positions(a_mat, b_vec, rho, height, width):
    f32 = torch.float32
    dev = a_mat.device
    u = torch.arange(width, dtype=f32, device=dev)
    v = torch.arange(height, dtype=f32, device=dev)
    a = a_mat.to(f32)
    c = torch.linalg.solve_ex(a, b_vec.to(f32))[0]
    rho = rho.to(f32)
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


def plane_sweep(prec: Precision, ref, meas_al, pos_x, pos_y, mx, my):
    chunk = 32
    h, w = ref.shape
    d = pos_x.shape[0]
    dev = ref.device
    ref = ref.to(torch.float32)
    meas = meas_al.to(torch.float32)
    nine = torch.full((), 9.0, device=dev)
    zero = torch.zeros((), device=dev)
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    out = torch.empty((h, w, d), dtype=prec.carrier, device=dev)
    for d0 in range(0, d, chunk):
        sl = slice(d0, min(d0 + chunk, d))
        px = pos_x[sl, None, :]
        py = pos_y[sl, :, None]
        m0 = mx[sl, 0, None, :] + my[sl, 0, :, None]
        m1 = mx[sl, 1, None, :] + my[sl, 1, :, None]
        m2 = mx[sl, 2, None, :] + my[sl, 2, :, None]
        valid = ((px >= 0.0) & (px <= w - 1.0) & (py >= 0.0) & (py <= h - 1.0)
                 & (m2 > 1e-6) & (m0 >= 0.0) & (m0 <= (w - 1.0) * m2)
                 & (m1 >= 0.0) & (m1 <= (h - 1.0) * m2))
        x0, y0 = torch.floor(px), torch.floor(py)
        wx0 = torch.clamp(1.0 - torch.abs(px - x0), min=0.0)
        wx1 = torch.clamp(1.0 - torch.abs(px - (x0 + 1.0)), min=0.0)
        wy0 = torch.clamp(1.0 - torch.abs(py - y0), min=0.0)
        wy1 = torch.clamp(1.0 - torch.abs(py - (y0 + 1.0)), min=0.0)
        xi0 = x0.clamp(0, w - 1).to(torch.int64)
        yi0 = y0.clamp(0, h - 1).to(torch.int64)
        xi1 = (xi0 + 1).clamp(max=w - 1)
        yi1 = (yi0 + 1).clamp(max=h - 1)
        r0 = wx0 * meas[yi0, xi0] + wx1 * meas[yi0, xi1]
        r1 = wx0 * meas[yi1, xi0] + wx1 * meas[yi1, xi1]
        warped = wy0 * r0 + wy1 * r1
        ad = torch.where(valid, torch.abs(warped - ref), zero)
        acc = torch.zeros_like(ad)
        for dy in range(3):
            ady = ad[:, (rows + dy - 1).clamp(0, h - 1)]
            for dx in range(3):
                acc = acc + ady[:, :, (cols + dx - 1).clamp(0, w - 1)]
        c = torch.where(valid, torch.clamp(acc / nine, min=0.0), torch.full((), -1.0, device=dev))
        out[:, :, sl] = prec.to(c.permute(1, 2, 0))
    return out


# ---------------------------------------------------------------- SGM and WTA

def _sgm_step(l_prev, c, p2, p1):
    big = torch.full_like(l_prev[:, :1], BIG)
    sp = torch.cat([big, l_prev[:, :-1]], dim=1)
    sm = torch.cat([l_prev[:, 1:], big], dim=1)
    min_prev = torch.amin(l_prev, dim=-1, keepdim=True)
    cand = torch.minimum(l_prev, torch.minimum(torch.minimum(sp, sm) + p1, min_prev + p2[:, None]))
    return c + cand - min_prev


def sgm_scan(prec: Precision, cost, p2_eff, p1, axis):
    c = torch.movedim(cost, axis, 0)
    p2 = torch.movedim(p2_eff, axis, 0)
    p1 = p1.to(torch.float32)
    s = c.shape[0]

    def run(order):
        out = torch.empty_like(c)
        lv = c[order[0]].to(torch.float32)
        out[order[0]] = c[order[0]]
        for i in order[1:]:
            lv = _sgm_step(lv, c[i].to(torch.float32), p2[i].to(torch.float32), p1)
            out[i] = prec.to(lv)
        return out

    total = prec.q(run(list(range(s))) + run(list(range(s - 1, -1, -1))))
    return torch.movedim(total, 0, axis).contiguous()


def wta(*vols, peak_ratio=0.98):
    x = vols[0].to(torch.float32)
    for v in vols[1:]:
        x = x + v.to(torch.float32)
    d = x.shape[-1]
    lane = torch.arange(d, device=x.device)
    c0 = torch.amin(x, dim=-1)
    idx = torch.where(x == c0[..., None], lane, d).amin(dim=-1)
    cm = torch.gather(x, -1, (idx - 1).clamp(min=0)[..., None])[..., 0]
    cp = torch.gather(x, -1, (idx + 1).clamp(max=d - 1)[..., None])[..., 0]
    denom = cm + cp - 2.0 * c0
    delta = torch.where(denom > 1e-6, 0.5 * (cm - cp) / torch.clamp(denom, min=1e-6),
                        torch.zeros((), device=x.device))
    idx_f = idx.to(torch.float32) + torch.clamp(delta, -1.0, 1.0)
    masked = torch.where(torch.abs(lane - idx[..., None]) <= 1,
                         torch.full((), BIG, device=x.device), x)
    c2 = torch.amin(masked, dim=-1)
    conf = (c0 < peak_ratio * c2) & (idx > 0) & (idx < d - 1)
    return idx_f, conf


def sgm_depth(p: Dense, prec: Precision, total, grad, rho, valid_count, penalty):
    big_jump = prec.to(grad) > p.tau_so
    dev = total.device
    p2_map = prec.to(torch.where(big_jump, torch.full((), p.pi2, device=dev),
                                 torch.full((), p.pi2, device=dev)))
    p1_map = prec.to(torch.where(big_jump, torch.full((), p.pi1, device=dev),
                                 torch.full((), p.pi1, device=dev)))
    p2_map = prec.q(p2_map * prec.to(penalty))
    p1_map = prec.q(p1_map * prec.to(penalty))
    p1_s = prec.to(p1_map.mean(dtype=torch.float32))
    total = total.contiguous()
    part_h = sgm_scan(prec, total, p2_map, p1_s, axis=1)
    part_v = sgm_scan(prec, total, p2_map, p1_s, axis=0)
    idx_f, conf = wta(part_h, part_v)
    conf = conf & (valid_count >= p.num_depths * 0.25)
    step = rho[1] - rho[0]
    return rho[0] + idx_f * step, conf


# ---------------------------------------------------------------- filter

def filter_update(st: Filter, x, tau2, meas_valid, mu_range=(0.01, 100.0)) -> Filter:
    mu, s2, a, b = st
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

    return Filter(keep(mu_new, mu), torch.clamp(keep(s2_new, s2), min=1e-10), keep(a_new, a),
                  keep(b_new, torch.where(meas_valid, b + 1.0, b)))


def converged(st: Filter, ratio=0.5, min_support=0.5, a0=15.0):
    ok = st.a / torch.clamp(st.a + st.b, min=1e-9) >= ratio
    return ok & (st.a > a0 + min_support)


def propagate(st: Filter, r_no, t_no, k_new, k_old_inv, sigma_inflate=1.2) -> Filter:
    h, w = st.mu.shape
    dt, dev = st.mu.dtype, st.mu.device
    init = init_filter(h, w, dev)
    u = torch.arange(w, dtype=dt, device=dev)
    v = torch.arange(h, dtype=dt, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rays = torch.einsum("ij,jhw->ihw", k_old_inv, torch.stack([uu, vv, torch.ones_like(uu)]))
    depth_old = 1.0 / torch.clamp(st.mu, min=1e-6)
    pts_new = torch.einsum("ij,jhw->ihw", r_no, rays * depth_old[None]) + t_no[:, None, None]
    z_new = pts_new[2]
    proj = torch.einsum("ij,jhw->ihw", k_new, pts_new)
    pu = proj[0] / torch.clamp(proj[2], min=1e-6)
    pv = proj[1] / torch.clamp(proj[2], min=1e-6)
    ok = (z_new > 1e-3) & (pu >= 0) & (pu <= w - 1) & (pv >= 0) & (pv <= h - 1)
    mu_new_val = 1.0 / torch.clamp(z_new, min=1e-6)
    s2_new_val = st.sigma2 * (mu_new_val / torch.clamp(st.mu, min=1e-6)) ** 4 * sigma_inflate
    n = h * w
    flat = (torch.round(pv).to(torch.int64) * w + torch.round(pu).to(torch.int64))
    flat = torch.where(ok, flat, n).ravel()
    key = torch.where(ok, z_new, float("inf")).ravel()
    seg_min = torch.full((n + 1,), float("inf"), dtype=dt, device=dev)
    seg_min.scatter_reduce_(0, flat, key, reduce="amin")
    winner = (key == seg_min[flat]) & ok.ravel()
    target = torch.where(winner, flat, n)

    def scatter(values, default):
        out = torch.full((n + 1,), default, dtype=dt, device=dev)
        out[target] = torch.where(winner, values.ravel(), torch.full((), default, dtype=dt, device=dev))
        return out[:n].reshape(h, w)

    got = scatter(torch.ones_like(st.mu), 0.0) > 0.5
    return Filter(torch.where(got, scatter(mu_new_val, 0.0), init.mu),
                  torch.where(got, scatter(s2_new_val, 0.0), init.sigma2),
                  torch.where(got, scatter(st.a, 0.0), init.a),
                  torch.where(got, scatter(st.b, 0.0), init.b))


# ---------------------------------------------------------------- one frame, finalize

def fuse(p: Dense, prec: Precision, st: State, meas, a_mat, b_vec, banded: bool) -> State:
    """One measurement frame fused into the reference's state."""
    dev = st.ref_img.device
    rho = inv_depths(p, dev)
    h, w = p.height, p.width
    meas = meas.to(torch.float32)
    cov_img, cov = banded_warp(meas, a_mat) if banded else exact_warp(meas, a_mat)
    meas_al = (cov_img / torch.clamp(cov, min=1e-3)).contiguous()
    pos_x, pos_y, mx, my = sweep_positions(a_mat, b_vec, rho, h, w)
    cost = plane_sweep(prec, st.ref_img, meas_al, pos_x.contiguous(), pos_y.contiguous(),
                       mx.contiguous(), my.contiguous())
    c, v = torch.clamp(cost, min=0), cost >= 0
    count = prec.q(st.count + v.to(prec.carrier))
    step = prec.q(prec.q(c - st.mean_cost) / torch.clamp(count, min=1.0))
    mean = prec.q(st.mean_cost + torch.where(v, step, torch.zeros((), dtype=step.dtype, device=dev)))
    observed = count > 0
    total = torch.where(observed, mean, torch.full((), 50.0, dtype=mean.dtype, device=dev))
    if st.bias is not None:
        total = prec.q(total + st.bias)
    inv_depth, conf = sgm_depth(p, prec, total, st.grad, rho, observed.sum(-1), st.penalty)
    tau2 = torch.full((), (p.dep_sample ** 2) / p.tau2_scale, dtype=torch.float32, device=dev)
    filt = filter_update(st.filt, inv_depth, tau2, conf)
    return st._replace(mean_cost=mean, count=count, filt=filt, num_frames=st.num_frames + 1)


def validate_photometric(p: Dense, st: State, meas, a_mat, b_vec, max_err=20.0):
    h, w = p.height, p.width
    dev = st.ref_img.device
    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    base = torch.einsum("ij,jhw->ihw", a_mat, torch.stack([uu, vv, torch.ones_like(uu)]))
    pt = base + b_vec[:, None, None] * st.filt.mu[None]
    z = torch.where(torch.abs(pt[2]) > 1e-6, pt[2], torch.full_like(pt[2], 1e-6))
    coords = torch.stack([pt[0] / z, pt[1] / z], dim=-1)
    warped = bilinear(meas.to(torch.float32), coords, fill=math.nan)
    err = torch.abs(warped - st.ref_img)
    in_view = ((coords[..., 0] >= 0) & (coords[..., 0] <= w - 1)
               & (coords[..., 1] >= 0) & (coords[..., 1] <= h - 1))
    return ~in_view | (torch.isfinite(err) & (err < max_err))


def published_depth(p: Dense, st: State, last_meas, last_a, last_b) -> torch.Tensor:
    """The depth map a reference publishes: converged pixels after at least
    `min_frames` frames that pass the photometric check, 0.1-20 m, else 0."""
    ok = converged(st.filt) & (st.num_frames >= p.min_frames)
    depth = 1.0 / torch.clamp(st.filt.mu, min=1e-6)
    if last_meas is not None:
        ok = ok & validate_photometric(p, st, last_meas, last_a, last_b)
    good = ok & (depth > 0.1) & (depth < 20.0)
    return torch.where(good, depth, torch.zeros((), device=depth.device))


def camera_pose(world, r_cb, p_bc):
    """A keyframe's camera pose (r_wc, t_wc), float32, from the server's
    4-DoF world estimate (yaw, pitch, roll, p) and the client's extrinsics:
    R_wb = Rz(yaw) Ry(pitch) Rx(roll) in float64 from float32 angles."""
    yaw, pitch, roll, p = world
    y, pt, r = (np.float64(np.float32(a)) for a in (yaw, pitch, roll))
    cy, sy, cp, sp, cr, sr = np.cos(y), np.sin(y), np.cos(pt), np.sin(pt), np.cos(r), np.sin(r)
    r_wb = np.array([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                     [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                     [-sp, cp * sr, cp * cr]])
    r_wc = r_wb @ np.asarray(r_cb, np.float32).T
    t_wc = np.asarray(p, np.float32) + r_wb @ np.asarray(p_bc, np.float32)
    return r_wc.astype(np.float32), t_wc.astype(np.float32)


def relative(r_wc_from, t_wc_from, r_wc_to, t_wc_to):
    """(R, t) with x_to = R x_from + t, from two camera poses in the world
    (in their dtype)."""
    return r_wc_to.T @ r_wc_from, r_wc_to.T @ (t_wc_from - t_wc_to)


def frame_maps(k: np.ndarray, r_mr: np.ndarray, t_mr: np.ndarray):
    """a = K R K^-1, b = K t of a measurement against its reference (in the
    dtype of K, R and t)."""
    return k @ r_mr @ np.linalg.inv(k), k @ t_mr

"""Plain PyTorch reference of the published map's TSDF fusion, frozen from
the program's plain path as it stood when the benchmark was written
(`cvids_tpu_torch/mapping/tsdf.py`: the chunk walk of a depth map's
truncation band and carving march; `ops/cuda_kernels.py`: the voxel update
of every touched chunk). It imports nothing of the program.

`Volume` holds chunks by their integer grid coordinates, so it follows the
program's map from a copy of its voxels taken before the window without
sharing its slot allocation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NO_KEY = np.iinfo(np.int64).max


class Tsdf(NamedTuple):
    voxel_size: float
    chunk_size: int
    trunc_scale: float
    trunc_quad: float
    carving: bool
    carve_weight: float
    max_weight: float
    min_depth: float
    max_depth: float


def tsdf_params(cfg: dict) -> Tsdf:
    return Tsdf(*(cfg[k] for k in Tsdf._fields))


def pack_keys(c):
    off = 1 << 20
    return (c[..., 0] + off) | ((c[..., 1] + off) << 21) | ((c[..., 2] + off) << 42)


def carving_march(p: Tsdf) -> np.ndarray:
    top = max(p.max_depth, float(np.float32(p.max_depth)))
    return np.arange(p.min_depth, top, p.voxel_size * p.chunk_size * 0.8)


def touched_chunks(p: Tsdf, depth: torch.Tensor, k: np.ndarray, r_wc: np.ndarray,
                   t_wc: np.ndarray) -> np.ndarray:
    """(M, 3) int grid coordinates of the chunks a depth map's band touches
    (K, R_wc and t_wc as the server holds them, float32),
    in packed-key order: every 4th pixel at three scales of the truncation
    band, and with carving every 16th pixel's march from min_depth."""
    dev = depth.device
    f64 = torch.float64
    vs, cs = p.voxel_size, p.chunk_size
    h, w = depth.shape
    kinv = torch.from_numpy(np.linalg.inv(k).astype(np.float64)).to(dev)
    r = torch.from_numpy(np.asarray(r_wc, np.float64)).to(dev)
    t = torch.from_numpy(np.asarray(t_wc, np.float64)).to(dev)
    march = torch.from_numpy(carving_march(p)).to(dev)
    dd = depth[::4, ::4]
    uu = torch.arange(0, w, 4, dtype=f64, device=dev)[None, :]
    vv = torch.arange(0, h, 4, dtype=f64, device=dev)[:, None]
    rays = [(kinv[i, 0] * uu + kinv[i, 1] * vv) + kinv[i, 2] for i in range(3)]

    def to_world(pc):
        return [((r[i, 0] * pc[0] + r[i, 1] * pc[1]) + r[i, 2] * pc[2]) + t[i] for i in range(3)]

    ok = (dd > p.min_depth) & (dd < p.max_depth)
    tau = p.trunc_scale * vs + p.trunc_quad * (dd * dd)
    q = 1.5 * tau / torch.clamp(dd, min=1e-6)
    sc = torch.stack([(1.0 - q).to(f64), torch.ones_like(dd, dtype=f64), (1.0 + q).to(f64)])
    dsc = dd.to(f64) * sc
    pts = [to_world([ray * dsc for ray in rays])]
    valid = [ok.expand_as(dsc)]
    if p.carving:
        ddc = dd[::4, ::4]
        okc = (ddc > p.min_depth) & (ddc < p.max_depth)
        far = torch.where(okc, ddc, torch.full((), -np.inf, device=dev)).max().to(f64)
        step = torch.full((), vs * cs * 0.8, dtype=f64, device=dev)
        count = torch.ceil((far - p.min_depth) / step)
        scc = torch.clamp(march[:, None, None] / torch.clamp(ddc, min=1e-6).to(f64), max=1.0)
        dscc = ddc.to(f64) * scc
        pts.append(to_world([ray[::4, ::4] * dscc for ray in rays]))
        i = torch.arange(march.shape[0], dtype=f64, device=dev)
        valid.append(okc & (i < count)[:, None, None])
    chunk = torch.full((), vs * cs, dtype=f64, device=dev)
    keys = []
    for pt, v in zip(pts, valid):
        key = pack_keys(torch.stack([torch.floor(x / chunk) for x in pt], -1).to(torch.int64))
        keys.append(torch.where(v, key, torch.full((), NO_KEY, device=dev)).reshape(-1))
    uk = torch.unique(torch.cat(keys)).cpu().numpy()
    uk = uk[uk != NO_KEY]
    off, mask = 1 << 20, (1 << 21) - 1
    return np.stack([(uk & mask) - off, ((uk >> 21) & mask) - off,
                     ((uk >> 42) & mask) - off], 1).astype(np.int32)


class Volume:
    """Chunks (S³ voxels of sdf, weight and colour) keyed by grid coordinates."""

    def __init__(self, p: Tsdf, sdf: torch.Tensor, weight: torch.Tensor, color: torch.Tensor,
                 row_of: dict):
        self.p = p
        self.sdf, self.weight, self.color = sdf, weight, color
        self.row_of = dict(row_of)
        self.touched: set = set()

    def rows(self, coords: np.ndarray) -> torch.Tensor:
        new = [tuple(int(x) for x in c) for c in coords if tuple(int(x) for x in c) not in self.row_of]
        if new:
            n0, s = self.sdf.shape[0], self.p.chunk_size
            for i, c in enumerate(new):
                self.row_of[c] = n0 + i
            dev = self.sdf.device
            z = len(new)
            self.sdf = torch.cat([self.sdf, torch.zeros((z, s, s, s), device=dev)])
            self.weight = torch.cat([self.weight, torch.zeros((z, s, s, s), device=dev)])
            self.color = torch.cat([self.color, torch.zeros((z, s, s, s, 3), device=dev)])
        keys = [tuple(int(x) for x in c) for c in coords]
        self.touched.update(keys)
        return torch.tensor([self.row_of[c] for c in keys], dtype=torch.int64, device=self.sdf.device)

    def integrate(self, depth: torch.Tensor, color: torch.Tensor, k: np.ndarray,
                  r_wc: np.ndarray, t_wc: np.ndarray, round_to=None) -> dict:
        """One depth + colour frame into the chunks its band touches (K and the
        camera pose float32, as the server holds them); returns
        the chunk count and the voxels updated and carved (the work counts of
        the roofline). `round_to` rounds every stored voxel value to a lower
        precision (the control)."""
        coords = touched_chunks(self.p, depth, k, r_wc, t_wc)
        if len(coords) == 0:
            return {"chunks": 0, "updated": 0, "carved": 0}
        rows = self.rows(coords)
        r_cw = np.ascontiguousarray(r_wc.T)
        t_cw = -r_wc.T @ t_wc
        dev = depth.device
        kt, rt, tt = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (k, r_cw, t_cw))
        cc = torch.from_numpy(coords).to(dev)
        return self._update(rows, cc, depth, color, kt, rt, tt, round_to)

    def _update(self, slots, coords, depth, color, k_mat, r_cw, t_cw, round_to):
        p = self.p
        s, vx = p.chunk_size, p.voxel_size
        h, w = depth.shape
        m = slots.shape[0]
        dev = depth.device
        r = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
        zz, yy, xx = torch.meshgrid(r, r, r, indexing="ij")
        offs = torch.stack([xx, yy, zz], -1).reshape(-1, 3)
        origin = coords.to(torch.float32) * (s * vx)
        cx, cy, cz = (origin[:, None, :] + offs * vx).unbind(-1)
        px, py, pz = (((cx * r_cw[i, 0] + cy * r_cw[i, 1]) + cz * r_cw[i, 2]) + t_cw[i]
                      for i in range(3))
        q0, q1, q2 = ((px * k_mat[i, 0] + py * k_mat[i, 1]) + pz * k_mat[i, 2] for i in range(3))
        den = torch.clamp(q2, min=1e-6)
        u, v = q0 / den, q1 / den
        ui = torch.clamp(torch.round(u), 0, w - 1).to(torch.int64)
        vi = torch.clamp(torch.round(v), 0, h - 1).to(torch.int64)
        in_img = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (pz > 1e-3)
        d = depth[vi, ui]
        col = color[vi, ui]
        d_ok = in_img & (d > p.min_depth) & (d < p.max_depth)
        surf = d - pz
        tau = p.trunc_scale * vx + p.trunc_quad * d * d
        old_sdf = self.sdf[slots].reshape(m, -1)
        old_w = self.weight[slots].reshape(m, -1)
        old_c = self.color[slots].reshape(m, -1, 3)
        upd = d_ok & (surf > -tau) & (surf < tau)
        uc = torch.minimum(torch.maximum(surf, -tau), tau)
        one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
        wsum = old_w + torch.where(upd, one, zero)
        denom = torch.clamp(wsum, min=1e-9)
        sdf = torch.where(upd, (old_sdf * old_w + uc) / denom, old_sdf)
        cnew = torch.where(upd[..., None], (old_c * old_w[..., None] + col) / denom[..., None], old_c)
        wout = torch.clamp(torch.where(upd, wsum, old_w), max=p.max_weight)
        carve = torch.zeros_like(upd)
        if p.carving:
            carve = d_ok & (surf > tau) & (old_w > 0)
            wout = torch.where(carve, torch.clamp(wout - p.carve_weight, min=0.0), wout)
            sdf = torch.where(carve & (wout <= 0.0), zero, sdf)
        if round_to is not None:
            sdf, wout, cnew = (x.to(round_to).to(torch.float32) for x in (sdf, wout, cnew))
        self.sdf.index_copy_(0, slots, sdf.reshape(m, s, s, s))
        self.weight.index_copy_(0, slots, wout.reshape(m, s, s, s))
        self.color.index_copy_(0, slots, cnew.reshape(m, s, s, s, 3))
        return {"chunks": int(m), "updated": int(upd.sum()), "carved": int(carve.sum())}

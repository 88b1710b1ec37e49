"""Chunked TSDF volume with device-side integration (port of
``cvids_tpu/mapping/tsdf.py``).

OpenChisel's `ChunkID -> ChunkPtr` hash map (`Chisel.h:114-213`,
`ChunkManager.h:40-55`) as a struct-of-arrays chunk pool on the device —
(C, 8, 8, 8) fp32 sdf and weight and (C, 8, 8, 8, 3) color tensors — plus a
host-side coordinate -> slot dict for allocation. A frame's integration is
one launch of the hand kernel `cuda_kernels.tsdf_integrate` over every
chunk it touches (`ProjectionIntegrator::IntegrateColor`'s voxel-centroid
projection with truncation and optional space carving), in place on the
pool; on the CPU its plain twin. The chunks a frame touches are named by a
fixed-shape walk on the volume's device (one CUDA graph a depth shape on
the card), one `torch.unique` and one read of the unique keys.

Over a mesh of ranks (``parallel``), `shard_pool` gives each rank a
contiguous block of the chunk axis and `sharded_integrate` integrates the
replicated frame into it, with no collective.

Defaults mirror the reference launch config (`chisel_ros/launch/
sample.launch:7-21`): 8³-voxel chunks, 0.1 m voxels, truncation scaling with
distance (quadratic truncator), space carving on.

One departure from the JAX package: its integrate pads each chunk batch to
a power-of-two tier with copies of slot 0 marked inactive, and the scatter's
last write (a stale copy) wins over slot 0's update whenever slot 0 is in a
padded batch, so that chunk's frame is lost. The port does not pad and
updates slot 0 like every other chunk.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device

__all__ = ["TsdfConfig", "ChunkPool", "TsdfVolume", "integrate_chunks",
           "sharded_integrate", "shard_pool", "walk_keys", "carving_march",
           "pack_chunk_keys"]


@dataclass(frozen=True)
class TsdfConfig:
    voxel_size: float = 0.1
    chunk_size: int = 8
    capacity: int = 4096          # initial resident-chunk pool size
    # pool growth ceiling: the pool doubles until this many chunks; beyond
    # it, chunks are dropped and counted (`TsdfVolume.dropped_chunks`).
    # None = unbounded growth, as the reference's chunk map
    # (`ChunkManager.h:40-55`).
    max_capacity: int | None = None
    trunc_scale: float = 2.0      # τ = trunc_scale * voxel_size (+ quadratic)
    trunc_quad: float = 0.0       # + trunc_quad * depth² (reference quadratic truncator)
    carving: bool = True
    carve_weight: float = 0.5     # weight decrement for carved voxels
    max_weight: float = 100.0
    min_depth: float = 0.3
    max_depth: float = 10.0


class ChunkPool(NamedTuple):
    """Device-side voxel storage; chunk coordinates live on the host in
    `TsdfVolume.coords_np`."""

    sdf: torch.Tensor      # (C, S, S, S)
    weight: torch.Tensor   # (C, S, S, S)
    color: torch.Tensor    # (C, S, S, S, 3)


def _empty_pool(capacity: int, s: int, device: torch.device) -> ChunkPool:
    return ChunkPool(
        sdf=torch.zeros((capacity, s, s, s), dtype=torch.float32, device=device),
        weight=torch.zeros((capacity, s, s, s), dtype=torch.float32, device=device),
        color=torch.zeros((capacity, s, s, s, 3), dtype=torch.float32, device=device))


def integrate_chunks(cfg: TsdfConfig, pool: ChunkPool, slots: torch.Tensor,
                     coords: torch.Tensor, depth: torch.Tensor,
                     color: torch.Tensor, k_mat: torch.Tensor,
                     r_cw: torch.Tensor, t_cw: torch.Tensor) -> None:
    """Integrate one depth + color frame into the chunks at pool `slots`
    (M,) int64, whose grid coordinates are `coords` (M, 3) integers;
    updates `pool` IN PLACE. Slots must be distinct. depth (H, W) and
    color (H, W, 3) (any strides) are fp32, k_mat, r_cw (world -> camera)
    and t_cw tensors, all on the pool's device. One call of
    `cuda_kernels.tsdf_integrate` (coords cast to int32, K, R and t to
    contiguous fp32): on the card one launch for all M chunks, on the CPU
    its twin."""
    from ..ops import cuda_kernels
    geom = (x.to(torch.float32).contiguous() for x in (k_mat, r_cw, t_cw))
    cuda_kernels.tsdf_integrate(cfg, pool, slots, coords.to(torch.int32).contiguous(), depth,
                                color, *geom)


def shard_pool(pool: ChunkPool, mesh) -> ChunkPool:
    """This rank's contiguous block of the pool's chunk axis (a copy), the
    shard of a chunk-sharded pool over `mesh` (`parallel.Mesh`). The
    capacity must be a multiple of the mesh size."""
    c = pool.sdf.shape[0]
    if c % mesh.size:
        raise ValueError(f"a pool of {c} chunks does not shard over {mesh.size} ranks")
    mine = mesh.block(c)
    return ChunkPool(*(x[mine].clone() for x in pool))


def sharded_integrate(cfg: TsdfConfig, pool_loc: ChunkPool, coords_loc: torch.Tensor,
                      active_loc: torch.Tensor, depth: torch.Tensor, color: torch.Tensor,
                      k_mat: torch.Tensor, r_cw: torch.Tensor, t_cw: torch.Tensor,
                      mesh) -> ChunkPool:
    """Integrate the replicated frame into this rank's resident chunks
    (`shard_pool`): `coords_loc` (C', 3) names slot i's chunk, and the
    active slots (`active_loc` (C',) bool) go through `integrate_chunks`;
    the inactive ones stay unchanged. Updates `pool_loc` in place and
    returns it. Every voxel stays on its rank: no collective, so `mesh`
    (`parallel.Mesh`) is only checked to hold the pool. The JAX function
    returns (jitted function, args) so that its HLO can be audited; the
    port's audit reads the mesh's log instead."""
    if pool_loc.sdf.device != torch.device(mesh.device):
        raise ValueError(f"the pool is on {pool_loc.sdf.device}, the mesh's rank on "
                         f"{mesh.device}")
    slots = torch.nonzero(active_loc).flatten()
    integrate_chunks(cfg, pool_loc, slots, coords_loc[slots], depth, color, k_mat, r_cw, t_cw)
    return pool_loc


_NO_KEY = np.iinfo(np.int64).max    # the walk's key of a masked point: sorts last


def pack_chunk_keys(c):
    """Chunk coordinates (..., 3) int64, numpy or torch, within ±2^20 ->
    the JAX package's packed int64 keys (21 bits an axis, x lowest), whose
    sort order is its chunk order."""
    off = 1 << 20
    return (c[..., 0] + off) | ((c[..., 1] + off) << 21) | ((c[..., 2] + off) << 42)


def carving_march(cfg: TsdfConfig) -> np.ndarray:
    """The carving march's sample depths, float64: `np.arange(min_depth,
    max_depth, 0.8 chunk)`, whose first len(np.arange(min_depth, max_d,
    0.8 chunk)) values are the JAX walk's for a farthest depth max_d (a
    valid depth is below max_depth as fp32 compares it)."""
    top = max(cfg.max_depth, float(np.float32(cfg.max_depth)))
    return np.arange(cfg.min_depth, top, cfg.voxel_size * cfg.chunk_size * 0.8)


def walk_keys(cfg: TsdfConfig, depth: torch.Tensor, geom: torch.Tensor,
              march: torch.Tensor) -> torch.Tensor:
    """The packed int64 chunk keys of every point of the JAX package's
    chunk walk (`cvids_tpu/mapping/tsdf.py` `TsdfVolume._touched_chunks`)
    at fixed shapes, `_NO_KEY` where that walk has no point: the
    truncation band's three scales of every 4th pixel, and with carving the
    march of every 16th pixel from min_depth at ~0.8 chunk steps, as many
    samples as the farthest valid depth needs (`np.arange`'s count) out of
    `march` (`carving_march`, float64, on depth's device). depth (H, W)
    fp32; geom (21,) float64: K⁻¹, R_wc (row-major) and t_wc. Each value
    is formed in the numpy walk's dtype and order (the band's scales in
    fp32, the points in float64; a division by a device scalar, which the
    card divides as the host does); nothing is read back, so the call can
    be captured."""
    dev = depth.device
    f64 = torch.float64
    vs, cs = cfg.voxel_size, cfg.chunk_size
    h, w = depth.shape
    kinv, r, t = geom[:9].view(3, 3), geom[9:18].view(3, 3), geom[18:]
    dd = depth[::4, ::4]                                        # fp32
    uu = torch.arange(0, w, 4, dtype=f64, device=dev)[None, :]
    vv = torch.arange(0, h, 4, dtype=f64, device=dev)[:, None]
    rays = [(kinv[i, 0] * uu + kinv[i, 1] * vv) + kinv[i, 2] for i in range(3)]

    def to_world(pc):
        return [((r[i, 0] * pc[0] + r[i, 1] * pc[1]) + r[i, 2] * pc[2]) + t[i]
                for i in range(3)]

    ok = (dd > cfg.min_depth) & (dd < cfg.max_depth)
    tau = cfg.trunc_scale * vs + cfg.trunc_quad * (dd * dd)     # fp32
    q = 1.5 * tau / torch.clamp(dd, min=1e-6)
    sc = torch.stack([(1.0 - q).to(f64), torch.ones_like(dd, dtype=f64), (1.0 + q).to(f64)])
    dsc = dd.to(f64) * sc                                       # (3, h/4, w/4)
    pts = [to_world([ray * dsc for ray in rays])]
    valid = [ok.expand_as(dsc)]
    if cfg.carving:
        ddc = dd[::4, ::4]
        okc = (ddc > cfg.min_depth) & (ddc < cfg.max_depth)
        far = torch.where(okc, ddc, torch.full((), -np.inf, device=dev)).max().to(f64)
        step = torch.full((), vs * cs * 0.8, dtype=f64, device=dev)
        count = torch.ceil((far - cfg.min_depth) / step)       # len(np.arange(...))
        scc = torch.clamp(march[:, None, None] / torch.clamp(ddc, min=1e-6).to(f64), max=1.0)
        dscc = ddc.to(f64) * scc                                # (F, h/16, w/16)
        pts.append(to_world([ray[::4, ::4] * dscc for ray in rays]))
        i = torch.arange(march.shape[0], dtype=f64, device=dev)
        valid.append(okc & (i < count)[:, None, None])
    chunk = torch.full((), vs * cs, dtype=f64, device=dev)
    keys = []
    for p, v in zip(pts, valid):
        key = pack_chunk_keys(torch.stack([torch.floor(x / chunk) for x in p], -1).to(torch.int64))
        keys.append(torch.where(v, key, torch.full((), _NO_KEY, device=dev)).reshape(-1))
    return torch.cat(keys)


class TsdfVolume:
    """Host-side chunk allocator + device pool — the `ChunkManager` role.

    Allocation (irregular, tiny) lives on the host: back-projected depth
    points name the chunks a frame touches; unseen ones get pool slots from a
    free list. The walk and the voxel math run on `device`. A new `pool`
    (growth, a restore) clears the mesh's graphs, which bind the old one.
    """

    def __init__(self, cfg: TsdfConfig | None = None,
                 device: torch.device | str | None = None):
        """`device=None` is the card (`default_device()`, which raises
        where there is none); pass "cpu" to run on the host."""
        self.cfg = cfg or TsdfConfig()
        self.device = resolve_device(device)
        self.capacity = self.cfg.capacity
        from . import mesh
        from ..utils.cuda_graph import GraphedCall
        # the fixed-shape programs, each a CUDA graph a signature on the card:
        # the chunk walk and the mesh batch (over the bound pool)
        self.walk_graph = GraphedCall(walk_keys)
        self.mesh_graph = GraphedCall(mesh.mesh_batch, bound=(0, 1, 2))
        self._march = torch.from_numpy(carving_march(self.cfg)).to(self.device)
        self.pool = _empty_pool(self.capacity, self.cfg.chunk_size, self.device)
        self.coords_np = np.zeros((self.capacity, 3), np.int32)
        self.occupied_np = np.zeros(self.capacity, bool)
        self.slot_of: dict[tuple, int] = {}
        self.free = list(range(self.capacity - 1, -1, -1))
        self.dirty: set[int] = set()
        # the JAX volume's cap on a compiled batch, kept with its host tables
        # (`interop`); the port integrates every chunk of a frame in one call
        self.max_chunks_per_frame = 1024
        self.dropped_chunks = 0   # chunks skipped because the pool hit max_capacity
        self._warned_full = False

    @property
    def pool(self) -> ChunkPool:
        return self._pool

    @pool.setter
    def pool(self, pool: ChunkPool) -> None:
        # a new pool (growth, a restore, `integrate_points`) drops the mesh
        # graphs captured over the old one
        self._pool = pool
        self.mesh_graph.clear()

    # ----- allocation -----

    def _touched_chunks(self, depth, k: np.ndarray, r_wc: np.ndarray,
                        t_wc: np.ndarray) -> np.ndarray:
        """Chunk coords intersecting the truncation band of this depth image
        (the reference's frustum-chunk intersection, `Chisel.h:125-148`,
        done by sparse back-projection instead of box tests), sorted as
        their packed keys sort: the JAX package's walk, the same points in
        float64, at fixed shapes on the volume's device (`walk_keys`; on
        the card one CUDA graph a depth shape), then one `torch.unique` and
        one read of the unique keys. `depth` is numpy or a tensor on any
        device."""
        cfg = self.cfg
        depth = self._tensor(depth)
        geom = np.concatenate([np.asarray(np.linalg.inv(k), np.float64).ravel(),
                               np.asarray(r_wc, np.float64).ravel(),
                               np.asarray(t_wc, np.float64).ravel()])
        keys = self.walk_graph(cfg, depth, torch.from_numpy(geom).to(self.device),
                                self._march)
        uk = torch.unique(keys).cpu().numpy()
        uk = uk[uk != _NO_KEY]
        off, mask = 1 << 20, (1 << 21) - 1
        return np.stack([(uk & mask) - off, ((uk >> 21) & mask) - off,
                         ((uk >> 42) & mask) - off], 1).astype(np.int32)

    def _grow(self) -> bool:
        """Double the chunk pool (the reference's chunk map grows unbounded,
        `ChunkManager.h:40-55`). Returns False when `max_capacity` forbids
        further growth."""
        new_cap = self.capacity * 2
        if self.cfg.max_capacity is not None and new_cap > self.cfg.max_capacity:
            return False
        old = self.capacity
        self.pool = ChunkPool(*(torch.cat([a, torch.zeros_like(a)]) for a in self.pool))
        self.coords_np = np.concatenate(
            [self.coords_np, np.zeros((old, 3), np.int32)])
        self.occupied_np = np.concatenate(
            [self.occupied_np, np.zeros(old, bool)])
        self.free = list(range(new_cap - 1, old - 1, -1)) + self.free
        self.capacity = new_cap
        return True

    def _alloc(self, coords: np.ndarray) -> np.ndarray:
        slots = []
        new_coords = []
        for c in map(tuple, coords):
            s = self.slot_of.get(c)
            if s is None:
                if not self.free and not self._grow():
                    # pool at max_capacity: drop, but never silently
                    self.dropped_chunks += 1
                    if not self._warned_full:
                        self._warned_full = True
                        print(f"TsdfVolume: chunk pool full at "
                              f"{self.capacity} (max_capacity="
                              f"{self.cfg.max_capacity}); dropping chunks",
                              file=sys.stderr)
                    continue
                s = self.free.pop()
                self.slot_of[c] = s
                new_coords.append((s, c))
            slots.append(s)
        if new_coords:
            idx = np.asarray([s for s, _ in new_coords], np.int32)
            cc = np.asarray([c for _, c in new_coords], np.int32)
            self.coords_np[idx] = cc
            self.occupied_np[idx] = True
        return np.asarray(slots, np.int32)

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(device=self.device, dtype=dtype)

    # ----- integration -----

    def integrate(self, depth, color, k: np.ndarray, r_wc: np.ndarray,
                  t_wc: np.ndarray):
        """Integrate a depth (+color) frame with camera->world pose
        (`Chisel::IntegrateDepthScanColor`). `depth` (H, W) and `color`
        (H, W, 3) are numpy arrays or tensors (a depth map the dense
        estimator left on the device stays there); k, r_wc, t_wc numpy. On
        the card: the walk's graph, one read of its unique keys, the
        allocation on the host, one `tsdf_integrate` launch."""
        depth_t = self._tensor(depth)
        coords = self._touched_chunks(depth_t, k, r_wc, t_wc)
        slots = self._alloc(coords)
        if len(slots) == 0:
            return
        r_cw = np.ascontiguousarray(r_wc.T)
        t_cw = -r_wc.T @ t_wc
        integrate_chunks(self.cfg, self.pool, self._tensor(slots, torch.int64),
                         self._tensor(self.coords_np[slots], torch.int32), depth_t,
                         self._tensor(color), self._tensor(k), self._tensor(r_cw),
                         self._tensor(t_cw))
        self.dirty.update(int(s) for s in slots)

    def integrate_points(self, pts_w: np.ndarray, colors: np.ndarray,
                         t_wc: np.ndarray):
        """PointCloud fusion mode — the reference's second integrator
        (`chisel_ros/src/ChiselNode.cpp:54-77` mode switch; raycast variant
        `open_chisel/src/ProjectionIntegrator.cpp:52-173`): integrate a
        WORLD-frame point cloud observed from sensor origin `t_wc`.

        Per point, the ray origin->point is sampled: a dense band of
        voxel-spaced samples across ±τ of the endpoint receives signed-
        distance updates, and, with carving on, coarse free-space samples in
        front of the surface decrement voxel weights. Updates land as
        `index_add_` scatters on the flattened pool (device); chunk
        allocation stays host-side like `integrate`.
        """
        cfg = self.cfg
        vs, cs = cfg.voxel_size, cfg.chunk_size
        t_wc = np.asarray(t_wc, np.float64)
        pts_w = np.asarray(pts_w, np.float64).reshape(-1, 3)
        colors = np.asarray(colors, np.float64).reshape(-1, 3)
        delta = pts_w - t_wc
        d = np.linalg.norm(delta, axis=1)
        keep = (d > cfg.min_depth) & (d < cfg.max_depth)
        if not keep.any():
            return
        pts_w, colors, d = pts_w[keep], colors[keep], d[keep]
        dirs = (pts_w - t_wc) / d[:, None]
        tau = cfg.trunc_scale * vs + cfg.trunc_quad * d * d

        # truncation-band samples at ~half-voxel spacing
        s_band = max(3, int(np.ceil(2 * float(tau.max()) / (0.5 * vs))) | 1)
        offs = np.linspace(-1.0, 1.0, s_band)                 # x tau
        t_band = d[:, None] + offs[None, :] * tau[:, None]    # (N, S)
        pos_b = t_wc + dirs[:, None, :] * t_band[..., None]   # (N, S, 3)
        u_b = (d[:, None] - t_band)                           # signed dist
        samples = [(pos_b.reshape(-1, 3),
                    np.clip(u_b, -tau[:, None], tau[:, None]).reshape(-1),
                    np.repeat(colors, s_band, axis=0), False)]

        if cfg.carving:
            s_carve = 16
            frac = (np.arange(s_carve) + 0.5) / s_carve
            t_c = cfg.min_depth + frac[None, :] * np.maximum(
                d[:, None] - 1.5 * tau[:, None] - cfg.min_depth, 0.0)
            ok_c = t_c < (d[:, None] - tau[:, None])
            pos_c = (t_wc + dirs[:, None, :] * t_c[..., None])[ok_c]
            samples.append((pos_c.reshape(-1, 3),
                            np.zeros(len(pos_c)),
                            np.zeros((len(pos_c), 3)), True))

        for pos, u, col, carve in samples:
            if len(pos) == 0:
                continue
            vox = np.floor(pos / vs).astype(np.int64)
            cc = np.floor_divide(vox, cs).astype(np.int32)
            uniq, inv = np.unique(cc, axis=0, return_inverse=True)
            self._alloc(uniq)   # allocates what fits; full-pool chunks drop
            slot_u = np.asarray([self.slot_of.get(tuple(c), -1)
                                 for c in uniq], np.int64)
            slot = slot_u[inv.reshape(-1)]
            ok = slot >= 0
            if not ok.any():
                continue
            vox, cc, slot = vox[ok], cc[ok], slot[ok]
            u, col = u[ok], col[ok]
            local = vox - cc.astype(np.int64) * cs
            flat = (slot.astype(np.int64) * cs ** 3
                    + local[:, 2] * cs * cs + local[:, 1] * cs + local[:, 0])
            flat_t = self._tensor(flat, torch.int64)
            sdf_f = self.pool.sdf.reshape(-1)
            w_f = self.pool.weight.reshape(-1)
            col_f = self.pool.color.reshape(-1, 3)
            zero = torch.zeros((), device=self.device)
            if carve:
                w_new = torch.clamp(w_f.index_add(
                    0, flat_t, torch.full((len(flat),), -cfg.carve_weight,
                                          device=self.device)), min=0.0)
                sdf_new = torch.where(w_new > 0.0, sdf_f, zero)
                col_new = col_f
            else:
                wsum = torch.zeros_like(w_f).index_add_(
                    0, flat_t, torch.ones(len(flat), device=self.device))
                wu = torch.zeros_like(sdf_f).index_add_(0, flat_t, self._tensor(u))
                wc = torch.zeros_like(col_f).index_add_(0, flat_t, self._tensor(col))
                denom = w_f + wsum
                upd = wsum > 0.0
                sdf_new = torch.where(
                    upd, (sdf_f * w_f + wu) / torch.clamp(denom, min=1e-9), sdf_f)
                col_new = torch.where(
                    upd[:, None],
                    (col_f * w_f[:, None] + wc) / torch.clamp(denom, min=1e-9)[:, None],
                    col_f)
                w_new = torch.clamp(torch.where(upd, denom, w_f), max=cfg.max_weight)
            self.pool = ChunkPool(sdf_new.reshape(self.pool.sdf.shape),
                                  w_new.reshape(self.pool.weight.shape),
                                  col_new.reshape(self.pool.color.shape))
            self.dirty.update(int(s) for s in np.unique(slot))

    # ----- queries -----

    def sdf_at(self, pts_w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Nearest-voxel SDF + weight lookup for (N, 3) world points."""
        cfg = self.cfg
        vs, cs = cfg.voxel_size, cfg.chunk_size
        vox = np.floor(pts_w / vs).astype(np.int64)
        cc = np.floor_divide(vox, cs)
        local = vox - cc * cs
        slot = np.asarray([self.slot_of.get(c, -1) for c in map(tuple, cc)], np.int64)
        hit = slot >= 0
        sdf = np.zeros(len(pts_w), np.float32)
        wgt = np.zeros(len(pts_w), np.float32)
        if hit.any():
            at = (self._tensor(slot[hit], torch.int64),) + tuple(
                self._tensor(local[hit, i], torch.int64) for i in (2, 1, 0))
            sdf[hit] = self.pool.sdf[at].cpu().numpy()
            wgt[hit] = self.pool.weight[at].cpu().numpy()
        return sdf, wgt

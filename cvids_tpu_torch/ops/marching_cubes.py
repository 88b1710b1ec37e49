"""Isosurface extraction by marching tetrahedra, batched over chunks (port
of ``cvids_tpu/ops/marching_cubes.py``).

Plays the role of OpenChisel's marching cubes (`MarchingCubes.h:35-130`):
each cube splits into 6 tetrahedra whose 16-case triangle table is generated
below, the output is watertight across cube and chunk boundaries, and every
cube has fixed triangle slots with a validity mask, so a whole batch of
chunks is one set of tensor ops, which reads nothing back and copies
nothing from the host (its tables are made once a device), so that a call
can be captured in a CUDA graph.

Convention: sdf < 0 is inside; triangles are oriented so that their normals
point toward positive sdf (outside), by the tet's exact linear-field
gradient.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["marching_tets", "CUBE_CORNERS", "TETS"]

# cube corner offsets (x, y, z)
CUBE_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)

# 6-tetrahedra decomposition of the cube around the 0-6 diagonal
TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int32)

# tet edges as (corner_a, corner_b) local indices 0..3
TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)


def _build_tet_table() -> np.ndarray:
    """(16, 2, 3) edge-index triangles per inside-mask case; -1 = unused.

    Case bit i set <=> tet vertex i is inside (sdf < 0).
    """
    def edge_id(a, b):
        for k, (x, y) in enumerate(TET_EDGES):
            if {a, b} == {x, y}:
                return k
        raise AssertionError

    table = -np.ones((16, 2, 3), np.int32)
    for case in range(16):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if i not in inside]
        if len(inside) == 1:
            i = inside[0]
            tri = [edge_id(i, o) for o in outside]
            table[case, 0] = tri
        elif len(inside) == 3:
            o = outside[0]
            tri = [edge_id(o, i) for i in inside]
            table[case, 0] = tri
        elif len(inside) == 2:
            i0, i1 = inside
            o0, o1 = outside
            e00, e01 = edge_id(i0, o0), edge_id(i0, o1)
            e10, e11 = edge_id(i1, o0), edge_id(i1, o1)
            table[case, 0] = [e00, e01, e11]
            table[case, 1] = [e00, e11, e10]
    return table


TET_TABLE = _build_tet_table()

_CONSTANTS: dict = {}    # str(device) -> the tables as tensors there


def _constants(dev: torch.device) -> dict:
    """The cube, tet and case tables as tensors on `dev`, made once a
    device: a copy from host memory is what a CUDA graph cannot capture,
    so a captured call finds them made by its warm-up call."""
    key = str(dev)
    got = _CONSTANTS.get(key)
    if got is None:
        got = _CONSTANTS[key] = {
            "corners": torch.as_tensor(CUBE_CORNERS, device=dev),
            "tets": torch.as_tensor(TETS, dtype=torch.int64, device=dev),
            "ea": torch.as_tensor(TET_EDGES[:, 0], dtype=torch.int64, device=dev),
            "eb": torch.as_tensor(TET_EDGES[:, 1], dtype=torch.int64, device=dev),
            "table": torch.as_tensor(TET_TABLE, dtype=torch.int64, device=dev),
            "flip": torch.as_tensor([0, 2, 1], dtype=torch.int64, device=dev)}
    return got


def marching_tets(sdf: torch.Tensor, wgt: torch.Tensor, origin: torch.Tensor,
                  voxel_size: float, color: torch.Tensor):
    """Extract triangles from a batch of (S+1, S+1, S+1) sample blocks.

    sdf, wgt: (B, S+1, S+1, S+1) fp32 indexed [b][z][y][x]; color:
    (B, S+1, S+1, S+1, 3); origin: (B, 3), the world position of each
    block's sample (0, 0, 0) (a voxel centre). Returns (verts (B, T, 3, 3),
    valid (B, T), vert_colors (B, T, 3, 3), vert_normals (B, T, 3, 3)) with
    T = S³·6·2 fixed slots per block. Normals are the normalized gradient of
    the containing tet's linear SDF field — outward, toward positive sdf
    (the role of OpenChisel's vertex normals, `ChunkManager.cpp:259-296`).
    """
    dev = sdf.device
    const = _constants(dev)
    b, s = sdf.shape[0], sdf.shape[1] - 1
    # corner samples per cube: (C, 8) with C = S³ cubes in [z][y][x] order
    g = torch.arange(s, device=dev)
    gz, gy, gx = torch.meshgrid(g, g, g, indexing="ij")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    corners = base[:, None, :] + const["corners"][None]
    cx, cy, cz = corners[..., 0], corners[..., 1], corners[..., 2]   # (C, 8)
    vals = sdf[:, cz, cy, cx]                                        # (B, C, 8)
    wvals = wgt[:, cz, cy, cx]
    cube_ok = torch.all(wvals > 0.0, dim=-1)                         # (B, C)
    pos = (corners.to(torch.float32) * voxel_size)[None] + origin[:, None, None, :]
    cols = color[:, cz, cy, cx]                                      # (B, C, 8, 3)

    tets = const["tets"]                                             # (6, 4)
    tv = vals[:, :, tets]                                            # (B, C, 6, 4)
    tp = pos[:, :, tets]                                             # (B, C, 6, 4, 3)
    tc = cols[:, :, tets]

    # case index per tet
    bits = (tv < 0.0).to(torch.int64)
    case = bits[..., 0] + 2 * bits[..., 1] + 4 * bits[..., 2] + 8 * bits[..., 3]

    # all 6 edge crossings (B, C, 6, 6 edges, 3)
    ea, eb = const["ea"], const["eb"]
    va = tv[..., ea]
    vb = tv[..., eb]
    denom = va - vb
    far = torch.abs(denom) > 1e-9
    t = torch.where(far, va / torch.where(far, denom, torch.ones_like(denom)),
                    torch.full_like(denom, 0.5))
    t = torch.clamp(t, 0.0, 1.0)
    pa = tp[..., ea, :]
    pb = tp[..., eb, :]
    cross = pa + t[..., None] * (pb - pa)
    ca = tc[..., ea, :]
    cb = tc[..., eb, :]
    ccross = ca + t[..., None] * (cb - ca)

    # gather triangles via the case table
    table = const["table"]                                           # (16, 2, 3)
    tri_edges = table[case]                                          # (B, C, 6, 2, 3)
    tri_valid = tri_edges[..., 0] >= 0                               # (B, C, 6, 2)
    safe = torch.clamp(tri_edges, min=0)
    shape5 = tri_edges.shape + (3,)                                  # (B, C, 6, 2, 3, 3)
    idx = safe[..., None].expand(shape5)
    verts = torch.gather(cross[:, :, :, None].expand(shape5[:4] + (6, 3)), 4, idx)
    vcols = torch.gather(ccross[:, :, :, None].expand(shape5[:4] + (6, 3)), 4, idx)

    # orientation: flip so the normal agrees with the tet's linear-field gradient
    e1 = verts[..., 1, :] - verts[..., 0, :]
    e2 = verts[..., 2, :] - verts[..., 0, :]
    normal = torch.linalg.cross(e1, e2)                              # (B, C, 6, 2, 3)
    # gradient of the linear field on the tet: closed-form solve of
    # [d10; d20; d30] g = rhs via the adjugate
    d10 = tp[..., 1, :] - tp[..., 0, :]
    d20 = tp[..., 2, :] - tp[..., 0, :]
    d30 = tp[..., 3, :] - tp[..., 0, :]
    r1 = tv[..., 1] - tv[..., 0]
    r2 = tv[..., 2] - tv[..., 0]
    r3 = tv[..., 3] - tv[..., 0]
    c23 = torch.linalg.cross(d20, d30)
    c31 = torch.linalg.cross(d30, d10)
    c12 = torch.linalg.cross(d10, d20)
    det = torch.sum(d10 * c23, dim=-1, keepdim=True)
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    grad = (r1[..., None] * c23 + r2[..., None] * c31 + r3[..., None] * c12) / det
    flip = torch.sum(normal * grad[..., None, :], -1) < 0.0          # (B, C, 6, 2)
    v1 = torch.where(flip[..., None, None], verts[..., const["flip"], :], verts)

    # per-vertex normals: the tet's gradient, normalized — shared by both
    # triangle slots and all 3 vertices (outward by construction)
    gn = grad / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True),
                            min=1e-12)
    vnorm = gn[:, :, :, None, None, :].expand(v1.shape)

    valid = tri_valid & cube_ok[:, :, None, None]
    tcount = s ** 3 * 6 * 2
    return (v1.reshape(b, tcount, 3, 3), valid.reshape(b, tcount),
            vcols.reshape(b, tcount, 3, 3), vnorm.reshape(b, tcount, 3, 3))

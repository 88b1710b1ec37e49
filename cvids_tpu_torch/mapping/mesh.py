"""Chunk meshing + PLY export (port of ``cvids_tpu/mapping/mesh.py``).

The `ChunkManager::RecomputeMeshes` role (`ChunkManager.cpp:91-168`): every
chunk gets an (S+1)³ sample block — its own voxels plus one layer from its
+x/+y/+z neighbours, so meshes are seamless across chunks — which marching
tetrahedra turns into fixed-slot triangles. The blocks are gathered on the
pool's device from a (chunks, 8) neighbour-slot table built on the host, and
the valid triangles are compacted there before one copy to the host. PLY
output mirrors `open_chisel/src/io/PLY.cpp` and writes the JAX package's
bytes exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.marching_cubes import marching_tets
from .tsdf import TsdfVolume

__all__ = ["extract_mesh", "write_ply", "read_ply"]


def _neighbour_slots(vol: TsdfVolume, chunks: list[tuple]) -> np.ndarray:
    """(len(chunks), 8) pool slots of each chunk's neighbours at
    (+dx, +dy, +dz), dx, dy, dz in {0, 1}, in the order dz*4 + dy*2 + dx;
    -1 where the neighbour is not allocated."""
    table = np.full((len(chunks), 8), -1, np.int64)
    for i, c in enumerate(chunks):
        for n in range(8):
            dx, dy, dz = n & 1, (n >> 1) & 1, n >> 2
            table[i, n] = vol.slot_of.get((c[0] + dx, c[1] + dy, c[2] + dz), -1)
    return table


def _block_index(s: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """For each sample (z, y, x) of an (S+1)³ block: which of the 8
    neighbours holds it and its voxel's flat offset in that chunk."""
    idx = torch.arange(s + 1, device=device)
    nb, loc = idx // s, idx % s
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    which = nb[zz] * 4 + nb[yy] * 2 + nb[xx]
    local = loc[zz] * s * s + loc[yy] * s + loc[xx]
    return which.reshape(-1), local.reshape(-1)


def extract_mesh(vol: TsdfVolume, chunks: list[tuple] | None = None,
                 batch: int = 256):
    """Mesh the given chunks (default: all allocated, in `vol.slot_of`
    order), `batch` chunks per marching-tetrahedra call.

    Returns (verts, colors, normals) — each (T, 3, 3) float32 numpy,
    compacted, in chunk order. Normals are outward SDF-gradient vertex
    normals (`ChunkManager.cpp:259-296`).
    """
    cfg = vol.cfg
    s = cfg.chunk_size
    if chunks is None:
        chunks = list(vol.slot_of.keys())
    empty = np.zeros((0, 3, 3), np.float32)
    if not chunks:
        return empty, empty.copy(), empty.copy()
    dev = vol.device
    which, local = _block_index(s, dev)
    n_vox = s ** 3
    sdf_f = vol.pool.sdf.reshape(-1)
    w_f = vol.pool.weight.reshape(-1)
    col_f = vol.pool.color.reshape(-1, 3)
    table = torch.from_numpy(_neighbour_slots(vol, chunks)).to(dev)
    origins = torch.from_numpy(np.asarray(chunks, np.float32) * (s * cfg.voxel_size)
                               + 0.5 * cfg.voxel_size).to(dev)
    shape = (-1, s + 1, s + 1, s + 1)
    out_v, out_c, out_n = [], [], []
    for start in range(0, len(chunks), batch):
        slots = table[start:start + batch][:, which]           # (B, (S+1)³)
        have = slots >= 0
        flat = torch.clamp(slots, min=0) * n_vox + local
        zero = torch.zeros((), device=dev)
        sdf_b = torch.where(have, sdf_f[flat], zero).reshape(shape)
        wgt_b = torch.where(have, w_f[flat], zero).reshape(shape)
        col_b = torch.where(have[..., None], col_f[flat], zero).reshape(shape + (3,))
        v, ok, c, nrm = marching_tets(sdf_b, wgt_b, origins[start:start + batch],
                                      cfg.voxel_size, col_b)
        out_v.append(v[ok])
        out_c.append(c[ok])
        out_n.append(nrm[ok])
    return tuple(torch.cat(x).cpu().numpy() for x in (out_v, out_c, out_n))


def write_ply(path: str, verts: np.ndarray, colors: np.ndarray | None = None,
              normals: np.ndarray | None = None):
    """Triangle soup -> binary-little-endian PLY (the reference's mesh-save
    output format, `open_chisel/src/io/PLY.cpp`; per-vertex nx/ny/nz match
    the reference's gradient normals in the saved mesh)."""
    t = len(verts)
    v = verts.reshape(-1, 3).astype(np.float32)
    n = len(v)
    has_c = colors is not None and len(colors)
    has_n = normals is not None and len(normals)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if has_n:
            hdr += ["property float nx", "property float ny",
                    "property float nz"]
        if has_c:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {t}", "property list uchar int vertex_index",
                "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        fields = [("xyz", np.float32, 3)]
        if has_n:
            fields.append(("n", np.float32, 3))
        if has_c:
            fields.append(("rgb", np.uint8, 3))
        rec = np.zeros(n, dtype=fields)
        rec["xyz"] = v
        if has_n:
            rec["n"] = normals.reshape(-1, 3).astype(np.float32)
        if has_c:
            rec["rgb"] = np.clip(colors.reshape(-1, 3), 0, 255).astype(np.uint8)
        f.write(rec.tobytes())
        faces = np.zeros(t, dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        faces["n"] = 3
        faces["idx"] = np.arange(3 * t, dtype=np.int32).reshape(-1, 3)
        f.write(faces.tobytes())


def read_ply(path: str):
    """Minimal reader for the writer above (tests/round-trips).

    Returns (verts (N, 3), face_count, normals (N, 3) or None)."""
    with open(path, "rb") as f:
        data = f.read()
    head, _, body = data.partition(b"end_header\n")
    lines = head.decode().splitlines()
    n = t = 0
    has_c = has_n = False
    for ln in lines:
        if ln.startswith("element vertex"):
            n = int(ln.split()[-1])
        elif ln.startswith("element face"):
            t = int(ln.split()[-1])
        elif "uchar red" in ln:
            has_c = True
        elif "float nx" in ln:
            has_n = True
    fields = [("xyz", np.float32, 3)]
    if has_n:
        fields.append(("n", np.float32, 3))
    if has_c:
        fields.append(("rgb", np.uint8, 3))
    rec = np.frombuffer(body, dtype=fields, count=n)
    return (rec["xyz"].copy(), t, rec["n"].copy() if has_n else None)

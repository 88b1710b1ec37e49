"""Chunk meshing + PLY export (port of ``cvids_tpu/mapping/mesh.py``).

The `ChunkManager::RecomputeMeshes` role (`ChunkManager.cpp:91-168`): every
chunk gets an (S+1)³ sample block — its own voxels plus one layer from its
+x/+y/+z neighbours, so meshes are seamless across chunks — which marching
tetrahedra turns into fixed-slot triangles. The blocks are gathered on the
pool's device from a (chunks, 8) neighbour-slot table built on the host, a
batch of 256 chunks at a time as one captured program on the card (the
JAX package's `_mesh_chunk_batch`; the last batch padded to a multiple of
64 chunks), and the valid triangles are compacted there before one copy
to the host. PLY
output mirrors `open_chisel/src/io/PLY.cpp` and writes the JAX package's
bytes exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.marching_cubes import marching_tets
from .tsdf import TsdfVolume, pack_chunk_keys

__all__ = ["extract_mesh", "write_ply", "read_ply"]


MESH_BATCH = 256     # chunks a marching-tetrahedra call (one graph replay on the card)
MESH_TIER = 64       # the last batch is padded to a multiple of this many chunks


def _neighbour_slots(vol: TsdfVolume, chunks) -> np.ndarray:
    """(len(chunks), 8) pool slots of each chunk's neighbours at
    (+dx, +dy, +dz), dx, dy, dz in {0, 1}, in the order dz*4 + dy*2 + dx;
    -1 where the neighbour is not allocated. A lookup of packed keys
    (`pack_chunk_keys`, chunk coordinates within ±2^20) in the allocated
    chunks' sorted keys."""
    c = np.asarray(chunks, np.int64).reshape(-1, 3)
    out = np.full((len(c), 8), -1, np.int64)
    if not vol.slot_of or not len(c):
        return out
    keys = pack_chunk_keys(np.asarray(list(vol.slot_of), np.int64))
    slots = np.fromiter(vol.slot_of.values(), np.int64, len(vol.slot_of))
    order = np.argsort(keys)
    keys, slots = keys[order], slots[order]
    n = np.arange(8)
    nb = c[:, None, :] + np.stack([n & 1, (n >> 1) & 1, n >> 2], 1)[None]   # (N, 8, 3)
    inside = np.all((nb >= -(1 << 20)) & (nb < (1 << 20)), -1)
    q = pack_chunk_keys(nb)
    at = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    hit = inside & (keys[at] == q)
    out[hit] = slots[at][hit]
    return out


def _block_index(s: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """For each sample (z, y, x) of an (S+1)³ block: which of the 8
    neighbours holds it and its voxel's flat offset in that chunk."""
    idx = torch.arange(s + 1, device=device)
    nb, loc = idx // s, idx % s
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    which = nb[zz] * 4 + nb[yy] * 2 + nb[xx]
    local = loc[zz] * s * s + loc[yy] * s + loc[xx]
    return which.reshape(-1), local.reshape(-1)


def mesh_batch(sdf_f: torch.Tensor, w_f: torch.Tensor, col_f: torch.Tensor,
               table: torch.Tensor, origins: torch.Tensor, voxel_size: float, s: int):
    """The counterpart of the JAX package's `_mesh_chunk_batch`: gather
    each chunk's (S+1)³ block from the flat pool (sdf_f, w_f (C·S³,),
    col_f (C·S³, 3)) through its neighbour slots `table` (B, 8) int64, 0
    weight where a slot is -1, and run `marching_tets` at `origins` (B, 3).
    Fixed shapes, no read back: one CUDA graph a batch size on the card."""
    dev = sdf_f.device
    which, local = _block_index(s, dev)
    slots = table[:, which]                                    # (B, (S+1)³)
    have = slots >= 0
    flat = torch.clamp(slots, min=0) * s ** 3 + local
    zero = torch.zeros((), device=dev)
    shape = (-1, s + 1, s + 1, s + 1)
    sdf_b = torch.where(have, sdf_f[flat], zero).reshape(shape)
    wgt_b = torch.where(have, w_f[flat], zero).reshape(shape)
    col_b = torch.where(have[..., None], col_f[flat], zero).reshape(shape + (3,))
    return marching_tets(sdf_b, wgt_b, origins, voxel_size, col_b)


def extract_mesh(vol: TsdfVolume, chunks: list[tuple] | None = None,
                 batch: int = MESH_BATCH):
    """Mesh the given chunks (default: all allocated, in `vol.slot_of`
    order), `batch` chunks a `mesh_batch` call; the last batch is padded
    to a multiple of `MESH_TIER` chunks (at most `batch`) with rows of no
    neighbour, which weigh 0 and make no triangle (the JAX package pads
    with a never-allocated chunk). On the card each batch is one replay of
    the volume's graphs (`vol.mesh_graph`, over the bound pool, one a
    batch size) and one read, the `nonzero` of its valid slots.

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
    n = len(chunks)
    last = n - (n - 1) // batch * batch
    n_pad = min(-(-last // MESH_TIER) * MESH_TIER, batch) - last
    table = np.concatenate([_neighbour_slots(vol, chunks), np.full((n_pad, 8), -1, np.int64)])
    origins = np.concatenate([np.asarray(chunks, np.float32) * (s * cfg.voxel_size)
                              + 0.5 * cfg.voxel_size, np.zeros((n_pad, 3), np.float32)])
    table_t, origins_t = torch.from_numpy(table).to(dev), torch.from_numpy(origins).to(dev)
    flat = (vol.pool.sdf.reshape(-1), vol.pool.weight.reshape(-1),
            vol.pool.color.reshape(-1, 3))
    out_v, out_c, out_n = [], [], []
    for start in range(0, n, batch):
        v, ok, c, nrm = vol.mesh_graph(*flat, table_t[start:start + batch],
                                       origins_t[start:start + batch], cfg.voxel_size, s)
        keep = torch.nonzero(ok.reshape(-1)).squeeze(1)
        out_v.append(v.reshape(-1, 3, 3).index_select(0, keep))
        out_c.append(c.reshape(-1, 3, 3).index_select(0, keep))
        out_n.append(nrm.reshape(-1, 3, 3).index_select(0, keep))
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

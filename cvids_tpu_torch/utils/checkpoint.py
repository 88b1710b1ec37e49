"""Checkpoint / resume for the collaborative server and the TSDF map (port of
``cvids_tpu/utils/checkpoint.py``).

The whole server state (keyframe store, submap/drift registry, loop edges,
BoW database) and the TSDF volume serialize to one compressed npz each.
The layout is the JAX package's — the same keys and the same `meta_json` —
so a checkpoint written by either package loads into the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..mapping.tsdf import ChunkPool

__all__ = ["save_server", "load_server", "save_tsdf", "load_tsdf"]

_STORE_FIELDS = [
    "client", "local_index", "timestamp", "vio_p", "vio_q", "world_p",
    "world_yaw", "world_pr", "win_pts3d", "win_uv", "win_ids", "win_desc",
    "win_valid", "ext_uv", "ext_desc", "ext_valid", "optimized",
]
_LOOP_FIELDS = ["loop_i", "loop_j", "loop_t", "loop_yaw", "loop_inter",
                "loop_valid", "loop_pcm_ok"]


def save_server(path: str, server) -> None:
    """Snapshot a `CollaborativePoseGraph`. In-flight loop verifications are
    resolved and the background solver quiesced first, so the snapshot is
    complete and untorn."""
    server.flush(final=False)
    arrays = {}
    for f in _STORE_FIELDS:
        arrays[f"store_{f}"] = getattr(server.store, f)
    for f in _LOOP_FIELDS:
        arrays[f] = getattr(server, f)
    if hasattr(server.db, "vectors"):       # dense BowDatabase
        arrays["db_vectors"] = server.db.vectors.cpu().numpy()
    else:                                   # SparseBowDatabase (tree mode)
        arrays["db_ids"] = server.db.ids.cpu().numpy()
        arrays["db_vals"] = server.db.vals.cpu().numpy()
    arrays["db_client"] = server.db.client
    meta = {
        "store_count": server.store.count,
        "loop_count": server.loop_count,
        "db_count": server.db.count,
        "world_client": server.world_client,
        "clients": [
            {"registered": c.registered, "aligned": c.aligned,
             "yaw_wl": c.yaw_wl, "t_wl": c.t_wl.tolist(),
             "yaw_drift": c.yaw_drift, "t_drift": c.t_drift.tolist(),
             "kf_count": c.kf_count, "r_cb": c.r_cb.tolist(),
             "p_bc": c.p_bc.tolist()}
            for c in server.clients],
    }
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


def load_server(path: str, server) -> None:
    """Restore in place into a freshly constructed server (same config); the
    database arrays go to the server's device."""
    data = np.load(path)
    meta = json.loads(bytes(data["meta_json"]).decode())
    for f in _STORE_FIELDS:
        getattr(server.store, f)[...] = data[f"store_{f}"]
    for f in _LOOP_FIELDS:
        getattr(server, f)[...] = data[f]
    # reassign every db array (not in place): the saved database may have
    # grown past the fresh server's capacity
    dev = server.device
    if "db_vectors" in data:
        server.db.vectors = torch.from_numpy(data["db_vectors"]).to(dev)
    else:
        server.db.ids = torch.from_numpy(data["db_ids"]).to(dev)
        server.db.vals = torch.from_numpy(data["db_vals"]).to(dev)
    server.db.client = np.array(data["db_client"])
    server.db.client_dev = torch.from_numpy(server.db.client).to(dev)
    server.store.count = int(meta["store_count"])
    server.loop_count = int(meta["loop_count"])
    server.db.count = int(meta["db_count"])
    server.world_client = int(meta["world_client"])
    for c, m in zip(server.clients, meta["clients"]):
        c.registered = bool(m["registered"])
        c.aligned = bool(m["aligned"])
        c.yaw_wl = float(m["yaw_wl"])
        c.t_wl = np.asarray(m["t_wl"], np.float32)
        c.yaw_drift = float(m["yaw_drift"])
        c.t_drift = np.asarray(m["t_drift"], np.float32)
        c.kf_count = int(m["kf_count"])
        c.r_cb = np.asarray(m["r_cb"], np.float32)
        c.p_bc = np.asarray(m["p_bc"], np.float32)


def save_tsdf(path: str, vol) -> None:
    """Snapshot the chunk pool (the `GetAllChunks` service equivalent)."""
    keys = np.asarray(list(vol.slot_of.keys()), np.int32).reshape(-1, 3)
    slots = np.asarray(list(vol.slot_of.values()), np.int32)
    np.savez_compressed(
        path,
        sdf=vol.pool.sdf.cpu().numpy(), weight=vol.pool.weight.cpu().numpy(),
        color=vol.pool.color.cpu().numpy(), coords=vol.coords_np,
        occupied=vol.occupied_np, keys=keys, slots=slots,
        free=np.asarray(vol.free, np.int32))


def load_tsdf(path: str, vol) -> None:
    """Restore into `vol`; the pool goes to the volume's device."""
    data = np.load(path)
    vol.pool = ChunkPool(*(torch.from_numpy(data[k]).to(vol.device)
                           for k in ("sdf", "weight", "color")))
    # the saved pool may have grown past vol's current tier
    vol.capacity = int(data["sdf"].shape[0])
    vol.coords_np = np.asarray(data["coords"], np.int32).copy()
    vol.occupied_np = np.asarray(data["occupied"], bool).copy()
    vol.slot_of = {tuple(int(x) for x in k): int(s)
                   for k, s in zip(data["keys"], data["slots"])}
    vol.free = [int(x) for x in data["free"]]

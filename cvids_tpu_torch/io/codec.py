"""AgentMsg wire codec: descriptor and point packing (copy of
``cvids_tpu/io/codec.py``, so that the port runs without the JAX package).

The reference packs each 256-bit BRIEF descriptor as 4×int64 in the ROS
message (`agent_msg/msg/AgentMsg.msg:11,14`; unpack at
`collaborative_server_system.cpp:618-646`). This codec converts between that
wire layout and the native uint32[8] layout bit-exactly, plus full packet
(de)serialization to a flat dict of arrays (the transport-agnostic form —
file replay, RPC, shared memory all carry the same dict). Host numpy only:
a packet encoded by either package decodes in the other to the same arrays.
"""

from __future__ import annotations

import numpy as np

from .msgs import KeyframePacket

__all__ = ["desc_to_int64", "desc_from_int64", "encode_packet", "decode_packet"]


def desc_to_int64(desc_u32: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 4) int64 (the AgentMsg layout), bit-exact."""
    return np.ascontiguousarray(desc_u32, np.uint32).view(np.int64) \
        .reshape(-1, 4).copy()


def desc_from_int64(desc_i64: np.ndarray) -> np.ndarray:
    """(N, 4) int64 -> (N, 8) uint32."""
    return np.ascontiguousarray(desc_i64, np.int64).view(np.uint32) \
        .reshape(-1, 8).copy()


_FIELDS = ["p_wb", "q_wb", "r_cb", "p_bc", "win_pts3d", "win_uv", "win_ids",
           "win_valid", "ext_uv", "ext_valid"]


def encode_packet(pkt: KeyframePacket) -> dict:
    out = {"client_id": np.int64(pkt.client_id),
           "timestamp": np.float64(pkt.timestamp),
           "win_desc_i64": desc_to_int64(pkt.win_desc) if len(pkt.win_desc)
           else np.zeros((0, 4), np.int64),
           "ext_desc_i64": desc_to_int64(pkt.ext_desc) if len(pkt.ext_desc)
           else np.zeros((0, 4), np.int64)}
    for f in _FIELDS:
        out[f] = np.asarray(getattr(pkt, f))
    if pkt.image is not None:
        out["image"] = pkt.image
    return out


def decode_packet(d: dict) -> KeyframePacket:
    return KeyframePacket(
        client_id=int(d["client_id"]), timestamp=float(d["timestamp"]),
        p_wb=d["p_wb"], q_wb=d["q_wb"], r_cb=d["r_cb"], p_bc=d["p_bc"],
        win_pts3d=d["win_pts3d"], win_uv=d["win_uv"], win_ids=d["win_ids"],
        win_desc=desc_from_int64(d["win_desc_i64"]),
        win_valid=d["win_valid"],
        ext_uv=d["ext_uv"], ext_desc=desc_from_int64(d["ext_desc_i64"]),
        ext_valid=d["ext_valid"],
        image=d.get("image"))

"""Keyframe packet schema — the AgentMsg-equivalent wire contract (copy of
``cvids_tpu/io/msgs.py``, so that the port runs without the JAX package).

Mirrors the reference's `agent_msg/msg/AgentMsg.msg:1-14`: per keyframe the
agent sends its IMU pose, camera extrinsics, windowed map points (3D in the
agent's local world, normalized 2D, feature ids, 256-bit BRIEF descriptors)
and extra full-image FAST features + descriptors for loop-closure matching.
Descriptors travel as uint32[8] (the reference packs 4×int64 per
descriptor); the server moves them to the device as int32 views.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["KeyframePacket"]


@dataclass
class KeyframePacket:
    client_id: int
    timestamp: float
    # IMU/body pose in the agent's local world frame
    p_wb: np.ndarray           # (3,)
    q_wb: np.ndarray           # (4,) wxyz
    # camera extrinsics (body -> camera): x_cam = r_cb @ (x_body - p_bc)
    r_cb: np.ndarray           # (3, 3)
    p_bc: np.ndarray           # (3,)
    # window map points
    win_pts3d: np.ndarray      # (P, 3) in agent-local world
    win_uv: np.ndarray         # (P, 2) normalized camera coords
    win_ids: np.ndarray        # (P,) int64 feature ids
    win_desc: np.ndarray       # (P, 8) uint32
    win_valid: np.ndarray      # (P,) bool
    # extra full-image features (for being matched by future loop queries)
    ext_uv: np.ndarray         # (F, 2) normalized camera coords
    ext_desc: np.ndarray       # (F, 8) uint32
    ext_valid: np.ndarray      # (F,) bool
    # optional grayscale image for dense mapping
    image: np.ndarray | None = None

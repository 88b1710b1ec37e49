"""Fixed-capacity struct-of-arrays keyframe store (numpy port of
``cvids_tpu/server/keyframe.py``).

One set of flat numpy arrays replaces the reference's per-object
`ServerKeyFrame` list (`server_keyframe.h:578-667`): every field is a
(capacity, ...) array. The store stays on the host; the server moves to the
device only what a device step reads (descriptors as int32 views of these
uint32 words).
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..io.msgs import KeyframePacket

__all__ = ["KeyframeStore"]

log = logging.getLogger(__name__)


class KeyframeStore:
    def __init__(self, capacity: int = 2048, max_win: int = 160,
                 max_ext: int = 512):
        self.capacity = capacity
        self.max_win = max_win
        self.max_ext = max_ext
        c = capacity
        self.count = 0
        self.client = np.full(c, -1, np.int32)
        self.local_index = np.full(c, -1, np.int32)   # per-client counter
        self.timestamp = np.zeros(c, np.float64)
        # VIO pose in the client's local frame
        self.vio_p = np.zeros((c, 3), np.float32)
        self.vio_q = np.zeros((c, 4), np.float32)
        # current world estimate (4-DoF convention: yaw free, pitch/roll frozen)
        self.world_p = np.zeros((c, 3), np.float32)
        self.world_yaw = np.zeros(c, np.float32)
        self.world_pr = np.zeros((c, 2), np.float32)  # (pitch, roll)
        # window points
        self.win_pts3d = np.zeros((c, max_win, 3), np.float32)   # local frame
        self.win_uv = np.zeros((c, max_win, 2), np.float32)
        self.win_ids = np.full((c, max_win), -1, np.int64)
        self.win_desc = np.zeros((c, max_win, 8), np.uint32)
        self.win_valid = np.zeros((c, max_win), bool)
        # extra features
        self.ext_uv = np.zeros((c, max_ext, 2), np.float32)
        self.ext_desc = np.zeros((c, max_ext, 8), np.uint32)
        self.ext_valid = np.zeros((c, max_ext), bool)
        # bookkeeping
        self.optimized = np.zeros(c, bool)  # covered by the last 4-DoF solve

    @property
    def valid(self) -> np.ndarray:
        return np.arange(self.capacity) < self.count

    def _grow(self) -> None:
        """Double every array (power-of-two capacity tiers; the reference's
        graph is unbounded, `server_pose_graph.cpp:344`)."""
        new_cap = self.capacity * 2
        log.info("KeyframeStore grow %d -> %d", self.capacity, new_cap)
        for name, arr in list(vars(self).items()):
            if isinstance(arr, np.ndarray) and arr.shape[:1] == (self.capacity,):
                pad = np.zeros((self.capacity,) + arr.shape[1:], arr.dtype)
                if arr.dtype in (np.int32, np.int64):
                    pad -= 1  # index-like fields use -1 = empty
                setattr(self, name, np.concatenate([arr, pad]))
        self.capacity = new_cap

    def add(self, pkt: KeyframePacket, local_index: int) -> int:
        if self.count >= self.capacity:
            self._grow()
        i = self.count
        self.client[i] = pkt.client_id
        self.local_index[i] = local_index
        self.timestamp[i] = pkt.timestamp
        self.vio_p[i] = pkt.p_wb
        self.vio_q[i] = pkt.q_wb

        def fill(dst, src, n):
            m = min(len(src), n)
            dst[i, :m] = src[:m]
            return m

        pw = min(len(pkt.win_pts3d), self.max_win)
        self.win_pts3d[i, :pw] = pkt.win_pts3d[:pw]
        self.win_uv[i, :pw] = pkt.win_uv[:pw]
        self.win_ids[i, :pw] = pkt.win_ids[:pw]
        self.win_desc[i, :pw] = pkt.win_desc[:pw]
        self.win_valid[i, :pw] = pkt.win_valid[:pw]
        pe = min(len(pkt.ext_uv), self.max_ext)
        self.ext_uv[i, :pe] = pkt.ext_uv[:pe]
        self.ext_desc[i, :pe] = pkt.ext_desc[:pe]
        self.ext_valid[i, :pe] = pkt.ext_valid[:pe]
        self.count += 1
        return i

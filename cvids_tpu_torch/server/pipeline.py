"""CollaborativeServer — full-system orchestration (port of
``cvids_tpu/server/pipeline.py``).

The role of the reference's `CollaborativeServer`
(`collaborative_server_system.cpp`): ingestion of agent keyframes, the
pose-graph core, per-client dense depth estimation against a rolling
reference keyframe, hand-off of finalized depth maps into the TSDF volume,
mesh save, stale-keyframe memory release (`FreeSpace`, `:421-426`), and the
reference's `AddDisturbance` fault injection (`server_pose_graph.h:48-77`).

The reference runs four long-lived threads synchronized by nine mutexes;
here the host side is a single-threaded queue drain (`process()`): every
heavy stage is tensor work on `device`, queued on its stream. On a CUDA
device the dense step runs the warp, sweep, SGM, WTA and filter kernels,
each loop verification the Hamming kernel, and the TSDF pool and the mesh
gather stay on the card.

Each client's dense state lives in one `estimator.DenseStep` for the whole
run: a reference roll writes into its buffers, so the frame's CUDA graphs
(one per warp and bias variant, picked by the host's banded gate) stay
valid, and every dense graph of the server shares one memory pool. A roll
is one upload of its host inputs and one more graph replay (one per bias
variant and landmark tier, in a pool of their own), on the image the
keyframe's frame already uploaded.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..dense import estimator
from ..geometry.hostmath import quat_to_matrix_np, ypr_to_r_np
from ..io.msgs import KeyframePacket
from ..mapping import mesh as mesh_mod
from ..mapping.tsdf import TsdfConfig, TsdfVolume
from ..ops.costvolume import warp_shift_bounds_np
from ..ops.image import bilinear_sample
from ..utils import tracing
from ..utils.tracing import Tracer
from .posegraph import CollaborativePoseGraph, ServerConfig

__all__ = ["CollaborativeServer", "PipelineConfig"]


@dataclass
class PipelineConfig:
    server: ServerConfig = field(default_factory=ServerConfig)
    dense: estimator.DenseConfig = field(default_factory=estimator.DenseConfig)
    tsdf: TsdfConfig = field(default_factory=TsdfConfig)
    dense_enabled: bool = True
    min_fused_frames: int = 2       # before a ref keyframe finalizes
    ref_advance: int = 5            # keyframes per reference (reference: 5)
    free_space_after: int = 8       # drop images of KFs this far behind
    # fault injection (`AddDisturbance`: +0.2 deg yaw, +0.02 m after 2000 KFs)
    disturbance_after: int = 2000
    disturbance_yaw_deg: float = 0.2
    disturbance_t: float = 0.02


@dataclass
class _DenseClientState:
    step: estimator.DenseStep       # the client's buffers and graphs
    ref_index: int = -1             # store index of the current reference KF
    fused: int = 0
    since_ref: int = 0
    # last fused measurement frame + its ref->meas mapping, retained for the
    # photometric validation gate at finalize (`DepthEstimator::Validate`)
    last_meas: object = None
    last_a: object = None
    last_b: object = None
    k_inv: tuple | None = None      # (K's bytes, K⁻¹ on the device) of the last roll

    @property
    def state(self) -> estimator.DenseState:
        return self.step.state


class CollaborativeServer:
    def __init__(self, voc, cfg: PipelineConfig | None = None,
                 device: torch.device | str | None = None,
                 noise: Callable[[int, int], torch.Tensor] | None = None):
        """`voc` and `noise` as for `CollaborativePoseGraph` (a dense
        `Vocabulary` or a `TreeVocabulary`; the RANSAC noise source).
        `device=None` is the card (`default_device()`, which raises where
        there is none); pass "cpu" to run on the host."""
        self.cfg = cfg or PipelineConfig()
        self.device = resolve_device(device)
        # one tracer for every span of the server, the solver thread's too
        self.tracer = Tracer()
        self.graph = CollaborativePoseGraph(voc, self.cfg.server, device=self.device,
                                            noise=noise, tracer=self.tracer)
        self.volume = TsdfVolume(self.cfg.tsdf, device=self.device)
        self.queue: deque[KeyframePacket] = deque()
        self.images: dict[int, np.ndarray] = {}   # store index -> image
        self.dense_state: dict[int, _DenseClientState] = {}
        self._dense_graphs = estimator.fuse_graphs()   # one pool for every client's graphs
        self._roll_graphs = estimator.roll_graphs()    # and one for their rolls
        self.depth_maps_published = 0
        self.last_depth: dict[int, dict] = {}   # client -> latest depth record
        self.depth_records: list[dict] = []     # all published (capped at 64)
        self._client_k: dict[int, np.ndarray] = {}
        self._undistort_grid: dict[int, torch.Tensor] = {}
        self._loop_overlay_pair: tuple | None = None
        # per-KF decimated thumbnails survive FreeSpace (the reference
        # plotter keeps downscaled copies for its loop-match image)
        self.thumbs: dict[int, tuple[np.ndarray, int]] = {}

    # ---------- ingestion ----------

    def submit(self, pkt: KeyframePacket):
        """Enqueue (the `/agent_frame` subscription role; the host-side queue
        is unbounded — the reference uses depth-2000 ROS queues)."""
        self.queue.append(pkt)

    def process(self, max_items: int | None = None) -> int:
        """Drain the queue (AgentProcess + PublishProcess combined)."""
        n = 0
        while self.queue and (max_items is None or n < max_items):
            self._process_one(self.queue.popleft())
            n += 1
        return n

    def _process_one(self, pkt: KeyframePacket):
        cfg = self.cfg
        with self.tracer.span("ingest"):
            self._maybe_disturb()
            info = self.graph.add_keyframe(pkt)
        idx = info["index"]
        if pkt.image is not None:
            self.images[idx] = pkt.image
            img = np.asarray(pkt.image)
            step = max(1, img.shape[1] // 160)
            self.thumbs[idx] = (img[::step, ::step].astype(np.float32), step)
        if info.get("loop") and pkt.image is not None:
            # thumbnail pair of the most recent accepted loop (for the
            # match-overlay diagnostic); with pipelined verification the loop
            # belongs to keyframe info["loop_at"]
            old = self.thumbs.get(info["loop_with"])
            new = self.thumbs.get(info.get("loop_at", idx))
            if old is not None and new is not None:
                self._loop_overlay_pair = (new, old)
        if cfg.dense_enabled and pkt.image is not None:
            with self.tracer.span("depth"):
                self._dense_step(pkt, idx, info)
        self._free_space(idx)
        return info

    def _maybe_disturb(self):
        """Reference `AddDisturbance`: once the graph is large, perturb the
        accepted loop edges to stress PCM/optimization."""
        g = self.graph
        cfg = self.cfg
        if g.store.count != cfg.disturbance_after or g.loop_count == 0:
            return
        n = g.loop_count
        g.loop_yaw[:n] += np.deg2rad(cfg.disturbance_yaw_deg)
        g.loop_t[:n] += cfg.disturbance_t

    # ---------- dense mapping ----------

    def _world_cam_pose(self, idx: int):
        """Camera pose in world from the store's 4-DoF world estimate."""
        st = self.graph.store
        c = self.graph.clients[int(st.client[idx])]
        r_wb = ypr_to_r_np(np.array([st.world_yaw[idx], st.world_pr[idx, 0],
                                     st.world_pr[idx, 1]], np.float32))
        r_wc = r_wb @ c.r_cb.T       # camera axes in world
        t_wc = st.world_p[idx] + r_wb @ c.p_bc
        return r_wc.astype(np.float32), t_wc.astype(np.float32)

    def _k_matrix(self, pkt: KeyframePacket):
        # packets carry undistorted (or synthetic pinhole) images; without
        # client intrinsics K comes from the image size and a 460 px focal
        h, w = pkt.image.shape
        return self._client_k.get(int(pkt.client_id),
                                  np.array([[460.0, 0, w / 2],
                                            [0, 460.0, h / 2],
                                            [0, 0, 1]], np.float32))

    def set_client_intrinsics(self, cid: int, k: np.ndarray):
        self._client_k[cid] = np.asarray(k, np.float32)

    def set_client_camera(self, cid: int, cam):
        """Dense-path undistortion: the reference and match frames are
        undistorted onto the pinhole K before the cost kernel
        (`sgm_stereo_mapper.cpp:55-123,155-175`). Builds the remap grid ONCE
        per client (each dense-image pixel -> its distorted source pixel), on
        the server's device, where it stays; per-frame undistortion is then
        a single bilinear gather there. `cam` is one of
        `cvids_tpu_torch.camera`'s models (picked by class name), on any
        device; an undistorted pinhole needs no grid."""
        cfg = self.cfg.dense
        fx, fy, cx, cy = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
        self._client_k[cid] = np.array([[fx, 0.0, cx], [0.0, fy, cy],
                                        [0.0, 0.0, 1.0]], np.float32)
        is_pinhole = type(cam).__name__ == "PinholeCamera"
        if is_pinhole and not bool(torch.as_tensor(cam.dist).any()):
            return  # already pinhole; no remap needed
        dev = self.device
        cam = type(cam)(*(f.to(dev) if isinstance(f, torch.Tensor) else f for f in cam))
        uu, vv = torch.meshgrid(torch.arange(cfg.width, dtype=torch.float32, device=dev),
                                torch.arange(cfg.height, dtype=torch.float32, device=dev),
                                indexing="xy")
        norm = torch.stack([(uu - cx) / fx, (vv - cy) / fy], dim=-1)
        if is_pinhole:
            px = cam.project_normalized(norm.reshape(-1, 2))
        else:
            # polymorphic path (equidistant/Mei): each virtual-pinhole
            # pixel's ray projected through the real model gives its
            # distorted source pixel
            rays = torch.cat([norm.reshape(-1, 2),
                              torch.ones((cfg.height * cfg.width, 1), device=dev)], -1)
            px = cam.project(rays)
        self._undistort_grid[cid] = px.reshape(cfg.height, cfg.width, 2).contiguous()

    def _undistort(self, cid: int, img: np.ndarray) -> torch.Tensor:
        """The image on the device, resampled through the client's remap
        grid when it has one (each dense-image pixel -> its source pixel)."""
        with tracing.sync():
            img_t = torch.from_numpy(np.asarray(img, np.float32)).to(self.device)
        grid = self._undistort_grid.get(cid)
        if grid is None:
            return img_t
        with self.tracer.span("remap"):
            return bilinear_sample(img_t, grid, fill=0.0)

    def _sparse_from_packet(self, pkt: KeyframePacket, k: np.ndarray):
        """Window VIO landmarks -> (pixel uv, inverse depth, valid) in the
        dense reference image (`BindSparsePoints`,
        `server_keyframe.cpp:934-962`): the agent's triangulated points give
        the cost volume a metric prior exactly where VIO is confident."""
        if pkt.win_pts3d is None or len(pkt.win_pts3d) == 0:
            return None
        r_wb = quat_to_matrix_np(pkt.q_wb)
        pts_b = (pkt.win_pts3d - pkt.p_wb) @ r_wb
        pts_c = (pts_b - pkt.p_bc) @ np.asarray(pkt.r_cb).T
        z = pts_c[:, 2]
        uv_h = pts_c @ k.T
        uv = uv_h[:, :2] / np.maximum(uv_h[:, 2:3], 1e-6)
        valid = (np.asarray(pkt.win_valid, bool)
                 & (z > 0.3) & (z < 50.0) & np.isfinite(uv).all(axis=1))
        if not valid.any():
            return None
        return (uv.astype(np.float32),
                (1.0 / np.maximum(z, 1e-6)).astype(np.float32), valid)

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        with tracing.sync():
            return torch.from_numpy(np.asarray(a)).to(device=self.device, dtype=dtype)

    def _dense_step(self, pkt: KeyframePacket, idx: int, info: dict):
        """Per-client rolling-reference depth estimation
        (`server_pose_graph.cpp:779-919` dense section)."""
        cfg = self.cfg
        cid = int(pkt.client_id)
        if not self.graph.clients[cid].aligned:
            return
        if pkt.image.shape != (cfg.dense.height, cfg.dense.width):
            raise ValueError(
                f"dense config expects {cfg.dense.height}x{cfg.dense.width} "
                f"images, got {pkt.image.shape} (client {cid})")
        ds = self.dense_state.get(cid)
        k = self._k_matrix(pkt)
        if ds is None:
            ds = self.dense_state[cid] = _DenseClientState(
                estimator.DenseStep(cfg.dense, self._dense_graphs, self._roll_graphs))
        if ds.ref_index < 0:
            self._new_reference(ds, pkt, idx)
            return
        # fuse the current frame into the client's reference keyframe
        r_wc_ref, t_wc_ref = self._world_cam_pose(ds.ref_index)
        r_wc_new, t_wc_new = self._world_cam_pose(idx)
        # measurement-from-reference: x_m = R x_r + t
        r_mr = r_wc_new.T @ r_wc_ref
        t_mr = r_wc_new.T @ (t_wc_ref - t_wc_new)
        a_mat = k @ r_mr @ np.linalg.inv(k)
        b_vec = k @ t_mr
        # alignment-warp choice on the host: the banded kernel covers the
        # usual consecutive-keyframe rotations (its 96/48 bands less an 8 px
        # margin, shifts sampled every 4 px); larger rotations take the
        # exact warp
        dx, dy = warp_shift_bounds_np(a_mat, cfg.dense.height, cfg.dense.width, step=4)
        banded = bool(dx < 88.0 and dy < 40.0)
        meas_t = self._undistort(cid, pkt.image)
        a_t, b_t = self._tensor(a_mat), self._tensor(b_vec)
        ds.step.fuse(meas_t, a_t, b_t, banded_warp=banded)
        ds.last_meas, ds.last_a, ds.last_b = meas_t, a_t, b_t
        ds.fused += 1
        ds.since_ref += 1
        if ds.fused >= cfg.min_fused_frames and ds.since_ref >= cfg.ref_advance:
            with self.tracer.span("fuse"):
                self._finalize_and_integrate(cid, ds, k)
            with self.tracer.span("roll"):     # old reference to new: the frame's pose
                self._roll(ds, pkt, k, r_mr, t_mr, meas_t)
            ds.ref_index, ds.fused, ds.since_ref = idx, 0, 0
            ds.last_meas = ds.last_a = ds.last_b = None

    def _new_reference(self, ds: _DenseClientState, pkt: KeyframePacket, idx: int) -> None:
        """Start client `ds`'s first reference on keyframe `idx`, in its
        step's buffers (which this allocates)."""
        img_t = self._undistort(int(pkt.client_id), pkt.image)
        sp = self._sparse_from_packet(pkt, self._k_matrix(pkt))
        sp_args = {}
        if sp is not None:
            sp_args = dict(sparse_uv=self._tensor(sp[0]),
                           sparse_inv_depth=self._tensor(sp[1]),
                           sparse_valid=self._tensor(sp[2], torch.bool))
        ds.step.init_reference(img_t, **sp_args)
        ds.ref_index, ds.fused, ds.since_ref = idx, 0, 0

    def _roll(self, ds: _DenseClientState, pkt: KeyframePacket, k: np.ndarray,
              r_no: np.ndarray, t_no: np.ndarray, img_t: torch.Tensor) -> None:
        """Roll client `ds`'s reference to the keyframe the frame just fused,
        whose image it uploaded as `img_t`, seeding the new reference's
        filter from the current one's through the frame's old-to-new pose
        (`r_no`, `t_no`; `PropogateFromPreviousFrame`): its host inputs in
        one upload, K⁻¹ computed once a client, the rest one graph replay
        on the card (`DenseStep.roll`). A roll that replayed a graph and
        captured none is recorded as one `roll_graph` too, so an eager roll
        or a capture reads as a roll that was not replayed."""
        inputs = estimator.roll_inputs(r_no, t_no, k, self._sparse_from_packet(pkt, k),
                                       self.device)
        if ds.k_inv is None or ds.k_inv[0] != k.tobytes():
            k_t = estimator.unpack_roll_inputs(inputs)[2]
            with tracing.sync():     # the inverse's error check blocks the host
                ds.k_inv = (k.tobytes(), torch.linalg.inv(k_t))
        rolls = ds.step.rolls
        replays, captures = rolls.replays, rolls.captures
        t0 = time.perf_counter()
        ds.step.roll(img_t, inputs, ds.k_inv[1])
        if rolls.replays > replays and rolls.captures == captures:     # a replay alone
            self.tracer.add("roll_graph", time.perf_counter() - t0)

    def _finalize_and_integrate(self, cid: int, ds: _DenseClientState,
                                k: np.ndarray):
        """FinalizeDepthMap -> TSDF integrate (PublishDenseInfo + chisel).
        The depth map stays on the device for the integration; its record
        keeps a host copy."""
        cfg = self.cfg
        inv_d, ok = estimator.finalize(cfg.dense, ds.state)
        depth = 1.0 / torch.clamp(inv_d, min=1e-6)
        # photometric validation against the last fused measurement — the
        # reference's `DepthEstimator::Validate` gate
        # (`depth_estimator.cpp:639-691`): a pixel whose estimated depth does
        # not re-project photometrically into the newest measurement is
        # confidently wrong, the outlier tail the Beta-ratio mask cannot see
        if ds.last_meas is not None:
            ok = ok & estimator.validate_photometric(
                cfg.dense, ds.state, ds.last_meas, ds.last_a, ds.last_b)
        # the NaN-out band of `PublishDenseInfo` (d outside [0.1, 20] m)
        good = ok & (depth > 0.1) & (depth < 20.0)
        depth = torch.where(good, depth, torch.zeros((), device=depth.device))
        color = ds.state.ref_img[..., None].expand(-1, -1, 3)
        r_wc, t_wc = self._world_cam_pose(ds.ref_index)
        with self.tracer.span("mesh"):
            self.volume.integrate(depth, color, k, r_wc, t_wc)
        self.depth_maps_published += 1
        with tracing.sync():
            depth_np = depth.cpu().numpy()
        # records of published depths (the reference dumps these to disk;
        # tests score them against rendered ground truth), capped
        rec = {"ref_index": ds.ref_index, "depth": depth_np, "k": k,
               "r_wc": r_wc, "t_wc": t_wc,
               "client": int(self.graph.store.client[ds.ref_index])}
        self.last_depth[rec["client"]] = rec
        self.depth_records.append(rec)
        if len(self.depth_records) > 64:
            self.depth_records.pop(0)

    def _free_space(self, idx: int):
        """Release images of keyframes far behind every client's reference
        (`FreeSpace`: the reference frees depth/image memory of stale KFs)."""
        horizon = idx - self.cfg.free_space_after
        ref_idxs = {d.ref_index for d in self.dense_state.values()}
        for k in [k for k in self.images if k < horizon and k not in ref_idxs]:
            del self.images[k]

    # ---------- outputs ----------

    def optimize(self):
        with self.tracer.span("optimize"):
            self.graph.optimize()

    def save_mesh(self, path: str):
        """The `/Chisel/SaveMesh` service equivalent; returns the triangle
        count."""
        with self.tracer.span("mesh"):
            verts, cols, norms = mesh_mod.extract_mesh(self.volume)
            mesh_mod.write_ply(path, verts, cols, norms)
        return len(verts)

    def trajectory(self, cid: int):
        return self.graph.trajectory(cid)

    def export_viewer(self, path: str) -> str:
        """Write the self-contained interactive WebGL viewer (trajectories,
        frusta, loop edges, TSDF mesh; the Pangolin-window role,
        `server_plotter.h:286-600`)."""
        from ..utils.viewer import collect_state, export_viewer_html
        with self.graph._lock:
            state = collect_state(self.graph, self.volume)
        return export_viewer_html(path, state=state)

    def live_viewer(self, host: str = "127.0.0.1", port: int = 0):
        """Serve a live re-polling viewer of this running server (the
        rviz/Pangolin live-view role). Returns a LiveViewer with `.url`.

        The /state.json handler is cheap when nothing changed: rev is
        computed under the graph lock, and an unchanged rev returns the
        cached serialized body without re-collecting (in particular without
        re-running the mesh extraction, which itself runs OUTSIDE the graph
        lock — the volume is only mutated by ingest, which rev's keyframe
        count already tracks)."""
        import json as _json

        from ..utils.viewer import LiveViewer, collect_state, collect_volume_state
        cache: dict = {"rev": None, "body": None}
        cache_lock = threading.Lock()

        def _rev_locked():
            st = self.graph.store
            # rev changes on ingest, loop acceptance AND optimizer
            # writeback (pose content hash), so the page re-pulls
            return (st.count + self.graph.loop_count * 100003
                    + (hash(st.world_p[:st.count].tobytes()) & 0xFFFFFFF))

        def state():
            with self.graph._lock:
                rev = _rev_locked()
            with cache_lock:
                if cache["rev"] == rev:
                    return cache["body"]
            with self.graph._lock:
                st = collect_state(self.graph, volume=None, rev=rev)
            st.update(collect_volume_state(self.volume))
            body = _json.dumps(st)
            with cache_lock:
                cache["rev"], cache["body"] = rev, body
            return body
        return LiveViewer(state, host=host, port=port)

    def save_loop_overlay(self, path: str) -> bool:
        """Render the most recent accepted loop closure as a side-by-side
        match image (the reference plotter's loop diagnostic,
        `server_plotter.h:612-691`). Returns False if no loop with retained
        images has been seen (or matplotlib is unavailable)."""
        loop = self.graph.last_loop
        if loop is None or self._loop_overlay_pair is None:
            return False
        from ..utils.visualization import save_loop_match_overlay
        (img_new, s_new), (img_old, s_old) = self._loop_overlay_pair

        def scaled_k(cid, s):
            k = self._client_k.get(cid)
            if k is None:
                return None
            return np.diag([1.0 / s, 1.0 / s, 1.0]) @ k

        cj = int(self.graph.store.client[loop["j"]])
        ci = int(self.graph.store.client[loop["i"]])
        return save_loop_match_overlay(
            path, img_new, img_old, loop,
            k_new=scaled_k(cj, s_new), k_old=scaled_k(ci, s_old))

    def close(self):
        """Stop the pose graph's background solver, if it runs one."""
        self.graph.close()

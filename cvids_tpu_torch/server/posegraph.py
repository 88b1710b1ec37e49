"""Collaborative multi-agent pose graph — the server core (port of
``cvids_tpu/server/posegraph.py``).

A host-side state machine over flat numpy arrays (`KeyframeStore`), with the
compute-heavy steps as tensor code on the server's device:

- keyframe ingestion -> world poses from per-client submap transforms +
  drift (yaw-only semantics, `server_pose_graph.cpp:242-304`);
- loop detection: BoW query with inter/intra thresholds and recent-frame
  exclusion (`:971-1062`), pipelined two stages deep; a keyframe's query
  and insert are one program (`vocab`), one CUDA graph per capacity tier
  on the card;
- geometric verification: Hamming matching (the `hamming_matrix` CUDA
  kernel) -> F-RANSAC -> PnP-RANSAC (their linear algebra on the Jacobi
  kernel) as one CUDA graph on the card (`_match_and_pnp`), and the
  40°/40 m acceptance gates on the host (`server_keyframe.cpp:501-718`);
- submap alignment on the first inter-agent loop (`AlignSubMaps`);
- PCM outlier rejection per client pair (`pcm_graph.cpp`);
- periodic 4-DoF optimization + drift propagation (`:1107-1815`), inline
  or on a worker thread, replayed as one CUDA graph per tier
  (`optimizer.optimize_pose_graph_graphed`). The worker solves on a stream
  of its own, so ingest never waits on its replays; the process captures
  one graph at a time, so the worker's and the ingest thread's captures
  (one per tier each) wait for each other.

Pose algebra on the host is float64 numpy (`geometry.hostmath`). Device
results are fetched where the JAX package calls ``np.asarray``/``bool()``:
a query's top-k one keyframe after its dispatch, a cascade's result one
step after that, each as one packed transfer. Host-to-device copies go
through pinned memory without waiting for the stream.

RANSAC draws its noise from `noise(num_hyp, n)` — by default standard Gumbel
noise from the uniforms of a CPU `torch.Generator` seeded 0 — twice per
dispatched cascade: first for the F stage, then for PnP.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
import types
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from .. import resolve_device
from ..geometry import Pose, compose, inverse, matrix_to_quat, rot_z, wrap_angle, ypr_to_r
from ..geometry.hostmath import (
    matrix_to_quat_np,
    quat_to_matrix_np,
    r_to_ypr_np,
    rot_z_np,
    wrap_angle_np,
    yaw_of_quat_np,
    ypr_to_r_np,
)
from ..ops import hamming, ransac
from . import optimizer as opt
from . import pcm as pcm_mod
from . import vocab as vocab_mod
from .keyframe import KeyframeStore

if TYPE_CHECKING:
    from ..io.msgs import KeyframePacket

__all__ = ["ServerConfig", "CollaborativePoseGraph"]

MAX_CLIENTS = 10  # reference path-array bound (`server_pose_graph.h:154`)
NUM_HYP = 128     # RANSAC hypotheses per stage


@dataclass
class ServerConfig:
    kf_capacity: int = 2048
    max_win: int = 160
    max_ext: int = 512
    max_loops: int = 512
    # loop gates (reference values)
    bow_thresh_inter: float = 0.003   # `server_pose_graph.cpp:996`
    bow_thresh_intra: float = 0.005
    # candidates must also score within this fraction of the best qualifying
    # candidate: the absolute thresholds presume the reference's million-word
    # vocabulary, and with smaller vocabularies the noise floor moves
    bow_rel_gate: float = 0.5
    exclude_recent: int = 10
    min_gap: int = 10                 # frame-index gap before a loop counts
    # candidates geometrically verified per keyframe, oldest first (the
    # reference verifies 1)
    max_loop_candidates: int = 3
    min_loop_matches: int = 15        # MIN_LOOP_NUM (`server_keyframe.h:24`)
    max_loop_yaw_deg: float = 40.0    # `server_keyframe.cpp:692`
    max_loop_t: float = 40.0
    pnp_thresh: float = 10.0 / 460.0
    # optimizer
    loop_t_weight: float = 1.0
    loop_yaw_weight: float = 0.1      # reference: yaw error /10
    loop_huber: float = 0.1
    seq_back: int = 6
    lm_iters: int = 12
    cg_iters: int = 60
    optimize_every: int = 20          # keyframes between solves
    # solve on a worker thread against a snapshot, writing poses and drift
    # back when done (the reference's Optimize4DoF thread,
    # `server_pose_graph.cpp:16,1811-1812`); False solves inline
    async_optimize: bool = False
    optimize_period_s: float = 5.0    # worker wake-up cadence (reference: 5 s)
    # PCM
    pcm_min_edges: int = 20
    pcm_gamma: float = 5.0
    pcm_sigma_t: float = 0.1
    pcm_sigma_yaw: float = 0.05
    # odometry-chain covariance whitening (the reference's Mahalanobis PCM)
    # with per-keyframe-step odometry noise
    pcm_chain_cov: bool = True
    pcm_step_sigma_t: float = 0.02
    pcm_step_sigma_yaw: float = 0.005
    # covisibility fallback connection (`server_pose_graph.cpp:670-703`)
    covis_check: bool = True
    covis_max_dist: float = 1.0
    covis_max_yaw: float = 0.5


@dataclass
class _ClientState:
    registered: bool = False
    aligned: bool = False
    yaw_wl: float = 0.0
    t_wl: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    yaw_drift: float = 0.0
    t_drift: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    kf_count: int = 0
    r_cb: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    p_bc: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))


def _upload(a, device: torch.device) -> torch.Tensor:
    """numpy array (copied) or CPU tensor -> `device`; to a card through
    pinned memory, so the copy does not wait for the stream."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, copy=True))
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def _fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Small device tensors -> numpy in ONE transfer (packed as float32:
    bools, indices < 2^24 and fp32 values survive exactly)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _match_and_pnp(win_desc, win_valid, win_uv, win_pts_camj, ext_desc,
                   ext_valid, ext_uv, gumbel_f, gumbel_p, pnp_thresh, min_inliers,
                   jacobi: bool | None = None):
    """Loop verification: the reference's FindConnection cascade
    (`server_keyframe.cpp:501-718`) —

      1. descriptor match with best<80 + 0.7-ratio gates (the Hamming
         kernel; `server_keyframe.cpp:294-378`);
      2. fundamental-matrix RANSAC on the matched normalized pairs, applied
         only when >= 8 matches survive (`:399-403`, `:539`);
      3. PnP-RANSAC on the epipolar-consistent survivors (`:565-582`).

    win_*: the NEW keyframe's window features (normalized 2-D `win_uv`, 3-D
    points in its own camera frame); ext_*: the OLD keyframe's full-image
    features. The recovered pose is T_cam_old <- cam_new. `jacobi` picks
    the RANSAC stages' linear algebra (`ops.ransac`; True: the Jacobi
    kernel in float64). With it on, nothing is read back to the host, and
    the server replays the cascade as one CUDA graph on the card (the JAX
    package's one `jax.jit`)."""
    m = hamming.match_descriptors(win_desc, ext_desc, win_valid, ext_valid)
    obs = ext_uv[m.indices]
    fres = ransac.fundamental_ransac(win_uv, obs, m.valid, gumbel_f, jacobi=jacobi)
    keep = torch.where(torch.sum(m.valid) >= 8, m.valid & fres.inliers, m.valid)
    res = ransac.pnp_ransac(win_pts_camj, obs, keep, gumbel_p,
                            inlier_thresh=pnp_thresh, min_inliers=min_inliers,
                            jacobi=jacobi)
    return res, m, keep


class CollaborativePoseGraph:
    def __init__(self, voc, config: ServerConfig | None = None,
                 device: torch.device | str | None = None,
                 noise: Callable[[int, int], torch.Tensor] | None = None):
        """`voc` is a trained dense `Vocabulary` (small word counts; moved to
        `device`) or a `TreeVocabulary` (the reference's k=10 L=6
        million-word scale), which switches place recognition to the sparse
        database. `noise(num_hyp, n)` returns (num_hyp, n) standard Gumbel
        noise for one RANSAC stage, on the CPU or on `device`.
        `device=None` is the card (`default_device()`, which raises where
        there is none); pass "cpu" to run on the host."""
        from ..utils.cuda_graph import GraphedCall

        self.cfg = config or ServerConfig()
        self.device = resolve_device(device)
        # the verification cascade, one graph on the card (shapes fixed by
        # the config: one capture a server); the Jacobi linear algebra there
        self._verify = GraphedCall(_match_and_pnp)
        self._jacobi = self.device.type == "cuda"
        self.store = KeyframeStore(self.cfg.kf_capacity, self.cfg.max_win,
                                   self.cfg.max_ext)
        self._tree_mode = isinstance(voc, vocab_mod.TreeVocabulary)
        if self._tree_mode:
            self.voc = voc
            self.db = vocab_mod.SparseBowDatabase(voc, self.cfg.kf_capacity,
                                                  device=self.device)
        else:
            self.voc = voc.to(self.device)
            self.db = vocab_mod.BowDatabase(self.voc, self.cfg.kf_capacity)
        self._noise = noise or functools.partial(
            ransac.gumbel_noise, generator=torch.Generator().manual_seed(0),
            device=self.device)
        self.clients = [_ClientState() for _ in range(MAX_CLIENTS)]
        self.world_client = -1  # the first registered client defines the world
        # loop edges (fixed capacity, doubled when full)
        L = self.cfg.max_loops
        self.loop_i = np.zeros(L, np.int32)
        self.loop_j = np.zeros(L, np.int32)
        self.loop_t = np.zeros((L, 3), np.float32)
        self.loop_yaw = np.zeros(L, np.float32)
        self.loop_inter = np.zeros(L, bool)
        self.loop_valid = np.zeros(L, bool)
        self.loop_pcm_ok = np.zeros(L, bool)
        self.loop_count = 0
        self._since_optimize = 0
        self.last_loop: dict | None = None
        self._chain_cache: dict = {}
        # in-flight verification cascades: each entry holds the dispatched
        # device results of one match/F-RANSAC/PnP cascade, consumed one
        # ingest step later (the reference's asynchronous keyframe-queue
        # loop thread, `server_pose_graph.cpp:16`)
        self._pending: deque = deque()
        # stage-1 slot: the newest keyframe's dispatched BoW query (idx, cid,
        # cand_idx, cand_score device tensors), gated next step
        self._pending_q: tuple | None = None
        # device copies of per-keyframe feature arrays (immutable once
        # stored), so a candidate's features are not uploaded again
        self._dev_feats: dict[int, tuple] = {}
        self._dev_feats_max = 8192
        # the lock guards every pose-graph mutation (ingest) and the
        # solver's snapshot/writeback; the solve itself runs unlocked
        self._lock = threading.RLock()
        self._align_gen = 0           # bumped by _align_submap; stale solves discard
        self.solve_count = 0
        self.discarded_solves = 0
        self.last_solve_s = 0.0
        self._opt_thread: threading.Thread | None = None
        self._opt_wake = threading.Event()
        self._opt_running = threading.Event()
        self._opt_stop = False
        self._opt_paused = False   # set by flush(); cleared by ingest wake
        if self.cfg.async_optimize:
            self._opt_stream = (torch.cuda.Stream(self.device)
                                if self.device.type == "cuda" else None)
            self._opt_thread = threading.Thread(
                target=self._opt_loop, name="optimize4dof", daemon=True)
            self._opt_thread.start()

    # ---------- background optimization worker ----------

    def _opt_loop(self):
        """The reference's Optimize4DoF thread: wake on demand (keyframe-count
        trigger) or every `optimize_period_s` seconds."""
        while not self._opt_stop:
            self._opt_wake.wait(timeout=self.cfg.optimize_period_s)
            if self._opt_stop:
                break
            if self._opt_paused and not self._opt_wake.is_set():
                # quiesced by flush(): only an ingest-triggered wake resumes
                # periodic solving, so no solve mutates world poses while a
                # post-flush reader walks the store
                continue
            self._opt_running.set()
            self._opt_wake.clear()
            try:
                if self.loop_count > 0 and self.store.count >= 2:
                    with (torch.cuda.stream(self._opt_stream) if self._opt_stream is not None
                          else contextlib.nullcontext()):
                        self.optimize()
            except Exception:   # never kill the worker; surface and continue
                import traceback
                traceback.print_exc()
            finally:
                self._opt_running.clear()

    def flush(self, final: bool = True):
        """Resolve in-flight loop verifications, wait for any background solve
        and quiesce the periodic worker (it resumes on the next
        ingest-triggered wake); optionally run one final synchronous solve."""
        with self._lock:
            self._resolve_inflight()
        self._opt_paused = True
        if self._opt_thread is not None:
            while self._opt_wake.is_set() or self._opt_running.is_set():
                time.sleep(0.005)
        if final and self.loop_count > 0 and self.store.count >= 2:
            self.optimize()

    def close(self):
        if self._opt_thread is not None:
            self._opt_stop = True
            self._opt_wake.set()
            self._opt_thread.join(timeout=60.0)
            self._opt_thread = None

    # ---------- client / submap management ----------

    def register_client(self, cid: int, r_cb=None, p_bc=None):
        """The first client becomes the world frame (aligned, identity
        transform); `RegisterClient` (`server_pose_graph.cpp:283-304`)."""
        c = self.clients[cid]
        if c.registered:
            return
        c.registered = True
        if r_cb is not None:
            c.r_cb = np.asarray(r_cb, np.float32)
        if p_bc is not None:
            c.p_bc = np.asarray(p_bc, np.float32)
        if self.world_client < 0:
            self.world_client = cid
            c.aligned = True

    def _local_to_world(self, cid: int, p: np.ndarray, q: np.ndarray):
        """Apply the submap transform, then drift (both yaw-only + t).

        Batched: p (..., 3), q (..., 4) -> (p_w, yaw_w, pitch_roll_w)."""
        c = self.clients[cid]
        p = np.asarray(p, np.float64)
        p_w = p @ rot_z_np(c.yaw_wl).T + c.t_wl
        ypr = r_to_ypr_np(quat_to_matrix_np(q))
        yaw_w = ypr[..., 0] + c.yaw_wl
        p_w = p_w @ rot_z_np(c.yaw_drift).T + c.t_drift
        yaw_w = yaw_w + c.yaw_drift
        if p.ndim == 1:
            return (p_w.astype(np.float32), float(yaw_w),
                    ypr[1:].astype(np.float32))
        return (p_w.astype(np.float32), yaw_w.astype(np.float32),
                ypr[..., 1:].astype(np.float32))

    # ---------- ingestion ----------

    def add_keyframe(self, pkt: KeyframePacket) -> dict:
        with self._lock:
            return self._add_keyframe_locked(pkt)

    def _add_keyframe_locked(self, pkt: KeyframePacket) -> dict:
        cfg = self.cfg
        cid = pkt.client_id
        self.register_client(cid, pkt.r_cb, pkt.p_bc)
        c = self.clients[cid]
        idx = self.store.add(pkt, c.kf_count)
        c.kf_count += 1

        p_w, yaw_w, pr_w = self._local_to_world(cid, pkt.p_wb, pkt.q_wb)
        self.store.world_p[idx] = p_w
        self.store.world_yaw[idx] = yaw_w
        self.store.world_pr[idx] = pr_w

        # BoW query + add (dense vector for trained small vocabularies,
        # sparse tf-idf at reference vocabulary scale) on the device copies,
        # which loop verification reuses (bounded FIFO cache)
        feats = self._feats(idx)
        self._dev_feats[idx] = feats
        if len(self._dev_feats) > self._dev_feats_max:
            self._dev_feats.pop(next(iter(self._dev_feats)))
        desc_d, valid_d = feats[0], feats[1]
        if self._tree_mode:
            cand_idx, cand_score = self.db.query_and_add(
                desc_d, cid, cfg.exclude_recent, valid=valid_d)
        else:
            cand_idx, cand_score = self.db.query_and_add_descriptors(
                desc_d, cid, cfg.exclude_recent, valid=valid_d)

        info = {"index": idx, "loop": False, "aligned_event": False}
        # two-stage pipelined loop detection: consume the in-flight cascade
        # result first, then gate the PREVIOUS keyframe's query result and
        # dispatch its cascade, then park this keyframe's query for the next
        # step. The host never waits on device work dispatched in the same
        # step; detection lands 1-2 keyframes late and is resolved by
        # flush()/optimize(). Draining before the candidate gate keeps
        # `_covisibility_candidate` reading post-alignment world poses.
        self._drain_pending(info)
        self._process_pending_query(info)
        self._pending_q = (idx, cid, cand_idx, cand_score)

        self._since_optimize += 1
        self._opt_paused = False         # new ingest re-arms the periodic worker
        if self._since_optimize >= cfg.optimize_every and self.loop_count > 0:
            if self._opt_thread is not None:
                self._opt_wake.set()     # overlapped: solve on the worker
            else:
                self.optimize()
            self._since_optimize = 0
        return info

    def _covisibility_candidate(self, idx, cid):
        """When BoW finds nothing, a proximity-based inter-agent connection
        (`server_pose_graph.cpp:670-703`): the nearest other-client aligned
        keyframe within the 1 m / 0.5 rad covisibility gates."""
        cfg = self.cfg
        st = self.store
        n = st.count
        other = (st.client[:n] != cid) & (st.client[:n] >= 0)
        other &= np.array([self.clients[int(c)].aligned if c >= 0 else False
                           for c in st.client[:n]])
        if not other.any():
            return None
        d = np.linalg.norm(st.world_p[:n] - st.world_p[idx], axis=1)
        dyaw = np.abs(wrap_angle_np(st.world_yaw[:n] - st.world_yaw[idx]))
        ok = other & (d < cfg.covis_max_dist) & (dyaw < cfg.covis_max_yaw)
        if not ok.any():
            return None
        cand = np.nonzero(ok)[0]
        return int(cand[np.argmin(d[cand])])

    def _select_loop_candidates(self, idx, cid, cand_idx, cand_score):
        """Reference gates: score threshold (inter vs intra), minimum frame
        gap, then every candidate within `bow_rel_gate` of the best, oldest
        first (`server_pose_graph.cpp:971-1062`; the reference verifies only
        the first)."""
        cfg = self.cfg
        cand_idx, cand_score = _fetch(cand_idx, cand_score)   # one transfer
        qualifying = []
        for k, s in zip(cand_idx, cand_score):
            if s <= 0:
                continue
            k = int(k)
            ocid = int(self.store.client[k])
            thresh = cfg.bow_thresh_intra if ocid == cid else cfg.bow_thresh_inter
            if s < thresh:
                continue
            if ocid == cid and abs(int(self.store.local_index[idx])
                                   - int(self.store.local_index[k])) < cfg.min_gap:
                continue
            qualifying.append((k, float(s)))
        if not qualifying:
            return []
        top = max(s for _, s in qualifying)
        return sorted(k for k, s in qualifying if s >= cfg.bow_rel_gate * top)

    def _feats(self, k):
        """Device copies of keyframe k's (ext_desc, ext_valid, ext_uv,
        win_desc, win_valid, win_uv), cached or uploaded."""
        hit = self._dev_feats.get(k)
        if hit is None:
            st, dev = self.store, self.device
            # descriptors as int32 views of the uint32 words
            hit = (_upload(st.ext_desc[k].view(np.int32), dev), _upload(st.ext_valid[k], dev),
                   _upload(st.ext_uv[k], dev), _upload(st.win_desc[k].view(np.int32), dev),
                   _upload(st.win_valid[k], dev), _upload(st.win_uv[k], dev))
        return hit

    def _dispatch_verify(self, j: int, cands: list) -> None:
        """Dispatch the match/F-RANSAC/PnP device cascade for new keyframe j
        against its first candidate, without waiting for it (the result is
        consumed by `_drain_pending` one ingest step later, or at flush)."""
        cfg = self.cfg
        st = self.store
        i = int(cands[0])
        cj = self.clients[int(st.client[j])]
        # window 3-D points of j, expressed in j's camera frame
        pts_l = st.win_pts3d[j]
        r_wb = quat_to_matrix_np(st.vio_q[j])
        pts_b = (pts_l - st.vio_p[j]) @ r_wb  # world->body (row-vector form)
        pts_cam = (pts_b - cj.p_bc) @ np.asarray(cj.r_cb).T
        n = st.max_win
        gumbel_f, gumbel_p = (_upload(g, self.device) if g.device.type == "cpu" else g
                              for g in (self._noise(NUM_HYP, n), self._noise(NUM_HYP, n)))
        _, _, _, wdj, wvj, wuj = self._feats(j)
        edi, evi, eui, _, _, _ = self._feats(i)
        res, m, keep = self._verify(
            wdj, wvj, wuj, _upload(pts_cam.astype(np.float32), self.device),
            edi, evi, eui, gumbel_f, gumbel_p, cfg.pnp_thresh, cfg.min_loop_matches,
            self._jacobi)
        self._pending.append({"j": j, "i": i, "rest": list(cands[1:]),
                              "res": res, "m": m, "keep": keep})

    def _process_pending_query(self, info: dict | None = None) -> None:
        """Stage 1 of the pipelined loop detection: gate the previous
        keyframe's BoW query result and dispatch the verification cascade
        for its best candidate."""
        if self._pending_q is None:
            return
        qidx, qcid, cand_idx, cand_score = self._pending_q
        self._pending_q = None
        cfg = self.cfg
        cands = self._select_loop_candidates(qidx, qcid, cand_idx, cand_score)
        if not cands and cfg.covis_check and self.clients[qcid].aligned:
            covis = self._covisibility_candidate(qidx, qcid)
            cands = [] if covis is None else [covis]
        if cands:
            self._dispatch_verify(qidx, list(cands[:cfg.max_loop_candidates]))

    def _resolve_inflight(self, info: dict | None = None) -> None:
        """Resolve both pipeline stages synchronously (under `_lock`, before
        anything reads 'final' state)."""
        self._process_pending_query(info)
        self._drain_pending(info, block_all=True)

    def _drain_pending(self, info: dict | None = None,
                       block_all: bool = False) -> None:
        """Consume in-flight verification cascades (under `_lock`).

        Per ingest step one result is consumed and — when it failed with
        candidates remaining — the next candidate's cascade is dispatched;
        `block_all=True` resolves everything."""
        while self._pending:
            pv = self._pending.popleft()
            edge = self._finish_connection(pv)
            if edge is None:
                if pv["rest"]:
                    self._dispatch_verify(pv["j"], pv["rest"])
                if block_all:
                    continue
                return
            self._accept_loop(pv["j"], pv["i"], edge, info)
            if not block_all:
                return

    def _accept_loop(self, j: int, i: int, edge: dict,
                     info: dict | None = None) -> None:
        """Accepted loop (new j, old i): align submaps if one side is still
        unaligned, then record the 4-DoF edge (`server_pose_graph.cpp:1014-1062`)."""
        cid = int(self.store.client[j])
        ocid = int(self.store.client[i])
        inter = ocid != cid
        aligned_new = self.clients[cid].aligned
        aligned_old = self.clients[ocid].aligned
        aligned_event = False
        if inter and aligned_old and not aligned_new:
            self._align_submap(cid, i, j, edge, flip=False)
            aligned_event = True
        elif inter and aligned_new and not aligned_old:
            self._align_submap(ocid, i, j, edge, flip=True)
            aligned_event = True
        self._record_loop(i, j, edge, bool(inter))
        if info is not None:
            info["loop"] = True
            info["loop_with"] = i
            info["loop_at"] = j
            if aligned_event:
                info["aligned_event"] = True

    def _finish_connection(self, pv: dict):
        """Host half of loop verification: fetch the cascade's result (one
        transfer), convert the camera-frame relative pose to body frames and
        apply the acceptance gates. Returns the edge dict or None."""
        cfg = self.cfg
        st = self.store
        j, i = pv["j"], pv["i"]
        res, m, keep = pv["res"], pv["m"], pv["keep"]
        ok, num_inliers, r, t, midx, inliers, keep_np = _fetch(
            res.ok, res.num_inliers, res.r, res.t, m.indices, res.inliers, keep)
        cj = self.clients[int(st.client[j])]
        ci = self.clients[int(st.client[i])]
        if not bool(ok):
            self._fc_fail = ("pnp", int(num_inliers))
            return None
        # T_ci<-cj (camera frames) -> T_bi<-bj (body frames), float64 numpy
        r_cicj = r.astype(np.float64)
        t_cicj = t.astype(np.float64)
        r_bc_i, t_bc_i = ci.r_cb.T.astype(np.float64), ci.p_bc.astype(np.float64)
        r_cb_j = cj.r_cb.astype(np.float64)          # T_cj<-bj rotation
        t_cb_j = -r_cb_j @ cj.p_bc.astype(np.float64)
        r_bibj = r_bc_i @ r_cicj @ r_cb_j
        t_ij = r_bc_i @ (r_cicj @ t_cb_j + t_cicj) + t_bc_i
        q_bibj = matrix_to_quat_np(r_bibj).astype(np.float32)
        # estimated world rotation of i = R_w_bj * R_bibj^T
        r_w_bj = ypr_to_r_np([st.world_yaw[j], st.world_pr[j, 0],
                              st.world_pr[j, 1]])
        r_w_bi_est = r_w_bj @ r_bibj.T
        yaw_i_est = float(np.arctan2(r_w_bi_est[1, 0], r_w_bi_est[0, 0]))
        rel_yaw = float(wrap_angle_np(st.world_yaw[j] - yaw_i_est))
        # acceptance gates (`server_keyframe.cpp:692-715`), meaningful only
        # when both submaps live in the world frame (relaxed in align mode)
        both_aligned = (self.clients[int(st.client[j])].aligned
                        and self.clients[int(st.client[i])].aligned)
        if both_aligned and abs(np.rad2deg(rel_yaw)) > cfg.max_loop_yaw_deg:
            self._fc_fail = ("yaw_gate", float(np.rad2deg(rel_yaw)))
            return None
        if np.linalg.norm(t_ij) > cfg.max_loop_t:
            self._fc_fail = ("t_gate", float(np.linalg.norm(t_ij)))
            return None
        # diagnostic record for the match-overlay render
        midx = midx.astype(np.int64)
        self.last_loop = {
            "i": i, "j": j, "inliers": int(num_inliers),
            "uv_j": st.win_uv[j].copy(),                # (M, 2) normalized
            "uv_i": st.ext_uv[i][midx].copy(),          # matched old-KF uv
            "inlier_mask": inliers.astype(bool),
            "match_mask": keep_np.astype(bool),
        }
        return {"t_ij": t_ij.astype(np.float32), "yaw_ij": rel_yaw,
                "q_bibj": q_bibj, "num_inliers": int(num_inliers)}

    # ---------- submap alignment ----------

    def _align_submap(self, cid_unaligned: int, i: int, j: int, edge: dict,
                      flip: bool):
        """Yaw-only alignment of an unaligned client's submap (`AlignSubMaps`
        + `UpdateSubMaps`, `server_pose_graph.cpp:40-280`), in float32 on the
        host.

        flip=False: old KF i is aligned, new KF j belongs to the unaligned
        client. flip=True: the reverse (new j aligned, old i unaligned)."""
        st = self.store
        t_bibj = Pose(torch.from_numpy(np.asarray(edge["q_bibj"], np.float32)),
                      torch.from_numpy(np.asarray(edge["t_ij"], np.float32)))
        if not flip:
            anchor, target = i, j  # anchor aligned; target in the unaligned client
            rel = t_bibj
        else:
            anchor, target = j, i
            rel = inverse(t_bibj)
        ypr_a = torch.tensor([st.world_yaw[anchor], st.world_pr[anchor, 0],
                              st.world_pr[anchor, 1]], dtype=torch.float32)
        t_w_anchor = Pose(matrix_to_quat(ypr_to_r(ypr_a)),
                          torch.from_numpy(st.world_p[anchor].copy()))
        t_w_target = compose(t_w_anchor, rel)
        yaw_w = float(yaw_of_quat_np(t_w_target.q.numpy()))
        yaw_l = float(yaw_of_quat_np(st.vio_q[target]))
        yaw_wl = float(wrap_angle(torch.tensor(yaw_w - yaw_l, dtype=torch.float32)))
        rz = rot_z(torch.tensor(yaw_wl, dtype=torch.float32)).numpy()
        t_wl = t_w_target.t.numpy() - rz @ st.vio_p[target]

        c = self.clients[cid_unaligned]
        c.yaw_wl = yaw_wl
        c.t_wl = t_wl.astype(np.float32)
        c.yaw_drift = 0.0
        c.t_drift = np.zeros(3, np.float32)
        c.aligned = True
        self._align_gen += 1   # invalidate any in-flight background solve
        # rewrite the world poses of every KF of this client (batched)
        sel = (st.client == cid_unaligned) & st.valid
        idxs = np.nonzero(sel)[0]
        if len(idxs):
            p_w, yaw_w2, pr_w = self._local_to_world(
                cid_unaligned, st.vio_p[idxs], st.vio_q[idxs])
            st.world_p[idxs] = p_w
            st.world_yaw[idxs] = yaw_w2
            st.world_pr[idxs] = pr_w

    def _grow_loops(self) -> None:
        """Double the loop-edge arrays (no silent drops past the initial
        capacity)."""
        for name in ("loop_i", "loop_j", "loop_t", "loop_yaw", "loop_inter",
                     "loop_valid", "loop_pcm_ok"):
            arr = getattr(self, name)
            setattr(self, name, np.concatenate([arr, np.zeros_like(arr)]))

    def _record_loop(self, i, j, edge, inter):
        if self.loop_count >= len(self.loop_i):
            self._grow_loops()
        st = self.store
        # the yaw measurement from the *current* world state (it may have just
        # changed in _align_submap), so edge and nodes agree
        r_bibj = quat_to_matrix_np(edge["q_bibj"])
        r_w_bj = ypr_to_r_np([st.world_yaw[j], st.world_pr[j, 0],
                              st.world_pr[j, 1]])
        r_w_bi_est = r_w_bj @ r_bibj.T
        yaw_i_est = float(np.arctan2(r_w_bi_est[1, 0], r_w_bi_est[0, 0]))
        yaw_ij = float(wrap_angle_np(st.world_yaw[j] - yaw_i_est))
        k = self.loop_count
        self.loop_i[k] = i
        self.loop_j[k] = j
        self.loop_t[k] = edge["t_ij"]
        self.loop_yaw[k] = yaw_ij
        self.loop_inter[k] = inter
        self.loop_valid[k] = True
        self.loop_pcm_ok[k] = True
        self.loop_count += 1

    # ---------- PCM + optimization ----------

    def _run_pcm(self, snap) -> np.ndarray:
        """PCM per client pair on inter-agent edges (`pcm_graph.cpp:56-305`).

        Reads only the snapshot (plus the append-only VIO fields) and returns
        the keep mask of the snapshot's `k_loops` edges."""
        cfg = self.cfg
        dev = self.device
        n = snap.k_loops
        pcm_ok = np.ones(n, bool)
        li, lj = snap.loop_i, snap.loop_j
        pairs = {}
        for e in range(n):
            if not (snap.loop_valid[e] and snap.loop_inter[e]):
                continue
            a, b = int(snap.client[li[e]]), int(snap.client[lj[e]])
            pairs.setdefault((min(a, b), max(a, b)), []).append(e)
        for es in pairs.values():
            es = np.asarray(es)
            e = len(es)
            if e < cfg.pcm_min_edges:
                continue
            # pad the edge set to a power-of-two tier (the JAX package does,
            # to bound recompiles; kept so both see the same (E, E) problem)
            tier = 1 << (e - 1).bit_length()
            pad = tier - e

            def padv(a):
                return _upload(np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]), dev)

            pmask = np.concatenate([np.ones(e, bool), np.zeros(pad, bool)])
            edge_T = pcm_mod.FourDof(padv(snap.loop_yaw[es]), padv(snap.loop_t[es]))
            yaw_i = yaw_of_quat_np(snap.vio_q[li[es]]).astype(np.float32)
            yaw_j = yaw_of_quat_np(snap.vio_q[lj[es]]).astype(np.float32)
            pose_i = pcm_mod.FourDof(padv(yaw_i), padv(snap.vio_p[li[es]]))
            pose_j = pcm_mod.FourDof(padv(yaw_j), padv(snap.vio_p[lj[es]]))
            chain = None
            if cfg.pcm_chain_cov:
                # full per-client odometry chains ordered by local index, so
                # the prefix-sum covariance can address any chain segment
                cid_a = int(snap.client[li[es][0]])
                cid_b = int(snap.client[lj[es][0]])
                chain = (self._client_chain(cid_a),
                         padv(snap.local_index[li[es]].astype(np.int64)),
                         self._client_chain(cid_b),
                         padv(snap.local_index[lj[es]].astype(np.int64)),
                         cfg.pcm_step_sigma_t, cfg.pcm_step_sigma_yaw)
            keep = pcm_mod.pcm_filter(edge_T, pose_i, pose_j, pmask,
                                      cfg.pcm_min_edges, cfg.pcm_sigma_t,
                                      cfg.pcm_sigma_yaw, cfg.pcm_gamma,
                                      chain=chain)
            pcm_ok[es] = keep[:e]
        return pcm_ok

    def _client_chain(self, cid: int) -> pcm_mod.FourDof:
        """One client's full odometry chain (local frame) in local-index
        order, on the device; cached per (client, keyframe count), since the
        VIO poses of stored keyframes never change."""
        st = self.store
        n = st.count
        key = (cid, n)
        hit = self._chain_cache.get(cid)
        if hit is not None and hit[0] == key:
            return hit[1]
        sel = np.nonzero(st.client[:n] == cid)[0]
        order = sel[np.argsort(st.local_index[sel])]
        yaws = yaw_of_quat_np(st.vio_q[order]).astype(np.float32)
        # padded to a power-of-two tier, as in the JAX package; chain
        # indices always address the real prefix
        tier = max(64, 1 << max(len(order) - 1, 0).bit_length())
        pad = tier - len(order)
        yaws = np.concatenate([yaws, np.repeat(yaws[-1:], pad)])
        ps = np.concatenate([st.vio_p[order],
                             np.repeat(st.vio_p[order][-1:], pad, axis=0)])
        chain = pcm_mod.FourDof(_upload(yaws, self.device), _upload(ps, self.device))
        self._chain_cache[cid] = (key, chain)
        return chain

    def optimize(self) -> bool:
        """4-DoF solve over aligned keyframes + drift propagation
        (`Optimize4DoF`, `server_pose_graph.cpp:1107-1815`).

        Only keyframes in [earliest loop index, newest] enter the problem
        (`:1470-1475`), padded to a power-of-two tier. Snapshot (locked) ->
        solve (unlocked) -> writeback (locked): in async mode the solve
        overlaps ingestion. Returns False when a concurrent submap alignment
        invalidated the solve (it is discarded)."""
        t0 = time.perf_counter()
        with self._lock:
            self._resolve_inflight()
            snap = self._snapshot()
        if snap is None:
            return True
        pcm_ok, result = self._solve(snap)
        with self._lock:
            applied = self._writeback(snap, pcm_ok, result)
        self.solve_count += 1
        self.last_solve_s = time.perf_counter() - t0
        if not applied:
            self.discarded_solves += 1
        return applied

    def _snapshot(self):
        """Consistent copy of the solver's inputs (under the lock). VIO fields
        are append-only and shared; world poses, loop edges and client submap
        state are copied."""
        st = self.store
        n = st.count
        k = self.loop_count
        if n < 2 or k == 0:
            return None
        return types.SimpleNamespace(
            n=n, k_loops=k, gen=self._align_gen,
            client=st.client, local_index=st.local_index,
            vio_p=st.vio_p, vio_q=st.vio_q,
            world_yaw=st.world_yaw[:n].copy(),
            world_p=st.world_p[:n].copy(),
            world_pr=st.world_pr[:n].copy(),
            loop_i=self.loop_i[:k].copy(), loop_j=self.loop_j[:k].copy(),
            loop_t=self.loop_t[:k].copy(), loop_yaw=self.loop_yaw[:k].copy(),
            loop_inter=self.loop_inter[:k].copy(),
            loop_valid=self.loop_valid[:k].copy(),
            aligned=np.array([c.aligned for c in self.clients]),
            yaw_wl=np.array([c.yaw_wl for c in self.clients], np.float32),
            t_wl=np.stack([c.t_wl for c in self.clients]).astype(np.float32))

    def _solve(self, snap):
        """PCM + 4-DoF LM/PCG on a snapshot, on the device. Touches no server
        state."""
        cfg = self.cfg
        dev = self.device
        n = snap.n
        pcm_ok = self._run_pcm(snap)
        k_loops = snap.k_loops
        lv = snap.loop_valid & pcm_ok
        lo = int(snap.loop_i[lv].min()) if lv.any() else 0
        wn = n - lo  # active window length

        client_w = snap.client[lo:n]
        aligned_mask = snap.aligned[np.clip(client_w, 0, MAX_CLIENTS - 1)]
        aligned_mask = aligned_mask & (client_w >= 0)
        tier = max(64, 1 << (wn - 1).bit_length())
        pad = tier - wn
        valid = np.concatenate([aligned_mask, np.zeros(pad, bool)])
        fixed = np.zeros(tier, bool)
        # anchor: the first in-window KF of the world client
        # (`server_pose_graph.cpp:1513-1519`)
        first_world = np.nonzero((client_w == self.world_client) & aligned_mask)[0]
        if len(first_world):
            fixed[first_world[0]] = True

        # node init: current world estimates; measurements from VIO
        vio_ypr = r_to_ypr_np(quat_to_matrix_np(snap.vio_q[lo:n]))
        vio_yaw = vio_ypr[:, 0].astype(np.float32)
        vio_pr = vio_ypr[:, 1:].astype(np.float32)

        def padded(a, dtype=np.float32):
            return _upload(np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)])[:tier].astype(dtype), dev)

        valid_d = _upload(valid, dev)
        nodes = opt.PoseGraphNodes(
            yaw=padded(snap.world_yaw[lo:]), pr=padded(snap.world_pr[lo:]),
            t=padded(snap.world_p[lo:]), valid=valid_d, fixed=_upload(fixed, dev))

        # sequential edges from VIO (invariant to the submap transform)
        client_pad = np.concatenate([client_w.astype(np.int32),
                                     np.full(pad, -2, np.int32)])
        seq = opt.make_sequential_edges(
            padded(vio_yaw), padded(vio_pr), padded(snap.vio_p[lo:n]),
            _upload(client_pad, dev), valid_d, max_back=cfg.seq_back)

        # loop edges (PCM-filtered), indices shifted into the window; every
        # recorded loop has i >= lo by construction (lo = min over loop_i)
        lt = max(64, 1 << max(k_loops - 1, 0).bit_length())
        li = np.zeros(lt, np.int64)
        lj = np.zeros(lt, np.int64)
        lT = np.zeros((lt, 3), np.float32)
        lyaw = np.zeros(lt, np.float32)
        lval = np.zeros(lt, bool)
        li[:k_loops] = snap.loop_i - lo
        lj[:k_loops] = snap.loop_j - lo
        lT[:k_loops] = snap.loop_t
        lyaw[:k_loops] = snap.loop_yaw
        lval[:k_loops] = lv & (snap.loop_i >= lo)
        li = np.clip(li, 0, tier - 1)
        lj = np.clip(lj, 0, tier - 1)

        def const(v):
            return torch.full((lt,), v, dtype=torch.float32, device=dev)

        loops = opt.PoseGraphEdges(
            i=_upload(li, dev), j=_upload(lj, dev), t_ij=_upload(lT, dev),
            yaw_ij=_upload(lyaw, dev), t_weight=const(cfg.loop_t_weight),
            yaw_weight=const(cfg.loop_yaw_weight), valid=_upload(lval, dev),
            huber=const(cfg.loop_huber))
        edges = opt.PoseGraphEdges(*[torch.cat([a, b]) for a, b in zip(seq, loops)])
        out = opt.optimize_pose_graph_graphed(nodes, edges, cfg.lm_iters, cfg.cg_iters)
        new_yaw, new_t = _fetch(out.yaw[:wn], out.t[:wn])
        return pcm_ok, types.SimpleNamespace(
            lo=lo, wn=wn, upd=valid[:wn], vio_yaw=vio_yaw,
            new_yaw=new_yaw, new_t=new_t)

    def _writeback(self, snap, pcm_ok, result) -> bool:
        """Apply a solve's poses and recompute drift (under the lock).
        Keyframes ingested while the solve ran get their world poses
        recomputed under the new drift (`server_pose_graph.cpp:1720-1796`)."""
        st = self.store
        self.loop_pcm_ok[:snap.k_loops] = pcm_ok
        if snap.gen != self._align_gen:
            # a submap alignment landed mid-solve: the solved poses live in a
            # superseded world frame; the next solve sees the new one
            return False
        lo, n = result.lo, snap.n
        upd = result.upd
        st.world_yaw[lo:n][upd] = result.new_yaw[upd]
        st.world_p[lo:n][upd] = result.new_t[upd]
        st.optimized[lo:n] |= upd

        # drift per client from its last optimized KF
        for cid, c in enumerate(self.clients):
            if not (c.registered and c.aligned):
                continue
            sel = np.nonzero((st.client[lo:n] == cid) & upd)[0]
            if len(sel) == 0:
                continue
            k = int(sel[-1])
            # submap-transformed VIO pose (no drift)
            p_sv = rot_z_np(c.yaw_wl) @ st.vio_p[lo + k] + c.t_wl
            yaw_sv = result.vio_yaw[k] + c.yaw_wl
            yaw_d = float(wrap_angle_np(st.world_yaw[lo + k] - yaw_sv))
            t_d = st.world_p[lo + k] - rot_z_np(yaw_d) @ p_sv
            c.yaw_drift = yaw_d
            c.t_drift = t_d.astype(np.float32)
            # re-propagate the new drift to keyframes ingested during the solve
            tail = np.nonzero(st.client[n:st.count] == cid)[0] + n
            if len(tail):
                p_w, yaw_w, pr_w = self._local_to_world(
                    cid, st.vio_p[tail], st.vio_q[tail])
                st.world_p[tail] = p_w
                st.world_yaw[tail] = yaw_w
                st.world_pr[tail] = pr_w
        return True

    # ---------- outputs ----------

    def trajectory(self, cid: int):
        """(M, 8) TUM-style rows [t, x, y, z, qw, qx, qy, qz] of the client's
        keyframes (`server_plotter.h:158-273`)."""
        st = self.store
        n = st.count
        sel = np.nonzero((st.client[:n] == cid))[0]
        if len(sel) == 0:
            return np.zeros((0, 8))
        ypr = np.stack([st.world_yaw[sel], st.world_pr[sel, 0],
                        st.world_pr[sel, 1]], axis=-1)
        q = matrix_to_quat_np(ypr_to_r_np(ypr))
        return np.concatenate([st.timestamp[sel, None], st.world_p[sel], q],
                              axis=1)

"""Per-agent VIO front-end: pixels + IMU in, keyframe packets out (port of
``cvids_tpu/vio/frontend.py``).

Layer A of the system (a VINS-Mono-class estimator whose contract is
`agent_msg/msg/AgentMsg.msg` + the `config/euroc/*.yaml` feature-tracker and
solver keys):

- feature maintenance: pyramidal KLT tracking + grid-spread FAST
  re-detection, batched (`ops.klt`, `ops.fast`), with the fundamental-matrix
  RANSAC gate (VINS rejectWithF);
- state estimation: the fixed-lag sliding-window visual-inertial LM
  (`vio.window_ba`), IMU preintegration between keyframes, the VI bootstrap
  (`vio.initializer`) and camera-only marginalization;
- output: the port's `io.msgs.KeyframePacket`: pose, window landmarks (3D +
  2D + ids + BRIEF), extra full-image features for loop closure.

The image-side work (KLT, FAST, BRIEF, the camera's lift and project), the
preintegration, the window state and every solve run on the front-end's
device (the card unless the caller names one); the feature and landmark
bookkeeping stays in host numpy, as in the JAX package, so each frame reads
its tracking results back to the host. RANSAC takes its Gumbel noise from
`_gumbel`, which draws from the front-end's CPU `torch.Generator`; the JAX
package splits a `jax.random` key at the same points, and a test can
replace `_gumbel` to feed the port the JAX draws.

On the card the JAX package's compiled programs replay as CUDA graphs,
each captured at its first call per shape (`utils.cuda_graph.GraphedCall`):
the same kernels as the eager call, one launch from the host, no read back
inside. They are the track step (KLT, both lifts, the F-RANSAC gate and its
inlier mask: `_track_step`), the re-detection (`_redetect_step`, JAX
`_redetect_compute`), the packet's image program (`_describe_step`, JAX
`_emit_compute`), the preintegration (`_preintegrate_step`), the window
solve (one launch of the hand kernel `cuda_kernels.window_lm` inside its
graph) and the marginalization up to its float64 `eigh`
(`window_ba.marg_schur_cam`); until the VI bootstrap locks, the pre-init
`ransac.essential_pose` (its Gumbel noise drawn before the graph) and the
bootstrap's two solves (`initializer.calibrate_gyro_bias`, then
`_align_step`: the bias correction and `initializer.linear_alignment`),
each read back after its replay as the JAX package reads them. The
camera is a bound argument of the graphs
that lift, so they are keyed by the camera as well as by shape. Host arrays
cross to the card through pinned memory without a sync; each graph's result
comes back in one packed read. With a `Tracer`, the stages are spans:
`track`, `detect`, `describe`, `preintegrate`, `solve`, `marginalize`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import resolve_device
from ..camera import make_camera
from ..geometry import g2r, matrix_to_quat, quat_multiply, quat_normalize, quat_to_matrix
from ..geometry.hostmath import matrix_to_quat_np, quat_to_matrix_np
from ..io.msgs import KeyframePacket
from ..ops import brief, fast, klt, ransac
from ..ops.image import gaussian_blur
from ..utils.config import AgentConfig
from ..utils.cuda_graph import GraphedCall
from . import imu as imu_mod
from . import initializer as vi_init
from . import window_ba as ba

__all__ = ["AgentFrontend"]

NUM_HYP = 128       # RANSAC hypotheses per call (the JAX package's default)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _set_row(t: torch.Tensor, i: int, value) -> torch.Tensor:
    out = t.clone()
    out[i] = torch.as_tensor(value, dtype=t.dtype, device=t.device)
    return out


def _track_points(prev, img, xy, valid, init_xy, fb_thresh):
    """The front-end's KLT call: 4 levels, 15 iterations, the
    forward-backward gate, photometric residual < 35."""
    return klt.track_points(prev, img, xy, valid, levels=4, iters=15, fb_thresh=fb_thresh,
                            max_residual=35.0, init_xy=init_xy)


def _track_step(prev, img, feats, noise, cam, fb_thresh, inlier_thresh):
    """One frame's tracking without a read back: KLT of the features
    feats[:, 0:2] (valid where feats[:, 2] > 0, seeded at feats[:, 3:5]),
    then VINS rejectWithF: both point sets lifted, F-RANSAC over the frame
    pair with `noise`, its inliers kept where at least 12 tracks and 12
    inliers. Returns (N, 4): tracked x, y, KLT's valid, valid after the
    gate (1.0 / 0.0)."""
    xy, valid, init_xy = feats[:, 0:2], feats[:, 2] > 0, feats[:, 3:5]
    res = _track_points(prev, img, xy, valid, init_xy, fb_thresh)
    fr = ransac.fundamental_ransac(cam.lift(xy), cam.lift(res.xy), res.valid, noise,
                                   inlier_thresh=inlier_thresh)
    take = (torch.sum(res.valid) >= 12) & (fr.num_inliers >= 12)
    gated = torch.where(take, res.valid & fr.inliers, res.valid)
    return torch.cat([res.xy, res.valid[:, None].to(xy.dtype), gated[:, None].to(xy.dtype)], 1)


def _redetect_step(img, feats, threshold, max_num, cell, min_dist):
    """FAST re-detection with a fixed candidate budget away from the
    tracked features feats[:, 0:2] (valid where feats[:, 2] > 0): (max_num,
    3) x, y, valid (JAX `_redetect_compute`)."""
    score = fast.fast_score_map(img, threshold)
    kps = fast.select_keypoints(score, max_num=max_num, cell=cell, existing_xy=feats[:, 0:2],
                                existing_valid=feats[:, 2] > 0, min_dist=min_dist)
    return torch.cat([kps.xy, kps.valid[:, None].to(kps.xy.dtype)], 1)


def _describe_step(img, win_px, cam, threshold, max_ext, cell):
    """The packet's image program (JAX `_emit_compute`): blur, BRIEF at the
    window features' pixels `win_px`, full-image FAST and selection, their
    BRIEF and lift. One int32 vector: the window descriptors (N x 8 words),
    then per extra feature its 8 words and the bits of x, y, valid, u, v."""
    blurred = gaussian_blur(img, 2.0, radius=4)
    wdesc = brief.compute_brief(blurred, win_px, pre_blurred=True)
    kps = fast.select_keypoints(fast.fast_score_map(img, threshold), max_num=max_ext, cell=cell)
    edesc = brief.compute_brief(blurred, kps.xy, pre_blurred=True)
    ext = torch.cat([kps.xy, kps.valid[:, None].to(kps.xy.dtype), cam.lift(kps.xy)], 1)
    return torch.cat([wdesc.reshape(-1), edesc.reshape(-1),
                      ext.contiguous().view(torch.int32).reshape(-1)])


def _preintegrate_step(buf, bg, ba, noise):
    """`imu.preintegrate` of a padded buffer (M, 8): gyro, accelerometer,
    dt, valid."""
    return imu_mod.preintegrate(buf[:, 0:3], buf[:, 3:6], buf[:, 6], bg, ba, noise=noise,
                                sample_valid=buf[:, 7] > 0)


def _solve_window_fast(state, meas, iters):
    return ba.solve_window_fast(state, meas, iters=iters)


def _align_step(p, q, pre, bg, valid):
    """The bootstrap's alignment: the preintegrations corrected to the gyro
    bias `bg`, then `initializer.linear_alignment`."""
    return vi_init.linear_alignment(p, q, imu_mod.bias_corrected(pre, bg, torch.zeros_like(bg)),
                                    valid)


def _roll(t: torch.Tensor) -> torch.Tensor:
    """Drop the oldest slot, repeat the newest (the window slide)."""
    return torch.cat([t[1:], t[-1:]], dim=0)


class AgentFrontend:
    MAX_IMU = 256       # IMU samples per keyframe interval (1.28 s @ 200 Hz)
    LM_MULT = 4         # landmark-slot pool = LM_MULT x max_features

    def __init__(self, cfg: AgentConfig, client_id: int = 0, device=None, tracer=None):
        self.cfg = cfg
        self.client_id = client_id
        self.device = resolve_device(device)
        self.tracer = tracer
        # the VINS operating point: a window of 10 (`euroc_config.yaml`)
        self.WINDOW = int(getattr(cfg, "window_size", 10) or 10)
        # polymorphic camera (pinhole / equidistant fisheye / Mei): the
        # front-end touches only lift/project and the focal for pixel weights
        self.cam = make_camera(cfg.camera, device=self.device)
        self._fx = float(self.cam.fx)
        self.r_cb = np.asarray(cfg.r_cb, np.float32)
        self.p_bc = np.asarray(cfg.p_bc, np.float32)
        self._r_cb_t = torch.from_numpy(self.r_cb).to(self.device)
        self._p_bc_t = torch.from_numpy(self.p_bc).to(self.device)
        self._gen = torch.Generator().manual_seed(4242)     # the RANSAC noise

        # tracked-feature capacity = `max_cnt`; landmark slots are a larger
        # pool, since landmarks stay observable by the rest of the window
        # after their features leave the image
        self.MAX_FEAT = mf = int(cfg.max_features)
        self.MAX_LM = ml = self.LM_MULT * mf
        self.feat_xy = np.zeros((mf, 2), np.float32)
        self.feat_id = np.full(mf, -1, np.int64)
        self.feat_valid = np.zeros(mf, bool)
        self.next_id = 0
        self.prev_image: torch.Tensor | None = None     # on the device
        self.track_stats = {"klt_killed": 0, "ransac_killed": 0,
                            "border_killed": 0, "detected": 0}

        # fisheye image-circle mask (`fisheye: 1` + fisheye_mask.jpg)
        self._mask_center = None
        self._mask_r2 = None
        if getattr(cfg, "fisheye", False):
            c_ = cfg.camera
            r = float(getattr(cfg, "fisheye_mask_radius", 0.0)) or min(
                float(c_.cx), float(c_.cy),
                c_.width - float(c_.cx), c_.height - float(c_.cy))
            self._mask_center = (float(c_.cx), float(c_.cy))
            self._mask_r2 = r * r

        # sliding window state, on the device
        w = self.WINDOW
        dev = self.device
        self.kf_count = 0
        self.n_in_window = 0
        self.state = ba.WindowState(
            p=torch.zeros((w, 3), device=dev),
            q=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(w, 1),
            v=torch.zeros((w, 3), device=dev), bg=torch.zeros((w, 3), device=dev),
            ba=torch.zeros((w, 3), device=dev), lm=torch.zeros((ml, 3), device=dev),
            kf_valid=torch.zeros(w, dtype=torch.bool, device=dev),
            lm_valid=torch.zeros(ml, dtype=torch.bool, device=dev))
        self.obs = np.zeros((w, ml, 2), np.float32)
        self.vis = np.zeros((w, ml), bool)
        self.lm_id = np.full(ml, -1, np.int64)   # landmark slot -> feature id
        self.pre_list: list = [None] * (w - 1)   # preintegrations between KFs
        self.initialized = False
        self.vi_initialized = False
        self._last_solved = None
        self._prior: ba.CamPriorFactor | None = None
        self._post_boot = 0
        self._dummy_pre = None

        # camera-rate tracking state (`process_frame`)
        self._imu_buf: list = []
        self._kf_t: float | None = None
        self._kf_feat_xy: dict = {}
        self._kf_norm: dict = {}
        self._kf_state = None

        # the JAX package's compiled programs: fixed-shape, sync-free and
        # hundreds to thousands of small launches each; on the card each
        # replays as one CUDA graph per shape (`utils.cuda_graph`), over
        # bound buffers that one pinned copy fills (`_stage`); on the CPU
        # they run as is. The camera is bound: its graphs are this camera's
        self._track = GraphedCall(_track_step, bound=(2, 3, 4))
        self._redetect_call = GraphedCall(_redetect_step, bound=(1,))
        self._describe = GraphedCall(_describe_step, bound=(1, 2))
        self._preint = GraphedCall(_preintegrate_step, bound=(0,))
        self._solve_fast = GraphedCall(_solve_window_fast)
        self._marg = GraphedCall(ba.marg_schur_cam)
        self._epose = GraphedCall(ransac.essential_pose)
        self._gyro_bias = GraphedCall(vi_init.calibrate_gyro_bias)
        self._align = GraphedCall(_align_step)
        self._staged: dict = {}

        self._cell = max(8, cfg.min_feature_dist // 2)
        # loop-closure features, budgeted apart from the tracker
        self._max_ext = max(int(getattr(cfg, "loop_features", 512)), self.MAX_FEAT * 2)

    # ---------- helpers ----------

    def _span(self, name: str):
        return self.tracer.span(name) if self.tracer is not None else contextlib.nullcontext()

    def _gumbel(self, n: int) -> torch.Tensor:
        """(NUM_HYP, n) Gumbel noise for one RANSAC call."""
        return ransac.gumbel_noise(NUM_HYP, n, self._gen, self.device)

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        """A host array on the front-end's device; to the card through
        pinned memory, without waiting for the copy."""
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, name: str, a) -> torch.Tensor:
        """The front-end's persistent float32 device buffer `name`, filled
        with `a` (a host array, or a tensor) by one copy: a graph's bound
        input, the same storage at every call."""
        t = (a if isinstance(a, torch.Tensor)
             else torch.as_tensor(np.asarray(a), dtype=torch.float32))
        buf = self._staged.get(name)
        if buf is None or buf.shape != t.shape:
            buf = self._staged[name] = torch.empty(t.shape, device=self.device)
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return buf.copy_(t, non_blocking=self.device.type == "cuda")

    def _lift_np(self, xy: np.ndarray) -> np.ndarray:
        return _np(self.cam.lift(self._t(xy)))

    def _preintegrate(self, gyr, acc, dts, bg, ba_) -> imu_mod.Preintegrated:
        """Preintegrate up to MAX_IMU samples, padded to MAX_IMU as in the
        JAX package (the last valid sample pairs with a padding sample)."""
        buf = np.zeros((self.MAX_IMU, 8), np.float32)       # gyro, accel, dt, valid
        n = min(len(gyr), self.MAX_IMU)
        buf[:n, 0:3], buf[:n, 3:6], buf[:n, 6], buf[:n, 7] = gyr[:n], acc[:n], dts[:n], 1.0
        with self._span("preintegrate"):
            return self._preint(self._stage("imu", buf), bg, ba_, self.cfg.imu)

    # ---------- feature maintenance ----------

    def _apply_fisheye_mask(self):
        """Kill features outside the fisheye image circle."""
        if self._mask_r2 is None:
            return
        cx, cy = self._mask_center
        d2 = ((self.feat_xy[:, 0] - cx) ** 2 + (self.feat_xy[:, 1] - cy) ** 2)
        self.feat_valid &= d2 <= self._mask_r2

    def _predict_features(self, p_pred: np.ndarray, q_pred: np.ndarray,
                          p_prev: np.ndarray, q_prev: np.ndarray):
        """Predicted pixel positions of the current features in the new
        frame (the VINS predicted-flow KLT seed): a feature's landmark
        reprojected where it has one, else its ray from the previous frame
        at the median landmark depth, carried through the IMU-predicted
        relative pose. Pre-bootstrap the prediction is rotation-only."""
        if not self.feat_valid.any():
            return None
        fv = self.feat_valid
        r_wb1 = quat_to_matrix_np(q_pred).astype(np.float32)
        r_wb0 = quat_to_matrix_np(q_prev).astype(np.float32)
        lm = _np(self.state.lm)
        lm_ok = _np(self.state.lm_valid) & (self.lm_id >= 0)
        if not self.vi_initialized:
            p_pred = p_prev
            lm_ok = np.zeros_like(lm_ok)

        match = (self.feat_id[:, None] == self.lm_id[None, :]) & lm_ok[None, :]
        has_lm = match.any(axis=1) & fv
        lm_slot = np.argmax(match, axis=1)

        rays = np.ones((self.MAX_FEAT, 3), np.float32)
        rays[:, :2] = self._lift_np(self.feat_xy)
        pts_b0 = (lm - p_prev[None, :]) @ r_wb0
        pts_c0 = (pts_b0 - self.p_bc[None, :]) @ self.r_cb.T
        depths = pts_c0[:, 2]
        good_d = lm_ok & (depths > 0.1)
        med_d = float(np.median(depths[good_d])) if good_d.any() else 5.0
        feat_d = np.where(has_lm, depths[lm_slot], med_d).astype(np.float32)
        feat_d = np.maximum(feat_d, 0.3)
        with np.errstate(invalid="ignore"):
            pt_c0 = rays * feat_d[:, None]
            pt_w = (pt_c0 @ self.r_cb + self.p_bc[None, :]) @ r_wb0.T + p_prev
            pt_w = np.where(has_lm[:, None], lm[lm_slot], pt_w)
            pt_b1 = (pt_w - p_pred[None, :]) @ r_wb1
            pt_c1 = (pt_b1 - self.p_bc[None, :]) @ self.r_cb.T
        px = _np(self.cam.project(self._t(pt_c1.astype(np.float32))))
        ok = fv & (pt_c1[:, 2] > 0.1) & np.isfinite(px).all(axis=1)
        return np.where(ok[:, None], px, self.feat_xy).astype(np.float32)

    def _feats(self, *cols) -> np.ndarray:
        """The tracked features as one (MAX_FEAT, 3 + ...) float32 array: x,
        y, valid, then `cols`."""
        return np.concatenate([self.feat_xy, self.feat_valid[:, None], *cols],
                              axis=1).astype(np.float32)

    def _redetect(self, img: torch.Tensor) -> np.ndarray:
        """FAST re-detection with a fixed candidate budget, away from the
        tracked features: (MAX_FEAT, 3) x, y, valid on the host."""
        cfg = self.cfg
        return _np(self._redetect_call(img, self._stage("detect", self._feats()),
                                       float(cfg.fast_threshold), self.MAX_FEAT,
                                       cfg.min_feature_dist, float(cfg.min_feature_dist)))

    def _track_and_detect(self, image: np.ndarray, init_xy: np.ndarray | None = None,
                          fb_thresh: float = 1.5):
        stats = self.track_stats
        img_t = self._t(image)
        if self.prev_image is not None and self.feat_valid.any():
            with self._span("track"):
                n0 = int(self.feat_valid.sum())
                # the noise is drawn before the step, which decides on the
                # device whether the gate runs; where it does not (fewer than
                # 12 tracks), the draw is undone, as the JAX package draws
                # only past that test
                gen_state = self._gen.get_state()
                noise = self._stage("noise", self._gumbel(self.MAX_FEAT))
                feats = self._feats(self.feat_xy if init_xy is None else init_xy)
                out = _np(self._track(self.prev_image, img_t, self._stage("track", feats),
                                      noise, self.cam, fb_thresh, (3.0 / self._fx) ** 2))
                self.feat_xy = out[:, 0:2].copy()
                tracked = out[:, 2] > 0
                self.feat_valid = out[:, 3] > 0
                n1 = int(tracked.sum())
                stats["klt_killed"] += n0 - n1
                if n1 < 12:
                    self._gen.set_state(gen_state)
                # VINS rejectWithF: fundamental-matrix RANSAC over the frame
                # pair kills KLT locks onto the wrong structure
                stats["ransac_killed"] += n1 - int(self.feat_valid.sum())
        # drop features too close to the border for BRIEF
        b = brief.PATCH_HALF + 1
        inb = ((self.feat_xy[:, 0] >= b) & (self.feat_xy[:, 0] < image.shape[1] - b)
               & (self.feat_xy[:, 1] >= b) & (self.feat_xy[:, 1] < image.shape[0] - b))
        n2 = int(self.feat_valid.sum())
        self.feat_valid &= inb
        self._apply_fisheye_mask()
        stats["border_killed"] += n2 - int(self.feat_valid.sum())
        # re-detect into free slots; the FAST threshold is not lowered when
        # starved (weak corners make bad landmarks)
        n_free = int((~self.feat_valid).sum())
        if n_free > 0:
            with self._span("detect"):
                det = self._redetect(img_t)
                new_xy, new_ok = det[:, 0:2], det[:, 2] > 0
            new_ok &= ((new_xy[:, 0] >= b) & (new_xy[:, 0] < image.shape[1] - b)
                       & (new_xy[:, 1] >= b) & (new_xy[:, 1] < image.shape[0] - b))
            if self._mask_r2 is not None:
                cx, cy = self._mask_center
                new_ok &= ((new_xy[:, 0] - cx) ** 2
                           + (new_xy[:, 1] - cy) ** 2) <= self._mask_r2
            free_slots = np.nonzero(~self.feat_valid)[0]
            k = 0
            for j in range(len(new_xy)):
                if not new_ok[j] or k >= len(free_slots):
                    continue
                s = free_slots[k]
                self.feat_xy[s] = new_xy[j]
                self.feat_id[s] = self.next_id
                self.next_id += 1
                self.feat_valid[s] = True
                k += 1
            stats["detected"] += k
        self.prev_image = img_t

    # ---------- window management ----------

    def _marginalize_oldest(self):
        """Schur-marginalize the leaving keyframe (and the landmarks dying
        with it) into a camera-only linearized prior over the shifted window
        (VINS marginalization: the prior spans pose/velocity/bias blocks
        only). None when the prior comes out non-finite."""
        st = self.state
        with self._span("marginalize"):
            meas = self._build_meas()
            k = self.WINDOW
            dying = self.vis[0] & ~self.vis[1:].any(axis=0)
            # the Schur complement as a graph, its float64 square root eager
            j, r0 = ba.sqrt_prior(*self._marg(st, meas, self._t(dying, torch.bool)))
            if not bool(torch.isfinite(j).all() & torch.isfinite(r0).all()):
                return None
            # re-index columns into the post-shift layout: kf slot s -> s-1
            # within each of the 5 camera blocks; the newest slot unconstrained
            jn = torch.zeros_like(j)
            for b in range(5):
                o = 3 * k * b
                jn[:, o:o + 3 * (k - 1)] = j[:, o + 3:o + 3 * k]
        return ba.CamPriorFactor(j=jn, r0=r0, p=_roll(st.p), q=_roll(st.q),
                                 v=_roll(st.v), bg=_roll(st.bg), ba=_roll(st.ba))

    def _shift_window(self):
        """Fixed-lag slide: marginalize the oldest keyframe into the prior,
        then drop it."""
        if self.initialized and self.vi_initialized:
            self._prior = self._marginalize_oldest()
        st = self.state
        self.state = st._replace(
            p=_roll(st.p), q=_roll(st.q), v=_roll(st.v), bg=_roll(st.bg), ba=_roll(st.ba),
            kf_valid=torch.cat([st.kf_valid[1:], torch.zeros(1, dtype=torch.bool,
                                                             device=self.device)]))
        self.obs = np.concatenate([self.obs[1:], np.zeros_like(self.obs[:1])])
        self.vis = np.concatenate([self.vis[1:], np.zeros_like(self.vis[:1])])
        self.pre_list = self.pre_list[1:] + [None]
        self.n_in_window -= 1
        seen = self.vis.any(axis=0)
        self.state = self.state._replace(lm_valid=self.state.lm_valid & self._t(seen, torch.bool))
        self.lm_id[~seen] = -1

    def _visual_pose_init(self, slot: int):
        """Pre-VI-init pose of the new slot from vision (the VINS-Mono SfM
        stage): PnP against triangulated landmarks when enough are visible,
        else the essential matrix against the previous frame (the first pair
        sets the arbitrary visual scale)."""
        st = self.state
        prev = slot - 1
        if prev < 0:
            return
        lm_valid = _np(st.lm_valid)
        vis_new = self.vis[slot] & lm_valid
        if vis_new.sum() >= 10:
            # the float32 LAPACK DLT on the card too (`jacobi=False`, eager,
            # pre-VI-init frames only): the agents' trajectories sit within
            # a centimetre of test_full_system.py's 10 cm bound, and the
            # float64 Jacobi DLT took one over it (ROADMAP F8)
            res = ransac.pnp_ransac(st.lm, self._t(self.obs[slot]), self._t(vis_new, torch.bool),
                                    self._gumbel(self.MAX_LM), inlier_thresh=4.0 / self._fx,
                                    min_inliers=8, jacobi=False)
            if bool(res.ok):
                r_cw = _np(res.r)
                r_wb = r_cw.T @ self.r_cb
                c_w = -r_cw.T @ _np(res.t)
                self._set_slot_pose(slot, r_wb, c_w - r_wb @ self.p_bc)
                return
        common = self.vis[prev] & self.vis[slot]
        if common.sum() >= 8:
            res = self._epose(self._t(self.obs[prev]), self._t(self.obs[slot]),
                              self._t(common, torch.bool), self._gumbel(self.MAX_LM))
            if bool(res.ok):
                r = _np(res.r)                       # R_c1<-c0
                tdir = _np(res.t)
                p_np = _np(st.p)
                r_wb0 = quat_to_matrix_np(_np(st.q[prev]))
                r_wc0 = r_wb0 @ self.r_cb.T
                c0 = p_np[prev] + r_wb0 @ self.p_bc
                # |t| is unobservable: keep the IMU-predicted displacement
                # magnitude (floored); the first pair fixes the visual scale
                scale = max(float(np.linalg.norm(p_np[slot] - p_np[prev])), 0.05)
                r_wc1 = r_wc0 @ r.T
                c1 = c0 + r_wc0 @ (-r.T @ tdir) * scale
                r_wb1 = r_wc1 @ self.r_cb
                self._set_slot_pose(slot, r_wb1, c1 - r_wb1 @ self.p_bc)

    def _set_slot_pose(self, slot: int, r_wb: np.ndarray, p: np.ndarray):
        st = self.state
        q = matrix_to_quat_np(r_wb).astype(np.float32)
        dtp = self.pre_list[slot - 1]
        dt = float(dtp.dt) if dtp is not None else 0.5
        v = (p - _np(st.p[slot - 1])) / max(dt, 1e-3)
        self.state = st._replace(p=_set_row(st.p, slot, np.asarray(p, np.float32)),
                                 q=_set_row(st.q, slot, q),
                                 v=_set_row(st.v, slot, np.asarray(v, np.float32)))

    def _imu_init_attitude(self, acc: np.ndarray) -> np.ndarray:
        """Gravity-aligned initial orientation (`server_utility.cpp` g2R):
        a stationary accelerometer reads R_wbᵀ (0, 0, 9.81)."""
        g_meas = self._t(np.asarray(acc, np.float32).mean(axis=0))
        return _np(matrix_to_quat(g2r(g_meas)))

    # ---------- main entry ----------

    def _preprocess(self, image: np.ndarray) -> np.ndarray:
        if self.cfg.equalize:
            # global photometric normalization (the `equalize: 1` role)
            m = float(image.mean())
            s = float(image.std())
            image = np.clip((image - m) * (48.0 / max(s, 1.0)) + 110.0,
                            0.0, 255.0).astype(np.float32)
        return image

    def process_keyframe(self, timestamp: float, image: np.ndarray,
                         imu_gyr: np.ndarray, imu_acc: np.ndarray,
                         imu_dts: np.ndarray) -> KeyframePacket | None:
        """Feed one keyframe-rate image + the IMU batch since the previous
        keyframe. Returns a KeyframePacket once the window is solvable."""
        image = self._preprocess(image)
        return self._ingest_keyframe(timestamp, image, imu_gyr, imu_acc, imu_dts,
                                     tracked=False)

    def _ingest_keyframe(self, timestamp: float, image: np.ndarray,
                         imu_gyr: np.ndarray, imu_acc: np.ndarray,
                         imu_dts: np.ndarray, tracked: bool) -> KeyframePacket | None:
        """Window update for a frame promoted to keyframe. `tracked`: the
        features were already tracked onto `image` (camera-rate path)."""
        w, mf = self.WINDOW, self.MAX_FEAT
        slot = min(self.n_in_window, w - 1)
        if self.n_in_window == w:
            self._shift_window()
            slot = w - 1

        # preintegrate the IMU since the previous keyframe (before tracking:
        # the predicted motion seeds KLT)
        if self.kf_count > 0 and len(imu_gyr):
            j0 = max(slot - 1, 0)
            pre = self._preintegrate(imu_gyr, imu_acc, imu_dts,
                                     self.state.bg[j0], self.state.ba[j0])
            self.pre_list[slot - 1] = pre
        else:
            pre = None

        st = self.state
        if self.kf_count == 0:
            q0 = self._imu_init_attitude(imu_acc if len(imu_acc) else np.array([[0, 0, 9.81]]))
            st = st._replace(q=_set_row(st.q, 0, q0), kf_valid=_set_row(st.kf_valid, 0, True))
            p_pred, q_pred = st.p[0], st.q[0]
        else:
            prev = slot - 1
            if pre is not None:
                # IMU dead reckoning
                dtot = pre.dt
                grav = imu_mod.GRAVITY.to(self.device)
                r_prev = quat_to_matrix(st.q[prev])
                p_pred = (st.p[prev] + st.v[prev] * dtot + 0.5 * grav * dtot * dtot
                          + r_prev @ pre.dp)
                q_pred = quat_normalize(quat_multiply(st.q[prev], pre.dq))
                v_pred = st.v[prev] + grav * dtot + r_prev @ pre.dv
            else:
                p_pred, q_pred, v_pred = st.p[prev], st.q[prev], st.v[prev]
            st = st._replace(p=_set_row(st.p, slot, p_pred), q=_set_row(st.q, slot, q_pred),
                             v=_set_row(st.v, slot, v_pred),
                             bg=_set_row(st.bg, slot, st.bg[prev]),
                             ba=_set_row(st.ba, slot, st.ba[prev]),
                             kf_valid=_set_row(st.kf_valid, slot, True))

        if not tracked:
            prev = max(slot - 1, 0)
            init_xy = self._predict_features(_np(p_pred), _np(q_pred), _np(st.p[prev]),
                                             _np(st.q[prev]))
            self._track_and_detect(image, init_xy)

        # observations: normalized coords of the tracked features, landmark
        # slots by feature id
        norm_xy = self._lift_np(self.feat_xy)
        for f in range(mf):
            if not self.feat_valid[f]:
                continue
            fid = self.feat_id[f]
            lm_slot = np.nonzero(self.lm_id == fid)[0]
            if len(lm_slot) == 0:
                free = np.nonzero(self.lm_id < 0)[0]
                if len(free) == 0:
                    continue
                lm_slot = free[:1]
                self.lm_id[lm_slot[0]] = fid
            s_ = int(lm_slot[0])
            self.obs[slot, s_] = norm_xy[f]
            self.vis[slot, s_] = True

        self.state = st
        # pre-bootstrap, the IMU baseline (unknown initial velocity) would
        # push triangulations behind the cameras: pose the slot visually
        if not self.vi_initialized and self.kf_count > 0:
            self._visual_pose_init(slot)
        self.n_in_window += 1
        self.kf_count += 1

        # triangulate landmarks with >= 2 views that are not active yet, and
        # keep only the geometrically sound ones (cheirality, residual,
        # parallax)
        counts = self.vis.sum(axis=0)
        lm_valid = _np(self.state.lm_valid).copy()
        to_tri = (counts >= 2) & ~lm_valid & (self.lm_id >= 0)
        if to_tri.any():
            obs_t, vis_t = self._t(self.obs), self._t(self.vis, torch.bool)
            pts, oks = ba.triangulate(self.state.p, self.state.q, obs_t, vis_t,
                                      self._r_cb_t, self._p_bc_t)
            md, mr, par = ba.landmark_quality(self.state.p, self.state.q, self.state.kf_valid,
                                              obs_t, vis_t, pts, self._r_cb_t, self._p_bc_t)
            pts = _np(pts)
            min_par = np.deg2rad(1.0 if self.vi_initialized else 0.05)
            min_d = 0.1 if self.vi_initialized else 1e-3
            good = (to_tri & _np(oks) & np.isfinite(pts).all(axis=1)
                    & (_np(md) > min_d) & (_np(mr) < 4.0 / self._fx) & (_np(par) > min_par))
            lm = _np(self.state.lm).copy()
            lm[good] = pts[good]
            lm_valid |= good
            self.state = self.state._replace(lm=self._t(lm), lm_valid=self._t(lm_valid, torch.bool))

        if self.n_in_window >= 2 and lm_valid.sum() >= 8:
            self._solve()
            self.initialized = True
            if not self.vi_initialized and self.n_in_window >= min(5, w):
                self._try_vi_bootstrap()

        # packets only after the VI bootstrap and a short settle period
        if self.vi_initialized:
            self._post_boot += 1
        ready = (self.initialized and self.vi_initialized
                 and self._post_boot > self.cfg.publish_warmup)
        return self._emit_packet(timestamp, image) if ready else None

    # ---------- camera-rate tracking + keyframe selection ----------

    def process_frame(self, timestamp: float, image: np.ndarray,
                      imu_gyr: np.ndarray, imu_acc: np.ndarray,
                      imu_dts: np.ndarray) -> KeyframePacket | None:
        """Camera-rate entry point (the reference's agent contract: the
        tracker runs at the full camera rate, keyframes are selected by
        rotation-compensated parallax and track survival). Feed every camera
        frame with the IMU batch since the previous frame. Returns a
        KeyframePacket when this frame became a publishable keyframe."""
        image = self._preprocess(image)
        g = np.asarray(imu_gyr, np.float32).reshape(-1, 3)
        a = np.asarray(imu_acc, np.float32).reshape(-1, 3)
        d = np.asarray(imu_dts, np.float32).reshape(-1)
        for row in zip(g, a, d[:len(g)]):
            self._imu_buf.append(row)

        if self.kf_count == 0:
            pkt = self._ingest_keyframe(timestamp, image, imu_gyr, imu_acc, imu_dts,
                                        tracked=False)
            self._snapshot_keyframe(timestamp)
            return pkt

        gyr_b, acc_b, dt_b = self._imu_buf_arrays()
        p_pred, q_pred = self._propagate_from_kf(gyr_b, acc_b, dt_b)
        p_prev, q_prev = self._prop_pose
        init_xy = self._predict_features(p_pred, q_pred, p_prev, q_prev)
        self._track_and_detect(image, init_xy)
        self._prop_pose = (p_pred, q_pred)

        if not self._keyframe_decision(timestamp, q_pred):
            return None
        pkt = self._ingest_keyframe(timestamp, image, gyr_b, acc_b, dt_b, tracked=True)
        self._snapshot_keyframe(timestamp)
        return pkt

    def _imu_buf_arrays(self):
        if not self._imu_buf:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                    np.zeros(0, np.float32))
        g = np.stack([r[0] for r in self._imu_buf])
        a = np.stack([r[1] for r in self._imu_buf])
        d = np.asarray([r[2] for r in self._imu_buf], np.float32)
        return g, a, d

    def _propagate_from_kf(self, gyr: np.ndarray, acc: np.ndarray, dts: np.ndarray):
        """IMU dead-reckoned (p, q) at the current frame from the last
        keyframe's solved state: re-preintegrates the accumulated buffer, so
        the per-frame prediction stays consistent with the keyframe factor."""
        p_kf, q_kf, v_kf, bg_kf, ba_kf = self._kf_state
        if len(gyr) == 0:
            return p_kf, q_kf
        pre = self._preintegrate(gyr, acc, dts, self._t(bg_kf), self._t(ba_kf))
        q = quat_normalize(quat_multiply(self._t(q_kf), pre.dq))
        host = _np(torch.cat([pre.dt[None], pre.dp, q]))         # one read back
        tt, dp, q = float(host[0]), host[1:4], host[4:8]
        grav = _np(imu_mod.GRAVITY)
        p = p_kf + v_kf * tt + 0.5 * grav * tt * tt + quat_to_matrix_np(q_kf) @ dp
        return p.astype(np.float32), q.astype(np.float32)

    def _keyframe_decision(self, timestamp: float, q_pred: np.ndarray) -> bool:
        """Promote the current frame to a keyframe? Parallax-triggered at
        ~freq Hz, plus a track-survival trigger and a max-interval failsafe."""
        cfg = self.cfg
        dt_kf = timestamp - (self._kf_t if self._kf_t is not None else -1e9)
        freq = float(getattr(cfg, "keyframe_freq", 10.0) or 10.0)
        if dt_kf < 0.8 / freq:
            return False
        if dt_kf >= float(getattr(cfg, "max_kf_interval", 1.0)):
            return True
        alive_ids = set(int(i) for i, v in zip(self.feat_id, self.feat_valid) if v)
        kf_ids = set(self._kf_feat_xy.keys())
        if kf_ids:
            survival = len(kf_ids & alive_ids) / len(kf_ids)
            if survival < float(getattr(cfg, "kf_min_survival", 0.55)):
                return True
        common = [(j, int(i)) for j, (i, v) in enumerate(zip(self.feat_id, self.feat_valid))
                  if v and int(i) in self._kf_norm]
        if len(common) < 8:
            return True                              # tracking collapsed
        slots = np.asarray([c[0] for c in common])
        norm_now = self._lift_np(self.feat_xy)
        rays1 = np.concatenate([norm_now[slots], np.ones((len(slots), 1), np.float32)], -1)
        r_wb0 = quat_to_matrix_np(self._kf_state[1])
        r_wb1 = quat_to_matrix_np(q_pred)
        r_c0c1 = self.r_cb @ (r_wb0.T @ r_wb1) @ self.r_cb.T
        rays0 = rays1 @ r_c0c1.T
        z = np.maximum(rays0[:, 2], 1e-6)
        comp = rays0[:, :2] / z[:, None]
        ref = np.asarray([self._kf_norm[c[1]] for c in common])
        par = np.median(np.linalg.norm(comp - ref, axis=1))
        # VINS: a fixed virtual focal of 460 px (compensatedParallax2)
        thresh = float(getattr(cfg, "keyframe_parallax", 10.0)) / 460.0
        return bool(par >= thresh)

    def _snapshot_keyframe(self, timestamp: float):
        """Record the keyframe-time reference for the camera-rate path."""
        slot = max(self.n_in_window - 1, 0)
        st = self.state
        rows = _np(torch.cat([st.p[slot], st.q[slot], st.v[slot], st.bg[slot], st.ba[slot]]))
        self._kf_t = timestamp
        self._kf_state = (rows[0:3], rows[3:7], rows[7:10], rows[10:13], rows[13:16])
        self._prop_pose = (self._kf_state[0], self._kf_state[1])
        norm = self._lift_np(self.feat_xy)
        self._kf_feat_xy = {int(i): xy.copy() for i, xy, v in
                            zip(self.feat_id, self.feat_xy, self.feat_valid) if v}
        self._kf_norm = {int(i): n.copy() for i, n, v in
                         zip(self.feat_id, norm, self.feat_valid) if v}
        self._imu_buf = []

    def _try_vi_bootstrap(self):
        """Gyro-bias calibration + gravity/velocity/scale alignment over the
        current window, applied only when the system is well-conditioned, |g|
        lands near 9.81 and the scale is sane."""
        w = self.WINDOW
        present = [p_ for p_ in self.pre_list if p_ is not None]
        if len(present) < 3:
            return
        valid = np.array([p_ is not None for p_ in self.pre_list[:w - 1]])
        pre = imu_mod.stack_preintegrated(
            [p_ if p_ is not None else present[0] for p_ in self.pre_list[:w - 1]])
        kf_ok = _np(self.state.kf_valid)
        valid &= kf_ok[:-1] & kf_ok[1:]
        if valid.sum() < 3:
            return
        valid_t = self._t(valid, torch.bool)
        bg = self._gyro_bias(self.state.q, pre, valid_t)
        bg_np = _np(bg)
        if not np.isfinite(bg_np).all() or float(np.linalg.norm(bg_np)) > 0.5:
            return
        res = self._align(self.state.p, self.state.q, pre, bg, valid_t)
        s = float(res.scale)
        # VINS-Mono's gates: conditioning and the free gravity's magnitude
        # near 9.81; the scale only gets a sanity band (the pre-bootstrap
        # visual scale is arbitrary)
        if (not bool(res.ok) or not (0.01 < s < 1000.0)
                or abs(float(res.g_free_norm) - 9.81) > 1.0):
            return
        # rotate the world so the recovered gravity lands on (0, 0, -9.81),
        # rescale to metric, install velocities and bias
        r_align = g2r(-res.gravity)
        q_align = matrix_to_quat(r_align)
        st = self.state
        self.state = st._replace(
            p=(st.p @ r_align.T) * s,
            q=quat_normalize(quat_multiply(q_align.expand_as(st.q), st.q)),
            v=res.v @ r_align.T,
            bg=bg.expand(w, 3).clone(),
            lm=(st.lm @ r_align.T) * s)
        self.vi_initialized = True
        # the bootstrap re-gauges the window: a prior from the old gauge is void
        self._prior = None

    def _build_meas(self) -> ba.WindowMeasurements:
        """WindowMeasurements over the current window with the running
        marginalization prior (shared by the solve and the marginalization,
        so both linearize the same problem)."""
        w = self.WINDOW
        pre_valid = np.array([p_ is not None for p_ in self.pre_list[:w - 1]])
        if not pre_valid.all() and self._dummy_pre is None:
            self._dummy_pre = imu_mod.preintegrate(
                torch.zeros((2, 3), device=self.device),
                torch.tensor([0.0, 0.0, 9.81], device=self.device).repeat(2, 1),
                torch.full((2,), 0.005, device=self.device),
                torch.zeros(3, device=self.device), torch.zeros(3, device=self.device),
                noise=self.cfg.imu)
        pre = imu_mod.stack_preintegrated(
            [p_ if p_ is not None else self._dummy_pre for p_ in self.pre_list[:w - 1]])
        m0 = quat_to_matrix(self.state.q[0])
        return ba.WindowMeasurements(
            obs=self._t(self.obs), vis=self._t(self.vis, torch.bool),
            pre=pre, pre_valid=self._t(pre_valid, torch.bool),
            r_cb=self._r_cb_t, p_bc=self._p_bc_t,
            pix_weight=self._fx, huber_delta=5.0,
            bias_weight=float(self.cfg.bias_weight), prior=self._prior,
            anchor_p=self.state.p[0], anchor_yaw=torch.atan2(m0[1, 0], m0[0, 0]))

    def _solve(self):
        iters = self.cfg.max_solver_iterations
        # solve / gate / re-solve until the observation set is clean (<= 3
        # rounds): gating redistributes residuals, so one pass can expose
        # new > 4 px observations
        for _round in range(3):
            meas = self._build_meas()
            with self._span("solve"):
                self.state, cost = self._solve_fast(self.state, meas, iters)
                self._last_solved = float(cost)
            res = ba.reprojection_residuals(self.state, meas)     # whitened
            err_px = _np(torch.linalg.vector_norm(res, dim=-1))
            bad = (err_px > 4.0) & self.vis
            if not bad.any():
                break
            self.vis &= ~bad
            counts = self.vis.sum(axis=0)
            self.state = self.state._replace(
                lm_valid=self.state.lm_valid & self._t(counts >= 2, torch.bool))
        # geometric sanity after the solve: drop landmarks pushed behind the
        # cameras or to unobservable depths (they re-triangulate later)
        md, _, par = ba.landmark_quality(self.state.p, self.state.q, self.state.kf_valid,
                                         self._t(self.obs), self._t(self.vis, torch.bool),
                                         self.state.lm, self._r_cb_t, self._p_bc_t)
        min_par = np.deg2rad(0.5 if self.vi_initialized else 0.02)
        min_d = 0.05 if self.vi_initialized else 1e-3
        sane = (_np(md) > min_d) & (_np(par) > min_par)
        self.state = self.state._replace(lm_valid=self.state.lm_valid & self._t(sane, torch.bool))

    def _emit_packet(self, timestamp: float, image: np.ndarray) -> KeyframePacket:
        slot = self.n_in_window - 1
        st = self.state
        p = _np(st.p[slot])
        q = _np(st.q[slot])
        # window landmarks observed in this keyframe, gated on current-frame
        # geometry: sane depth and a small self-reprojection residual (the
        # packet's 3-D points feed the server's PnP)
        vis_now = self.vis[slot] & _np(st.lm_valid)
        feat_lookup = {self.feat_id[f]: f for f in range(self.MAX_FEAT) if self.feat_valid[f]}
        lm_all = _np(st.lm)
        r_wb_np = quat_to_matrix_np(q)
        pts_c_all = ((lm_all - p) @ r_wb_np - self.p_bc) @ self.r_cb.T
        z_all = pts_c_all[:, 2]
        proj = pts_c_all[:, :2] / np.maximum(z_all[:, None], 1e-6)
        self_res = np.linalg.norm(proj - self.obs[slot], axis=1)
        has_px = np.array([i in feat_lookup for i in self.lm_id])
        vis_now &= ((z_all > 0.2) & (z_all < 200.0)
                    & (self_res < 4.0 / self._fx) & has_px)
        idxs = np.nonzero(vis_now)[0]
        pts3d = lm_all[idxs]
        uv = self.obs[slot][idxs]
        ids = self.lm_id[idxs]
        # descriptors of those features at their current pixels, then the
        # full-image FAST + BRIEF features for loop closure, on the device
        px = np.array([self.feat_xy[feat_lookup[i]] for i in ids], np.float32).reshape(-1, 2)
        px_pad = np.zeros((self.MAX_FEAT, 2), np.float32)
        px_pad[:len(px)] = px
        with self._span("describe"):
            mf, ne = self.MAX_FEAT, self._max_ext
            out = _np(self._describe(self._t(image), self._stage("describe", px_pad), self.cam,
                                     float(self.cfg.fast_threshold), ne, self._cell))
            desc = out[:8 * mf].reshape(mf, 8)[:len(px)].view(np.uint32)
            ext_desc = out[8 * mf:8 * (mf + ne)].reshape(ne, 8).view(np.uint32)
            ext = out[8 * (mf + ne):].view(np.float32).reshape(ne, 5)
            ext_xy, ext_ok, ext_uv = ext[:, 0:2], ext[:, 2] > 0, ext[:, 3:5]
        bmargin = brief.PATCH_HALF + 1
        ext_ok &= ((ext_xy[:, 0] >= bmargin) & (ext_xy[:, 0] < image.shape[1] - bmargin)
                   & (ext_xy[:, 1] >= bmargin) & (ext_xy[:, 1] < image.shape[0] - bmargin))
        return KeyframePacket(
            client_id=self.client_id, timestamp=timestamp,
            p_wb=p, q_wb=q, r_cb=self.r_cb, p_bc=self.p_bc,
            win_pts3d=pts3d.astype(np.float32), win_uv=uv.astype(np.float32),
            win_ids=ids.astype(np.int64), win_desc=desc,
            win_valid=np.ones(len(idxs), bool),
            ext_uv=ext_uv.astype(np.float32), ext_desc=ext_desc,
            ext_valid=ext_ok, image=image)

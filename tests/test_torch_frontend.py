"""The port's `AgentFrontend` against `cvids_tpu.vio.frontend` on the CPU.

The same rendered frames and IMU (test_frontend.py's blob world, made from
a numpy seed) go through both front-ends, keyframe by keyframe, up to and
including the first packet, in lockstep: each frame the port starts from
the JAX front-end's state (`interop` carries it across), so each frame's
computation is compared and rounding does not compound from frame to
frame. Every RANSAC call of the JAX front-end is recorded (its key and
point count) and the port's `_gumbel` is fed the same `jax.random.gumbel`
draws in the same order. The JAX package's DLT takes the port's
eigenvector sign (the departure ROADMAP names, held hypothesis by
hypothesis in test_torch_server_ops.py): with LAPACK's sign a PnP can fail
in one package and succeed in the other, and the control flow would part.

The F-RANSAC's inlier test is a hard threshold: a point on it may pass in
one package and not the other (the 8-point F of one sample differs by a few
percent in Sampson error between the packages' float32 eigensolvers), so
tracks are held to a share. Free-running, such flips compound into
different re-detections within a few frames; in lockstep every track
agreed. After each frame: the same RANSAC calls; of the features tracked
from earlier frames, >= ID_AGREE of the JAX package's also tracked by the
port, within FEAT_TOL; the valid counts within 1 - ID_AGREE; the window
orientations within ROT_TOL, its positions within WIN_TOL after the VI
bootstrap and, before it, their shape (positions scaled to unit norm:
the visual scale is free) within SHAPE_TOL; the same frame of VI
initialization and of the first packet; that packet's pose within
POSE_TOL, its common landmarks within PTS_TOL, their descriptors equal in
>= DESC_AGREE of the bits. Then the port alone
runs test_frontend.py's trajectory case to its bounds, the fisheye mask
case, and the configuration loaders against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.io import render as jrender
from cvids_tpu.io import synthetic as jsyn
from cvids_tpu.ops import ransac as jransac
from cvids_tpu.utils import config as jconfig
from cvids_tpu.vio.frontend import AgentFrontend as JFrontend
from cvids_tpu_torch import interop
from cvids_tpu_torch.io import render as trender
from cvids_tpu_torch.io import synthetic as tsyn
from cvids_tpu_torch.utils import config as tconfig
from cvids_tpu_torch.utils.metrics import ate_rmse, umeyama
from cvids_tpu_torch.vio.frontend import AgentFrontend as TFrontend

# tolerances from the measured run (in brackets)
ID_AGREE = 0.95     # share of tracks, feature counts and packet ids that agree [1.0]
FEAT_TOL = 0.05     # px, positions of the features both packages track
SHAPE_TOL = 0.02    # window positions before the VI bootstrap, scaled to unit norm
WIN_TOL = 0.01      # m, window positions after it [0.0054]
ROT_TOL = 2e-3      # window quaternion entries [7e-4]
POSE_TOL = 1e-3     # m and quaternion entries, the first packet's pose [1e-4]
PTS_TOL = 0.01      # m, the first packet's landmarks [2.3e-4]
DESC_AGREE = 0.99   # share of equal descriptor bits in the first packet [1.0]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run thousands of small ops, which
    many threads slow down several times over when xdist workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(rng, syn):
    """test_frontend.py's sequence and blob field (from either package's
    copy of the generator)."""
    traj = syn.Trajectory.circle(radius=4.0, omega=0.35, height_amp=0.2, speed_mod=0.3,
                                 speed_mod_freq=0.9)
    seq = syn.generate_sequence(traj, duration=6.0, kf_rate=2.0, imu_rate=200.0, num_landmarks=0,
                                gyr_noise=0.0005, acc_noise=0.01, bg=(0.001, -0.001, 0.0005),
                                ba=(0.005, -0.01, 0.02))
    n_lm = 400
    landmarks = np.stack([rng.uniform(-12, 12, n_lm), rng.uniform(-12, 12, n_lm),
                          rng.uniform(0.0, 3.5, n_lm)], -1)
    return seq, landmarks, rng.uniform(80, 200, n_lm)


def _cfg(mod):
    cam = mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0, k1=0.0, k2=0.0, p1=0.0,
                           p2=0.0, width=320, height=240)
    return mod.AgentConfig(camera=cam, fast_threshold=12.0, min_feature_dist=24,
                           max_solver_iterations=10)


def _frames(seq, landmarks, intens, cam, cfg, render):
    """(image, gyr, acc, dts) of every keyframe, rendered as test_frontend.py
    renders them."""
    from cvids_tpu_torch.geometry.hostmath import quat_to_matrix_np

    r_cb = np.asarray(cfg.r_cb, np.float32)
    p_bc = np.asarray(cfg.p_bc, np.float32)
    g, a, dt, vmask = tsyn.imu_slices(seq)
    out = []
    for i in range(len(seq.times_kf)):
        r_wb = quat_to_matrix_np(seq.q_gt[i].astype(np.float32)).astype(np.float32)
        img = render.render_blobs(cam, landmarks, intens, r_wb, seq.p_gt[i], r_cb, p_bc)
        if i == 0:
            out.append((img, np.zeros((0, 3)), seq.acc[:5], np.zeros(0)))
        else:
            sel = vmask[i - 1]
            out.append((img, g[i - 1][sel], a[i - 1][sel], dt[i - 1][sel]))
    return out


def _dlt_pose_port_sign(pts3d, obs):
    """`cvids_tpu.ops.ransac._dlt_pose` with the nullspace's sign chosen so
    that det(P[:, :3]) >= 0, as the port's `_dlt_pose` chooses it."""
    s = pts3d.shape[0]
    x, y = obs[:, 0], obs[:, 1]
    xh = jnp.concatenate([pts3d, jnp.ones((s, 1), pts3d.dtype)], axis=1)
    zeros = jnp.zeros_like(xh)
    a = jnp.concatenate([jnp.concatenate([xh, zeros, -x[:, None] * xh], axis=1),
                         jnp.concatenate([zeros, xh, -y[:, None] * xh], axis=1)], axis=0)
    _, v = jnp.linalg.eigh(a.T @ a)
    p = v[:, 0].reshape(3, 4)
    p = jnp.where(jnp.linalg.det(p[:, :3]) < 0, -p, p)
    r_raw, t_raw = p[:, :3], p[:, 3]
    u, sv, vt = jnp.linalg.svd(r_raw)
    scale = jnp.mean(sv)
    r = u @ vt
    det = jnp.linalg.det(r)
    r = jnp.where(det < 0, (u * jnp.asarray([1.0, 1.0, -1.0])) @ vt, r)
    t = t_raw / jnp.where(jnp.abs(scale) > 1e-12, scale, 1e-12)
    t = jnp.where(det < 0, -t, t)
    flip = jnp.sum(jnp.sign((pts3d @ r.T + t)[:, 2])) < 0
    return jnp.where(flip, -r, r), jnp.where(flip, -t, t)


class _Recorder:
    """Wraps the JAX package's RANSAC entry points: records (n, key) of
    every call the front-end makes (calls traced inside a jitted function
    are not the front-end's and are not recorded)."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("fundamental_ransac", "pnp_ransac", "essential_pose"):
            real = getattr(jransac, name)
            monkeypatch.setattr(jransac, name, self._wrap(real))

    def _wrap(self, real):
        def f(p, obs, valid, key, *args, **kwargs):
            if not isinstance(key, jax.core.Tracer):
                self.calls.append((p.shape[0], key))
            return real(p, obs, valid, key, *args, **kwargs)
        return f

    def noise(self):
        """The recorded calls' Gumbel draws, in order, as (n, tensor)."""
        out = [(n, torch.from_numpy(np.array(jax.random.gumbel(key, (128, n)))))
               for n, key in self.calls]
        self.calls = []
        return out


def _start_from(fe_t, fe_j):
    """Lockstep: the port's next frame starts from the JAX front-end's
    state (features, landmark slots, window state, preintegrations, prior,
    counters), carried across by `interop`."""
    tree = lambda x: jax.tree_util.tree_map(np.asarray, x)     # noqa: E731
    for name in ("feat_xy", "feat_id", "feat_valid", "obs", "vis", "lm_id"):
        setattr(fe_t, name, np.array(getattr(fe_j, name), copy=True))
    for name in ("next_id", "initialized", "vi_initialized", "kf_count", "n_in_window",
                 "_post_boot", "_last_solved"):
        setattr(fe_t, name, getattr(fe_j, name))
    fe_t.prev_image = (None if fe_j.prev_image is None
                       else torch.from_numpy(np.array(fe_j.prev_image, np.float32)))
    fe_t.state = interop.window_state_to_torch(tree(fe_j.state), "cpu")
    fe_t.pre_list = [None if p_ is None else interop.preintegrated_to_torch(tree(p_), "cpu")
                     for p_ in fe_j.pre_list]
    fe_t._prior = None if fe_j._prior is None else interop.cam_prior_to_torch(tree(fe_j._prior), "cpu")


def test_frontend_matches_jax_to_first_packet(monkeypatch):
    rng = np.random.default_rng(0)
    seq, landmarks, intens = _world(rng, tsyn)
    cfg_j, cfg_t = _cfg(jconfig), _cfg(tconfig)
    fe_j = JFrontend(cfg_j, client_id=0)
    fe_t = TFrontend(cfg_t, client_id=0, device="cpu")
    frames = _frames(seq, landmarks, intens, fe_t.cam, cfg_t, trender)
    monkeypatch.setattr(jransac, "_dlt_pose", _dlt_pose_port_sign)
    rec = _Recorder(monkeypatch)
    queue = []

    def replay(n):
        want_n, g = queue.pop(0)
        assert want_n == n, (want_n, n)
        return g

    fe_t._gumbel = replay
    first = None
    for i, (img, g, a, dt) in enumerate(frames):
        _start_from(fe_t, fe_j)
        old_id = fe_j.next_id                 # ids older than this frame's detections
        pkt_j = fe_j.process_keyframe(seq.times_kf[i], img, g, a, dt)
        queue.extend(rec.noise())
        pkt_t = fe_t.process_keyframe(seq.times_kf[i], img, g, a, dt)
        assert not queue, f"frame {i}: the port made {len(queue)} fewer RANSAC calls"
        tracked = [{int(f): xy for f, xy, v in zip(fe.feat_id, fe.feat_xy, fe.feat_valid)
                    if v and f < old_id} for fe in (fe_t, fe_j)]
        common = sorted(set(tracked[0]) & set(tracked[1]))
        assert len(common) >= ID_AGREE * len(tracked[1]), f"frame {i}: {len(common)} common tracks"
        np.testing.assert_allclose([tracked[0][f] for f in common], [tracked[1][f] for f in common],
                                   atol=FEAT_TOL, err_msg=f"frame {i}")
        assert abs(int(fe_t.feat_valid.sum()) - int(fe_j.feat_valid.sum())) <= \
            (1 - ID_AGREE) * fe_j.feat_valid.sum(), f"frame {i}"
        assert fe_t.vi_initialized == fe_j.vi_initialized, f"frame {i}"
        assert (pkt_t is None) == (pkt_j is None), f"frame {i}"
        kf = np.asarray(fe_j.state.kf_valid)
        p_j, p_t = np.asarray(fe_j.state.p)[kf], fe_t.state.p.numpy()[kf]
        np.testing.assert_allclose(fe_t.state.q.numpy()[kf], np.asarray(fe_j.state.q)[kf],
                                   atol=ROT_TOL, err_msg=f"frame {i}")
        if fe_j.vi_initialized:
            np.testing.assert_allclose(p_t, p_j, atol=WIN_TOL, err_msg=f"frame {i}")
        else:
            # before the bootstrap the window's scale is the arbitrary,
            # weakly observed visual one, which the solve's rounding moves
            # by tens of percent: the window's shape is compared
            unit = lambda p: p / max(np.linalg.norm(p), 1e-9)     # noqa: E731
            np.testing.assert_allclose(unit(p_t), unit(p_j), atol=SHAPE_TOL, err_msg=f"frame {i}")
        if pkt_j is not None:
            first = (i, pkt_j, pkt_t)
            break
    assert first is not None and first[0] >= 4, "no packet, or one before the VI bootstrap"
    _, pkt_j, pkt_t = first
    np.testing.assert_allclose(pkt_t.p_wb, pkt_j.p_wb, atol=POSE_TOL)
    np.testing.assert_allclose(pkt_t.q_wb, pkt_j.q_wb, atol=POSE_TOL)
    common, it, ij = np.intersect1d(pkt_t.win_ids, pkt_j.win_ids, return_indices=True)
    assert len(common) >= ID_AGREE * len(pkt_j.win_ids)
    assert pkt_t.win_desc.dtype == np.uint32
    bits = np.unpackbits((pkt_t.win_desc[it] ^ pkt_j.win_desc[ij]).view(np.uint8))
    assert 1.0 - bits.mean() >= DESC_AGREE
    np.testing.assert_allclose(pkt_t.win_pts3d[it], pkt_j.win_pts3d[ij], atol=PTS_TOL)
    assert (pkt_t.ext_valid == pkt_j.ext_valid).mean() >= ID_AGREE
    assert pkt_t.ext_desc.dtype == np.uint32 and pkt_t.ext_desc.shape == pkt_j.ext_desc.shape


def test_frontend_tracks_trajectory():
    """test_frontend.py's trajectory case on the port alone, its bounds:
    the VI bootstrap locks, packets >= k - 7, ATE sim3 < 0.25 m, scale in
    (0.5, 2), usable packet contents."""
    rng = np.random.default_rng(0)
    seq, landmarks, intens = _world(rng, tsyn)
    cfg = _cfg(tconfig)
    fe = TFrontend(cfg, client_id=0, device="cpu")
    packets, est, gt = [], [], []
    for i, (img, g, a, dt) in enumerate(_frames(seq, landmarks, intens, fe.cam, cfg, trender)):
        pkt = fe.process_keyframe(seq.times_kf[i], img, g, a, dt)
        if pkt is not None:
            packets.append(pkt)
            est.append(pkt.p_wb)
            gt.append(seq.p_gt[i])
    k = len(seq.times_kf)
    assert fe.vi_initialized, "VI bootstrap never locked"
    assert len(packets) >= k - 7, "frontend failed to initialize"
    est, gt = np.asarray(est), np.asarray(gt)
    assert ate_rmse(est, gt, align="sim3") < 0.25
    s, _, _ = umeyama(est, gt, with_scale=True)
    assert 0.5 < s < 2.0, s
    last = packets[-1]
    assert last.win_pts3d.shape[0] >= 5
    assert last.ext_desc.shape[1] == 8
    assert last.win_desc.dtype == np.uint32


def test_fisheye_mask_gates_features():
    """`fisheye: 1` image-circle mask: features outside the circle die."""
    cam = tconfig.CameraConfig(fx=150.0, fy=150.0, cx=160.0, cy=120.0, width=320, height=240)
    fe = TFrontend(tconfig.AgentConfig(camera=cam, fisheye=True), device="cpu")
    fe.feat_xy[:4] = [[160, 120], [30, 120], [160, 230], [310, 10]]
    fe.feat_valid[:4] = True
    fe._apply_fisheye_mask()
    assert list(fe.feat_valid[:4]) == [True, False, True, False]
    fe2 = TFrontend(tconfig.AgentConfig(camera=cam), device="cpu")
    fe2.feat_xy[:1] = [[5, 5]]
    fe2.feat_valid[:1] = True
    fe2._apply_fisheye_mask()
    assert fe2.feat_valid[0]


def test_config_loaders_match():
    d = {"max_cnt": 120, "min_dist": 20, "freq": 5, "equalize": 1, "max_num_iterations": 6,
         "acc_n": 0.01, "gyr_n": 0.001, "acc_w": 1e-4, "gyr_w": 1e-5, "image_width": 640,
         "image_height": 400, "model_type": "MEI",
         "projection_parameters": {"fx": 300.0, "fy": 301.0, "cx": 320.5, "cy": 200.5},
         "distortion_parameters": {"k1": -0.1, "k2": 0.02, "p1": 1e-4, "p2": 2e-4}}
    want = jconfig.load_agent_yaml(d)
    got = tconfig.load_agent_yaml(d)
    assert interop.agent_config_to_dict(got) == interop.agent_config_to_dict(
        interop.agent_config_to_torch(want))
    back = interop.agent_config_to_dict(got)
    rebuilt = jconfig.AgentConfig(camera=jconfig.CameraConfig(**back.pop("camera")),
                                  imu=jconfig.ImuNoise(**back.pop("imu")), **back)
    assert rebuilt == want
    assert tconfig._VINS_KEYS == jconfig._VINS_KEYS
    sj, st = jconfig.SystemConfig(num_agents=3), tconfig.SystemConfig(num_agents=3)
    assert len(st.agents) == 3 and all(isinstance(a, tconfig.AgentConfig) for a in st.agents)
    for name in ("server", "dense", "tsdf"):
        assert vars(getattr(st, name)) == vars(getattr(sj, name)), name
    assert st.override(num_agents=1).num_agents == 1
    assert interop.agent_config_to_dict(st.agents[0]) == interop.agent_config_to_dict(
        interop.agent_config_to_torch(sj.agents[0]))


def test_keypoints_and_pattern_interop():
    from cvids_tpu.ops import brief as jbrief
    from cvids_tpu.ops import fast as jfast
    from cvids_tpu_torch.ops import brief as tbrief

    img = jnp.asarray(np.random.default_rng(5).uniform(0, 255, (64, 80)), jnp.float32)
    kj = jfast.select_keypoints(jfast.fast_score_map(img, 12.0), 20, cell=8)
    kt = interop.keypoints_to_torch(jax.tree_util.tree_map(np.asarray, kj), "cpu")
    assert kt.valid.dtype == torch.bool
    for a, b in zip(interop.keypoints_to_numpy(kt), kj):
        np.testing.assert_array_equal(a, np.asarray(b))
    pat = jbrief.brief_pattern(11)
    pt = interop.brief_pattern_to_torch(pat, "cpu")
    np.testing.assert_array_equal(interop.brief_pattern_to_numpy(pt), pat)
    xy = kt.xy[kt.valid]
    want = np.asarray(jbrief.compute_brief(img, jnp.asarray(xy.numpy()), pattern=pat))
    got = tbrief.compute_brief(torch.from_numpy(np.asarray(img)), xy, pattern=pt)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_rendered_world_copies():
    """The frames the tests feed both front-ends are the same from either
    package's generator and renderer."""
    seq_t, lm_t, in_t = _world(np.random.default_rng(0), tsyn)
    seq_j, lm_j, in_j = _world(np.random.default_rng(0), jsyn)
    np.testing.assert_array_equal(seq_t.p_gt, seq_j.p_gt)
    np.testing.assert_array_equal(seq_t.acc, seq_j.acc)
    np.testing.assert_array_equal(lm_t, lm_j)
    from cvids_tpu.camera import make_camera as jmake
    from cvids_tpu_torch.camera import make_camera as tmake

    cfg = _cfg(tconfig)
    ft = _frames(seq_t, lm_t, in_t, tmake(cfg.camera, device="cpu"), cfg, trender)[:3]
    fj = _frames(seq_j, lm_j, in_j, jmake(_cfg(jconfig).camera), cfg, jrender)[:3]
    for a, b in zip(ft, fj):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("field", ["p", "q", "kf_valid"])
def test_frontend_state_on_requested_device(field):
    fe = TFrontend(_cfg(tconfig), device="cpu")
    assert getattr(fe.state, field).device == torch.device("cpu")
    assert fe.cam.fx.device == torch.device("cpu")


def test_graphed_call_is_the_function_on_the_cpu():
    """`GraphedCall` captures nothing for CPU tensors: it is the function."""
    from cvids_tpu_torch.utils.cuda_graph import GraphedCall

    call = GraphedCall(lambda a, b, k: (a * k + b, {"s": a.sum()}))
    a, b = torch.arange(6.0).reshape(2, 3), torch.ones(3)
    out, extra = call(a, b, 2.0)
    torch.testing.assert_close(out, a * 2.0 + b)
    assert float(extra["s"]) == 15.0 and not call.graphs and call.replays == 0

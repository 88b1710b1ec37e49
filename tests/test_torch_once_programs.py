"""The JAX package's last compiled programs in the port, on the CPU: the
calibrators' residuals and Jacobian (`jax.jit(residuals)` and
`jax.jit(jax.jacfwd(residuals))` in `cvids_tpu.camera.models`), now
functions of their arguments that `GraphedCall` replays on the card, held
to the JAX package's programs on the same flat vector; the front-end's VI
bootstrap and pre-init essential pose going through their `GraphedCall`s,
held to the JAX functions on the front-end's own inputs; and
`chip_smoke.board_views`, the copy of `test_extras._board_views` (and of
its pinhole case's views) that phase 14 renders its boards with (those
import the JAX package).

On the CPU a `GraphedCall` runs its function, so these hold the functions
that the graphs capture; `tests/test_torch_cuda.py` and `chip_smoke.py`
phase 14 hold the replays to the eager calls bit for bit on a card.
Tolerances (float32, the same operations in other orders): residuals 1e-4
px plus 1e-5 relative (measured ≤ 3.1e-5 px, and 1.6e-4 px within that
bound on the scaramuzza residuals), Jacobian entries 1e-4 relative to the column's
largest entry (measured ≤ 5.2e-6); the bootstrap's gyro bias 1e-6 rad/s
(measured 2.8e-8), the alignment's scale 1e-4 relative, gravity and
velocities 1e-4 (measured 1.6e-5, 1.4e-5 and 3.3e-5).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.camera import models as jmodels
from cvids_tpu.ops import ransac as jransac
from cvids_tpu.vio import imu as jimu
from cvids_tpu.vio import initializer as jinit
from cvids_tpu_torch import camera as tcam
from cvids_tpu_torch.camera import models as tmodels
from cvids_tpu_torch.ops import ransac as transac
from cvids_tpu_torch.utils.cuda_graph import GraphedCall
from cvids_tpu_torch.vio import frontend as tfrontend
from cvids_tpu_torch.vio import initializer as tinit
from test_torch_calib import _true_camera, _views
from test_torch_frontend import _cfg, _frames, _world

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))   # chip_smoke.py
import chip_smoke as cs  # noqa: E402
from cvids_tpu_torch.io import render as trender  # noqa: E402
from cvids_tpu_torch.io import synthetic as tsyn  # noqa: E402
from cvids_tpu_torch.utils import config as tconfig  # noqa: E402

W, H = 320, 240
ROWS, COLS, SQ = cs.CALIB_BOARD


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: thousands of small ops, which many threads slow
    down when xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("model", ["pinhole", "equidistant", "mei", "scaramuzza"])
def test_board_views_copy_matches_test_extras(model):
    """`chip_smoke.board_views` (the port's renderer) renders the views of
    test_extras.py's chessboard calibrations (`_board_views`' eleven, and
    the pinhole case's four, as `test_torch_calib._views` renders them
    with the JAX package): bit for bit but at most two pixels a view
    (a supersample on the other side of a square's edge; measured: one
    pixel in one equidistant view, every other view equal). The camera
    that phase 14 calibrates at 752x480 is test_extras.py's with the
    principal point moved to the image centre."""
    want = _views(model)
    got = cs.board_views(_true_camera(tcam, model),
                         cs.PINHOLE_BOARD_POSES if model == "pinhole" else cs.BOARD_POSES)
    assert len(got) == len(want) == (4 if model == "pinhole" else len(cs.BOARD_POSES))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (H, W) and g.dtype == w.dtype
        assert (g != w).sum() <= 2
    big, small = cs.calib_camera(model, "cpu"), _true_camera(tcam, model)
    assert (big.width, big.height) == (cs.CALIB_W, cs.CALIB_H)
    assert float(big.cx) - float(small.cx) == (cs.CALIB_W - W) / 2
    assert float(big.cy) - float(small.cy) == (cs.CALIB_H - H) / 2


def _board_problem(model, rng):
    """Five views of the board's inner corners through the true camera
    (noiseless), poses near test_extras.py's, a perturbed start."""
    cam = _true_camera(tcam, model)
    obj = np.zeros((ROWS * COLS, 3), np.float32)
    obj[:, 0] = np.tile(np.arange(COLS), ROWS) * SQ
    obj[:, 1] = np.repeat(np.arange(ROWS), COLS) * SQ
    img, poses = [], []
    for yaw, pitch, tz, tx, ty in cs.BOARD_POSES[:5]:
        r, t = cs._board_pose(yaw, pitch, tz, tx, ty)
        img.append(cam.project(torch.from_numpy(obj @ r.T + t)).numpy())
        ang = np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))
        rvec = ang / (2 * np.sin(ang)) * np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                                                   r[1, 0] - r[0, 1]])
        poses.append(np.concatenate([rvec, t]))
    v = len(img)
    valid = np.ones((v, ROWS * COLS), bool)
    valid[1, 3] = False
    true = {"pinhole": [300.0, 300.0, 160.0, 120.0, -0.15, 0.05, 0.0, 0.0],
            "equidistant": [250.0, 250.0, 160.0, 120.0, -0.03, 0.006, 0.0, 0.0],
            "mei": [0.9, 420.0, 420.0, 160.0, 120.0, -0.05, 0.01, 0.0, 0.0]}.get(model)
    if true is None:
        true = list(_np(cam.inv_poly)[:6]) + [1.002, 0.0006, -0.0011, 160.5, 119.0]
    init = np.asarray(true, np.float32)
    init = init * (1 + rng.normal(0, 0.01, init.shape)).astype(np.float32)
    poses0 = (np.stack(poses) + rng.normal(0, 0.01, (v, 6))).astype(np.float32)
    return (np.tile(obj[None], (v, 1, 1)), np.stack(img).astype(np.float32), valid, init,
            poses0)


class _Kept:
    """Stands in for `GraphedCall` / `jax.jit` while a calibrator is set up:
    keeps each program made."""

    def __init__(self, make):
        self.make, self.made = make, []

    def __call__(self, fn, **kw):
        self.made.append(self.make(fn, **kw))
        return self.made[-1]


@pytest.mark.parametrize("model", ["pinhole", "equidistant", "mei", "scaramuzza"])
def test_calibrator_programs_match_jax(model, rng, monkeypatch):
    """Each calibrator's two programs as `_calibrate_gn` makes them (the
    port's `GraphedCall`s over `_residuals` with the data and the prior as
    arguments; the JAX package's `jax.jit`s of its closure), on the same
    flat vector [intrinsics, poses] with a masked observation: the same
    residuals (the scaramuzza prior's three rows included) and Jacobian."""
    obj, img, valid, init, poses0 = _board_problem(model, rng)
    kept_t = _Kept(GraphedCall)
    monkeypatch.setattr(tmodels, "GraphedCall", kept_t)
    getattr(tmodels, f"calibrate_{model}")(*(torch.from_numpy(a) for a in
                                             (obj, img, valid, init, poses0)), iters=0)
    kept_j = _Kept(jax.jit)
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", kept_j)
        getattr(jmodels, f"calibrate_{model}")(*(jnp.asarray(a) for a in
                                                 (obj, img, valid, init, poses0)), iters=0)
    (res_t, jac_t), (res_j, jac_j) = kept_t.made, kept_j.made
    assert all(isinstance(c, GraphedCall) for c in kept_t.made)
    data = (torch.from_numpy(obj), torch.from_numpy(img), torch.from_numpy(valid))
    prior = (None,) if model != "scaramuzza" else ((
        torch.tensor([6, 7, 8]), torch.tensor([1.0, 0.0, 0.0]),
        torch.tensor([1000.0, 1000.0, 1000.0])),)
    flat = np.concatenate([init, poses0.reshape(-1)]).astype(np.float32)
    flat += rng.normal(0, 1e-3, flat.shape).astype(np.float32)
    r_t = _np(res_t(torch.from_numpy(flat), *data, *prior))
    r_j = np.asarray(res_j(jnp.asarray(flat)))
    assert r_t.shape == r_j.shape == (2 * obj.shape[0] * obj.shape[1] + 3 * (model == "scaramuzza"),)
    assert r_t[2 * 33] == 0.0 and r_t[2 * 33 + 1] == 0.0       # view 1, corner 3: masked
    np.testing.assert_allclose(r_t, r_j, rtol=1e-5, atol=1e-4)
    j_t = _np(jac_t(torch.from_numpy(flat), *data, *prior))
    j_j = np.asarray(jac_j(jnp.asarray(flat)))
    assert j_t.shape == j_j.shape == (r_t.shape[0], flat.shape[0])
    scale = np.maximum(np.abs(j_j).max(0), 1e-6)
    np.testing.assert_array_less(np.abs(j_t - j_j) / scale, 1e-4)


def test_frontend_once_programs_through_graphed_calls():
    """test_frontend.py's trajectory through the port's front-end: until
    the VI bootstrap locks, every pre-init essential pose and both of the
    bootstrap's solves go through the front-end's `GraphedCall`s, and on
    the inputs of each last call the JAX package's functions agree: the
    essential pose's winning sample and its inlier count exactly (the JAX
    8-point on the port's samples), the bootstrap's solves to the
    module docstring's tolerances."""
    rng = np.random.default_rng(0)
    seq, landmarks, intens = _world(rng, tsyn)
    cfg = _cfg(tconfig)
    fe = tfrontend.AgentFrontend(cfg, client_id=0, device="cpu")
    calls = {"essential_pose": fe._epose, "gyro_bias": fe._gyro_bias, "alignment": fe._align}
    fns = {"essential_pose": transac.essential_pose, "gyro_bias": tinit.calibrate_gyro_bias,
           "alignment": tfrontend._align_step}
    assert all(isinstance(c, GraphedCall) and c.fn is fns[n] for n, c in calls.items())
    rec = cs.record_once_programs(fe)
    for i, (img, g, a, dt) in enumerate(_frames(seq, landmarks, intens, fe.cam, cfg, trender)):
        fe.process_keyframe(seq.times_kf[i], img, g, a, dt)
    assert fe.vi_initialized
    assert all(len(r.args) >= 1 for r in rec.values()), {n: len(r.args) for n, r in rec.items()}
    assert len(rec["gyro_bias"].args) >= len(rec["alignment"].args)

    p0, p1, common, gumbel = rec["essential_pose"].args[-1]
    got = transac.essential_pose(p0, p1, common, gumbel)
    # the JAX package's 8-point and Sampson error on the same samples
    idx = _np(transac._sample_indices(gumbel, common, 8))
    f_j = jax.vmap(jransac._eight_point)(jnp.asarray(_np(p0)[idx]), jnp.asarray(_np(p1)[idx]))
    f_t = transac._eight_point(p0[idx], p1[idx])
    thresh = (1.5 / 460.0) ** 2
    c_j = np.asarray(jnp.sum((jax.vmap(lambda f: jransac._sampson_error(
        f, jnp.asarray(_np(p0)), jnp.asarray(_np(p1))))(f_j) < thresh) & _np(common)[None], 1))
    c_t = _np(torch.sum((transac._sampson_error(f_t, p0, p1) < thresh) & common[None], 1))
    best = int(np.argmax(c_t))
    assert int(np.argmax(c_j)) == best and c_j[best] == c_t[best] == int(got.inliers.sum())
    assert bool(got.ok)

    q, pre, valid = rec["gyro_bias"].args[-1]
    pre_j = jimu.Preintegrated(*(jnp.asarray(_np(x)) for x in pre))
    bg_t = _np(tinit.calibrate_gyro_bias(q, pre, valid))
    bg_j = np.asarray(jinit.calibrate_gyro_bias(jnp.asarray(_np(q)), pre_j, jnp.asarray(_np(valid))))
    np.testing.assert_allclose(bg_t, bg_j, atol=1e-6)
    p, q, pre, bg, valid = rec["alignment"].args[-1]
    res_t = tfrontend._align_step(p, q, pre, bg, valid)
    pre_c = jax.vmap(lambda p_: jimu.bias_corrected(p_, jnp.asarray(_np(bg)), jnp.zeros(3)))(
        jimu.Preintegrated(*(jnp.asarray(_np(x)) for x in pre)))
    res_j = jinit.linear_alignment(jnp.asarray(_np(p)), jnp.asarray(_np(q)), pre_c,
                                   jnp.asarray(_np(valid)))
    assert bool(res_t.ok) == bool(res_j.ok)
    np.testing.assert_allclose(float(res_t.scale), float(res_j.scale), rtol=1e-4)
    np.testing.assert_allclose(_np(res_t.gravity), np.asarray(res_j.gravity), atol=1e-4)
    np.testing.assert_allclose(_np(res_t.v), np.asarray(res_j.v), atol=1e-4)

"""The port's calibrators against `cvids_tpu.camera`'s on the CPU.

Each case builds `test_extras.py`'s data once (the noisy planar-board
observations, or the rendered chessboard views), runs the reference's
calibrator and the port's on it, and holds the port to the bounds
`test_extras.py` holds the reference to AND to within half of each bound of
the reference's own result. The two Gauss-Newton solves need not take the
same steps (an accept/reject decision on a float comparison may flip in
float32), so the result is held, not the path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu import camera as jcam
from cvids_tpu.camera import chessboard as jboard
from cvids_tpu.camera import models as jmodels
from cvids_tpu_torch import camera as tcam
from cvids_tpu_torch.camera import chessboard as tboard
from cvids_tpu_torch.camera import models as tmodels
from test_extras import _board_views, _projection_agreement

W, H = 320, 240
ROWS, COLS, SQ = 5, 6, 0.04


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_calibrate_pinhole_matches_jax(rng):
    """`test_calibration_recovers_intrinsics`'s five noisy views of a 6x8
    board: focal and centre within 1 px, k1 within 0.05, rms < 0.3, and each
    within half of that of the reference's result."""
    from cvids_tpu.camera.pinhole import distort
    from cvids_tpu.geometry import quat_to_matrix, so3_exp

    true = np.array([300.0, 305.0, 160.0, 120.0, -0.2, 0.05, 0.001, -0.002], np.float32)
    gx, gy = np.meshgrid(np.arange(8) * 0.05, np.arange(6) * 0.05)
    board = np.stack([gx.ravel(), gy.ravel(), np.zeros(48)], -1).astype(np.float32)
    views, poses = [], []
    for v in range(5):
        rvec = rng.normal(0, 0.2, 3).astype(np.float32)
        tvec = np.array([-0.2 + 0.1 * v, -0.15, 0.6 + 0.1 * v], np.float32)
        r = np.asarray(quat_to_matrix(so3_exp(jnp.asarray(rvec))))
        pc = board @ r.T + tvec
        nrm = pc[:, :2] / pc[:, 2:3]
        nd = nrm + np.asarray(distort(jnp.asarray(nrm), jnp.asarray(true[4:8])))
        px = np.stack([true[0] * nd[:, 0] + true[2], true[1] * nd[:, 1] + true[3]], -1)
        px += rng.normal(0, 0.1, px.shape)
        views.append(px.astype(np.float32))
        poses.append(np.concatenate([rvec, tvec]))
    obj = np.tile(board[None], (5, 1, 1))
    img = np.stack(views)
    valid = np.ones((5, 48), bool)
    init = np.array([280.0, 280.0, 150.0, 110.0, 0, 0, 0, 0], np.float32)
    poses0 = (np.stack(poses) + rng.normal(0, 0.01, (5, 6))).astype(np.float32)
    pj, posej, rmsj = jmodels.calibrate_pinhole(*(jnp.asarray(a) for a in
                                                  (obj, img, valid, init, poses0)))
    pt, poset, rmst = tmodels.calibrate_pinhole(*(_t(a) for a in (obj, img, valid, init, poses0)))
    pj, pt = np.asarray(pj), _np(pt)
    assert pt.shape == (8,) and poset.shape == (5, 6)
    np.testing.assert_allclose(pt[:4], true[:4], atol=1.0)
    np.testing.assert_allclose(pt[4], true[4], atol=0.05)
    assert float(rmst) < 0.3
    np.testing.assert_allclose(pt[:4], pj[:4], atol=0.5)
    np.testing.assert_allclose(pt[4], pj[4], atol=0.025)
    assert abs(float(rmst) - float(rmsj)) < 0.15
    np.testing.assert_allclose(_np(poset), np.asarray(posej), atol=0.01)
    # a masked observation does not count: garbage there changes nothing
    bad = img.copy()
    bad[0, 0] = 1e4
    valid2 = valid.copy()
    valid2[0, 0] = False
    p2, _, rms2 = tmodels.calibrate_pinhole(*(_t(a) for a in (obj, bad, valid2, init, poses0)))
    np.testing.assert_allclose(_np(p2)[:4], pt[:4], atol=0.5)
    assert float(rms2) < 0.3


def _true_camera(module, model):
    """`test_extras.py`'s true camera of each chessboard calibration, in
    either package (`module` is `cvids_tpu.camera` or the port's)."""
    kw = {} if module is jcam else {"device": "cpu"}
    if model == "pinhole":
        return module.PinholeCamera.create(300.0, 300.0, 160.0, 120.0,
                                           (-0.15, 0.05, 0.0, 0.0), W, H, **kw)
    if model == "equidistant":
        return module.EquidistantCamera.create(250.0, 250.0, 160.0, 120.0,
                                               (-0.03, 0.006, 0.0, 0.0), W, H, **kw)
    if model == "mei":
        return module.MeiCamera.create(0.9, 420.0, 420.0, 160.0, 120.0,
                                       (-0.05, 0.01, 0.0, 0.0), W, H, **kw)
    return module.ScaramuzzaCamera.create(poly=(-215.0, 0.0, 4.0e-4, 0.0, 0.0), c=1.002,
                                          d=0.0006, e=-0.0011, cx=160.5, cy=119.0,
                                          width=W, height=H, **kw)


def _views(model):
    cam = _true_camera(jcam, model)
    if model != "pinhole":
        return _board_views(cam, ROWS, COLS, SQ)

    def pose(yaw, pitch, tz):
        cy_, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
        r = (np.array([[cy_, -sy, 0], [sy, cy_, 0], [0, 0, 1]])
             @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])).astype(np.float32)
        return r, np.array([-0.10, -0.08, tz], np.float32)

    return [jboard.render_chessboard(ROWS, COLS, 0, cam, *pose(*p), SQ)[0]
            for p in [(0.1, 0.15, 0.5), (-0.2, 0.1, 0.6), (0.15, -0.2, 0.45), (0.0, 0.3, 0.55)]]


class _AsJax:
    """The port's camera behind the `project(jnp array) -> array` call that
    `test_extras._projection_agreement` makes."""

    def __init__(self, cam):
        self.cam = cam

    def project(self, pts):
        return self.cam.project(_t(np.asarray(pts))).numpy()


def _estimated(module, model, p):
    """The camera of a calibration's parameters, in either package."""
    if module is jcam:
        arr = lambda v: jnp.asarray(np.asarray(v), jnp.float32)   # noqa: E731
        fit = jmodels.fit_forward_poly
    else:
        arr = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32)   # noqa: E731
        fit = tmodels.fit_forward_poly
    if model == "equidistant":
        return module.EquidistantCamera(*(arr(v) for v in (p[0], p[1], p[2], p[3], p[4:8])), W, H)
    if model == "mei":
        return module.MeiCamera(*(arr(v) for v in (p[0], p[1], p[2], p[3], p[4], p[5:9])), W, H)
    poly = fit(arr(p[:6]), theta_max=-0.8)
    return module.ScaramuzzaCamera(poly, arr(p[:6]), *(arr(p[i]) for i in range(6, 11)), W, H)


# model: (iterations, index of (fx, fy) or None, index of (cx, cy), focal, centre,
#         projection-agreement bound in px or None): test_extras.py's bounds
CASES = {"pinhole": (40, (0, 1), (2, 3), 300.0, (160.0, 120.0), None),
         "equidistant": (40, (0, 1), (2, 3), 250.0, (160.0, 120.0), 4.0),
         "mei": (50, None, (3, 4), None, (160.0, 120.0), 1.5),
         "scaramuzza": (100, None, (9, 10), None, (160.5, 119.0), 4.0)}


@pytest.mark.parametrize("model", list(CASES))
def test_calibrate_chessboards_matches_jax(model):
    """Rendered boards through both packages' detection and calibration:
    every view used, rms < 1 px, focal within 12 px and centre within 8 px
    of the truth (k1 within 0.08 for the pinhole), the estimated model within
    its bound of the true one in projection space; and each of these within
    half of its bound of the reference's result on the same views."""
    iters, f_idx, c_idx, focal, centre, agree_bound = CASES[model]
    views = _views(model)
    pj, posej, rmsj, usedj = jboard.calibrate_chessboards(views, ROWS, COLS, SQ, W, H,
                                                          iters=iters, model=model)
    pt, poset, rmst, usedt = tboard.calibrate_chessboards(views, ROWS, COLS, SQ, W, H,
                                                          iters=iters, model=model, device="cpu")
    assert isinstance(pt, torch.Tensor) and pt.device.type == "cpu"
    pj, pt = np.asarray(pj), _np(pt)
    assert usedt.all() and usedj.all() and pt.shape == pj.shape
    assert poset.shape == tuple(np.asarray(posej).shape)
    assert float(rmst) < 1.0, float(rmst)
    assert abs(float(rmst) - float(rmsj)) < 0.5, (float(rmst), float(rmsj))
    if f_idx is not None:
        assert np.abs(pt[list(f_idx)] - focal).max() < 12, pt[list(f_idx)]
        assert np.abs(pt[list(f_idx)] - pj[list(f_idx)]).max() < 6, (pt, pj)
    assert np.abs(pt[list(c_idx)] - centre).max() < 8, pt[list(c_idx)]
    assert np.abs(pt[list(c_idx)] - pj[list(c_idx)]).max() < 4, (pt, pj)
    if model == "pinhole":
        assert abs(pt[4] + 0.15) < 0.08 and abs(pt[4] - pj[4]) < 0.04, (pt[4], pj[4])
        return
    true_j = _true_camera(jcam, model)
    agree_t = _projection_agreement(true_j, _AsJax(_estimated(tcam, model, pt)), W, H)
    agree_j = _projection_agreement(true_j, _estimated(jcam, model, pj), W, H)
    assert agree_t < agree_bound, agree_t
    assert abs(agree_t - agree_j) < agree_bound / 2, (agree_t, agree_j)

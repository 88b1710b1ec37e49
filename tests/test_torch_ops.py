"""Port parity: the PyTorch ops of the dense step and the geometry helpers
against `cvids_tpu` on the same numpy inputs (CPU, small shapes).

JAX runs op by op here (no jit), so where the port rounds at the reference's
points the results agree to the last bit or nearly; each tolerance says why
it is what it is.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.geometry import fourdof as jfourdof
from cvids_tpu.geometry import rotations as jrot
from cvids_tpu.geometry import se3 as jse3
from cvids_tpu.ops import costvolume as jcv
from cvids_tpu.ops import depth_filter as jdf
from cvids_tpu.ops import image as jim
from cvids_tpu.ops import sgm as jsgm
from cvids_tpu_torch.geometry import fourdof as tfourdof
from cvids_tpu_torch.geometry import rotations as trot
from cvids_tpu_torch.geometry import se3 as tse3
from cvids_tpu_torch.ops import costvolume as tcv
from cvids_tpu_torch.ops import depth_filter as tdf
from cvids_tpu_torch.ops import image as tim
from cvids_tpu_torch.ops import sgm as tsgm

H, W, D = 24, 40, 16
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rot(ax_a, ax_b):
    ca, sa, cb, sb = np.cos(ax_a), np.sin(ax_a), np.cos(ax_b), np.sin(ax_b)
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    return rx @ ry


def _homography(kind):
    k = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]])
    r = np.eye(3) if kind == "identity" else _rot(0.03, -0.05)
    return (k @ r @ np.linalg.inv(k)).astype(np.float32), k.astype(np.float32)


def _image(rng, h=H, w=W):
    return rng.uniform(0, 255, (h, w)).astype(np.float32)


def test_sobel_and_gradients(rng):
    img = _image(rng)
    gx_j, gy_j = jim.sobel(jnp.asarray(img))
    gx_t, gy_t = tim.sobel(_t(img))
    # 3-tap fp32 sums of small integers times intensities: exact
    np.testing.assert_array_equal(_np(gx_t), np.asarray(gx_j))
    np.testing.assert_array_equal(_np(gy_t), np.asarray(gy_j))
    # the square root may round differently by one ulp
    np.testing.assert_allclose(_np(tim.image_gradients(_t(img))),
                               np.asarray(jim.image_gradients(jnp.asarray(img))),
                               rtol=1e-6)


def test_bilinear_sample(rng):
    img = _image(rng)
    xy = np.stack([rng.uniform(-3, W + 2, (7, 11)),
                   rng.uniform(-3, H + 2, (7, 11))], -1).astype(np.float32)
    xy[0, 0] = (W - 1, H - 1)        # the far corner is inside
    ref = np.asarray(jim.bilinear_sample(jnp.asarray(img), jnp.asarray(xy),
                                         fill=jnp.nan))
    out = _np(tim.bilinear_sample(_t(img), _t(xy), fill=float("nan")))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    # same fp32 expression in the same order
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4, equal_nan=True)


@pytest.mark.parametrize("kind", ["identity", "rotation", "degenerate"])
def test_warp_pass_positions(kind):
    m, _ = _homography("rotation" if kind == "degenerate" else kind)
    if kind == "degenerate":
        m = m.copy()
        m[1, 1] = 5.0 * m[2, 1]      # row r = 5 has den_v = 0
    g_j, y_j = jim.warp_pass_positions(jnp.asarray(m), H, W)
    g_t, y_t = tim.warp_pass_positions(_t(m), H, W)
    # identical fp32 expressions evaluated op by op
    np.testing.assert_array_equal(_np(g_t), np.asarray(g_j))
    np.testing.assert_array_equal(_np(y_t), np.asarray(y_j))


@pytest.mark.parametrize("kind", ["identity", "rotation"])
def test_projective_warp_mxu(rng, kind):
    img = _image(rng)
    m, _ = _homography(kind)
    a_j, c_j = jim.projective_warp_mxu(jnp.asarray(img), jnp.asarray(m))
    a_t, c_t = tim.projective_warp_mxu(_t(img), _t(m))
    # the port rounds image, weights and intermediate to bf16 at the
    # reference's points, and bf16 x bf16 products are exact in fp32, so the
    # two-tap gathers reproduce the hat-weight matmuls; 1e-3 leaves room for
    # one fp32 ulp of a 255-scale sum
    np.testing.assert_allclose(_np(a_t), np.asarray(a_j), atol=1e-3)
    np.testing.assert_allclose(_np(c_t), np.asarray(c_j), atol=1e-6)


def test_projective_warp_mxu_float32_weights(rng):
    img = _image(rng)
    m, _ = _homography("rotation")
    a_j, c_j = jim.projective_warp_mxu(jnp.asarray(img), jnp.asarray(m),
                                       weight_dtype=jnp.float32)
    a_t, c_t = tim.projective_warp_mxu(_t(img), _t(m), weight_dtype=torch.float32)
    # fp32 weights: two products per output, one rounding each
    np.testing.assert_allclose(_np(a_t), np.asarray(a_j), atol=1e-3)
    np.testing.assert_allclose(_np(c_t), np.asarray(c_j), atol=1e-6)


def _sweep_geometry(kind):
    m, k = _homography(kind)
    b = (k @ np.array([-0.1, 0.02, 0.01])).astype(np.float32)
    inv = ((np.arange(D) + 1) * 0.05).astype(np.float32)
    return m, b, inv


@pytest.mark.parametrize("kind", ["identity", "rotation"])
def test_sweep_positions(kind):
    m, b, inv = _sweep_geometry(kind)
    ref = jcv._sweep_positions(jnp.asarray(m), jnp.asarray(b), jnp.asarray(inv), H, W)
    out = tcv._sweep_positions(_t(m), _t(b), _t(inv), H, W)
    for name, r, o in zip(("pos_x", "pos_y", "mx", "my"), ref, out):
        # c = A^-1 b from two LU solves may differ in the last ulp; positions
        # reach ~W, so 1e-4 px
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=1e-5, atol=1e-4,
                                   err_msg=name)


def test_sweep_positions_behind_camera():
    m, b, _ = _sweep_geometry("identity")
    inv = np.array([0.5, 50.0, 100.0], np.float32)   # 1 + c2*rho <= 0 for the last
    b = b.copy()
    b[2] = -0.02
    pos_x, pos_y, _, _ = tcv._sweep_positions(_t(m), _t(b), _t(inv), H, W)
    ref_x, ref_y, _, _ = jcv._sweep_positions(jnp.asarray(m), jnp.asarray(b),
                                              jnp.asarray(inv), H, W)
    np.testing.assert_array_equal(_np(pos_x) == -1e9, np.asarray(ref_x) == -1e9)
    assert (_np(pos_x)[-1] == -1e9).all() and (_np(pos_y)[-1] == -1e9).all()


def test_warp_shift_bounds_np():
    for kind in ("identity", "rotation"):
        m, _ = _homography(kind)
        for step in (4, 16):
            assert tcv.warp_shift_bounds_np(m, H, W, step) == \
                jcv.warp_shift_bounds_np(m, H, W, step)


@pytest.mark.parametrize("kind", ["identity", "rotation"])
def test_plane_sweep_cost(rng, kind):
    ref = _image(rng)
    meas = _image(rng)
    m, b, inv = _sweep_geometry(kind)
    c_j, v_j = jcv.plane_sweep_cost(jnp.asarray(ref), jnp.asarray(meas),
                                    jnp.asarray(m), jnp.asarray(b), jnp.asarray(inv))
    c_t, v_t = tcv.plane_sweep_cost(_t(ref), _t(meas), _t(m), _t(b), _t(inv))
    v_j, v_t = np.asarray(v_j), _np(v_t)
    assert c_t.shape == (H, W, D) and v_t.shape == (H, W, D)
    # validity tests compare fp32 positions against the image edges: the
    # two LU solves may move a sample across an edge by an ulp
    assert (v_t == v_j).mean() > 0.999
    both = v_t & v_j
    assert both.mean() > 0.3
    # fp32 bilinear fetch vs fp32 hat-weight matmuls: same products, one
    # rounding apart; the box mean of 255-scale ADs keeps that under 1e-3
    np.testing.assert_allclose(_np(c_t)[both], np.asarray(c_j)[both], atol=1e-3)


def test_plane_sweep_cost_gather(rng):
    ref = _image(rng)
    meas = _image(rng)
    m, b, inv = _sweep_geometry("rotation")
    c_j, v_j = jcv.plane_sweep_cost_gather(jnp.asarray(ref), jnp.asarray(meas),
                                           jnp.asarray(m), jnp.asarray(b),
                                           jnp.asarray(inv))
    c_t, v_t = tcv.plane_sweep_cost_gather(_t(ref), _t(meas), _t(m), _t(b), _t(inv))
    # same fp32 gather formulation; the 3x3 box sums 9 taps in one order
    assert (_np(v_t) == np.asarray(v_j)).mean() > 0.999
    np.testing.assert_allclose(_np(c_t), np.asarray(c_j), atol=1e-3)


def test_accumulate_cost_in_place(rng):
    shape = (4, 5, 8)
    m_j, n_j = jnp.zeros(shape), jnp.zeros(shape)
    m_t, n_t = torch.zeros(shape), torch.zeros(shape)
    for _ in range(3):
        c = rng.uniform(0, 50, shape).astype(np.float32)
        v = rng.uniform(size=shape) > 0.3
        m_j, n_j = jcv.accumulate_cost(m_j, n_j, jnp.asarray(c), jnp.asarray(v))
        out_m, out_n = tcv.accumulate_cost(m_t, n_t, _t(c), _t(v))
        assert out_m is m_t and out_n is n_t          # updated in place
    # the same three fp32 operations per element
    np.testing.assert_array_equal(_np(n_t), np.asarray(n_j))
    np.testing.assert_allclose(_np(m_t), np.asarray(m_j), rtol=1e-6)


@pytest.mark.parametrize("s", [9, 11])   # n = s-1: a multiple of the unroll, and not
def test_scan_bidir(rng, s):
    cost = rng.uniform(0, 50, (s, 6, D)).astype(np.float32)
    p2 = rng.uniform(30, 70, (s, 6)).astype(np.float32)
    ref = jsgm._scan_bidir(jnp.asarray(cost), jnp.asarray(16.0, jnp.float32),
                           jnp.asarray(p2))
    out = tsgm._scan_bidir(_t(cost), torch.tensor(16.0), _t(p2))
    # min-plus algebra in fp32 with the same operation order: exact
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


def test_sgm_aggregate(rng):
    cost = rng.uniform(0, 50, (H, W, D)).astype(np.float32)
    grad = rng.uniform(0, 16, (H, W)).astype(np.float32)
    pen = rng.uniform(0.8, 2.3, (H, W)).astype(np.float32)
    ref = jsgm.sgm_aggregate(jnp.asarray(cost), jnp.asarray(grad),
                             penalty_scale=jnp.asarray(pen), use_pallas=False)
    out = tsgm.sgm_aggregate(_t(cost), _t(grad), penalty_scale=_t(pen))
    # fp32 carries on both sides; P1 is a mean over the map, whose sum order
    # may differ by an ulp, which moves the aggregates by ~1e-5
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5, atol=1e-3)


def test_wta_depth_ties_and_boundaries(rng):
    h, w, d = 6, 8, 32
    cost = rng.uniform(0, 50, (h, w, d)).astype(np.float32)
    cost[0, 0, :] = 15.0                      # all tied: first index wins
    cost[1, 1, 3] = cost[1, 1, 20] = -60.0    # two-way tie
    cost[2, 2, 0] = -100.0                    # minimum at the boundaries
    cost[3, 3, d - 1] = -100.0
    vc = rng.integers(0, d, (h, w)).astype(np.float32)
    i_j, c_j = jsgm.wta_depth(jnp.asarray(cost), jnp.asarray(vc), 8.0)
    i_t, c_t = tsgm.wta_depth(_t(cost), _t(vc), 8.0)
    # the same fp32 parabola; conf is a strict comparison of the same values
    np.testing.assert_allclose(_np(i_t), np.asarray(i_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(c_t), np.asarray(c_j))
    assert _np(i_t)[0, 0] == 0.0 and not _np(c_t)[2, 2] and not _np(c_t)[3, 3]


def _filter_state(rng, h=7, w=9):
    return (rng.uniform(0.2, 1.0, (h, w)).astype(np.float32),
            rng.uniform(0.01, 1.0, (h, w)).astype(np.float32),
            rng.uniform(5, 30, (h, w)).astype(np.float32),
            rng.uniform(5, 30, (h, w)).astype(np.float32))


def test_depth_filter_update(rng):
    st = _filter_state(rng)
    x = rng.uniform(0.1, 1.5, st[0].shape).astype(np.float32)
    x[0, 0] = 500.0                                    # out of range
    tau2 = np.full(st[0].shape, 0.01, np.float32)
    valid = np.ones(st[0].shape, bool)
    valid[1, 1] = False
    ref = jdf.update(jdf.FilterState(*map(jnp.asarray, st)), jnp.asarray(x),
                     jnp.asarray(tau2), jnp.asarray(valid))
    out = tdf.update(tdf.FilterState(*map(_t, st)), _t(x), _t(tau2), _t(valid))
    for name, r, o in zip(tdf.FilterState._fields, ref, out):
        # the same element-wise fp32 expressions; exp/sqrt may differ by an ulp
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_depth_filter_converged_mask(rng):
    st = _filter_state(rng)
    for kw in ({}, {"max_sigma2": 0.5}, {"min_support": 0.0}):
        np.testing.assert_array_equal(
            _np(tdf.converged_mask(tdf.FilterState(*map(_t, st)), **kw)),
            np.asarray(jdf.converged_mask(jdf.FilterState(*map(jnp.asarray, st)), **kw)))


@pytest.mark.parametrize("kind", ["identity", "motion"])
def test_depth_filter_propagate(rng, kind):
    h, w = 12, 16
    st = list(_filter_state(rng, h, w))
    st[0] = rng.uniform(0.3, 0.6, (h, w)).astype(np.float32)
    k = np.array([[10.0, 0, w / 2], [0, 10.0, h / 2], [0, 0, 1]], np.float32)
    r = np.eye(3, dtype=np.float32) if kind == "identity" \
        else _rot(0.02, 0.04).astype(np.float32)
    t = np.zeros(3, np.float32) if kind == "identity" \
        else np.array([0.05, -0.02, 0.1], np.float32)
    k_inv = np.linalg.inv(k).astype(np.float32)
    ref = jdf.propagate(jdf.FilterState(*map(jnp.asarray, st)), jnp.asarray(r),
                        jnp.asarray(t), jnp.asarray(k), jnp.asarray(k_inv))
    out = tdf.propagate(tdf.FilterState(*map(_t, st)), _t(r), _t(t), _t(k), _t(k_inv))
    for name, rr, o in zip(tdf.FilterState._fields, ref, out):
        rr, o = np.asarray(rr), _np(o)
        # forward splat: a source pixel whose projection sits within an ulp
        # of a rounding boundary may land one pixel over, so allow a few
        # pixels (2 %) to differ; the rest agree to fp32 precision
        close = np.isclose(o, rr, rtol=1e-4, atol=1e-5)
        assert close.mean() > 0.98, (name, close.mean())


def test_rotations(rng):
    ypr = rng.uniform(-3, 3, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(trot.ypr_to_r(_t(ypr))),
                               np.asarray(jrot.ypr_to_r(jnp.asarray(ypr))),
                               rtol=1e-6, atol=1e-6)
    yaw = rng.uniform(-9, 9, 11).astype(np.float32)
    np.testing.assert_allclose(_np(trot.rot_z(_t(yaw))),
                               np.asarray(jrot.rot_z(jnp.asarray(yaw))),
                               rtol=1e-6, atol=1e-6)
    # the same three fp32 operations
    np.testing.assert_array_equal(_np(trot.wrap_angle(_t(yaw))),
                                  np.asarray(jrot.wrap_angle(jnp.asarray(yaw))))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _angles_close(a, b, atol):
    """Angles compared modulo 2 pi."""
    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64) + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(d, 0.0, atol=atol)


def _quats_close(a, b, atol):
    """Quaternions compared up to sign."""
    a, b = np.asarray(a), np.asarray(b)
    sign = np.where(np.sum(a * b, -1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(a * sign, b, atol=atol)


ROTATION_CASES = ["quat_from_axis_angle", "so3_log", "so3_log_small", "r_to_ypr",
                  "r_to_ypr_deg", "ypr_deg_to_r", "yaw_of_quat", "yaw_of_matrix",
                  "quat_slerp", "quat_slerp_same", "g2r", "g2r_aligned"]


@pytest.mark.parametrize("case", ROTATION_CASES)
def test_rotations_rest(rng, case):
    """The rest of `geometry.rotations` against the JAX functions on the
    same float32 inputs, to 1e-5 (angles modulo 2 pi, quaternions up to
    sign), with the small-angle branches and their gradients at 0."""
    tol = 1e-5
    q = _quats(rng, 9)
    if case == "quat_from_axis_angle":
        axis = rng.normal(size=(9, 3)).astype(np.float32)
        ang = rng.uniform(-3, 3, 9).astype(np.float32)
        _quats_close(_np(trot.quat_from_axis_angle(_t(axis), _t(ang))),
                     jrot.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(ang)), tol)
    elif case == "so3_log":
        np.testing.assert_allclose(_np(trot.so3_log(_t(q))),
                                   np.asarray(jrot.so3_log(jnp.asarray(q))), atol=tol)
        w = rng.normal(0, 0.8, (9, 3)).astype(np.float32)
        np.testing.assert_allclose(_np(trot.so3_log(trot.so3_exp(_t(w)))), w, atol=tol)
    elif case == "so3_log_small":
        tiny = np.array([[1.0, 0, 0, 0], [1.0, 1e-9, -2e-9, 0], [-1.0, 0, 0, 1e-8]], np.float32)
        np.testing.assert_allclose(_np(trot.so3_log(_t(tiny))),
                                   np.asarray(jrot.so3_log(jnp.asarray(tiny))), atol=1e-12)
        qt = _t(tiny[:1]).requires_grad_()
        trot.so3_log(qt).sum().backward()
        assert torch.isfinite(qt.grad).all()
    elif case in ("r_to_ypr", "r_to_ypr_deg"):
        m = np.asarray(jrot.quat_to_matrix(jnp.asarray(q)))
        if case == "r_to_ypr":
            _angles_close(_np(trot.r_to_ypr(_t(m))), jrot.r_to_ypr(jnp.asarray(m)), tol)
        else:
            d = _np(trot.r_to_ypr_deg(_t(m))) - np.asarray(jrot.r_to_ypr_deg(jnp.asarray(m)))
            np.testing.assert_allclose((d + 180.0) % 360.0 - 180.0, 0.0, atol=1e-3)   # degrees
    elif case == "ypr_deg_to_r":
        ypr = rng.uniform(-170, 170, (9, 3)).astype(np.float32)
        np.testing.assert_allclose(_np(trot.ypr_deg_to_r(_t(ypr))),
                                   np.asarray(jrot.ypr_deg_to_r(jnp.asarray(ypr))), atol=tol)
    elif case == "yaw_of_quat":
        _angles_close(_np(trot.yaw_of(_t(q))), jrot.yaw_of(jnp.asarray(q)), tol)
    elif case == "yaw_of_matrix":
        m = np.asarray(jrot.quat_to_matrix(jnp.asarray(q)))
        _angles_close(_np(trot.yaw_of(_t(m))), jrot.yaw_of(jnp.asarray(m)), tol)
        _angles_close(_np(trot.yaw_of(_t(m))), _np(trot.yaw_of(_t(q))), tol)
    elif case == "quat_slerp":
        q1 = _quats(rng, 9)
        t = rng.uniform(0, 1, 9).astype(np.float32)
        _quats_close(_np(trot.quat_slerp(_t(q), _t(q1), _t(t))),
                     jrot.quat_slerp(jnp.asarray(q), jnp.asarray(q1), jnp.asarray(t)), tol)
        _quats_close(_np(trot.quat_slerp(_t(q), _t(q1), 0.25)),
                     jrot.quat_slerp(jnp.asarray(q), jnp.asarray(q1), 0.25), tol)
    elif case == "quat_slerp_same":
        q0 = _t(q).requires_grad_()
        out = trot.quat_slerp(q0, _t(q), 0.3)
        _quats_close(_np(out.detach()), jrot.quat_slerp(jnp.asarray(q), jnp.asarray(q), 0.3), tol)
        _quats_close(_np(out.detach()), q, tol)
        out.sum().backward()
        assert torch.isfinite(q0.grad).all()
    elif case == "g2r":
        g = rng.normal(size=(9, 3)).astype(np.float32) * 9.8
        out = _np(trot.g2r(_t(g)))
        np.testing.assert_allclose(out, np.asarray(jrot.g2r(jnp.asarray(g))), atol=tol)
        up = np.einsum("nij,nj->ni", out, g / np.linalg.norm(g, axis=-1, keepdims=True))
        np.testing.assert_allclose(up, np.tile([0.0, 0.0, 1.0], (9, 1)), atol=tol)
    else:
        g = np.array([[0.0, 0.0, 9.8], [0.0, 0.0, -9.8]], np.float32)
        np.testing.assert_allclose(_np(trot.g2r(_t(g))),
                                   np.asarray(jrot.g2r(jnp.asarray(g))), atol=tol)


def _poses(rng, n):
    return _quats(rng, n), rng.normal(0, 2, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("case", ["pose_identity", "transform_points", "pose_to_matrix",
                                  "pose_from_matrix", "se3_exp", "se3_exp_small", "se3_log",
                                  "se3_log_small"])
def test_se3_rest(rng, case):
    """The rest of `geometry.se3` against the JAX functions to 1e-5
    (quaternions up to sign)."""
    tol = 1e-5
    q, t = _poses(rng, 7)
    pj, pt = jse3.Pose(jnp.asarray(q), jnp.asarray(t)), tse3.Pose(_t(q), _t(t))
    if case == "pose_identity":
        ij, it = jse3.pose_identity((2, 3)), tse3.pose_identity((2, 3), device="cpu")
        np.testing.assert_array_equal(_np(it.q), np.asarray(ij.q))
        np.testing.assert_array_equal(_np(it.t), np.asarray(ij.t))
        assert tse3.pose_identity().q.shape == (4,)
    elif case == "transform_points":
        pts = rng.normal(0, 3, (7, 5, 3)).astype(np.float32)
        np.testing.assert_allclose(_np(tse3.transform_points(pt, _t(pts))),
                                   np.asarray(jse3.transform_points(pj, jnp.asarray(pts))),
                                   atol=tol)
    elif case == "pose_to_matrix":
        np.testing.assert_allclose(_np(tse3.pose_to_matrix(pt)),
                                   np.asarray(jse3.pose_to_matrix(pj)), atol=tol)
        np.testing.assert_allclose(_np(pt.matrix), np.asarray(pj.matrix), atol=tol)
    elif case == "pose_from_matrix":
        m = np.asarray(jse3.pose_to_matrix(pj))
        oj, ot = jse3.pose_from_matrix(jnp.asarray(m)), tse3.pose_from_matrix(_t(m))
        _quats_close(_np(ot.q), oj.q, tol)
        np.testing.assert_allclose(_np(ot.t), np.asarray(oj.t), atol=tol)
    elif case in ("se3_exp", "se3_exp_small"):
        xi = rng.normal(0, 0.7, (7, 6)).astype(np.float32)
        if case == "se3_exp_small":
            xi[:, 3:] *= 1e-7
            xi[0] = 0.0
        oj, ot = jse3.se3_exp(jnp.asarray(xi)), tse3.se3_exp(_t(xi))
        _quats_close(_np(ot.q), oj.q, tol)
        np.testing.assert_allclose(_np(ot.t), np.asarray(oj.t), atol=tol)
        x = _t(xi).requires_grad_()
        out = tse3.se3_exp(x)
        (out.q.sum() + out.t.sum()).backward()
        assert torch.isfinite(x.grad).all()
    else:
        if case == "se3_log_small":
            q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (7, 1))
            q[1:, 1:] = rng.normal(0, 1e-7, (6, 3))
            pj, pt = jse3.Pose(jnp.asarray(q), jnp.asarray(t)), tse3.Pose(_t(q), _t(t))
        np.testing.assert_allclose(_np(tse3.se3_log(pt)), np.asarray(jse3.se3_log(pj)), atol=tol)
        xi = rng.normal(0, 0.5, (7, 6)).astype(np.float32)
        np.testing.assert_allclose(_np(tse3.se3_log(tse3.se3_exp(_t(xi)))), xi, atol=tol)


@pytest.mark.parametrize("name", ["fourdof_rotation", "relative_edge", "edge_residual",
                                  "apply_drift"])
def test_fourdof(rng, name):
    """`geometry.fourdof` against the JAX functions to 1e-5 (yaw modulo
    2 pi)."""
    n = 8
    f32 = np.float32
    yaw_i, yaw_j = rng.uniform(-3, 3, (2, n)).astype(f32)
    pr = rng.uniform(-0.3, 0.3, (n, 2)).astype(f32)
    t_i, t_j = rng.normal(0, 3, (2, n, 3)).astype(f32)
    if name == "fourdof_rotation":
        args = (yaw_i, pr[:, 0], pr[:, 1])
    elif name == "relative_edge":
        args = (yaw_i, pr, t_i, yaw_j, t_j)
    elif name == "edge_residual":
        args = (yaw_i, pr, t_i, yaw_j, t_j, rng.normal(0, 1, (n, 3)).astype(f32),
                rng.uniform(-3, 3, n).astype(f32), 2.0, 0.5)
    else:
        args = (yaw_i, t_i, yaw_j, t_j)
    to = lambda f: [f(a) if isinstance(a, np.ndarray) else a for a in args]   # noqa: E731
    out_j = getattr(jfourdof, name)(*to(jnp.asarray))
    out_t = getattr(tfourdof, name)(*to(_t))
    assert sorted(tfourdof.__all__) == sorted(jfourdof.__all__)
    if name == "fourdof_rotation":
        np.testing.assert_allclose(_np(out_t), np.asarray(out_j), atol=1e-5)
    elif name == "relative_edge":
        np.testing.assert_allclose(_np(out_t[0]), np.asarray(out_j[0]), atol=1e-5)
        _angles_close(_np(out_t[1]), out_j[1], 1e-5)
    elif name == "edge_residual":
        np.testing.assert_allclose(_np(out_t)[:, :3], np.asarray(out_j)[:, :3], atol=2e-5)
        _angles_close(_np(out_t)[:, 3] / 0.5, np.asarray(out_j)[:, 3] / 0.5, 1e-5)
    else:
        _angles_close(_np(out_t[0]), out_j[0], 1e-5)
        np.testing.assert_allclose(_np(out_t[1]), np.asarray(out_j[1]), atol=1e-5)


def test_geometry_exports():
    """`geometry` exports what the JAX package's `geometry` exports."""
    import cvids_tpu.geometry as jgeo
    import cvids_tpu_torch.geometry as tgeo
    names = set(jgeo.rotations.__all__) | set(jgeo.se3.__all__) | {"fourdof", "hostmath"}
    assert not [n for n in names if not hasattr(tgeo, n)]
    assert sorted(tgeo.rotations.__all__) == sorted(jgeo.rotations.__all__)
    assert sorted(tgeo.se3.__all__) == sorted(jgeo.se3.__all__)


@pytest.mark.parametrize("case", ["kernel", "blur", "blur_batch", "downsample", "pyramid"])
def test_gaussian_blur_and_pyramid(rng, case):
    """`gaussian_kernel1d`, `gaussian_blur`, `downsample2x` and
    `build_pyramid` against the JAX functions to 1e-5 relative (1e-3 of 255
    absolute), edge replication included: a constant image stays constant up
    to its border."""
    img = _image(rng, 26, 38)
    if case == "kernel":
        for sigma, radius in ((1.0, None), (2.0, 4), (0.7, 1)):
            np.testing.assert_allclose(_np(tim.gaussian_kernel1d(sigma, radius)),
                                       np.asarray(jim.gaussian_kernel1d(sigma, radius)),
                                       rtol=1e-6)
    elif case == "blur":
        for sigma, radius in ((1.0, None), (2.0, 4)):
            np.testing.assert_allclose(
                _np(tim.gaussian_blur(_t(img), sigma, radius)),
                np.asarray(jim.gaussian_blur(jnp.asarray(img), sigma, radius)),
                rtol=1e-5, atol=1e-3)
        flat = np.full((9, 11), 37.0, np.float32)
        np.testing.assert_allclose(_np(tim.gaussian_blur(_t(flat), 2.0, 4)), flat, rtol=1e-6)
    elif case == "blur_batch":
        batch = np.stack([img, img[::-1].copy()])
        np.testing.assert_allclose(_np(tim.gaussian_blur(_t(batch), 1.5)),
                                   np.asarray(jim.gaussian_blur(jnp.asarray(batch), 1.5)),
                                   rtol=1e-5, atol=1e-3)
    elif case == "downsample":
        np.testing.assert_allclose(_np(tim.downsample2x(_t(img))),
                                   np.asarray(jim.downsample2x(jnp.asarray(img))),
                                   rtol=1e-6, atol=1e-4)
    else:
        img = _image(rng, 32, 48)
        pj, pt = jim.build_pyramid(jnp.asarray(img), 3), tim.build_pyramid(_t(img), 3)
        assert [tuple(x.shape) for x in pt] == [tuple(x.shape) for x in pj] \
            == [(32, 48), (16, 24), (8, 12)]
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-3)


def test_port_imports_without_jax():
    code = ("import sys, cvids_tpu_torch, cvids_tpu_torch.interop, "
            "cvids_tpu_torch.dense.estimator, cvids_tpu_torch.server.optimizer, "
            "cvids_tpu_torch.ops.cuda_kernels, cvids_tpu_torch._build, "
            "cvids_tpu_torch.server.pipeline, cvids_tpu_torch.server.smooth_optimizer, "
            "cvids_tpu_torch.mapping.tsdf, cvids_tpu_torch.mapping.mesh, "
            "cvids_tpu_torch.ops.marching_cubes, cvids_tpu_torch.utils.checkpoint, "
            "cvids_tpu_torch.utils.tracing, cvids_tpu_torch.io.render, "
            "cvids_tpu_torch.camera, cvids_tpu_torch.camera.models, "
            "cvids_tpu_torch.camera.chessboard, cvids_tpu_torch.geometry.fourdof, "
            "cvids_tpu_torch.utils.config, cvids_tpu_torch.utils.metrics, "
            "cvids_tpu_torch.vio.imu, cvids_tpu_torch.vio.initializer, "
            "cvids_tpu_torch.vio.window_ba, cvids_tpu_torch.vio.frontend, "
            "cvids_tpu_torch.ops.fast, cvids_tpu_torch.ops.brief, cvids_tpu_torch.ops.klt, "
            "cvids_tpu_torch.ops.ransac, cvids_tpu_torch.io.synthetic, cvids_tpu_torch.server.vocab; "
            "print('jax' in sys.modules, 'cvids_tpu' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["False", "False"], res.stdout


def test_server_port_runs_without_jax():
    """A short stream from the port's own generator runs through the port's
    server, with the native max clique, in a fresh process that loads
    neither JAX nor any module of `cvids_tpu`."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import cvids_tpu_torch.server.posegraph as pg, cvids_tpu_torch.server.vocab as voc\n"
        "import cvids_tpu_torch.server.pcm as pcm, cvids_tpu_torch.ops.ransac\n"
        "import cvids_tpu_torch.ops.hamming\n"
        "from cvids_tpu_torch.io import multiagent\n"
        "from cvids_tpu_torch.io.synthetic import Trajectory\n"
        "lm = np.random.default_rng(0).uniform(-10, 10, (200, 3))\n"
        "d = multiagent.landmark_descriptors(200)\n"
        "pk, _ = multiagent.generate_packets([multiagent.AgentSim(Trajectory.circle())], lm, d,\n"
        "                                     duration=3.0, max_feats=40)\n"
        "s = pg.CollaborativePoseGraph(voc.synthesize_tree_vocabulary(k=4, levels=3),\n"
        "                              pg.ServerConfig(kf_capacity=16, max_win=40, max_ext=40),\n"
        "                              device='cpu')\n"
        "[s.add_keyframe(p) for _, _, _, p in pk]\n"
        "s.flush()\n"
        "assert pcm.max_clique(np.ones((4, 4), bool)).tolist() == [0, 1, 2, 3]\n"
        "print('jax' in sys.modules, 'cvids_tpu' in sys.modules, s.store.count)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["False", "False", "4"], res.stdout


def test_pipeline_port_runs_without_jax(tmp_path):
    """Keyframes with rendered images go through the port's whole server
    (pose graph, dense depth, TSDF, mesh, checkpoints) in a fresh process
    that loads neither JAX nor any module of `cvids_tpu`."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from cvids_tpu_torch.camera import PinholeCamera\n"
        "from cvids_tpu_torch.dense.estimator import DenseConfig\n"
        "from cvids_tpu_torch.io import multiagent, render\n"
        "from cvids_tpu_torch.io.msgs import KeyframePacket\n"
        "from cvids_tpu_torch.io.synthetic import quat_from_matrix_np\n"
        "from cvids_tpu_torch.mapping.mesh import read_ply\n"
        "from cvids_tpu_torch.mapping.tsdf import TsdfConfig\n"
        "from cvids_tpu_torch.server import pipeline, posegraph, vocab\n"
        "from cvids_tpu_torch.utils import checkpoint\n"
        "h, w = 48, 64\n"
        "cam = PinholeCamera.create(40.0, 40.0, w / 2, h / 2, width=w, height=h, device='cpu')\n"
        "lm = render.sample_scene_landmarks(300, np.random.default_rng(0))\n"
        "desc = multiagent.landmark_descriptors(300)\n"
        "cfg = pipeline.PipelineConfig(\n"
        "    server=posegraph.ServerConfig(kf_capacity=16, max_win=40, max_ext=40),\n"
        "    dense=DenseConfig(height=h, width=w, num_depths=32, dep_sample=1 / (0.11 * 40)),\n"
        "    tsdf=TsdfConfig(voxel_size=0.2, capacity=64), ref_advance=2)\n"
        "s = pipeline.CollaborativeServer(vocab.synthesize_tree_vocabulary(k=4, levels=3), cfg,\n"
        "                                 device='cpu')\n"
        "s.set_client_camera(0, cam)\n"
        "r_cb = multiagent.R_CB_DEFAULT\n"
        "for i in range(6):\n"
        "    eye = np.array([1.2 + 0.1 * i, -2.2, 1.2])\n"
        "    z = np.array([1.5, 1.0, 0.5]) - eye\n"
        "    z /= np.linalg.norm(z)\n"
        "    x = np.cross(z, [0.0, 0.0, 1.0])\n"
        "    x /= np.linalg.norm(x)\n"
        "    r_wc = np.stack([x, np.cross(z, x), z], 1)\n"
        "    img, _ = render.render_textured_scene(cam, r_wc, eye)\n"
        "    pc = (lm - eye) @ r_wc\n"
        "    idx = np.nonzero(pc[:, 2] > 0.5)[0][:40]\n"
        "    uv = (pc[idx, :2] / pc[idx, 2:]).astype(np.float32)\n"
        "    ok = np.ones(len(idx), bool)\n"
        "    s.submit(KeyframePacket(\n"
        "        client_id=0, timestamp=float(i), p_wb=eye.astype(np.float32),\n"
        "        q_wb=quat_from_matrix_np(r_wc @ r_cb).astype(np.float32), r_cb=r_cb,\n"
        "        p_bc=np.zeros(3, np.float32), win_pts3d=lm[idx].astype(np.float32),\n"
        "        win_uv=uv, win_ids=idx, win_desc=desc[idx], win_valid=ok, ext_uv=uv,\n"
        "        ext_desc=desc[idx], ext_valid=ok, image=img))\n"
        "s.process()\n"
        f"n = s.save_mesh({str(tmp_path / 'mesh.ply')!r})\n"
        f"assert read_ply({str(tmp_path / 'mesh.ply')!r})[1] == n > 0\n"
        f"checkpoint.save_tsdf({str(tmp_path / 'map.npz')!r}, s.volume)\n"
        "s.close()\n"
        "print('jax' in sys.modules, 'cvids_tpu' in sys.modules, s.depth_maps_published)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["False", "False", "2"], res.stdout


def _one_thread(fn, **kw):
    """fn(**kw) on one intra-op thread (16 small renders and their FAST and
    BRIEF: many threads slow them several times over when xdist workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(**kw)
    finally:
        torch.set_num_threads(n)


def _one_frame_root(tmp_path) -> str:
    """A one-frame EuRoC-format sequence at 64x48 and a small DBoW2 binary
    vocabulary beside it: enough for an agent or an app to start."""
    from cvids_tpu_torch.io import euroc_synth
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.utils.config import AgentConfig, CameraConfig

    root = str(tmp_path / "seq")
    cam = CameraConfig(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
    euroc_synth.write_euroc_sequence(root, cfg=AgentConfig(camera=cam, max_features=8),
                                     duration=0.0, cam_rate=20.0, num_landmarks=20)
    vocab.save_dbow_binary(str(tmp_path / "tree.bin"),
                           vocab.synthesize_tree_vocabulary(k=4, levels=2))
    return root


def _app(main, argv, **kw):
    """Run an app's `main` (with `--device` when given); returns the
    `CollaborativePoseGraph` it built."""
    from cvids_tpu_torch.server import posegraph

    made = []

    class Recording(posegraph.CollaborativePoseGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(posegraph, "CollaborativePoseGraph", Recording)
        assert main(argv + (["--device", str(kw["device"])] if "device" in kw else [])) == 0
    return made[0]


def _agent(root, **kw):
    """`apps.agent_process.run_agent` on `root`, publishing to a socket
    server in this process; returns its front-end."""
    from cvids_tpu_torch.apps import agent_process
    from cvids_tpu_torch.io import transport

    srv = transport.CollaborativeSocketServer(lambda pkt: None)
    try:
        return agent_process.run_agent(root, 0, srv.port, **kw)
    finally:
        srv.stop()


def _device_owners(tmp_path):
    """(name, constructor taking a device) for every entry point of the port
    that owns device state, every helper that makes tensors from nothing or
    from host data, the agent process and the apps."""
    from cvids_tpu_torch.apps import run_euroc, run_synthetic
    from cvids_tpu_torch.mapping.tsdf import TsdfConfig, TsdfVolume
    from cvids_tpu_torch.ops import depth_filter, hamming, ransac
    from cvids_tpu_torch.server import pipeline, posegraph, vocab
    from cvids_tpu_torch.utils.config import AgentConfig, CameraConfig
    from cvids_tpu_torch.vio.frontend import AgentFrontend

    tree = vocab.synthesize_tree_vocabulary(k=4, levels=2)
    cam = CameraConfig(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
    descs = np.random.default_rng(0).integers(0, 2 ** 32, (64, 8), dtype=np.uint32)
    small = posegraph.ServerConfig(kf_capacity=16, max_win=8, max_ext=8)
    pcfg = pipeline.PipelineConfig(server=small, tsdf=TsdfConfig(capacity=8),
                                   dense_enabled=False)
    return {
        "CollaborativeServer": lambda **kw: pipeline.CollaborativeServer(tree, pcfg, **kw),
        "CollaborativePoseGraph": lambda **kw: posegraph.CollaborativePoseGraph(tree, small, **kw),
        "TsdfVolume": lambda **kw: TsdfVolume(TsdfConfig(capacity=8), **kw),
        "SparseBowDatabase": lambda **kw: vocab.SparseBowDatabase(tree, capacity=8, **kw),
        "train_vocabulary": lambda **kw: vocab.train_vocabulary(descs, k=2, levels=2, **kw),
        "init_state": lambda **kw: depth_filter.init_state(4, 6, **kw),
        "descriptors_to_torch": lambda **kw: hamming.descriptors_to_torch(descs, **kw),
        "gumbel_noise": lambda **kw: ransac.gumbel_noise(
            8, 16, torch.Generator().manual_seed(0), **kw),
        "AgentFrontend": lambda **kw: AgentFrontend(AgentConfig(camera=cam, max_features=8), **kw),
        "generic_vocabulary": lambda **kw: _one_thread(vocab.generic_vocabulary, k=2, levels=2,
                                                       seed=1, **kw),
        "agent_process": lambda **kw: _agent(_one_frame_root(tmp_path), **kw),
        "run_synthetic": lambda **kw: _app(run_synthetic.main, ["--agents", "1", "--duration",
                                                                "2", "--landmarks", "60"], **kw),
        "run_euroc": lambda **kw: _app(run_euroc.main, [
            "--seq", _one_frame_root(tmp_path), "--vocab", str(tmp_path / "tree.bin")], **kw),
    }


@pytest.mark.parametrize("name", ["default_device", "CollaborativeServer",
                                  "CollaborativePoseGraph", "TsdfVolume",
                                  "SparseBowDatabase", "train_vocabulary",
                                  "init_state", "descriptors_to_torch",
                                  "gumbel_noise", "AgentFrontend", "generic_vocabulary",
                                  "agent_process", "run_synthetic", "run_euroc"])
def test_default_device_is_the_card(name, monkeypatch, tmp_path):
    """With no device given, every entry point that owns device state, and
    every helper that makes tensors from nothing or from host data, asks
    for the card: without one it raises and names the remedy (no silent
    CPU); with device="cpu" it builds, on the CPU. The agent process and
    the apps (`cvids_tpu_torch/apps`) likewise, unless given `--device`."""
    import cvids_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name == "default_device":
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cvids_tpu_torch.default_device()
        assert cvids_tpu_torch.resolve_device("cpu") == torch.device("cpu")
        return
    build = _device_owners(tmp_path)[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()
    ran_on = []     # generic_vocabulary's FAST and BRIEF inputs' devices
    if name == "generic_vocabulary":
        from cvids_tpu_torch.ops import brief, fast
        from cvids_tpu_torch.server import vocab

        def recording(fn):
            def call(img, *args, **kwargs):
                ran_on.append(img.device)
                return fn(img, *args, **kwargs)
            return call

        monkeypatch.setattr(vocab, "_GENERIC_CACHE", {})
        monkeypatch.setattr(fast, "fast_score_map", recording(fast.fast_score_map))
        monkeypatch.setattr(brief, "compute_brief", recording(brief.compute_brief))
    obj = build(device="cpu")
    where = {"CollaborativeServer": lambda o: o.volume.pool.sdf.device,
             "CollaborativePoseGraph": lambda o: o.db.ids.device,
             "TsdfVolume": lambda o: o.pool.sdf.device,
             "SparseBowDatabase": lambda o: o.ids.device,
             "train_vocabulary": lambda o: o.weights.device,
             "init_state": lambda o: o.mu.device,
             "descriptors_to_torch": lambda o: o.device,
             "gumbel_noise": lambda o: o.device,
             "AgentFrontend": lambda o: o.state.lm.device,
             "agent_process": lambda o: o.state.lm.device,
             "run_synthetic": lambda o: o.db.vectors.device,
             "run_euroc": lambda o: o.db.ids.device,
             # a host tree: FAST and BRIEF on 8 worlds x 2 views, each call
             # on the device asked for
             "generic_vocabulary": lambda o: ran_on[0] if len(set(ran_on)) == 1 else ran_on}[name](obj)
    assert where == torch.device("cpu")
    assert name != "generic_vocabulary" or len(ran_on) == 32
    if hasattr(obj, "close"):
        obj.close()

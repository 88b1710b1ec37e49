"""The port's IMU preintegration, VI bootstrap and sliding-window BA against
`cvids_tpu.vio` on the CPU, and `test_vio.py`'s ground-truth cases re-run
on the port.

The same inputs (test_vio.py's synthetic sequences, made from numpy seeds)
go through both packages, carried across by `interop`. Tolerances:
preintegration fields within 1e-4 relative to each field's largest entry
(the port evaluates the recursion by scans, the JAX package step by step);
residuals and the bootstrap within 1e-4 relative; triangulation within 5e-4
relative, landmark parallax within 1e-3 rad; the solvers' poses within 1e-3 m, landmarks within 1e-2 m and costs
within 1e-3 relative after 12 iterations; the marginalization priors as
JᵀJ and Jᵀr0 (their square roots' eigenvector signs are free) within 1e-3
relative. The camera-only marginalization's normal equations, assembled
from the closed-form Jacobians block by block, are held to `jacfwd` over
the whole tangent (the form it replaced) within 1e-6 relative, and its
prior to the dense elimination of the `jacfwd` system within 1e-3. The
host copies (synthetic sequences, metrics) are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from cvids_tpu.io import synthetic as jsyn
from cvids_tpu.utils import metrics as jmetrics
from cvids_tpu.vio import imu as jimu
from cvids_tpu.vio import initializer as jinit
from cvids_tpu.vio import window_ba as jba
from cvids_tpu_torch import interop
from cvids_tpu_torch.geometry import quat_inverse, quat_multiply, quat_normalize, so3_log
from cvids_tpu_torch.io import synthetic as tsyn
from cvids_tpu_torch.utils import metrics as tmetrics
from cvids_tpu_torch.vio import imu as timu
from cvids_tpu_torch.vio import initializer as tinit
from cvids_tpu_torch.vio import window_ba as tba
from test_vio import _build_problem, make_seq

REL = 1e-4
R_CB = torch.tensor([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
P_BC = torch.zeros(3)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run thousands of small ops, which
    many threads slow down several times over when xdist workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, np.abs(want).max()))


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _preint_both(seq, bg, ba):
    g, a, dt, v = jsyn.imu_slices(seq)
    f32 = lambda x: jnp.asarray(x, jnp.float32)      # noqa: E731
    pj = jax.vmap(lambda gg, aa, dd, vv: jimu.preintegrate(
        f32(gg), f32(aa), f32(dd), f32(bg), f32(ba), sample_valid=jnp.asarray(vv)))(g, a, dt, v)
    pt = timu.preintegrate(_t(g, torch.float32), _t(a, torch.float32), _t(dt, torch.float32),
                           _t(bg, torch.float32), _t(ba, torch.float32), sample_valid=_t(v))
    return pj, pt


def _problem(seed=3, perturb=0.1, duration=5.0, n_lm=40, rng_seed=None):
    """test_vio.py's window problem with unit quaternions, in both packages."""
    seq = make_seq(duration=duration, num_landmarks=n_lm, seed=seed)
    state, meas = _build_problem(seq, perturb=perturb,
                                 rng=np.random.default_rng(seed if rng_seed is None else rng_seed))
    state = state._replace(q=state.q / jnp.linalg.norm(state.q, axis=-1, keepdims=True))
    return seq, state, meas, tba.WindowState(*interop.window_state_to_torch(_np_tree(state), "cpu")), \
        _meas_to_torch(meas)


def _meas_to_torch(meas):
    return tba.WindowMeasurements(
        obs=_t(meas.obs), vis=_t(meas.vis), pre=interop.preintegrated_to_torch(_np_tree(meas.pre), "cpu"),
        pre_valid=_t(meas.pre_valid), r_cb=_t(meas.r_cb), p_bc=_t(meas.p_bc),
        pix_weight=meas.pix_weight, huber_delta=meas.huber_delta, bias_weight=meas.bias_weight,
        prior=None, anchor_p=_t(meas.anchor_p), anchor_yaw=_t(meas.anchor_yaw))


# ---------- IMU ----------

@pytest.mark.parametrize("n_valid", [83, 256])
def test_preintegrate_matches(n_valid):
    rng = np.random.default_rng(0)
    n = 256
    g = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    a = (rng.normal(0, 1, (n, 3)) + [0, 0, 9.81]).astype(np.float32)
    dt = np.full(n, 0.005, np.float32)
    v = np.arange(n) < n_valid
    g[~v] = 0.0
    a[~v] = 0.0
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.02, 0.01, -0.03], np.float32)
    noise = jimu.ImuNoise(acc_n=0.005, gyr_n=2e-4)
    pj = jimu.preintegrate(*(jnp.asarray(x) for x in (g, a, dt, bg, ba)), noise=noise,
                           sample_valid=jnp.asarray(v))
    pt = timu.preintegrate(*(_t(x) for x in (g, a, dt, bg, ba)), noise=timu.ImuNoise(*noise),
                           sample_valid=_t(v))
    for f in jimu.Preintegrated._fields:
        _close(getattr(pt, f), getattr(pj, f))


def test_preintegrate_batched_residual_and_bias_correction():
    seq = make_seq(duration=3.0, gyr_noise=0.0, acc_noise=0.0)
    pj, pt = _preint_both(seq, np.zeros(3), np.zeros(3))
    for f in jimu.Preintegrated._fields:
        _close(getattr(pt, f), getattr(pj, f))
    k = len(seq.times_kf)
    f32 = lambda x: np.asarray(x, np.float32)        # noqa: E731
    bgs = np.random.default_rng(1).normal(0, 0.01, (2, 3)).astype(np.float32)
    states = [f32(seq.p_gt), f32(seq.q_gt), f32(seq.v_gt)]
    for i in (0, k // 2, k - 2):
        pre_j = jax.tree_util.tree_map(lambda x: x[i], pj)
        pre_t = timu.Preintegrated(*(x[i] for x in pt))
        args = [states[0][i], states[1][i], states[2][i], bgs[0], bgs[1],
                states[0][i + 1], states[1][i + 1], states[2][i + 1], bgs[0] + 1e-3, bgs[1]]
        want = jimu.imu_residual(pre_j, *(jnp.asarray(x) for x in args), weight_bias=10.0)
        got = timu.imu_residual(pre_t, *(_t(x) for x in args), weight_bias=10.0)
        _close(got, want, 1e-3)
    # batched residual and bias correction
    sl = slice(0, k - 1)
    args = [states[0][sl], states[1][sl], states[2][sl], np.zeros((k - 1, 3), np.float32),
            np.zeros((k - 1, 3), np.float32), states[0][1:], states[1][1:], states[2][1:],
            np.zeros((k - 1, 3), np.float32), np.zeros((k - 1, 3), np.float32)]
    want = jax.vmap(lambda pre, *a: jimu.imu_residual(pre, *a))(pj, *(jnp.asarray(x) for x in args))
    _close(timu.imu_residual(pt, *(_t(x) for x in args)), want, 1e-3)
    bj = jax.vmap(lambda p_: jimu.bias_corrected(p_, jnp.asarray(bgs[0]), jnp.asarray(bgs[1])))(pj)
    bt = timu.bias_corrected(pt, _t(bgs[0]), _t(bgs[1]))
    for f in ("dp", "dv", "dq", "bg", "ba"):
        _close(getattr(bt, f), getattr(bj, f))


def test_preintegration_consistent_with_ground_truth():
    """test_vio.py's case on the port: noise-free IMU at the true biases,
    the residual at the ground truth is finite and its bias part 0."""
    seq = tsyn.generate_sequence(tsyn.Trajectory.circle(radius=5.0, omega=0.5), duration=3.0,
                                 kf_rate=2.0, num_landmarks=40, seed=0, gyr_noise=0.0,
                                 acc_noise=0.0)
    g, a, dt, v = tsyn.imu_slices(seq)
    bg, ba = _t(seq.bg_true, torch.float32), _t(seq.ba_true, torch.float32)
    pre = timu.preintegrate(_t(g, torch.float32), _t(a, torch.float32), _t(dt, torch.float32),
                            bg, ba, sample_valid=_t(v))
    k = len(seq.times_kf)
    f32 = lambda x: _t(x, torch.float32)             # noqa: E731
    for i in [0, k // 2, k - 2]:
        r = timu.imu_residual(timu.Preintegrated(*(x[i] for x in pre)),
                              f32(seq.p_gt[i]), f32(seq.q_gt[i]), f32(seq.v_gt[i]), bg, ba,
                              f32(seq.p_gt[i + 1]), f32(seq.q_gt[i + 1]), f32(seq.v_gt[i + 1]),
                              bg, ba)
        assert torch.abs(r[9:]).max() < 1e-5
        assert torch.isfinite(r).all()


def test_preintegration_bias_jacobian():
    """test_vio.py's case on the port: the first-order correction predicts
    a re-preintegration at a shifted gyro bias."""
    seq = tsyn.generate_sequence(tsyn.Trajectory.circle(radius=5.0, omega=0.5), duration=2.0,
                                 kf_rate=2.0, num_landmarks=40, seed=0, gyr_noise=0.0,
                                 acc_noise=0.0)
    g, a, dt, v = tsyn.imu_slices(seq)
    bg0, ba0 = _t(seq.bg_true, torch.float32), _t(seq.ba_true, torch.float32)
    dbg = torch.tensor([0.002, -0.001, 0.0015])
    i = 1
    args = (_t(g[i], torch.float32), _t(a[i], torch.float32), _t(dt[i], torch.float32))
    pre0 = timu.preintegrate(*args, bg0, ba0, sample_valid=_t(v[i]))
    pre1 = timu.preintegrate(*args, bg0 + dbg, ba0, sample_valid=_t(v[i]))
    corr = timu.bias_corrected(pre0, bg0 + dbg, ba0)
    torch.testing.assert_close(corr.dp, pre1.dp, atol=5e-4, rtol=0)
    torch.testing.assert_close(corr.dv, pre1.dv, atol=5e-4, rtol=0)
    dq_err = so3_log(quat_multiply(quat_inverse(pre1.dq), corr.dq))
    assert torch.abs(dq_err).max() < 5e-4


# ---------- initializer ----------

def test_initializer_matches_and_recovers_truth():
    """The bootstrap on test_vio.py's case in both packages: gyro bias and
    the alignment agree; the port recovers the truth to that test's bounds."""
    seq = make_seq(duration=6.0, num_landmarks=30, seed=5, bg=(0.02, -0.015, 0.01))
    k = len(seq.times_kf)
    pj, pt = _preint_both(seq, np.zeros(3), np.zeros(3))
    valid = np.ones(k - 1, bool)
    valid[3] = False
    q = np.asarray(seq.q_gt, np.float32)
    bg_j = jinit.calibrate_gyro_bias(jnp.asarray(q), pj, jnp.asarray(valid))
    bg_t = tinit.calibrate_gyro_bias(_t(q), pt, _t(valid))
    _close(bg_t, bg_j, 1e-3)
    np.testing.assert_allclose(bg_t.numpy(), seq.bg_true, atol=3e-3)
    pj2, pt2 = _preint_both(seq, np.asarray(bg_j, np.float32), np.zeros(3))
    s_true = 3.7
    p_vis = np.asarray(seq.p_gt / s_true, np.float32)
    rj = jinit.linear_alignment(jnp.asarray(p_vis), jnp.asarray(q), pj2, jnp.asarray(valid))
    rt = tinit.linear_alignment(_t(p_vis), _t(q), pt2, _t(valid))
    assert bool(rt.ok) and bool(rj.ok)
    for f in ("scale", "gravity", "v", "g_free_norm"):
        _close(getattr(rt, f), getattr(rj, f), 1e-3)
    assert abs(float(rt.scale) - s_true) / s_true < 0.05
    np.testing.assert_allclose(rt.gravity.numpy(), [0, 0, -9.81], atol=0.25)
    assert np.median(np.linalg.norm(rt.v.numpy() - seq.v_gt, axis=1)) < 0.15


# ---------- window BA ----------

def test_triangulate_and_landmark_quality():
    seq = make_seq(duration=4.0, num_landmarks=20, gyr_noise=0.0, acc_noise=0.0,
                   pix_noise_norm=0.0)
    p = np.asarray(seq.p_gt, np.float32)
    q = np.asarray(seq.q_gt, np.float32)
    obs = np.nan_to_num(seq.obs).astype(np.float32)
    vis = seq.vis
    pts, oks = tba.triangulate(_t(p), _t(q), _t(obs), _t(vis), R_CB, P_BC)
    for lid in range(20):
        pj, okj = jba.triangulate(jnp.asarray(p), jnp.asarray(q), jnp.asarray(obs[:, lid]),
                                  jnp.asarray(vis[:, lid]), jnp.asarray(R_CB.numpy()),
                                  jnp.zeros(3))
        assert bool(oks[lid]) == bool(okj)
        if vis[:, lid].sum() >= 3:
            np.testing.assert_allclose(pts[lid].numpy(), np.asarray(pj), rtol=5e-4, atol=1e-4)
            np.testing.assert_allclose(pts[lid].numpy(), seq.landmarks[lid], atol=5e-3)
        pt1, ok1 = tba.triangulate(_t(p), _t(q), _t(obs[:, lid]), _t(vis[:, lid]), R_CB, P_BC)
        assert bool(ok1) == bool(okj) and pt1.shape == (3,)
    lm = np.asarray(seq.landmarks, np.float32)
    kf_valid = np.ones(len(p), bool)
    kf_valid[2] = False
    want = jba.landmark_quality(jnp.asarray(p), jnp.asarray(q), jnp.asarray(kf_valid),
                                jnp.asarray(obs), jnp.asarray(vis), jnp.asarray(lm),
                                jnp.asarray(R_CB.numpy()), jnp.zeros(3))
    got = tba.landmark_quality(_t(p), _t(q), _t(kf_valid), _t(obs), _t(vis), _t(lm), R_CB, P_BC)
    # parallax is an arccos near 1: float32 rounding of the cosine moves a
    # zero angle by up to ~5e-4 rad
    for a, b, tol in zip(got, want, (1e-4, 1e-5, 1e-3)):
        b = np.asarray(b)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a.numpy()), fin)
        np.testing.assert_allclose(a.numpy()[fin], b[fin], atol=tol)


def test_reprojection_jacobians_equal_jacfwd():
    """The fast solver's closed-form Jacobians (Huber weight included) equal
    `jacfwd` of the residual over the camera and landmark tangents."""
    _, _, _, st, m = _problem(perturb=0.1)
    m = m._replace(huber_delta=1.0)          # many residuals beyond the Huber knee
    k, l = st.p.shape[0], st.lm.shape[0]

    def f(dx):
        s2 = tba.retract_cam(st, dx[:15 * k])
        return tba.reprojection_residuals(s2._replace(lm=s2.lm + dx[15 * k:].reshape(l, 3)), m)

    jac = jacfwd(f)(torch.zeros(15 * k + 3 * l))
    r, j_pose, j_lm = tba.reprojection_jacobians(st, m)
    r0 = f(torch.zeros(15 * k + 3 * l))
    assert float((r - r0).abs().max()) < 1e-5 * float(r0.abs().max())
    ref_dp = torch.stack([jac[kk, :, :, 3 * kk:3 * kk + 3] for kk in range(k)])
    ref_dth = torch.stack([jac[kk, :, :, 3 * k + 3 * kk:3 * k + 3 * kk + 3] for kk in range(k)])
    ref_lm = torch.stack([jac[:, li, :, 15 * k + 3 * li:15 * k + 3 * li + 3] for li in range(l)], 1)
    scale = float(jac.abs().max())
    assert scale > 10
    for a, b in ((j_pose[..., :3], ref_dp), (j_pose[..., 3:], ref_dth), (j_lm, ref_lm)):
        assert float((a - b).abs().max()) < 1e-5 * scale


@pytest.mark.parametrize("solver", ["solve_window_fast", "solve_window", "solve_window_schur"])
def test_solvers_match(solver):
    seq, state, meas, st, m = _problem(perturb=0.1)
    sj, cj = getattr(jba, solver)(state, meas, iters=12)
    s2, c2 = getattr(tba, solver)(st, m, iters=12)
    np.testing.assert_allclose(s2.p.numpy(), np.asarray(sj.p), atol=1e-3)
    np.testing.assert_allclose(s2.lm.numpy(), np.asarray(sj.lm), atol=1e-2)
    np.testing.assert_allclose(float(c2), float(cj), rtol=1e-3)
    ate = [np.sqrt(np.mean(np.linalg.norm(p - seq.p_gt, axis=1) ** 2))
           for p in (s2.p.numpy(), np.asarray(sj.p))]
    assert ate[0] < ate[1] + 1e-3


def test_marginalization_priors_match():
    _, state, meas, st, m = _problem(seed=5, perturb=0.05, duration=3.0, n_lm=30)
    sj, _ = jba.solve_window_fast(state, meas, iters=8)
    s_t = tba.WindowState(*interop.window_state_to_torch(_np_tree(sj), "cpu"))
    dying = np.asarray(meas.vis[0]) & ~np.asarray(meas.vis[1:]).any(0)
    jj, rj = (np.asarray(x, np.float64) for x in jba.marginalize_prior_cam(sj, meas, jnp.asarray(dying)))
    jt, rt = (x.numpy().astype(np.float64) for x in tba.marginalize_prior_cam(s_t, m, _t(dying)))
    _close(jt.T @ jt, jj.T @ jj, 1e-3)
    _close(jt.T @ rt, jj.T @ rj, 1e-3)
    # the full-tangent prior of test_vio.py's case, first keyframe marginalized
    k, l = state.p.shape[0], state.lm.shape[0]
    mask = np.zeros(15 * k + 3 * l, bool)
    off = 0
    for key in ("dba", "dbg", "dlm", "dp", "dth", "dv"):
        if key != "dlm":
            mask[off:off + 3] = True
        off += 3 * (l if key == "dlm" else k)
    jj, rj = (np.asarray(x, np.float64) for x in jba.marginalize_prior(sj, meas, jnp.asarray(mask)))
    jt, rt = (x.numpy().astype(np.float64) for x in tba.marginalize_prior(s_t, m, _t(mask)))
    _close(jt.T @ jt, jj.T @ jj, 1e-3)
    _close(jt.T @ rt, jj.T @ rj, 1e-3)
    assert np.abs(jt[:, mask]).max() < 1e-3 * max(1.0, np.abs(jt).max())


def _slot0_residuals_jacfwd_form(state, meas, dying):
    """The marginalization's factor set as one residual vector, as the
    port computed it before its Jacobians became closed form: slot-0
    reprojections of the dying landmarks, then the slot-0 IMU, bias and
    prior rows."""
    from cvids_tpu_torch.geometry import quat_to_matrix

    r_bw0 = quat_to_matrix(quat_inverse(state.q[0]))
    pts_c = ((state.lm - state.p[0][None]) @ r_bw0.T - meas.p_bc[None]) @ meas.r_cb.T
    z = pts_c[:, 2]
    proj = pts_c[:, :2] / tba._safe(z)[:, None]
    valid = meas.vis[0] & dying & (z > 0.05) & state.kf_valid[0] & state.lm_valid
    r = (proj - torch.nan_to_num(meas.obs[0])) * meas.pix_weight
    rn = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    w = torch.sqrt(torch.clamp(meas.huber_delta / torch.clamp(rn, min=1e-9), max=1.0))
    r_proj = torch.where(valid[:, None], r * w, torch.zeros(())).reshape(-1)
    return torch.cat([r_proj] + tba._slot0_imu_and_bias(state, meas))


@pytest.mark.parametrize("with_prior", [False, True])
def test_cam_marginalization_closed_form_matches_jacfwd(with_prior):
    """`marg_normal_equations` (closed-form reprojection blocks, `jacfwd`
    over the camera tangent only) against `jacfwd` over the camera tangent
    and every landmark, as JᵀJ and Jᵀr0 [measured: JᵀJ equal, Jᵀr0 8e-8];
    the block-wise float64 Schur complement's prior against the dense
    float32 one's [1.7e-4, the dense float32 elimination's own distance
    from float64]. With a previous prior in the factor set too."""
    _, _, _, st, m = _problem(seed=5, perturb=0.05, duration=3.0, n_lm=30)
    st, _ = tba.solve_window_fast(st, m, iters=8)
    dying = m.vis[0] & ~m.vis[1:].any(0)
    if with_prior:
        j0, r0 = tba.marginalize_prior_cam(st, m, dying)
        m = m._replace(prior=tba.CamPriorFactor(j=j0, r0=r0, p=st.p, q=st.q, v=st.v,
                                                bg=st.bg, ba=st.ba))
        st = st._replace(p=st.p + 0.01)
    k, l = st.p.shape[0], st.lm.shape[0]
    pc = 15 * k

    def res_of(dcl):
        s_ = tba.retract_cam(st, dcl[:pc])
        return _slot0_residuals_jacfwd_form(s_._replace(lm=s_.lm + dcl[pc:].reshape(l, 3)),
                                            m, dying)

    z = torch.zeros(pc + 3 * l)
    jmat = jacfwd(res_of)(z)
    h_ref, g_ref = jmat.T @ jmat, jmat.T @ res_of(z)
    h_cc, g_c, h_pl, h_ll, g_l = tba.marg_normal_equations(st, m, dying)
    h, g = torch.zeros_like(h_ref), torch.zeros_like(g_ref)
    h[:pc, :pc], g[:pc] = h_cc, g_c
    pose = torch.tensor([0, 1, 2, 3 * k, 3 * k + 1, 3 * k + 2])
    for i in range(l):
        blk = slice(pc + 3 * i, pc + 3 * i + 3)
        h[blk, blk], g[blk] = h_ll[i], g_l[i]
        h[pose[:, None], torch.arange(blk.start, blk.stop)[None]] = h_pl[:, i]
        h[torch.arange(blk.start, blk.stop)[:, None], pose[None]] = h_pl[:, i].T
    _close(h.numpy(), h_ref.numpy(), 1e-6)
    _close(g.numpy(), g_ref.numpy(), 1e-6)
    marg = torch.zeros(pc + 3 * l, dtype=torch.bool)
    for b in range(5):
        marg[3 * k * b:3 * k * b + 3] = True
    marg[pc:] = True
    jr, rr = (x.double().numpy() for x in tba._schur_prior(h_ref, g_ref, marg, 1e-8, keep_cols=pc))
    jt, rt = (x.double().numpy() for x in tba.marginalize_prior_cam(st, m, dying))
    _close(jt.T @ jt, jr.T @ jr, 1e-3)
    _close(jt.T @ rt, jr.T @ rr, 1e-3)


def test_window_ba_converges_to_ground_truth():
    """test_vio.py's case on the port (its world, perturbation and bounds;
    the fast solver, from unit quaternions)."""
    seq, _, _, st, m = _problem(seed=3, perturb=0.15, rng_seed=0)
    cost0 = 0.5 * float(torch.sum(tba._all_residuals(st, m) ** 2))
    st_f, cost_f = tba.solve_window_fast(st, m, iters=25)
    assert float(cost_f) < 0.1 * cost0
    ate = np.sqrt(np.mean(np.linalg.norm(st_f.p.numpy() - seq.p_gt, axis=1) ** 2))
    assert ate < 0.1
    np.testing.assert_allclose(st_f.bg[-1].numpy(), seq.bg_true, atol=5e-3)
    assert np.abs(st_f.ba[-1].numpy()).max() < 0.5


def test_cam_prior_marginalization():
    """test_vio.py's case on the port: the camera-only prior is finite,
    eliminates slot 0, pulls states toward the linearization point, and a
    full-tangent prior is rejected by the fast solver."""
    _, _, _, st, m = _problem(seed=5, perturb=0.05, duration=3.0, n_lm=30)
    st_f, _ = tba.solve_window_fast(st, m, iters=8)
    k = st_f.p.shape[0]
    dying = m.vis[0] & ~m.vis[1:].any(0)
    j, r0 = tba.marginalize_prior_cam(st_f, m, dying)
    assert j.shape == (15 * k, 15 * k)
    assert torch.isfinite(j).all() and torch.isfinite(r0).all()
    for b in range(5):
        o = 3 * k * b
        assert float(j[:, o:o + 3].abs().max()) < 1e-3 * max(1.0, float(j.abs().max()))
    prior = tba.CamPriorFactor(j=j, r0=r0, p=st_f.p, q=st_f.q, v=st_f.v, bg=st_f.bg, ba=st_f.ba)
    moved = st_f._replace(p=st_f.p + torch.tensor([0.3, 0.0, 0.0]) * (torch.arange(k) == 1)[:, None])
    assert float(torch.sum(tba._prior_residual(moved, prior) ** 2)) > \
        float(torch.sum(tba._prior_residual(st_f, prior) ** 2))
    # the prior carried across the packages: the same residual in both
    pj = jba.CamPriorFactor(*(jnp.asarray(x) for x in interop.cam_prior_to_numpy(prior)))
    sj = jba.WindowState(*(jnp.asarray(x) for x in interop.window_state_to_numpy(moved)))
    _close(tba._prior_residual(moved, prior), jba._prior_residual(sj, pj), 1e-3)
    full = tba.PriorFactor(j=torch.zeros(3, 15 * k + 3 * st.lm.shape[0]), r0=torch.zeros(3),
                           p=st_f.p, q=st_f.q, v=st_f.v, bg=st_f.bg, ba=st_f.ba, lm=st_f.lm)
    with pytest.raises(ValueError):
        tba.solve_window_fast(st_f, m._replace(prior=full))
    # the solve accepts its own camera-only prior
    s3, c3 = tba.solve_window_fast(st_f, m._replace(prior=prior), iters=4)
    assert torch.isfinite(c3)


# ---------- host copies and interop ----------

def test_synthetic_and_metrics_copies():
    kw = dict(duration=3.0, kf_rate=2.0, num_landmarks=30, seed=4, pix_noise_norm=0.001)
    want = jsyn.generate_sequence(jsyn.Trajectory.circle(radius=4.0, speed_mod=0.3), **kw)
    got = tsyn.generate_sequence(tsyn.Trajectory.circle(radius=4.0, speed_mod=0.3), **kw)
    for f in ("times_kf", "p_gt", "q_gt", "v_gt", "imu_t", "gyr", "acc", "bg_true", "ba_true",
              "landmarks", "obs", "vis"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for a, b in zip(tsyn.imu_slices(got, 64), jsyn.imu_slices(want, 64)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    est, gt = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    for align in ("none", "se3", "sim3", "yaw"):
        assert tmetrics.ate_rmse(est, gt, align) == jmetrics.ate_rmse(est, gt, align)
    for a, b in zip(tmetrics.umeyama(est, gt, True), jmetrics.umeyama(est, gt, True)):
        np.testing.assert_array_equal(a, b)
    assert tmetrics.rpe(est, gt, 2) == jmetrics.rpe(est, gt, 2)


def test_state_interop_round_trip():
    _, state, meas, st, _ = _problem(seed=2, duration=2.0, n_lm=10)
    back = interop.window_state_to_numpy(st)
    for a, b in zip(back, _np_tree(state)):
        np.testing.assert_array_equal(a, b)
    pre = interop.preintegrated_to_torch(_np_tree(meas.pre), "cpu")
    for a, b in zip(interop.preintegrated_to_numpy(pre), _np_tree(meas.pre)):
        np.testing.assert_array_equal(a, b)
    assert st.kf_valid.dtype == torch.bool and st.p.dtype == torch.float32
    q = quat_normalize(st.q)
    assert torch.allclose(torch.linalg.vector_norm(q, dim=-1), torch.ones(q.shape[0]))


def test_fast_solver_zero_residual_departure():
    """A departure ROADMAP names (found by dev/torch_probe_frontend_lockstep.py
    at 752x480): where one observation reprojects exactly onto its landmark
    (a zero residual, which a converging float32 solve reaches), the
    derivative of `jnp.linalg.norm` in the JAX package's per-landmark
    residual is 0/0. Its `jacfwd` Jacobian gets NaN rows, the reduced system
    is NaN, and its fast solve rejects every LM step from there on; the
    port's closed-form Jacobians stay finite and its solve descends. With
    the observation moved off zero by 1e-6 the JAX solve descends too."""
    _, state, meas, st, m = _problem(perturb=0.1)
    # keyframe 0 at the identity, landmark 0 two metres ahead on its optical
    # axis, observed at the image centre: every product in the projection is
    # exact, so the residual is exactly zero whatever the order of operations
    p0 = np.array([0.5, -1.25, 1.0], np.float32)
    q0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    lm0 = p0 + np.array([2.0, 0.0, 0.0], np.float32)
    obs = np.asarray(meas.obs).copy()
    obs[0, 0] = 0.0
    vis = np.asarray(meas.vis).copy()
    vis[0, 0] = vis[1, 0] = True
    lm_valid = np.asarray(state.lm_valid).copy()
    lm_valid[0] = True
    state_j = state._replace(p=state.p.at[0].set(p0), q=state.q.at[0].set(q0),
                             lm=state.lm.at[0].set(lm0), lm_valid=jnp.asarray(lm_valid))
    meas_j = meas._replace(obs=jnp.asarray(obs), vis=jnp.asarray(vis))
    st_t = tba.WindowState(*interop.window_state_to_torch(_np_tree(state_j), "cpu"))
    m_t = m._replace(obs=_t(obs), vis=_t(vis))
    assert float(tba.reprojection_residuals(st_t, m_t)[0, 0].abs().max()) == 0.0

    k = state_j.p.shape[0]

    def res(dcl):
        s2 = jba.retract_cam(state_j, dcl[:15 * k])
        return jba._proj_residual_one_lm(s2.p, s2.q, state_j.kf_valid, state_j.lm_valid[0],
                                         meas_j.r_cb, meas_j.p_bc, meas_j.pix_weight,
                                         meas_j.huber_delta, state_j.lm[0] + dcl[15 * k:],
                                         meas_j.obs[:, 0], meas_j.vis[:, 0])

    jac = np.asarray(jax.jacfwd(res)(jnp.zeros(15 * k + 3)))
    assert np.isnan(jac[:2]).any() and np.isfinite(jac[2:]).all()
    _, j_pose, j_lm = tba.reprojection_jacobians(st_t, m_t)
    assert bool(torch.isfinite(j_pose).all()) and bool(torch.isfinite(j_lm).all())

    cost0 = 0.5 * float(torch.sum(tba._all_residuals(st_t, m_t) ** 2))
    sj, cj = jba.solve_window_fast(state_j, meas_j, iters=12)
    np.testing.assert_array_equal(np.asarray(sj.p), np.asarray(state_j.p))    # no step taken
    assert float(cj) == pytest.approx(cost0, rel=1e-5)
    s2, c2 = tba.solve_window_fast(st_t, m_t, iters=12)
    assert bool(torch.isfinite(s2.p).all()) and float(c2) < 0.5 * cost0
    obs[0, 0, 0] = 1e-6
    _, cn = jba.solve_window_fast(state_j, meas_j._replace(obs=jnp.asarray(obs)), iters=12)
    assert float(cn) < 0.5 * cost0

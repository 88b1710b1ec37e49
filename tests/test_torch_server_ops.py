"""Port parity for the server slice's building blocks against `cvids_tpu`
on the same numpy inputs (CPU): geometry, descriptor matching, RANSAC,
the BoW vocabularies and databases, and PCM.

RANSAC gets JAX's own Gumbel noise (`jax.random.gumbel` of the key the JAX
function would split), so both packages sample the same minimal sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu import native as jnative
from cvids_tpu.geometry import hostmath as jhm
from cvids_tpu.geometry import rotations as jrot
from cvids_tpu.geometry import se3 as jse3
from cvids_tpu.ops import hamming as jham
from cvids_tpu.ops import ransac as jransac
from cvids_tpu.server import pcm as jpcm
from cvids_tpu.server import vocab as jvoc
from cvids_tpu.server.posegraph import _match_and_pnp as jax_match_and_pnp
from cvids_tpu_torch import interop
from cvids_tpu_torch import native as tnative
from cvids_tpu_torch.geometry import hostmath as thm
from cvids_tpu_torch.geometry import rotations as trot
from cvids_tpu_torch.geometry import se3 as tse3
from cvids_tpu_torch.ops import hamming as tham
from cvids_tpu_torch.ops import ransac as transac
from cvids_tpu_torch.server import pcm as tpcm
from cvids_tpu_torch.server import vocab as tvoc
from cvids_tpu_torch.server.posegraph import _match_and_pnp as torch_match_and_pnp
from test_pcm_vocab import make_edges
from test_ransac import make_pnp_problem
from test_torch_native import wait_for_reference_native


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _td(desc):
    return tham.descriptors_to_torch(desc, device="cpu")


# ---------- geometry ----------


def test_rotation_helpers(rng):
    w = (rng.normal(size=(7, 3)) * 0.8).astype(np.float32)
    w[0] = 0.0                                              # the Taylor branch
    q_j = jrot.so3_exp(jnp.asarray(w))
    q_t = trot.so3_exp(_t(w))
    np.testing.assert_allclose(_np(q_t), np.asarray(q_j), rtol=1e-6, atol=1e-7)
    m_j = jrot.quat_to_matrix(q_j)
    m_t = trot.quat_to_matrix(q_t)
    np.testing.assert_allclose(_np(m_t), np.asarray(m_j), rtol=1e-6, atol=1e-6)
    # Shepperd's method picks the same pivot: the same quaternion
    np.testing.assert_allclose(_np(trot.matrix_to_quat(_t(np.asarray(m_j)))),
                               np.asarray(jrot.matrix_to_quat(m_j)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(trot.so3_hat(_t(w))), np.asarray(jrot.so3_hat(jnp.asarray(w))))


def test_se3(rng):
    def pose(mod, q, t, conv):
        return mod.Pose(conv(q), conv(t))

    q = np.asarray(jrot.so3_exp(jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32))))
    t = rng.normal(size=(4, 3)).astype(np.float32)
    a_j, b_j = pose(jse3, q[:2], t[:2], jnp.asarray), pose(jse3, q[2:], t[2:], jnp.asarray)
    a_t, b_t = pose(tse3, q[:2], t[:2], _t), pose(tse3, q[2:], t[2:], _t)
    for fj, ft in ((jse3.compose(a_j, b_j), tse3.compose(a_t, b_t)),
                   (jse3.inverse(a_j), tse3.inverse(a_t)),
                   (jse3.between(a_j, b_j), tse3.between(a_t, b_t))):
        np.testing.assert_allclose(_np(ft.q), np.asarray(fj.q), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(ft.t), np.asarray(fj.t), rtol=1e-5, atol=1e-6)


def test_hostmath_is_the_reference_numpy(rng):
    q = rng.normal(size=(6, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    m = jhm.quat_to_matrix_np(q)
    ypr = rng.uniform(-3, 3, (6, 3))
    for name, arg in (("quat_to_matrix_np", q), ("matrix_to_quat_np", m),
                      ("yaw_of_quat_np", q), ("r_to_ypr_np", m), ("ypr_to_r_np", ypr),
                      ("rot_z_np", ypr[:, 0]), ("wrap_angle_np", ypr[:, 0] * 3)):
        np.testing.assert_array_equal(getattr(thm, name)(arg), getattr(jhm, name)(arg), err_msg=name)


# ---------- descriptor matching ----------


@pytest.mark.parametrize("cross_check", [False, True])
@pytest.mark.parametrize("m", [1, 97])
def test_match_descriptors(rng, m, cross_check):
    n = 60
    b = _desc(rng, m)
    a = _desc(rng, n)
    k = min(n, m)
    a[:k] = b[:k] ^ (rng.random((k, 8)) < 0.05).astype(np.uint32)   # near copies
    a[k // 2:k // 2 + 3] = b[0]                      # several rows want column 0
    a_valid = rng.random(n) > 0.1
    b_valid = rng.random(m) > 0.1
    ref = jham.match_descriptors(jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_valid),
                                 jnp.asarray(b_valid), cross_check=cross_check)
    out = tham.match_descriptors(_td(a), _td(b), _t(a_valid), _t(b_valid),
                                 cross_check=cross_check)
    # integer distances: equal indices, distances and flags
    np.testing.assert_array_equal(_np(out.indices), np.asarray(ref.indices))
    np.testing.assert_array_equal(_np(out.distances), np.asarray(ref.distances))
    np.testing.assert_array_equal(_np(out.valid), np.asarray(ref.valid))
    assert _np(out.valid).sum() > 0


def test_pack_unpack_bits(rng):
    bits = (rng.random((5, 256)) < 0.5).astype(np.uint8)
    words = tham.pack_bits(_t(bits))
    np.testing.assert_array_equal(_np(words).view(np.uint32),
                                  np.asarray(jham.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(_np(tham.unpack_bits(words)), bits)


# ---------- RANSAC ----------


def _pnp_counts(mod, rs, ts, pts, obs, valid, thresh=10.0 / 460.0):
    if mod is jransac:
        errs = jax.vmap(lambda r, t: jransac._reproj_residuals(r, t, pts, obs))(rs, ts)
        return np.asarray(jnp.sum((errs < thresh) & valid[None], axis=1))
    errs = transac._reproj_residuals(rs, ts, pts, obs)
    return _np(torch.sum((errs < thresh) & valid[None], dim=1))


_F32_U = 2.0 ** -24               # float32 unit roundoff


def _nullspace_condition(a):
    """λmax / (λ2 - λ1) of AᵀA in float64: how far float32 rounding of the
    system moves its nullspace vector, in units of the roundoff."""
    lam = np.linalg.eigvalsh(a.T @ a)
    return lam[-1] / (lam[1] - lam[0])


def _dlt_system(p3, ob):
    """The 2S × 12 DLT system of one sample, in float64."""
    xh = np.concatenate([p3, np.ones((len(p3), 1))], 1).astype(np.float64)
    z = np.zeros_like(xh)
    return np.concatenate([np.concatenate([xh, z, -ob[:, :1] * xh], 1),
                           np.concatenate([z, xh, -ob[:, 1:] * xh], 1)], 0)


def _jax_dlt_sign_canonical(pts, obs):
    """Per hypothesis: whether the JAX package's eigh returned the DLT
    nullspace with det(P[:, :3]) >= 0 (the sign the port fixes)."""
    def ata(p3, ob):
        s = p3.shape[0]
        xh = jnp.concatenate([p3, jnp.ones((s, 1))], 1)
        z = jnp.zeros_like(xh)
        a = jnp.concatenate([jnp.concatenate([xh, z, -ob[:, :1] * xh], 1),
                             jnp.concatenate([z, xh, -ob[:, 1:] * xh], 1)], 0)
        return a.T @ a
    _, v = jax.vmap(jnp.linalg.eigh)(jax.vmap(ata)(jnp.asarray(pts), jnp.asarray(obs)))
    p = np.asarray(v)[:, :, 0].reshape(-1, 3, 4)
    return np.linalg.det(p[:, :, :3]) >= 0


@pytest.mark.parametrize("case", ["outliers", "validity"])
def test_pnp_ransac_matches_jax(rng, case):
    """Same draws: the same minimal sets, and the same result.

    One known departure, hypothesis by hypothesis: the JAX package takes
    eigh's eigenvector sign as LAPACK returns it, and a sign with
    det(P[:, :3]) < 0 turns that DLT hypothesis into R composed with a
    half-turn, which finds almost no inliers; the port fixes the sign, so
    it keeps good hypotheses the JAX package loses, and its winner may be
    another clean sample. The JAX winner must score the same in the port.
    The final pose is Gauss-Newton from the winner over its inlier mask, so
    each package's final pose is held (1e-4) to the other package's
    refinement from the same winner, and both to the ground truth."""
    r_gt, t_gt, pts, obs, _ = make_pnp_problem(rng, outlier_frac=0.3 if case == "outliers" else 0.0)
    n = len(pts)
    valid = np.ones(n, bool)
    if case == "validity":
        valid[50:] = False
    key = jax.random.PRNGKey(3)
    ref = jransac.pnp_ransac(jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(valid), key)
    gumbel = np.asarray(jax.random.gumbel(key, (128, n)))
    out = transac.pnp_ransac(_t(pts), _t(obs), _t(valid), _t(gumbel))
    assert bool(out.ok) and bool(ref.ok)
    assert int(out.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(_np(out.inliers), np.asarray(ref.inliers))
    for r, t in ((out.r, out.t), (ref.r, ref.t)):       # test_ransac.py's bounds
        np.testing.assert_allclose(_np(r), r_gt, atol=2e-2)
        np.testing.assert_allclose(_np(t), t_gt, atol=5e-2)

    idx_j = np.asarray(jransac._sample_indices(key, 128, 6, n, jnp.asarray(valid)))
    idx_t = _np(transac._sample_indices(_t(gumbel), _t(valid), 6))
    np.testing.assert_array_equal(idx_t, idx_j)
    rs_j, ts_j = jax.vmap(jransac._dlt_pose)(jnp.asarray(pts[idx_j]), jnp.asarray(obs[idx_j]))
    rs_t, ts_t = transac._dlt_pose(_t(pts[idx_t]), _t(obs[idx_t]))
    c_j = _pnp_counts(jransac, rs_j, ts_j, jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(valid))
    c_t = _pnp_counts(transac, rs_t, ts_t, _t(pts), _t(obs), _t(valid))
    best_j = int(np.argmax(c_j))
    assert c_t[best_j] == c_j[best_j] and c_t.max() >= c_j.max()
    # each package's float32 LAPACK DLT against the float64 solve of the same
    # minimal system, within unit roundoff times the nullspace's condition
    # λmax / (λ2 - λ1) of AᵀA (measured: at most 0.1 of it)
    r64, t64 = transac._dlt_pose(_t(pts[idx_t]).double(), _t(obs[idx_t]).double(), jacobi=False)
    bound = _F32_U * _nullspace_condition(_dlt_system(pts[idx_j][best_j], obs[idx_j][best_j]))
    for rs in (_np(rs_t), np.asarray(rs_j)):
        np.testing.assert_allclose(rs[best_j], r64[best_j].numpy(), atol=bound)
    canonical = _jax_dlt_sign_canonical(pts[idx_j], obs[idx_j])
    lost = (c_t >= 10) & ~canonical
    assert (c_j[lost] <= 2).all()
    best_t = int(np.argmax(c_t))
    jpts, jobs, thresh = jnp.asarray(pts), jnp.asarray(obs), 10.0 / 460.0
    # the JAX winner, refined by the port, lands on the JAX package's pose
    mask = np.asarray(jransac._reproj_residuals(rs_j[best_j], ts_j[best_j], jpts, jobs) < thresh) & valid
    r_x, t_x = transac.refine_pose_gn(_t(np.asarray(rs_j[best_j])), _t(np.asarray(ts_j[best_j])),
                                      _t(pts), _t(obs), _t(mask))
    np.testing.assert_allclose(_np(r_x), np.asarray(ref.r), atol=1e-4)
    np.testing.assert_allclose(_np(t_x), np.asarray(ref.t), atol=1e-4)
    # the port's winner, refined by the JAX package, lands on the port's pose
    mask = _np(transac._reproj_residuals(rs_t[best_t], ts_t[best_t], _t(pts), _t(obs)) < thresh) & valid
    r_x, t_x = jransac.refine_pose_gn(jnp.asarray(_np(rs_t[best_t])), jnp.asarray(_np(ts_t[best_t])),
                                      jpts, jobs, jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(r_x), _np(out.r), atol=1e-4)
    np.testing.assert_allclose(np.asarray(t_x), _np(out.t), atol=1e-4)


def test_pnp_ransac_garbage_fails_in_both(rng):
    pts = rng.uniform(-2, 2, (40, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32)
    obs = rng.uniform(-0.5, 0.5, (40, 2)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    ref = jransac.pnp_ransac(jnp.asarray(pts), jnp.asarray(obs), jnp.ones(40, bool), key)
    out = transac.pnp_ransac(_t(pts), _t(obs), torch.ones(40, dtype=torch.bool),
                             _t(np.asarray(jax.random.gumbel(key, (128, 40)))))
    assert not bool(ref.ok) and not bool(out.ok)


def test_fundamental_ransac_matches_jax(rng):
    """F's sign is free and the Sampson error does not see it: every
    hypothesis counts the same inliers in both, so the same one wins."""
    r = np.asarray(jrot.quat_to_matrix(jrot.so3_exp(jnp.asarray([0.05, -0.1, 0.08]))))
    t = np.array([0.4, 0.1, 0.05], np.float32)
    pts = rng.uniform(-2, 2, (60, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    pc2 = pts @ r.T + t
    p1 = (pts[:, :2] / pts[:, 2:3] + rng.normal(size=(60, 2)) * 0.3 / 460).astype(np.float32)
    p2 = (pc2[:, :2] / pc2[:, 2:3] + rng.normal(size=(60, 2)) * 0.3 / 460).astype(np.float32)
    p2[:10] += 0.2
    valid = np.ones(60, bool)
    valid[55:] = False
    key = jax.random.PRNGKey(3)
    ref = jransac.fundamental_ransac(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), key)
    gumbel = np.asarray(jax.random.gumbel(key, (128, 60)))
    out = transac.fundamental_ransac(_t(p1), _t(p2), _t(valid), _t(gumbel))
    assert int(out.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(_np(out.inliers), np.asarray(ref.inliers))
    idx = np.asarray(jransac._sample_indices(key, 128, 8, 60, jnp.asarray(valid)))
    f_j = jax.vmap(jransac._eight_point)(jnp.asarray(p1[idx]), jnp.asarray(p2[idx]))
    c_j = np.asarray(jnp.sum((jax.vmap(lambda f: jransac._sampson_error(
        f, jnp.asarray(p1), jnp.asarray(p2)))(f_j) < (3.0 / 460.0) ** 2) & valid[None], axis=1))
    f_t = transac._eight_point(_t(p1[idx]), _t(p2[idx]))
    c_t = _np(torch.sum((transac._sampson_error(f_t, _t(p1), _t(p2)) < (3.0 / 460.0) ** 2)
                        & _t(valid)[None], dim=1))
    assert int(np.argmax(c_t)) == int(np.argmax(c_j)) and c_t.max() == c_j.max()
    # fp32 eigh of a near-degenerate 8-point system may return another
    # nullspace vector; wherever the two hypotheses agree to 1e-3, the
    # counts agree but for a point on the threshold
    fn_j = np.asarray(f_j).reshape(128, 9)
    fn_t = _np(f_t).reshape(128, 9)
    fn_j = fn_j / np.linalg.norm(fn_j, axis=1, keepdims=True)
    fn_t = fn_t / np.linalg.norm(fn_t, axis=1, keepdims=True)
    same = np.minimum(np.abs(fn_j - fn_t).max(1), np.abs(fn_j + fn_t).max(1)) < 1e-3
    assert same.mean() > 0.5
    assert np.abs(c_t[same] - c_j[same]).max() <= 1
    # the winner's F up to sign and scale: fp32 eigh of the same 9×9 system
    # by two LAPACKs (1.2e-3 apart on this sample, measured)
    fj, ft = np.asarray(ref.f), _np(out.f)
    fj, ft = fj / np.linalg.norm(fj), ft / np.linalg.norm(ft)
    assert min(np.abs(fj - ft).max(), np.abs(fj + ft).max()) < 5e-3


def _cascade_case(rng):
    """The planted-outlier data of
    `test_find_connection_cascade_rejects_planted_outliers`, both packages'
    cascades on it with the JAX key chain's noise, the port's with
    `jacobi`. Returns (port's, JAX's, the planted bad matches)."""
    n = 60
    r = np.asarray(jrot.quat_to_matrix(jrot.so3_exp(jnp.asarray([0.04, -0.08, 0.06]))))
    t = np.array([0.5, 0.15, 0.1], np.float32)
    pts_cj = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pts_cj[:, 2] += 6.0
    win_uv = (pts_cj[:, :2] / pts_cj[:, 2:3]).astype(np.float32)
    pc_i = pts_cj @ r.T + t
    ext_uv = (pc_i[:, :2] / pc_i[:, 2:3]).astype(np.float32)
    ext_uv += rng.normal(size=ext_uv.shape).astype(np.float32) * 0.3 / 460
    desc = _desc(rng, n)
    win_desc = desc.copy()
    bad = np.arange(18)
    win_desc[bad] = desc[40 + bad]
    ones = np.ones(n, bool)
    key = jax.random.PRNGKey(7)
    res_j, m_j, keep_j = jax_match_and_pnp(
        jnp.asarray(win_desc), jnp.asarray(ones), jnp.asarray(win_uv), jnp.asarray(pts_cj),
        jnp.asarray(desc), jnp.asarray(ones), jnp.asarray(ext_uv), key, 10.0 / 460.0, 15)
    key_f, key_p = jax.random.split(key)

    def port(jacobi):
        return torch_match_and_pnp(
            _td(win_desc), _t(ones), _t(win_uv), _t(pts_cj), _td(desc), _t(ones), _t(ext_uv),
            _t(np.asarray(jax.random.gumbel(key_f, (128, n)))),
            _t(np.asarray(jax.random.gumbel(key_p, (128, n)))), 10.0 / 460.0, 15, jacobi)
    return port, (res_j, m_j, keep_j), bad


def test_match_and_pnp_cascade_matches_jax(rng):
    """The loop cascade (match -> F -> PnP) on the planted-outlier data of
    `test_find_connection_cascade_rejects_planted_outliers`, with the JAX
    key chain's noise: the same matches, the same F-consistent survivors,
    the same pose."""
    port, (res_j, m_j, keep_j), bad = _cascade_case(rng)
    res_t, m_t, keep_t = port(None)
    for a, b in zip(m_t, m_j):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(keep_t), np.asarray(keep_j))
    assert _np(keep_t)[bad].mean() < 0.2 and _np(keep_t)[18:].mean() > 0.8
    assert bool(res_t.ok) and bool(res_j.ok)
    assert int(res_t.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_array_equal(_np(res_t.inliers), np.asarray(res_j.inliers))
    np.testing.assert_allclose(_np(res_t.r), np.asarray(res_j.r), atol=1e-4)
    np.testing.assert_allclose(_np(res_t.t), np.asarray(res_j.t), atol=1e-4)


def test_match_and_pnp_cascade_with_jacobi_matches_jax(rng):
    """The card's cascade (`jacobi=True`: the 8-point F, the DLT and its
    SVD in float64 through the Jacobi eigensolver; here its twin) on the
    same data and draws: the same matches and F-consistent survivors, the
    same PnP inliers, and a pose within POSE_TOL of the JAX package's
    float32 LAPACK one [measured: survivors and inliers equal]."""
    POSE_TOL = 1e-4
    port, (res_j, m_j, keep_j), bad = _cascade_case(rng)
    res_t, m_t, keep_t = port(True)
    for a, b in zip(m_t, m_j):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(keep_t), np.asarray(keep_j))
    assert bool(res_t.ok) and bool(res_j.ok)
    assert int(res_t.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_array_equal(_np(res_t.inliers), np.asarray(res_j.inliers))
    np.testing.assert_allclose(_np(res_t.r), np.asarray(res_j.r), atol=POSE_TOL)
    np.testing.assert_allclose(_np(res_t.t), np.asarray(res_j.t), atol=POSE_TOL)


# ---------- vocabulary ----------


@pytest.fixture(scope="module")
def trained():
    descs = np.random.default_rng(5).integers(0, 2 ** 32, (400, 8), dtype=np.uint32)
    return descs, jvoc.train_vocabulary(descs, k=5, levels=2, seed=1)


def test_train_vocabulary_and_bow(trained, rng):
    descs, voc_j = trained
    voc_t = tvoc.train_vocabulary(descs, k=5, levels=2, seed=1, device="cpu")
    # the same numpy k-medoids and idf: identical trees and weights
    for a, b in zip(voc_t.level_desc, voc_j.level_desc):
        np.testing.assert_array_equal(_np(a).view(np.uint32), np.asarray(b))
    np.testing.assert_array_equal(_np(voc_t.weights), np.asarray(voc_j.weights))
    q = _desc(rng, 90)
    q[:40] = descs[:40]
    valid = rng.random(90) > 0.2
    np.testing.assert_array_equal(_np(tvoc.quantize(voc_t, _td(q))),
                                  np.asarray(jvoc.quantize(voc_j, jnp.asarray(q))))
    v_j = np.asarray(jvoc.bow_vector(voc_j, jnp.asarray(q), jnp.asarray(valid)))
    v_t = _np(tvoc.bow_vector(voc_t, _td(q), _t(valid)))
    # exact counts; the L1 norm's sum order differs (last ulp)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-6, atol=1e-7)


def test_bow_database_query_and_add(trained, rng):
    descs, voc_j = trained
    voc_t = interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc_j), "cpu")
    frames = [descs[rng.integers(0, 400, 60)] for _ in range(20)]
    frames[7] = frames[3]                                  # a tie in score
    db_j = jvoc.BowDatabase(voc_j, capacity=8)             # grows at frame 8
    db_t = tvoc.BowDatabase(voc_t, capacity=8)
    for i, f in enumerate(frames):
        i_j, s_j = db_j.query_and_add(jvoc.bow_vector(voc_j, jnp.asarray(f)), i % 3,
                                      exclude_recent=4)
        i_t, s_t = db_t.query_and_add(tvoc.bow_vector(voc_t, _td(f)), i % 3,
                                      exclude_recent=4)
        assert isinstance(i_t, torch.Tensor)               # not fetched
        np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))
        np.testing.assert_allclose(_np(s_t), np.asarray(s_j), atol=1e-6)
    assert db_t.count == len(frames) and db_t.vectors.shape[0] == 32
    q = frames[3]
    i_j, s_j = db_j.query(jvoc.bow_vector(voc_j, jnp.asarray(q)), 1, exclude_recent=4)
    i_t, s_t = db_t.query(tvoc.bow_vector(voc_t, _td(q)), 1, exclude_recent=4)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, atol=1e-6)


def test_tree_vocabulary_quantize_and_sparse_db(rng):
    tree_j = jvoc.synthesize_tree_vocabulary(k=10, levels=3, seed=0)
    tree_t = interop.tree_vocabulary_to_torch(tree_j)
    np.testing.assert_array_equal(
        tree_t.node_desc, tvoc.synthesize_tree_vocabulary(k=10, levels=3, seed=0).node_desc)
    pool = _desc(rng, 120)
    frames = [pool[rng.integers(0, 120, 60)] for _ in range(14)]
    q = frames[0]
    np.testing.assert_array_equal(_np(tvoc.quantize_tree(tree_t, _td(q))),
                                  np.asarray(jvoc.quantize_tree(tree_j, jnp.asarray(q))))
    valid = rng.random(60) > 0.3
    ids_j, vals_j = jvoc.sparse_bow(tree_j, jnp.asarray(q), jnp.asarray(valid))
    ids_t, vals_t = tvoc.sparse_bow(tree_t, _td(q), _t(valid))
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-6)
    # 32 words per frame < the ~50 distinct words of a frame: the top-f
    # truncation breaks the ties of uniform weights by word id in both
    db_j = jvoc.SparseBowDatabase(tree_j, capacity=8, words_per_frame=32)
    db_t = tvoc.SparseBowDatabase(tree_t, capacity=8, words_per_frame=32, device="cpu")
    for i, f in enumerate(frames):
        v = rng.random(60) > 0.1
        i_j, s_j = db_j.query_and_add(jnp.asarray(f), i % 3, exclude_recent=4, valid=jnp.asarray(v))
        i_t, s_t = db_t.query_and_add(_td(f), i % 3, exclude_recent=4, valid=_t(v))
        np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))
        np.testing.assert_allclose(_np(s_t), np.asarray(s_j), atol=1e-6)
    np.testing.assert_array_equal(_np(db_t.ids), np.asarray(db_j.ids))
    np.testing.assert_allclose(_np(db_t.vals), np.asarray(db_j.vals), rtol=1e-6)
    # query() + add_descriptors() return what the fused step returns
    db_q = tvoc.SparseBowDatabase(tree_t, capacity=8, words_per_frame=32, device="cpu")
    db_f = tvoc.SparseBowDatabase(tree_t, capacity=8, words_per_frame=32, device="cpu")
    for i, f in enumerate(frames):
        i_q, s_q = db_q.query(_td(f), i % 3, exclude_recent=4)
        db_q.add_descriptors(_td(f), i % 3)
        i_f, s_f = db_f.query_and_add(_td(f), i % 3, exclude_recent=4)
        np.testing.assert_array_equal(i_q, _np(i_f))
        np.testing.assert_allclose(s_q, _np(s_f), atol=1e-6)
    i_j, s_j = db_j.query(jnp.asarray(frames[2]), 1, exclude_recent=2, top_k=3)
    i_t, s_t = db_t.query(_td(frames[2]), 1, exclude_recent=2, top_k=3)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, atol=1e-6)


def test_dbow_binary_roundtrip_byte_for_byte(trained, tmp_path):
    """Both packages write the same file for the same tree, and each reads
    the other's."""
    descs, voc_j = trained
    tree_j = jvoc.tree_from_trained(jvoc.train_vocabulary(descs, k=4, levels=3, seed=0))
    tree_t = tvoc.tree_from_trained(tvoc.train_vocabulary(descs, k=4, levels=3, seed=0,
                                                        device="cpu"))
    synth = tvoc.synthesize_tree_vocabulary(k=10, levels=3, seed=2)
    for name, tj, tt in (("trained", tree_j, tree_t), ("synth", synth, synth)):
        pj, pt = tmp_path / f"{name}_jax.bin", tmp_path / f"{name}_torch.bin"
        jvoc.save_dbow_binary(str(pj), tj)
        tvoc.save_dbow_binary(str(pt), tt)
        assert pj.read_bytes() == pt.read_bytes(), name
        back_t = tvoc.load_dbow_binary(str(pj))
        back_j = jvoc.load_dbow_binary(str(pt))
        for f in ("children", "node_desc", "word_id", "weights"):
            np.testing.assert_array_equal(getattr(back_t, f), np.asarray(getattr(back_j, f)))
        tvoc.save_dbow_binary(str(pt), back_t)
        assert pt.read_bytes() == pj.read_bytes()


# ---------- PCM ----------


def _fourdof(mod, conv, *arrs):
    return mod.FourDof(*(conv(a) for a in arrs))


def _edges_np(rng, **kw):
    edge_T, pose_i, pose_j = make_edges(rng, **kw)
    return [tuple(np.asarray(x) for x in f) for f in (edge_T, pose_i, pose_j)]


def _chain_case(rng):
    """`test_pcm_with_chain_whitening_filters_outliers`'s two-client layout."""
    n_nodes, e = 60, 24
    ta = np.cumsum(rng.normal(0, 0.2, (n_nodes, 3)), 0).astype(np.float32)
    tb = np.cumsum(rng.normal(0, 0.2, (n_nodes, 3)), 0).astype(np.float32)
    yaw_ab, t_ab = 0.5, np.array([1.0, 2.0, 0.0], np.float32)
    c, s = np.cos(yaw_ab), np.sin(yaw_ab)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    idx_i = rng.integers(0, n_nodes, e)
    idx_j = rng.integers(0, n_nodes, e)
    edge_t = np.stack([rz @ tb[idx_j[k]] + t_ab - ta[idx_i[k]] for k in range(e)]).astype(np.float32)
    edge_t[-6:] += rng.uniform(1.5, 3.0, (6, 3)).astype(np.float32)
    zeros = np.zeros(e, np.float32)
    return (ta, tb, idx_i, idx_j, (np.full(e, yaw_ab, np.float32), edge_t),
            (zeros, ta[idx_i]), (zeros, tb[idx_j]))


def _chains(mod, conv, ta, tb, idx_i, idx_j):
    n = ta.shape[0]
    zeros = np.zeros(n, np.float32)
    return (_fourdof(mod, conv, zeros, ta), conv(idx_i), _fourdof(mod, conv, zeros, tb),
            conv(idx_j), 0.02, 0.005)


@pytest.mark.parametrize("whitening", ["fixed", "chain"])
def test_pairwise_consistency_and_filter(rng, whitening):
    if whitening == "fixed":
        edge, pi, pj = _edges_np(rng)
        kw = dict(sigma_t=0.1, sigma_yaw=0.05, gamma=5.0)
        chain_j = chain_t = None
        min_edges = 10
    else:
        ta, tb, idx_i, idx_j, edge, pi, pj = _chain_case(rng)
        kw = dict(sigma_t=0.05, sigma_yaw=0.02, gamma=5.0)
        chain_j = _chains(jpcm, jnp.asarray, ta, tb, idx_i, idx_j)
        chain_t = _chains(tpcm, lambda a: _t(a.astype(np.int64) if a.dtype.kind == "i" else a),
                          ta, tb, idx_i, idx_j)
        min_edges = 10
    e = edge[0].shape[0]
    valid = np.ones(e, bool)
    valid[1] = False
    args_j = [_fourdof(jpcm, jnp.asarray, *f) for f in (edge, pi, pj)]
    args_t = [_fourdof(tpcm, _t, *f) for f in (edge, pi, pj)]
    adj_j = np.asarray(jpcm.pairwise_consistency(*args_j, jnp.asarray(valid), chain=chain_j, **kw))
    adj_t = _np(tpcm.pairwise_consistency(*args_t, _t(valid), chain=chain_t, **kw))
    np.testing.assert_array_equal(adj_t, adj_j)
    keep_j = jpcm.pcm_filter(*args_j, valid, min_edges=min_edges, chain=chain_j, **kw)
    keep_t = tpcm.pcm_filter(*args_t, valid, min_edges=min_edges, chain=chain_t, **kw)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert not keep_t[-5:].any() and keep_t[2:e - 6].mean() > 0.8


def test_chain_cov(rng):
    ts = np.cumsum(rng.normal(0, 0.3, (50, 3)), axis=0).astype(np.float32)
    ia = rng.integers(0, 50, 9)
    ib = rng.integers(0, 50, 9)
    rot = np.asarray(jrot.rot_z(jnp.asarray(rng.uniform(-3, 3, 9).astype(np.float32))))
    cov_j, vy_j = jpcm.chain_cov(jpcm.FourDof(jnp.zeros(50), jnp.asarray(ts)), jnp.asarray(ia),
                                 jnp.asarray(ib), 0.02, 0.005, jnp.asarray(rot))
    cov_t, vy_t = tpcm.chain_cov(tpcm.FourDof(torch.zeros(50), _t(ts)), _t(ia.astype(np.int64)),
                                 _t(ib.astype(np.int64)), 0.02, 0.005, _t(rot))
    # prefix sums in fp32, summed in another order
    np.testing.assert_allclose(_np(cov_t), np.asarray(cov_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(vy_t), np.asarray(vy_j), rtol=1e-6)


@pytest.mark.parametrize("route", ["native", "python"])
def test_max_clique_matches_reference(rng, route, monkeypatch):
    """The port's max clique (its own build of fmc.cpp, or the Python search
    without a compiler) gives the JAX package's cliques, exactly."""
    if route == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        # the reference's library is built by `make` at its first use, maybe
        # by another worker at this moment: wait it out before comparing
        wait_for_reference_native(jnative)
        assert tpcm.native_max_clique_available() == jnative.available()
    for n in (0, 6, 25, 45):
        a = rng.random((n, n)) < 0.5
        a = a | a.T
        np.testing.assert_array_equal(tpcm.max_clique(a), jpcm.max_clique(a))


def test_max_clique_native_recovers_from_a_lost_build_race(rng, monkeypatch):
    """A worker that read the reference's library while another worker was
    still writing it is left with `_TRIED` set and `_LIB` None, and reports
    the library missing; the wait clears that and finds the library, so
    the port's availability and cliques agree with the reference's."""
    import shutil

    if not (shutil.which("make") and (shutil.which("g++") or shutil.which("c++"))):
        pytest.skip("no make and C++ compiler on PATH to build the reference's native library")
    assert wait_for_reference_native(jnative), "the JAX package's native library did not build"
    monkeypatch.setattr(jnative, "_TRIED", True)
    monkeypatch.setattr(jnative, "_LIB", None)
    assert not jnative.available()                      # the losing worker's state
    assert wait_for_reference_native(jnative)
    assert tpcm.native_max_clique_available() == jnative.available()
    a = rng.random((30, 30)) < 0.5
    a = a | a.T
    np.testing.assert_array_equal(tpcm.max_clique(a), jpcm.max_clique(a))

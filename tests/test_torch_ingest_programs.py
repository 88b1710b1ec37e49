"""The pose-graph server's per-keyframe programs on the CPU: the loop
verification's linear algebra as the card runs it, and each BoW database's
query-and-insert as one program, against the JAX package.

- The card's PnP DLT (`jacobi=True`: the 2S×12 system in float64, AᵀA's
  eigenvectors from the Jacobi eigensolver, P[:, :3]'s SVD through the
  eigenvectors of MᵀM, determinants by cofactors; here the twin) against
  `cvids_tpu.ops.ransac.pnp_ransac` on the same draws: a named departure,
  held to the JAX package's result within stated counts and tolerances.
- That path calls no torch.linalg `eigh`, `svd` or `det`, so on the card
  it reads nothing back and is captured in the cascade's graph.
- `SparseBowDatabase.query_and_add` and `BowDatabase.query_and_add_descriptors`
  (`vocab._sparse_query_insert`, `vocab._dense_bow_query_insert`, graphed on
  the card) against the JAX package's databases, whose steps are its jits
  `_sparse_bow_query` + `_sparse_insert` + `_client_set` and
  `_bow_vector_impl` + `_db_topk_masked` + `_db_insert` + `_client_set`,
  over streams that grow the store three times.
- The server's ingest goes through those programs and the cascade's.

The programs' replays against their eager calls, bit for bit, and one
capture per tier run on the card (`test_torch_cuda.py`, `chip_smoke.py`
phase 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ransac import make_pnp_problem

from cvids_tpu.ops import ransac as jransac
from cvids_tpu.server import vocab as jvoc
from cvids_tpu_torch import interop
from cvids_tpu_torch.ops import ransac
from cvids_tpu_torch.ops.hamming import descriptors_to_torch
from cvids_tpu_torch.server import vocab

PNP_NOISE = {"exact": 0.0, "noisy": 0.5 / 460.0}


@pytest.fixture(autouse=True)
def _one_thread():
    # xdist's workers share the cores: one intra-op thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _td(desc):
    return descriptors_to_torch(desc, device="cpu")


# ---------- the card's DLT and PnP ----------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("outliers", [0.0, 0.3])
@pytest.mark.parametrize("noise", sorted(PNP_NOISE))
def test_card_pnp_departs_from_jax_by_its_rounding(noise, outliers, seed):
    """A named departure: the card's PnP (`jacobi=True`, float64 DLT; here
    the twin) against the JAX package's (float32 LAPACK, which the CPU path
    keeps) on test_ransac.py's problems with the JAX draws: the same `ok`,
    inlier sets within INLIER_DIFF points [measured 0 in all 16 cases of
    seeds 0-3], the pose within R_TOL / T_TOL of the JAX package's
    [measured 3.6e-3 / 1.6e-2, one noisy case; the rest below 4e-5 / 3.3e-4];
    on exact data within EXACT_TOL of the truth [measured 1.2e-7 rotation,
    7.2e-7 translation], on noisy data within test_ransac.py's bounds."""
    INLIER_DIFF, R_TOL, T_TOL, EXACT_TOL = 2, 1e-2, 5e-2, 1e-5
    rng = np.random.default_rng(seed)
    r_gt, t_gt, pts, obs, _ = make_pnp_problem(rng, outlier_frac=outliers,
                                                noise=PNP_NOISE[noise])
    n = len(pts)
    valid = np.ones(n, bool)
    key = jax.random.PRNGKey(seed)
    want = jransac.pnp_ransac(jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(valid), key)
    gumbel = _t(np.asarray(jax.random.gumbel(key, (128, n))))
    got = ransac.pnp_ransac(_t(pts), _t(obs), _t(valid), gumbel, jacobi=True)
    assert bool(got.ok) == bool(want.ok)
    assert int((got.inliers.numpy() != np.asarray(want.inliers)).sum()) <= INLIER_DIFF
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), atol=R_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=T_TOL)
    r_tol, t_tol = (EXACT_TOL, EXACT_TOL) if noise == "exact" else (2e-2, 5e-2)
    np.testing.assert_allclose(got.r.numpy(), r_gt, atol=r_tol)
    np.testing.assert_allclose(got.t.numpy(), t_gt, atol=t_tol)


def test_card_dlt_is_as_close_as_float64():
    """The float64 Jacobi DLT on exact 6-point samples against the truth:
    within DLT_TOL (median) [measured 2.5e-7 rotation, 2.1e-6 translation,
    as float64 LAPACK], where the float32 LAPACK DLT (the CPU path, the JAX
    package's arithmetic) is a hundred times further at least [measured
    4.1e-4 / 5.6e-3]: AᵀA squares the condition of a system whose columns
    mix metres with normalized coordinates."""
    DLT_TOL = 1e-5
    r, t, pts, obs, _ = make_pnp_problem(np.random.default_rng(0), n=6 * 64,
                                         outlier_frac=0.0, noise=0.0)
    p3, ob = _t(pts).reshape(64, 6, 3), _t(obs).reshape(64, 6, 2)
    err = {}
    for name, jacobi in (("card", True), ("lapack32", False)):
        rs, ts = ransac._dlt_pose(p3, ob, jacobi=jacobi)
        assert rs.dtype == torch.float32 and ts.dtype == torch.float32
        err[name] = (float((rs - _t(r)).abs().amax((1, 2)).median()),
                     float((ts - _t(t)).abs().amax(1).median()))
    assert max(err["card"]) < DLT_TOL, err
    assert 100 * err["card"][0] < err["lapack32"][0], err


@pytest.mark.parametrize("kind", ["proper", "improper", "rank2"])
def test_svd3_through_mtm_is_an_svd(kind):
    """`ransac._svd3_jacobi` returns an SVD: U diag(s) Vᵀ = M, orthonormal U
    and V, s = LAPACK's singular values, det(U) det(V) = sign(det M), so
    U Vᵀ is LAPACK's U Vᵀ (the polar factor) where M has full rank; for a
    rank-2 F nothing divides by the zero singular value, which comes out
    as the square root of MᵀM's least eigenvalue, at most ~sqrt(eps) s₁
    [measured 1.3e-8]: RANK2_TOL."""
    RANK2_TOL = 1e-7
    rng = np.random.default_rng({"proper": 1, "improper": 2, "rank2": 3}[kind])
    m = torch.from_numpy(rng.normal(size=(64, 3, 3)))
    if kind != "rank2":
        sign = torch.sign(torch.linalg.det(m))
        m = m * (sign if kind == "proper" else -sign)[:, None, None]
    else:
        u, s, vt = torch.linalg.svd(m)
        m = (u * torch.stack([s[:, 0], s[:, 1], 0 * s[:, 2]], -1)[:, None, :]) @ vt
    u, s, vt = ransac._svd3_jacobi(m)
    eye = torch.eye(3, dtype=m.dtype)
    tol = RANK2_TOL if kind == "rank2" else 1e-12
    assert float(((u * s[:, None, :]) @ vt - m).abs().max()) < tol
    assert float((u.transpose(-1, -2) @ u - eye).abs().max()) < 1e-12
    assert float((vt @ vt.transpose(-1, -2) - eye).abs().max()) < 1e-12
    s_ref = torch.linalg.svdvals(m)
    assert float((s - s_ref).abs().max()) < tol
    if kind == "rank2":
        return
    assert torch.equal(torch.sign(ransac._det3(u) * ransac._det3(vt)),
                       torch.sign(torch.linalg.det(m)))
    u_r, _, vt_r = torch.linalg.svd(m)
    assert float((u @ vt - u_r @ vt_r).abs().max()) < 1e-10


@pytest.mark.parametrize("entry", ["pnp_ransac", "essential_pose", "match_and_pnp"])
def test_card_path_calls_no_linalg_decomposition(entry, monkeypatch):
    """With `jacobi=True` the RANSAC entry points (and the server's cascade)
    call no torch.linalg `eigh`, `svd` or `det`, whose error checks wait
    for the card and which a CUDA graph cannot capture."""
    from cvids_tpu_torch.server.posegraph import _match_and_pnp

    def refuse(*args, **kwargs):
        raise AssertionError("torch.linalg decomposition called on the card's path")

    rng = np.random.default_rng(4)
    _, _, pts, obs, _ = make_pnp_problem(rng, n=60)
    p3, ob = _t(pts), _t(obs)
    valid = torch.ones(60, dtype=torch.bool)
    g = ransac.gumbel_noise(128, 60, torch.Generator().manual_seed(0), device="cpu")
    for name in ("eigh", "svd", "det"):
        monkeypatch.setattr(torch.linalg, name, refuse)
    if entry == "pnp_ransac":
        out = ransac.pnp_ransac(p3, ob, valid, g, jacobi=True)
        assert bool(out.ok)
    elif entry == "essential_pose":
        out = ransac.essential_pose(ob, ob + 0.01, valid, g, jacobi=True)
        assert torch.isfinite(out.r).all()
    else:
        desc = _td(rng.integers(0, 2 ** 32, (60, 8), dtype=np.uint32))
        res, m, _ = _match_and_pnp(desc, valid, ob, p3, desc, valid, ob, g, g,
                                   10.0 / 460.0, 15, True)
        assert bool(m.valid.all()) and torch.isfinite(res.r).all()


# ---------- the BoW programs ----------


TIE = 1e-6


def _same_topk(i_t, s_t, i_j, s_j):
    """The port's top-k against the JAX package's: scores within TIE, and
    the same rows but at a tie. Two rows whose scores are equal in real
    arithmetic (uniform weights make such ties common) can come out an ulp
    apart in either package's sum order, so where the k-th rows differ the
    JAX package's k-th score is within TIE of a neighbour's, or k is the
    last place (its rival is not shown)."""
    i_t, s_t, i_j, s_j = i_t.numpy(), s_t.numpy(), np.asarray(i_j), np.asarray(s_j)
    np.testing.assert_allclose(s_t, s_j, atol=TIE)
    for k in np.nonzero(i_t != i_j)[0]:
        near = [abs(s_j[k] - s_j[q]) <= TIE for q in (k - 1, k + 1) if 0 <= q < len(s_j)]
        assert k == len(s_j) - 1 or any(near), (k, i_t, i_j, s_j)


def _frames(rng, pool, n_frames=20, n=60):
    return [pool[rng.integers(0, len(pool), n)] for _ in range(n_frames)]


class _Counted:
    """A program (a GraphedCall) whose calls are counted."""

    def __init__(self, program):
        self.program, self.calls = program, []

    def __call__(self, *args):
        self.calls.append(1)
        return self.program(*args)

    def __getattr__(self, name):
        return getattr(self.program, name)


def _counted(monkeypatch, owner, name):
    """Count the calls of `owner`'s program `name`; returns the list that
    grows by one a call."""
    wrapped = _Counted(getattr(owner, name))
    monkeypatch.setattr(owner, name, wrapped)
    return wrapped.calls


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("words", [32, 256])
def test_sparse_query_insert_matches_jax_across_growth(words, masked, monkeypatch):
    """Twenty keyframes into a 4-row store (grown at 4, 8 and 16): each
    step of `SparseBowDatabase.query_and_add` is one call of its program,
    and gives the JAX package's top-k (`_same_topk`: the same rows but at a
    tie, scores within 1e-6), and after the stream the same stores (ids and
    clients exactly, values within 1e-6 relative), as the current tests
    hold them."""
    rng = np.random.default_rng(words + masked)
    tree_j = jvoc.synthesize_tree_vocabulary(k=10, levels=3, seed=0)
    tree_t = interop.tree_vocabulary_to_torch(tree_j)
    db_j = jvoc.SparseBowDatabase(tree_j, capacity=4, words_per_frame=words)
    db_t = vocab.SparseBowDatabase(tree_t, capacity=4, words_per_frame=words, device="cpu")
    calls = _counted(monkeypatch, db_t, "_query_insert")
    pool = rng.integers(0, 2 ** 32, (120, 8), dtype=np.uint32)
    for i, f in enumerate(_frames(rng, pool)):
        v = rng.random(60) > 0.1 if masked else None
        i_j, s_j = db_j.query_and_add(jnp.asarray(f), i % 3, exclude_recent=4,
                                      valid=None if v is None else jnp.asarray(v))
        i_t, s_t = db_t.query_and_add(_td(f), i % 3, exclude_recent=4,
                                      valid=None if v is None else _t(v))
        assert isinstance(i_t, torch.Tensor)               # device handles, not fetched
        _same_topk(i_t, s_t, i_j, s_j)
    assert len(calls) == 20 and db_t.count == 20 and db_t.ids.shape[0] == 32
    np.testing.assert_array_equal(db_t.ids.numpy(), np.asarray(db_j.ids))
    np.testing.assert_allclose(db_t.vals.numpy(), np.asarray(db_j.vals), rtol=1e-6)
    np.testing.assert_array_equal(db_t.client_dev.numpy(), np.asarray(db_j.client_dev))
    np.testing.assert_array_equal(db_t.client, db_j.client)


@pytest.mark.parametrize("masked", [True, False])
def test_dense_query_insert_matches_jax_across_growth(masked, monkeypatch):
    """The dense database's ingest step, the BoW vector computed inside the
    program (`query_and_add_descriptors`), against the JAX package's
    `bow_vector` + `BowDatabase.query_and_add` over twenty keyframes into a
    4-row store: the same top-k (`_same_topk`), the same clients, and
    vectors within 1e-6 (the L1 norm's sum order)."""
    rng = np.random.default_rng(7 + masked)
    descs = rng.integers(0, 2 ** 32, (400, 8), dtype=np.uint32)
    voc_j = jvoc.train_vocabulary(descs, k=5, levels=2, seed=1)
    voc_t = interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc_j), "cpu")
    db_j = jvoc.BowDatabase(voc_j, capacity=4)
    db_t = vocab.BowDatabase(voc_t, capacity=4)
    calls = _counted(monkeypatch, db_t, "_bow_query_insert")
    frames = _frames(rng, descs)
    frames[7] = frames[3]                                  # a tie in score
    for i, f in enumerate(frames):
        v = rng.random(60) > 0.2 if masked else None
        vec = jvoc.bow_vector(voc_j, jnp.asarray(f), None if v is None else jnp.asarray(v))
        i_j, s_j = db_j.query_and_add(vec, i % 3, exclude_recent=4)
        i_t, s_t = db_t.query_and_add_descriptors(_td(f), i % 3, exclude_recent=4,
                                                  valid=None if v is None else _t(v))
        _same_topk(i_t, s_t, i_j, s_j)
    assert len(calls) == 20 and db_t.count == 20 and db_t.vectors.shape[0] == 32
    np.testing.assert_allclose(db_t.vectors.numpy(), np.asarray(db_j.vectors), atol=1e-6)
    np.testing.assert_array_equal(db_t.client_dev.numpy(), np.asarray(db_j.client_dev))


def test_dense_query_and_add_of_a_vector_is_the_same_program():
    """`BowDatabase.query_and_add(vec)` (the top-k and insert program over
    a given vector) and `query_and_add_descriptors` (the vector computed
    inside) give the same results and stores, bit for bit."""
    rng = np.random.default_rng(9)
    descs = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    voc = vocab.train_vocabulary(descs, k=4, levels=2, seed=2, device="cpu")
    a, b = vocab.BowDatabase(voc, capacity=4), vocab.BowDatabase(voc, capacity=4)
    for i, f in enumerate(_frames(rng, descs, n_frames=12)):
        ia, sa = a.query_and_add(vocab.bow_vector(voc, _td(f)), i % 2, exclude_recent=3)
        ib, sb = b.query_and_add_descriptors(_td(f), i % 2, exclude_recent=3)
        assert torch.equal(ia, ib) and torch.equal(sa, sb)
    assert torch.equal(a.vectors, b.vectors) and torch.equal(a.client_dev, b.client_dev)


def test_scalars_are_views_of_one_buffer():
    """A database's (count, client, recent cut) enter its program as 0-d
    views of one persistent buffer, the same storage at every call (a
    graph's bound inputs)."""
    sc = vocab._Scalars(torch.device("cpu"))
    first = sc(5, 2, 0)
    second = sc(6, 1, 1)
    assert all(x.dim() == 0 for x in second)
    assert [int(x) for x in second] == [6, 1, 1]
    assert [x.data_ptr() for x in first] == [x.data_ptr() for x in second]


# ---------- the server goes through the programs ----------


@pytest.mark.parametrize("mode", ["tree", "dense"])
def test_server_ingest_runs_the_programs(mode, monkeypatch):
    """A two-agent stream through `CollaborativePoseGraph` on the CPU: every
    keyframe is one call of its database's program, and every dispatched
    verification one call of the cascade's (`_verify`), with the CPU's
    linear algebra (`jacobi` off: the JAX package's arithmetic)."""
    from cvids_tpu_torch.io import multiagent
    from cvids_tpu_torch.io.synthetic import Trajectory
    from cvids_tpu_torch.server import posegraph

    rng = np.random.default_rng(0)
    landmarks = np.stack([rng.uniform(-8, 8, 600), rng.uniform(-8, 8, 600),
                          rng.uniform(0.2, 3.0, 600)], -1)
    descs = multiagent.landmark_descriptors(600)
    agents = [multiagent.AgentSim(Trajectory.circle(radius=3.0, omega=0.5, phase=1.5 * a,
                                                    center=(0.0, 0.0, 1.5)),
                                  yaw_offset=0.3 * a, t_offset=np.array([1.0 * a, 0.0, 0.0]))
              for a in range(2)]
    packets, _ = multiagent.generate_packets(agents, landmarks, descs, duration=14.0,
                                             kf_rate=1.0, max_feats=128)
    if mode == "tree":
        voc = vocab.synthesize_tree_vocabulary(k=8, levels=3, seed=0)
    else:
        voc = vocab.train_vocabulary(descs[:400], k=6, levels=2, seed=0, device="cpu")
    cfg = posegraph.ServerConfig(kf_capacity=8, max_win=64, max_ext=128, min_gap=4,
                                 exclude_recent=4)
    server = posegraph.CollaborativePoseGraph(voc, cfg, device="cpu")
    assert server._jacobi is False
    bow = _counted(monkeypatch, server.db,
                   "_query_insert" if mode == "tree" else "_bow_query_insert")
    verify = _counted(monkeypatch, server, "_verify")
    dispatched = []
    real = server._dispatch_verify

    def dispatch(j, cands):
        dispatched.append(j)
        return real(j, cands)

    monkeypatch.setattr(server, "_dispatch_verify", dispatch)
    for _, _, _, pkt in packets:
        server.add_keyframe(pkt)
    server.flush(final=False)
    server.close()
    assert len(bow) == len(packets) == server.store.count
    assert len(dispatched) > 0 and len(verify) == len(dispatched)

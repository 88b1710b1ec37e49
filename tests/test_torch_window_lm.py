"""The window kernel's twin, `cuda_kernels.window_lm_twin` (the order of
operations of ``csrc/window_lm.cu``, stated in ``ops/window_lm.py``),
against the port's CPU `solve_window_fast` and the JAX package's on the
CPU; and what the wrapper `window_lm` takes.

Windows are test_vio.py's (`test_torch_vio._problem`: K = 10 and 5
keyframes, 60 and 40 landmark slots; K = 13 and 21, the kernel's limit,
with 40), made from numpy seeds and carried to
both packages by `interop`; a camera-only prior is the port's
`marginalize_prior_cam` of the window, carried the same way. Tolerances,
after the same iterations:

- the port's CPU solve: positions 1e-4 m, landmarks 1e-3 m, cost 1e-4
  relative (the same float32 algorithm with other sums: the prior's Gram
  matrix formed once as jᵀj, duals for `jacfwd`, an adjugate for
  `inv_ex`, a right-looking Cholesky for LAPACK's; measured ~1e-5 m);
- the window with two keyframe slots and an interval invalid: the twin
  and the CPU solve each against the float64 run of the CPU algorithm,
  positions 5e-4 m, landmarks 1e-3 m, cost 1e-4 relative. Its keyframes
  after the invalid interval hang on the landmarks alone, and the window
  has a weak direction, a common scale about the anchor among others,
  along which float-level sums move the whole window (no single landmark:
  each of 40 moves 0.5-1.5e-3 m between the two float32 solvers). The
  CPU solve sums through PyTorch's CPU BLAS and reductions, whose order
  may follow the machine (the twin states its own): twin against CPU
  measured 1.8e-4 m on one machine and 1.5e-3 m on another; against float64 the twin is 7.7e-4 m and 2.1e-4 m (lm, p)
  off and the CPU solve 7.2e-4 m and 2.9e-4 m, a third of it a common
  scale of 3.6e-5 and -4.5e-5;
- the JAX package's: test_solvers_match's 1e-3 m, 1e-2 m and 1e-3.

The JAX function runs as test_vio.py runs it (jit on the CPU). On the card
the kernel equals the twin bit for bit (`test_torch_cuda.py`,
`chip_smoke.py` phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.vio import window_ba as jba
from cvids_tpu_torch import interop
from cvids_tpu_torch.ops import cuda_kernels as ck
from cvids_tpu_torch.ops import window_lm as wl
from cvids_tpu_torch.vio import window_ba as tba
from test_torch_vio import _problem

PORT = dict(p=1e-4, lm=1e-3, cost=1e-4)
PORT_WEAK = dict(p=5e-4, lm=1e-3, cost=1e-4)
JAX = dict(p=1e-3, lm=1e-2, cost=1e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: thousands of small ops, which many threads slow
    down when xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(kind):
    """(state_j, meas_j, state_t, meas_t) of a named window, both packages."""
    if kind == "K5":
        _, sj, mj, st, m = _problem(seed=5, perturb=0.05, duration=2.0, n_lm=40)
    else:
        _, sj, mj, st, m = _problem(seed=3, perturb=0.1, duration=4.5, n_lm=60)
    if kind == "prior":
        dying = m.vis[0] & ~m.vis[1:].any(0)
        j, r0 = tba.marginalize_prior_cam(st, m, dying)
        prior = tba.CamPriorFactor(j=j, r0=r0, p=st.p + 0.02, q=st.q, v=st.v, bg=st.bg,
                                   ba=st.ba)
        m = m._replace(prior=prior)
        mj = mj._replace(prior=jba.CamPriorFactor(
            *(jnp.asarray(x) for x in interop.cam_prior_to_numpy(prior))))
    elif kind == "huber":
        m, mj = m._replace(huber_delta=1.0), mj._replace(huber_delta=1.0)
    elif kind == "invalid":
        kf = np.ones(st.p.shape[0], bool)
        kf[[-2, -1]] = False
        pre = np.ones(st.p.shape[0] - 1, bool)
        pre[3] = False
        st = st._replace(kf_valid=torch.from_numpy(kf))
        sj = sj._replace(kf_valid=jnp.asarray(kf))
        m = m._replace(pre_valid=torch.from_numpy(pre))
        mj = mj._replace(pre_valid=jnp.asarray(pre))
    elif kind == "no landmark":
        st = st._replace(lm_valid=torch.zeros_like(st.lm_valid))
        sj = sj._replace(lm_valid=jnp.zeros_like(sj.lm_valid))
    return sj, mj, st, m


def _close(got, want, tol):
    (gs, gc), (ws, wc) = got, want
    p, lm = np.asarray(ws.p, np.float64), np.asarray(ws.lm, np.float64)
    assert np.abs(gs.p.numpy() - p).max() < tol["p"]
    assert np.abs(gs.lm.numpy() - lm).max() < tol["lm"]
    assert abs(float(gc) - float(wc)) <= tol["cost"] * max(1.0, abs(float(wc)))


@pytest.mark.parametrize("kind", ["plain", "prior", "huber", "invalid", "no landmark", "K5"])
def test_twin_matches_both_solvers(kind):
    """8 iterations with and without a camera-only prior, with the Huber
    branch on most observations (δ = 1), with two keyframe slots and an
    interval invalid, with no valid landmark, at K = 5."""
    sj, mj, st, m = _window(kind)
    got = ck.window_lm_twin(st, m, 8)
    assert torch.isfinite(got[0].p).all() and torch.isfinite(got[1])
    assert got[0].kf_valid is st.kf_valid and got[0].lm_valid is st.lm_valid
    if kind == "invalid":
        # both float32 solvers to the float64 run of the CPU algorithm
        want = tba.solve_window_fast(*_float64(st, m), iters=8)
        _close(got, want, PORT_WEAK)
        _close(tba.solve_window_fast(st, m, iters=8), want, PORT_WEAK)
    else:
        _close(got, tba.solve_window_fast(st, m, iters=8), PORT)
    _close(got, jba.solve_window_fast(sj, mj, iters=8), JAX)


def _float64(st, m):
    """A window and its measurements in float64."""
    def wide(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() else x
    return (st._replace(**{f: wide(getattr(st, f)) for f in st._fields}),
            m._replace(**{f: wide(getattr(m, f)) for f in m._fields if f not in ("pre", "prior")},
                       pre=type(m.pre)(*map(wide, m.pre))))


@pytest.mark.parametrize("k", [13, 21])
def test_twin_matches_both_solvers_long_windows(k):
    """Past the 12 keyframes one SM's shared memory holds (the kernel spreads
    the system over its cluster): K = 13 and K = 21, bench.py's window, with
    a camera-only prior and 40 landmark slots, 2 iterations."""
    _, sj, mj, st, m = _problem(seed=k, perturb=0.05, duration=(k - 1) / 2.0, n_lm=40)
    assert st.p.shape[0] == k
    dying = m.vis[0] & ~m.vis[1:].any(0)
    j, r0 = tba.marginalize_prior_cam(st, m, dying)
    prior = tba.CamPriorFactor(j=j, r0=r0, p=st.p + 0.02, q=st.q, v=st.v, bg=st.bg, ba=st.ba)
    m = m._replace(prior=prior)
    mj = mj._replace(prior=jba.CamPriorFactor(
        *(jnp.asarray(x) for x in interop.cam_prior_to_numpy(prior))))
    got = ck.window_lm_twin(st, m, 2)
    assert torch.isfinite(got[0].p).all() and torch.isfinite(got[1])
    _close(got, tba.solve_window_fast(st, m, iters=2), PORT)
    _close(got, jba.solve_window_fast(sj, mj, iters=2), JAX)


@pytest.mark.parametrize("iters", [1, 25])
def test_twin_iterations(iters):
    """One iteration and 25."""
    sj, mj, st, m = _window("plain")
    got = ck.window_lm_twin(st, m, iters)
    _close(got, tba.solve_window_fast(st, m, iters=iters), PORT)
    _close(got, jba.solve_window_fast(sj, mj, iters=iters), JAX)


def test_rejected_steps():
    """A step is taken only where it lowers the cost. With a non-finite
    anchor every cost is NaN and every step is rejected: the twin, the port
    and the JAX package return the state they were given. With the yaw
    anchor 3 rad off and λ = 1e-10 the twin takes its first step and rejects
    the next (λ grows by 4): two iterations end where one does."""
    sj, mj, st, m = _window("K5")
    nan = torch.full((3,), float("nan"))
    for s_, c_ in (ck.window_lm_twin(st, m._replace(anchor_p=nan), 3),
                   tba.solve_window_fast(st, m._replace(anchor_p=nan), iters=3),
                   jba.solve_window_fast(sj, mj._replace(anchor_p=jnp.asarray(nan.numpy())),
                                         iters=3)):
        assert np.isnan(float(c_))
        for a, b in zip(s_, st):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    m = m._replace(anchor_yaw=m.anchor_yaw + 3.0)
    one, two = ck.window_lm_twin(st, m, 1, 1e-10), ck.window_lm_twin(st, m, 2, 1e-10)
    assert not torch.equal(one[0].p, st.p)
    for a, b in zip(one[0], two[0]):
        assert torch.equal(a, b)
    assert float(one[1]) == float(two[1])


def test_zero_residual_departure():
    """test_torch_vio's zero-residual window (one observation reprojects
    exactly onto its landmark): the JAX package's `jacfwd` of the norm is
    0/0 there and its solve rejects every step (a named departure); the
    twin's closed-form blocks stay finite and it descends, as the port's
    CPU solve does (the window is ill-conditioned, keyframe 0 moved 2.5 m:
    the two descend along paths ~1e-3 m apart, so they are held to the
    reference test's bound, half the starting cost, not to each other)."""
    _, _, _, st, m = _problem(perturb=0.1)
    p0 = torch.tensor([0.5, -1.25, 1.0])
    st = st._replace(p=st.p.clone(), q=st.q.clone(), lm=st.lm.clone(),
                     lm_valid=st.lm_valid.clone())
    st.p[0], st.q[0] = p0, torch.tensor([1.0, 0.0, 0.0, 0.0])
    st.lm[0], st.lm_valid[0] = p0 + torch.tensor([2.0, 0.0, 0.0]), True
    obs, vis = m.obs.clone(), m.vis.clone()
    obs[0, 0] = 0.0
    vis[0, 0] = vis[1, 0] = True
    m = m._replace(obs=obs, vis=vis)
    assert float(tba.reprojection_residuals(st, m)[0, 0].abs().max()) == 0.0
    cost0 = 0.5 * float(torch.sum(tba._all_residuals(st, m) ** 2))
    for s_, c_ in (ck.window_lm_twin(st, m, 12), tba.solve_window_fast(st, m, iters=12)):
        assert torch.isfinite(s_.p).all() and float(c_) < 0.5 * cost0


def test_block_sum_order():
    """The kernel's block sum: lane i mod 1024 in index order, then the
    warps' halving trees. Integers add exactly in any order; a float vector
    matches its float64 sum to rounding; and the order is not torch.sum's."""
    v = torch.arange(3000, dtype=torch.float32)
    assert float(wl.block_sum(v)) == float(v.double().sum())
    x = torch.from_numpy(np.random.default_rng(0).normal(size=2500).astype(np.float32))
    assert float(wl.block_sum(x)) == pytest.approx(float(x.double().sum()), abs=1e-4)
    lanes = torch.zeros(1024)
    lanes[:5] = torch.tensor([1e8, 1.0, -1e8, 1.0, 1.0])
    # warp 0 halves: offset 4 adds lane 4's 1 to lane 0's 1e8 (absorbed in
    # float32), offset 2 cancels 1e8 with lane 2's -1e8 and adds lanes 1
    # and 3, offset 1 leaves 0 + 2; a sum in index order gives 1
    assert float(wl.block_sum(lanes)) == 2.0


def test_kernel_work_and_plan():
    """The roofline's counts grow with the iterations and the data; the
    launch plan (one cluster of 4 blocks of 256 threads) fits a block's
    shared memory up to K = 21 and refuses beyond it."""
    b0, o0 = ck.kernel_work("window_lm", k=10, l=600, iters=0, prior=150)
    b8, o8 = ck.kernel_work("window_lm", k=10, l=600, iters=8, prior=150)
    assert b0 == b8 and o0 == 150 * 150 * 151 and o8 > o0
    few = ck.kernel_work("window_lm", k=10, l=600, iters=8, prior=150, obs=1204, pairs=4233)
    assert few[0] == b8 and few[1] < o8
    assert ck.kernel_work("window_lm", k=10, l=600, iters=8)[0] < b8       # no prior to read
    assert ck.WINDOW_LM_MAX_K == 21
    for k in range(1, ck.WINDOW_LM_MAX_K + 1):
        for p in (0, 15 * k, 15 * k + 1):
            plan = ck.window_lm_plan(k, 1100, p)
            assert plan.threads * plan.cluster == 1024 and plan.cluster == 4
            assert plan.smem_bytes <= ck.MAX_DYNAMIC_SMEM
    assert ck.window_lm_plan(10, 600, 150) == ck.WindowLmPlan(103848, 428280, 256, 4)
    assert ck.window_lm_plan(21, 600, 315) == ck.WindowLmPlan(214860, 1040531, 256, 4)
    with pytest.raises(ValueError):
        ck.window_lm_plan(22, 600, 0)


def test_wrapper_refusals():
    """What the kernel does not take raises on either device: float64, a
    full-tangent `PriorFactor`, K above 21, a prior of more than 15K + 1
    rows, a negative iteration count."""
    _, _, st, m = _window("K5")
    k = st.p.shape[0]
    with pytest.raises(ValueError, match="dtype"):
        ck.window_lm(st._replace(p=st.p.double()), m)
    full = tba.PriorFactor(j=torch.zeros(3, 15 * k + 3 * st.lm.shape[0]), r0=torch.zeros(3),
                           p=st.p, q=st.q, v=st.v, bg=st.bg, ba=st.ba, lm=st.lm)
    with pytest.raises(ValueError, match="camera-only"):
        ck.window_lm(st, m._replace(prior=full))
    big = tba.CamPriorFactor(j=torch.zeros(15 * k + 2, 15 * k), r0=torch.zeros(15 * k + 2),
                             p=st.p, q=st.q, v=st.v, bg=st.bg, ba=st.ba)
    with pytest.raises(ValueError, match="15K"):
        ck.window_lm(st, m._replace(prior=big))
    with pytest.raises(ValueError, match="iters"):
        ck.window_lm(st, m, -1)
    _, _, _, st22, m22 = _problem(seed=2, duration=10.5, n_lm=20)
    assert st22.p.shape[0] == 22
    with pytest.raises(ValueError, match="K"):
        ck.window_lm(st22, m22)


def test_cpu_solve_keeps_its_body(monkeypatch):
    """On CPU tensors `solve_window_fast` runs its own body: the wrapper is
    not called (the CPU tests and the lockstep front-end test see today's
    arithmetic)."""
    _, _, st, m = _window("K5")

    def refuse(*_a, **_k):
        raise AssertionError("window_lm called on CPU tensors")

    monkeypatch.setattr(ck, "window_lm", refuse)
    _, c = tba.solve_window_fast(st, m, iters=2)
    assert torch.isfinite(c)

"""Port parity for the dense step as a whole: `fuse_measurement` chains of
the port against `cvids_tpu` from the same state (carried across by
`cvids_tpu_torch.interop`), and the port alone through the reference's
end-to-end depth check.

Slice parity runs with dtype="float32": in bf16 the JAX package's CPU path
carries the SGM recurrence in bf16 while its Pallas kernel (and the port)
carry it in fp32, so bf16 is held per kernel in test_torch_kernel_twins.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.dense import estimator as je
from cvids_tpu.ops.image import gaussian_blur
from cvids_tpu_torch import interop
from cvids_tpu_torch.dense import estimator as te

H, W, D = 48, 64, 32


def _to_numpy_tree(state):
    return jax.tree_util.tree_map(np.asarray, state)


def _views(rng, depth=2.0, baselines=(0.1, 0.15, 0.2), smooth=1.5):
    """A fronto-parallel textured plane seen from a reference camera and
    x-translated measurement cameras (as tests/test_dense.py builds it)."""
    k = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    pad = 40
    tex = rng.uniform(0, 255, (H, W + 2 * pad)).astype(np.float32)
    tex = np.asarray(gaussian_blur(jnp.asarray(tex), smooth))
    ref = tex[:, pad:pad + W]
    views = []
    for b in baselines:
        shift = int(round(k[0, 0] * b / depth))
        views.append((tex[:, pad + shift:pad + shift + W],
                      (k @ np.linalg.inv(k)).astype(np.float32),
                      (k @ np.array([-b, 0.0, 0.0], np.float32)).astype(np.float32)))
    return ref, views, k


def _cfg_kw(dtype="float32"):
    inv = np.linspace(1.0 / 8.0, 1.0 / 0.8, D).astype(np.float32)
    return dict(height=H, width=W, num_depths=D, dep_sample=float(inv[1] - inv[0]),
                tau2_scale=0.5, pi1=2.0, pi2=8.0, dtype=dtype)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("sparse", [False, True])
def test_fuse_chain_matches_jax(rng, sparse):
    ref, views, _ = _views(rng)
    jc, tc = je.DenseConfig(**_cfg_kw()), te.DenseConfig(**_cfg_kw())
    kw = {}
    if sparse:
        gy, gx = np.mgrid[4:H - 4:8, 4:W - 4:8]
        uv = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
        kw = dict(sparse_uv=jnp.asarray(uv),
                  sparse_inv_depth=jnp.full(len(uv), 0.5, jnp.float32),
                  sparse_valid=jnp.ones(len(uv), bool))
    js = je.init_reference(jc, jnp.asarray(ref), **kw)
    ts = interop.dense_state_to_torch(_to_numpy_tree(js), "cpu")
    assert (ts.sparse_bias is None) == (not sparse)
    for meas, a, b in views:
        js = je.fuse_measurement(jc, js, jnp.asarray(meas), jnp.asarray(a),
                                 jnp.asarray(b))
        ts = te.fuse_measurement(tc, ts, _t(meas), _t(a), _t(b))
    out = interop.dense_state_to_numpy(ts)
    # counts are small integers: exact
    np.testing.assert_array_equal(out.count, np.asarray(js.count))
    # running means of fp32 box costs; the two sweeps differ by one fp32
    # rounding per sample (bilinear fetch vs hat-weight matmul)
    np.testing.assert_allclose(out.mean_cost, np.asarray(js.mean_cost), atol=1e-3)
    # SGM/WTA is discrete, but at ~1e-5 cost differences no argmin flips on
    # this scene, so the filter agrees to fp32 precision everywhere (the Beta
    # counts grow to ~30, hence the relative tolerance)
    for name in ("mu", "sigma2", "a", "b"):
        np.testing.assert_allclose(getattr(out.filt, name),
                                   np.asarray(getattr(js.filt, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert int(out.num_frames) == int(js.num_frames) == len(views)
    # finalize: the same converged mask
    np.testing.assert_array_equal(te.finalize(tc, ts)[1].numpy(),
                                  np.asarray(je.finalize(jc, js)[1]))


def test_dense_pipeline_end_to_end_port(rng):
    """tests/test_dense.py's end-to-end depth check, on the port alone, in
    the default bf16 volumes."""
    depth = 2.0
    inv = np.linspace(1.0 / 8.0, 1.0 / 0.8, D).astype(np.float32)
    cfg = te.DenseConfig(height=H, width=W, num_depths=D,
                         dep_sample=float(inv[1] - inv[0]),
                         tau2_scale=0.5, pi1=2.0, pi2=8.0)
    assert cfg.torch_dtype == torch.bfloat16
    assert cfg.inv_depths[0] < 1.0 / depth < cfg.inv_depths[-1]
    ref, views, _ = _views(rng, depth=depth)
    st = te.init_reference(cfg, _t(ref))
    for meas, a, b in views:
        st = te.fuse_measurement(cfg, st, _t(meas), _t(a), _t(b))
    inv_d, ok = te.finalize(cfg, st)
    crop = (slice(10, -10), slice(10, -10))
    okc = ok.numpy()[crop]
    est = 1.0 / np.maximum(inv_d.numpy()[crop], 1e-6)
    assert okc.mean() > 0.5, okc.mean()
    assert abs(np.median(est[okc]) - depth) < 0.3, np.median(est[okc])


def test_banded_and_exact_warp_agree_on_the_slice(rng):
    """The banded warp (twin on the CPU) and the exact warp give the same
    depth on an identity-rotation chain, as the host gate assumes."""
    ref, views, _ = _views(rng)
    cfg = te.DenseConfig(**_cfg_kw())
    mu, ok = [], []
    for banded in (False, True):
        st = te.init_reference(cfg, _t(ref))
        for meas, a, b in views:
            st = te.fuse_measurement(cfg, st, _t(meas), _t(a), _t(b),
                                     banded_warp=banded)
        mu.append(st.filt.mu.numpy())
        ok.append(te.finalize(cfg, st)[1].numpy())
    # identity rotation: the banded warp returns the image itself, the exact
    # warp its bf16 rounding (its rounding point), so the costs differ by
    # < 1 intensity level; the estimated depth barely moves
    crop = (slice(10, -10), slice(10, -10))
    assert (ok[0][crop] == ok[1][crop]).mean() > 0.95
    assert np.median(np.abs(mu[0] - mu[1])[crop]) < 1e-3


def test_state_helpers_match_jax(rng):
    ref, views, k = _views(rng)
    jc, tc = je.DenseConfig(**_cfg_kw()), te.DenseConfig(**_cfg_kw())
    js = je.init_reference(jc, jnp.asarray(ref))
    for meas, a, b in views[:2]:
        js = je.fuse_measurement(jc, js, jnp.asarray(meas), jnp.asarray(a),
                                 jnp.asarray(b))
    ts = interop.dense_state_to_torch(_to_numpy_tree(js), "cpu")
    # init_reference: gradients and penalty map (fp32 element-wise)
    ti = te.init_reference(tc, _t(ref))
    ji = je.init_reference(jc, jnp.asarray(ref))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(ji.grad), rtol=1e-6)
    np.testing.assert_allclose(ti.penalty.numpy(), np.asarray(ji.penalty), rtol=1e-5)
    # regularize_depth: 3x3 weighted mean, same taps in the same order
    np.testing.assert_allclose(te.regularize_depth(ts).filt.mu.numpy(),
                               np.asarray(je.regularize_depth(js).filt.mu),
                               rtol=1e-5, atol=1e-6)
    # validate_photometric: a strict threshold on the same fp32 errors
    meas, a, b = views[0]
    ok_t = te.validate_photometric(tc, ts, _t(meas), _t(a), _t(b), max_err=8.0)
    ok_j = je.validate_photometric(jc, js, jnp.asarray(meas), jnp.asarray(a),
                                   jnp.asarray(b), max_err=8.0)
    assert (ok_t.numpy() == np.asarray(ok_j)).mean() > 0.999
    # propagate_reference: the forward splat (see test_torch_ops' tolerance)
    pr_t = te.propagate_reference(tc, ts, _t(ref), torch.eye(3), torch.zeros(3), _t(k))
    pr_j = je.propagate_reference(jc, js, jnp.asarray(ref), jnp.eye(3),
                                  jnp.zeros(3), jnp.asarray(k))
    assert np.isclose(pr_t.filt.mu.numpy(), np.asarray(pr_j.filt.mu),
                      rtol=1e-4, atol=1e-5).mean() > 0.98
    assert int(pr_t.num_frames) == 0


def test_splat_sparse_matches_jax(rng):
    jc, tc = je.DenseConfig(**_cfg_kw()), te.DenseConfig(**_cfg_kw())
    uv = np.stack([rng.uniform(-2, W + 1, 30), rng.uniform(-2, H + 1, 30)],
                  -1).astype(np.float32)
    inv = rng.uniform(0.2, 1.0, 30).astype(np.float32)
    valid = rng.uniform(size=30) > 0.2
    ref = je.splat_sparse(jc, jnp.asarray(uv), jnp.asarray(inv), jnp.asarray(valid))
    out = te.splat_sparse(tc, _t(uv), _t(inv), _t(valid))
    # (2r+1)^2 weighted sums in the same order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("order", ["forward", "reversed"])
def test_splat_sparse_duplicates_match_jax(rng, order):
    """Several valid landmarks on one pixel, and rejected ones (invalid or
    out of the image, all sent to the spare slot): the port keeps the
    landmark the reference's scatter keeps on the CPU, the last one, in
    either order, and equals it exactly; ten runs give the same bits."""
    jc, tc = je.DenseConfig(**_cfg_kw()), te.DenseConfig(**_cfg_kw())
    n = 40
    uv = np.stack([rng.uniform(-2, W + 1, n), rng.uniform(-2, H + 1, n)], -1).astype(np.float32)
    uv[5:9] = [[7.2, 5.1], [6.9, 4.8], [7.4, 5.3], [6.6, 4.6]]     # all round to (7, 5)
    uv[20:23] = [[11.0, 3.0], [11.3, 2.8], [10.8, 3.2]]            # (11, 3), one invalid
    inv = rng.uniform(0.2, 1.0, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    valid[5:9] = True
    valid[20:23] = [True, True, False]
    if order == "reversed":
        uv, inv, valid = uv[::-1].copy(), inv[::-1].copy(), valid[::-1].copy()
    ref = np.asarray(je.splat_sparse(jc, jnp.asarray(uv), jnp.asarray(inv), jnp.asarray(valid)))
    outs = [te.splat_sparse(tc, _t(uv), _t(inv), _t(valid)).numpy() for _ in range(10)]
    np.testing.assert_allclose(outs[0], ref, rtol=1e-5, atol=1e-4)
    assert all(np.array_equal(o, outs[0]) for o in outs[1:])
    # the pixel's mean depth is the last landmark's: radius 0 shows the splat
    last = inv[np.nonzero(valid & (np.round(uv) == [7, 5]).all(1))[0][-1]]
    ref0 = np.asarray(je.splat_sparse(jc, jnp.asarray(uv), jnp.asarray(inv),
                                      jnp.asarray(valid), radius=0))
    out0 = te.splat_sparse(tc, _t(uv), _t(inv), _t(valid), radius=0).numpy()
    np.testing.assert_array_equal(out0, ref0)
    want = np.abs(np.asarray(tc.inv_depths) - last) / tc.dep_sample * tc.sparse_ratio
    np.testing.assert_allclose(out0[5, 7], want, rtol=1e-6)
    # no landmark at all
    empty = te.splat_sparse(tc, torch.zeros((0, 2)), torch.zeros(0),
                            torch.zeros(0, dtype=torch.bool))
    assert empty.shape == (H, W, D) and not empty.any()


def test_interop_round_trip_bf16(rng):
    jc = je.DenseConfig(**_cfg_kw("bfloat16"))
    ref, _, _ = _views(rng)
    js = je.init_reference(jc, jnp.asarray(ref))
    js = js._replace(mean_cost=jnp.asarray(rng.uniform(0, 50, (H, W, D)), jnp.bfloat16))
    ts = interop.dense_state_to_torch(_to_numpy_tree(js), "cpu")
    assert ts.mean_cost.dtype == torch.bfloat16 and ts.num_frames.dtype == torch.int32
    back = interop.dense_state_to_numpy(ts)
    # bf16 -> tensor -> float32 numpy is exact
    np.testing.assert_array_equal(back.mean_cost,
                                  np.asarray(js.mean_cost.astype(jnp.float32)))
    np.testing.assert_array_equal(back.filt.mu, np.asarray(js.filt.mu))
    # the port updates volumes in place: the tensors own their memory
    ts.mean_cost.zero_()
    assert np.asarray(js.mean_cost.astype(jnp.float32)).any()

"""The plain PyTorch twins of the port's six CUDA kernels against the
Pallas kernels they replace, run in interpret mode on the CPU (and against
the XLA functions whose contract they share), at the shapes of
`tests/test_pallas.py` and of the port's paths; and the CPU dispatch of the
wrappers.

The CUDA kernels themselves run only on the card, where `chip_smoke.py`
holds each against its twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.ops import costvolume as jcv
from cvids_tpu.ops import depth_filter as jdf
from cvids_tpu.ops import hamming as jham
from cvids_tpu.ops import pallas_kernels as pk
from cvids_tpu.ops.image import projective_warp_mxu as jax_warp_mxu
from cvids_tpu_torch.ops import cuda_kernels as ck
from cvids_tpu_torch.ops import depth_filter as tdf


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _homography(kind, h, w):
    k = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]])
    if kind == "identity":
        r = np.eye(3)
    else:
        a, b = 0.02, -0.03
        rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        r = rx @ ry
    return (k @ r @ np.linalg.inv(k)).astype(np.float32), k


@pytest.mark.parametrize("kind", ["identity", "rotation"])
def test_warp_banded_twin_matches_pallas(rng, kind):
    h, w = 32, 128
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    m, _ = _homography(kind, h, w)
    a_p, c_p = pk.projective_warp_banded(jnp.asarray(img), jnp.asarray(m),
                                         band_x=8, band_y=8, interpret=True)
    a_t, c_t = ck.projective_warp_banded_twin(_t(img), _t(m), band_x=8, band_y=8)
    # coverage: sums of hat weights in [0, 2]; the Pallas wrapper computes
    # the warp positions inside jit, where fused multiply-adds move them by
    # a few fp32 ulps
    np.testing.assert_allclose(_np(c_t), np.asarray(c_p), atol=1e-5)
    # value: a position moved by ~1e-5 px moves a sample of this 255-scale
    # white-noise image by up to ~255 * 1e-5 per pass
    np.testing.assert_allclose(_np(a_t), np.asarray(a_p), atol=1e-2)
    if kind == "identity":
        np.testing.assert_array_equal(_np(a_t), np.asarray(a_p))


def test_warp_banded_twin_band_edge(rng):
    """Shifts beyond the band lose coverage in both; inside it, the banded
    warp equals the exact warp with fp32 weights."""
    h, w = 32, 128
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    m = np.eye(3, dtype=np.float32)
    m[0, 2] = 6.5                      # x_in = u + 6.5: inside band 8, not band 4
    a8, c8 = ck.projective_warp_banded_twin(_t(img), _t(m), band_x=8, band_y=8)
    a4, c4 = ck.projective_warp_banded_twin(_t(img), _t(m), band_x=4, band_y=8)
    a_p, c_p = pk.projective_warp_banded(jnp.asarray(img), jnp.asarray(m),
                                         band_x=4, band_y=8, interpret=True)
    np.testing.assert_array_equal(_np(c4), np.asarray(c_p))
    np.testing.assert_array_equal(_np(a4), np.asarray(a_p))
    assert (_np(c4) == 0).all()
    a_x, c_x = jax_warp_mxu(jnp.asarray(img), jnp.asarray(m),
                            weight_dtype=jnp.float32)
    # a half-pixel shift: weights 0.5 exactly, so the two forms agree to an
    # fp32 rounding of the 255-scale value
    np.testing.assert_allclose(_np(c8), np.asarray(c_x), atol=1e-6)
    np.testing.assert_allclose(_np(a8), np.asarray(a_x), atol=1e-4)


def test_plane_sweep_twin_matches_pallas(rng):
    h, w, d = 16, 128, 8
    ref = rng.uniform(0, 255, (h, w)).astype(np.float32)
    meas = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]], np.float32)
    r = np.eye(3, dtype=np.float32)
    r[0, 1], r[1, 0] = 0.01, -0.01
    a_mat = jnp.asarray(k @ r @ np.linalg.inv(k))
    b_vec = jnp.asarray(k @ np.array([-0.1, 0.02, 0.01], np.float32))
    inv_depths = jnp.asarray((np.arange(d) + 1) * 0.05, jnp.float32)
    pos = jcv._sweep_positions(a_mat, b_vec, inv_depths, h, w)
    mc, cov = jax_warp_mxu(jnp.asarray(meas), a_mat)
    meas_al = np.asarray(mc / jnp.maximum(cov, 1e-3))
    cd = pk.plane_sweep_pallas(jnp.asarray(ref), jnp.asarray(meas_al), *pos,
                               out_dtype=jnp.float32, interpret=True)
    c_p = np.transpose(np.asarray(cd), (1, 2, 0))
    for dt in (torch.float32, torch.bfloat16):
        c_t = _np(ck.plane_sweep_twin(_t(ref), _t(meas_al),
                                      *(_t(np.asarray(p)) for p in pos),
                                      out_dtype=dt))
        assert c_t.shape == (h, w, d)
        # validity comes from the same positions: identical masks
        np.testing.assert_array_equal(c_t >= 0, c_p >= 0)
        both = (c_t >= 0) & (c_p >= 0)
        err = np.abs(c_t - c_p)[both]
        # the Pallas kernel resamples with bf16 matmul operands and sums the
        # box in bf16; the twin is fp32 (stored bf16 in the bf16 case): the
        # tolerances of test_pallas.py's sweep check
        assert err.max() < 1.5, err.max()
        assert err.mean() < 0.2, err.mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [48, 45])
def test_sgm_scan_twin_matches_pallas(rng, s, dtype):
    cost = rng.uniform(0, 50, (s, 32, 128)).astype(np.float32)
    p2 = rng.uniform(30, 70, (s, 32)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    cost_j, p2_j = jnp.asarray(cost, jdt), jnp.asarray(p2, jdt)
    ref = pk.sgm_scan_bidir(cost_j, p2_j, jnp.asarray(16.0), interpret=True)
    # the twin gets the reference's exact (possibly bf16-rounded) inputs
    cost_t = _t(np.asarray(cost_j.astype(jnp.float32))).to(tdt)
    p2_t = _t(np.asarray(p2_j.astype(jnp.float32))).to(tdt)
    out = ck.sgm_scan_bidir_twin(cost_t, p2_t, torch.tensor(16.0), axis=0)
    assert out.dtype == tdt
    # fp32 carries, each direction rounded to the cost dtype, then added in
    # the cost dtype, in the kernel's operation order: exact
    np.testing.assert_array_equal(_np(out), np.asarray(ref.astype(jnp.float32)))


def test_sgm_scan_twin_axis1_matches_pallas(rng):
    h, w, d = 16, 32, 128
    cost = rng.uniform(0, 50, (h, w, d)).astype(np.float32)
    p2 = rng.uniform(30, 90, (h, w)).astype(np.float32)
    ref = pk.sgm_scan_bidir_axis1(jnp.asarray(cost), jnp.asarray(p2),
                                  jnp.asarray(16.0), interpret=True)
    out = ck.sgm_scan_bidir_twin(_t(cost), _t(p2), torch.tensor(16.0), axis=1)
    # same recurrence and order along axis 1: exact
    np.testing.assert_array_equal(_np(out), np.asarray(ref))
    # and the axis-1 scan is the axis-0 scan of the swapped volume
    swapped = ck.sgm_scan_bidir_twin(_t(cost).transpose(0, 1).contiguous(),
                                     _t(p2).T.contiguous(), torch.tensor(16.0))
    np.testing.assert_array_equal(_np(out), _np(swapped.transpose(0, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_wta_twin_matches_pallas(rng, n_parts, dtype):
    h, w, d = 8, 16, 128
    parts = [rng.uniform(0, 50, (h, w, d)).astype(np.float32) for _ in range(n_parts)]
    for k, p in enumerate(parts):
        p[0, 0, :] = 5.0 * (k + 1)                # all tied: first index wins
    parts[0][1, 1, 3] = parts[0][1, 1, 90] = -80.0
    parts[0][2, 2, 0] = -100.0                    # minimum at the boundaries
    parts[0][3, 3, d - 1] = -100.0
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    pj = [jnp.asarray(p, jdt) for p in parts]
    i_p, c_p = pk.wta_pallas(*pj, interpret=True)
    pt = [_t(np.asarray(p.astype(jnp.float32))).to(tdt) for p in pj]
    i_t, c_t = ck.wta_twin(*pt)
    # the parts are summed in fp32 in the same order; argmin, parabola and
    # second best are then the same fp32 expressions (test_pallas.py's
    # tolerance on the subpixel index)
    np.testing.assert_allclose(_np(i_t), np.asarray(i_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(c_t), np.asarray(c_p))
    assert _np(i_t)[0, 0] == 0.0


def test_cpu_dispatch_routes_to_twins(rng):
    ck.reset_launches()
    h, w, d = 8, 16, 32
    img = _t(rng.uniform(0, 255, (h, w)).astype(np.float32))
    m = torch.eye(3)
    np.testing.assert_array_equal(_np(ck.projective_warp_banded(img, m, 4, 4)[0]),
                                  _np(ck.projective_warp_banded_twin(img, m, 4, 4)[0]))
    pos_x = torch.arange(w, dtype=torch.float32).repeat(d, 1)
    pos_y = torch.arange(h, dtype=torch.float32).repeat(d, 1)
    mx = torch.stack([pos_x, torch.zeros_like(pos_x), torch.ones_like(pos_x)], 1)
    my = torch.stack([torch.zeros_like(pos_y), pos_y, torch.zeros_like(pos_y)], 1)
    sweep = ck.plane_sweep(img, img, pos_x, pos_y, mx, my)
    np.testing.assert_array_equal(_np(sweep),
                                  _np(ck.plane_sweep_twin(img, img, pos_x, pos_y, mx, my)))
    assert (_np(sweep) == 0).all()           # the image against itself
    cost = _t(rng.uniform(0, 50, (h, w, d)).astype(np.float32))
    p2 = torch.full((h, w), 64.0)
    np.testing.assert_array_equal(_np(ck.sgm_scan_bidir(cost, p2, 16.0, axis=1)),
                                  _np(ck.sgm_scan_bidir_twin(cost, p2, 16.0, axis=1)))
    np.testing.assert_array_equal(_np(ck.wta(cost, cost)[0]),
                                  _np(ck.wta_twin(cost, cost)[0]))
    a = _t(rng.integers(0, 2 ** 32, (5, 8), dtype=np.uint32).view(np.int32))
    np.testing.assert_array_equal(_np(ck.hamming_matrix(a, a[:3])),
                                  _np(ck.hamming_matrix_twin(a, a[:3])))
    st = tdf.init_state(h, w)
    x = torch.full((h, w), 0.4)
    valid = torch.ones((h, w), dtype=torch.bool)
    for o, r in zip(ck.depth_filter_update(st, x, 0.01, valid),
                    ck.depth_filter_update_twin(st, x, 0.01, valid)):
        np.testing.assert_array_equal(_np(o), _np(r))
    # nothing was launched: the CPU tensors went to the twins
    assert ck.launches == {"warp_banded": 0, "plane_sweep": 0, "sgm_scan": 0, "wta": 0,
                           "hamming_matrix": 0, "depth_filter_update": 0}


def test_dispatch_rejects_mixed_devices():
    with pytest.raises(ValueError):
        ck._on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        ck._require_depths(48)
    ck._require_depths(128)


def _descriptors(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


@pytest.mark.parametrize("n,m", [(1, 1), (37, 129), (160, 512), (128, 256), (50, 1)])
def test_hamming_twin_matches_pallas(rng, n, m):
    """Ragged shapes, exact tile multiples and M == 1; exact (integers)."""
    a, b = _descriptors(rng, n), _descriptors(rng, m)
    b[: min(n, m) // 2] = a[: min(n, m) // 2]        # some zero distances
    a_valid = rng.random(n) > 0.2
    b_valid = rng.random(m) > 0.2
    ta, tb = _t(a.view(np.int32)), _t(b.view(np.int32))
    raw = pk.hamming_matrix(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_array_equal(_np(ck.hamming_matrix_twin(ta, tb)), np.asarray(raw))
    for av, bv in ((a_valid, None), (None, b_valid), (a_valid, b_valid)):
        ref = jham.hamming_distance_matrix(
            jnp.asarray(a), jnp.asarray(b), None if av is None else jnp.asarray(av),
            None if bv is None else jnp.asarray(bv))
        out = ck.hamming_matrix_twin(ta, tb, None if av is None else _t(av),
                                     None if bv is None else _t(bv))
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(_np(out), np.asarray(ref))


def test_popcount32_all_bit_patterns(rng):
    words = np.concatenate([rng.integers(0, 2 ** 32, 4096, dtype=np.uint32),
                            np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 0x80000001], np.uint32)])
    want = np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(1)
    np.testing.assert_array_equal(_np(ck.popcount32(_t(words.view(np.int32)))), want)


def _filter_inputs(rng, h, w, tau2_kind):
    st = [rng.uniform(0.1, 1.5, (h, w)).astype(np.float32),
          rng.uniform(1e-4, 0.5, (h, w)).astype(np.float32),
          rng.uniform(5.0, 40.0, (h, w)).astype(np.float32),
          rng.uniform(5.0, 40.0, (h, w)).astype(np.float32)]
    x = rng.uniform(0.05, 2.0, (h, w)).astype(np.float32)
    x[0, :3] = [0.001, 500.0, 100.5]                     # outside mu_range
    valid = rng.random((h, w)) > 0.2
    valid[0, 1] = False                                  # invalid and out of range
    tau2 = (np.float32(0.01) if tau2_kind == "scalar"
            else rng.uniform(1e-3, 0.05, (h, w)).astype(np.float32))
    return st, x, tau2, valid


@pytest.mark.parametrize("tau2_kind", ["scalar", "map"])
@pytest.mark.parametrize("h,w", [(8, 128), (13, 37)])
def test_depth_filter_twin_matches_pallas(rng, h, w, tau2_kind):
    st, x, tau2, valid = _filter_inputs(rng, h, w, tau2_kind)
    jst = jdf.FilterState(*map(jnp.asarray, st))
    tau2_j = jnp.broadcast_to(jnp.asarray(tau2), (h, w))
    ref_p = pk.depth_filter_update(jst, jnp.asarray(x), tau2_j, jnp.asarray(valid),
                                   interpret=True)
    ref_x = jdf.update(jst, jnp.asarray(x), tau2_j, jnp.asarray(valid))
    tau2_t = float(tau2) if tau2_kind == "scalar" else _t(tau2)
    out = ck.depth_filter_update_twin(tdf.FilterState(*map(_t, st)), _t(x), tau2_t, _t(valid))
    # The same element-wise fp32 expression, but exp, sqrt (the Pallas
    # kernel: rsqrt) and XLA's fusion round differently by an ulp or two;
    # mu agrees to 2 ulp. sigma2_new = c1 (s + m²) + c2 (s2 + mu²) - mu_new²
    # cancels (error ~ eps·mu²/sigma2) and the Beta moment matching divides
    # by f - e/f ~ f(1-f)/(a+b+1): on these inputs the reference's own Pallas
    # kernel and XLA function differ by up to 4.0e-4 (sigma2) and 2.0e-5
    # (a, b) relative, the twin by as much; each field is held to a bound
    # above that measurement.
    rtol = {"mu": 1e-6, "sigma2": 1e-3, "a": 1e-4, "b": 1e-4}
    for name, o, rp, rx in zip(tdf.FilterState._fields, out, ref_p, ref_x):
        np.testing.assert_allclose(_np(o), np.asarray(rp), rtol=rtol[name], atol=1e-7,
                                   err_msg=name)
        np.testing.assert_allclose(_np(o), np.asarray(rx), rtol=rtol[name], atol=1e-7,
                                   err_msg=name)
    # the range gate and the b + 1 bump on a valid out-of-range measurement
    for k in range(3):
        assert _np(out.mu)[0, k] == st[0][0, k]
    assert _np(out.b)[0, 1] == st[3][0, 1]               # invalid: unchanged
    assert _np(out.b)[0, 2] == np.float32(st[3][0, 2] + 1.0)

"""The plain PyTorch twins of the port's six CUDA kernels against the
Pallas kernels they replace, run in interpret mode on the CPU (and against
the XLA functions whose contract they share), at the shapes of
`tests/test_pallas.py` and of the port's paths; and the CPU dispatch of the
wrappers.

The CUDA kernels themselves run only on the card, where `chip_smoke.py`
holds each against its twin.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))   # chip_smoke.py

from cvids_tpu.ops import costvolume as jcv
from cvids_tpu.ops import depth_filter as jdf
from cvids_tpu.ops import hamming as jham
from cvids_tpu.ops import pallas_kernels as pk
from cvids_tpu.ops.image import projective_warp_mxu as jax_warp_mxu
from cvids_tpu_torch.ops import cuda_kernels as ck
from cvids_tpu_torch.ops import depth_filter as tdf
from cvids_tpu_torch.ops.image import warp_pass_positions


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


# power-of-two entries, so that every product in the positions is exact and
# fused multiply-adds inside jit cannot move them: the pass-1 inversion
# degenerates at row 16 (m11 - 16 m21 = 0), and y_in = 16 + 16 / v keeps
# rows 9 to 25 within band_y = 8 of it
_DEGENERATE_ROW = np.array([[1, 0, 0.25], [0, 1, 1], [0, 1.0 / 16, 0]], np.float32)
# y_in = 16 (v + 16) / (v + 16): every output row samples the degenerate row
_DEGENERATE_ROW_SAMPLED = np.array([[1, 0, 0.25], [0, 1, 16], [0, 1.0 / 16, 1]], np.float32)


def _perspective(h, w):
    """A homography with m20 and m21 well away from 0 (a camera turned about
    all three axes), shifts within the bands of 8."""
    k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
    a, b, c = 0.04, -0.05, 0.02
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
    return (k @ rz @ rx @ ry @ np.linalg.inv(k)).astype(np.float32)


@pytest.mark.parametrize("kind", ["degenerate_row", "degenerate_row_sampled", "perspective"])
def test_warp_banded_twin_matches_pallas_maps(rng, kind):
    """The maps the fused CUDA kernel computes its positions for: a row
    inside the image where the pass-1 inversion degenerates (g = -1e9, no
    coverage from it, its neighbours covered), a map that samples only that
    row, and a perspective map."""
    h, w = 32, 128
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    m = {"degenerate_row": _DEGENERATE_ROW, "degenerate_row_sampled": _DEGENERATE_ROW_SAMPLED,
         "perspective": _perspective(h, w)}[kind]
    a_p, c_p = pk.projective_warp_banded(jnp.asarray(img), jnp.asarray(m),
                                         band_x=8, band_y=8, interpret=True)
    a_t, c_t = ck.projective_warp_banded_twin(_t(img), _t(m), band_x=8, band_y=8)
    # the tolerances of test_warp_banded_twin_matches_pallas
    np.testing.assert_allclose(_np(c_t), np.asarray(c_p), atol=1e-5)
    np.testing.assert_allclose(_np(a_t), np.asarray(a_p), atol=1e-2)
    covered = _np(c_t) > 0.5
    if kind == "degenerate_row":
        den = m[1, 1] - np.arange(h, dtype=np.float32) * m[2, 1]
        assert (np.abs(den) < 1e-3).nonzero()[0].tolist() == [16]
        # v = 16 samples row 17 alone; v = 32 would sample the degenerate row
        assert covered[16].all() and not covered[:8].any() and not covered[26:].any()
    elif kind == "degenerate_row_sampled":
        # without g = -1e9 on row 16, rows 8 to 24 would be fully covered
        assert (_np(c_t) == 0).all() and (np.asarray(c_p) == 0).all()
    else:
        assert abs(m[2, 0]) > 5e-4 and abs(m[2, 1]) > 5e-4
        assert covered.mean() > 0.7


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


def _check_plane_sweep_twin(rng, h, w, d):
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
        if both.any():        # a single row has no sample in view
            assert err.max() < 1.5, err.max()
            assert err.mean() < 0.2, err.mean()


def test_plane_sweep_twin_matches_pallas(rng):
    _check_plane_sweep_twin(rng, 16, 128, 8)


@pytest.mark.parametrize("h,w", [(9, 31), (8, 30), (17, 61), (1, 33), (11, 29)])
def test_plane_sweep_twin_matches_pallas_ragged(rng, h, w):
    """Heights and widths that are not multiples of the CUDA kernel's
    8 x 30 tile (one row or column over, one under, exactly one tile, a
    single row)."""
    _check_plane_sweep_twin(rng, h, w, 4)


def _check_sgm_scan_twin(rng, s, x, d, dtype):
    cost = rng.uniform(0, 50, (s, x, d)).astype(np.float32)
    p2 = rng.uniform(30, 70, (s, x)).astype(np.float32)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [48, 45])
def test_sgm_scan_twin_matches_pallas(rng, s, dtype):
    _check_sgm_scan_twin(rng, s, 32, 128, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 2, 3, 7, 15, 17, 33])
def test_sgm_scan_twin_matches_pallas_short(rng, s, dtype):
    """Scan lengths around the CUDA kernel's ring: one and two rows (the two
    directions meet at once), odd lengths (both reach the middle row in the
    same step), shorter than the 8-row ring, one under and over twice it, and
    one over four times it; a line count that leaves a block's last group spare."""
    _check_sgm_scan_twin(rng, s, 3, 128, dtype)


@pytest.mark.parametrize("d", [32, 64, 96, 160, 192, 224, 256])
def test_sgm_scan_twin_matches_pallas_depths(rng, d):
    """Every D/32 that takes another lane grouping in the CUDA kernel."""
    _check_sgm_scan_twin(rng, 9, 5, d, "float32")


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


def _built_wta_rows(d):
    """Rows that decide what the CUDA kernel's lane groups must get right,
    as {name: (row of part 0, expected first-minimum index)}; the other
    parts are constant."""
    base = np.linspace(10.0, 40.0, d).astype(np.float32)
    rows = {}
    for name, at in (("tie_15_16", (15, 16)), ("tie_31_32", (31, 32)),
                     ("tie_far", (100, 7)), ("first", (0,)), ("last", (d - 1,))):
        r = base.copy()
        r[list(at)] = -80.0
        rows[name] = (r, min(at))
    rows["plateau"] = (np.full(d, 3.0, np.float32), 0)
    r = -base
    r[40:72] = -90.0                                  # a plateau across lanes
    rows["negative_plateau"] = (r, 40)
    r = np.full(d, 0.0, np.float32)
    r[5] = -0.0                                        # -0 == +0: index 0 wins
    rows["signed_zero"] = (r, 0)
    return rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_parts", [1, 3])
def test_wta_twin_matches_pallas_built(n_parts, dtype):
    """Built rows (ties across the positions where the CUDA kernel's lanes
    and vectors meet, plateaus, the ends, negative values, signed zeros):
    the twin equals the Pallas kernel exactly. Every multiplication of the
    parabola is by a power of two, so fused multiply-adds cannot move it."""
    d = 128
    rows = _built_wta_rows(d)
    h, w = 8, 16
    parts = [np.full((h, w, d), 1.5 * k, np.float32) for k in range(n_parts)]
    parts[0][:] = np.linspace(20.0, 30.0, d, dtype=np.float32)
    for i, (row, _) in enumerate(rows.values()):
        parts[0][i // w, i % w] = row
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    pj = [jnp.asarray(p, jdt) for p in parts]
    i_p, c_p = pk.wta_pallas(*pj, interpret=True)
    pt = [_t(np.asarray(p.astype(jnp.float32))).to(tdt) for p in pj]
    i_t, c_t = ck.wta_twin(*pt)
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_p))
    np.testing.assert_array_equal(_np(c_t), np.asarray(c_p))
    # the parabola moves a discrete minimum by at most half a step (two
    # adjacent tied minima give first + 0.5 whichever of them is taken; the
    # far tie and the plateaus tell the first from a later one)
    for i, (name, (_, first)) in enumerate(rows.items()):
        assert abs(_np(i_t)[i // w, i % w] - first) <= 0.5, name


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
    st = tdf.init_state(h, w, device="cpu")
    x = torch.full((h, w), 0.4)
    valid = torch.ones((h, w), dtype=torch.bool)
    for o, r in zip(ck.depth_filter_update(st, x, 0.01, valid),
                    ck.depth_filter_update_twin(st, x, 0.01, valid)):
        np.testing.assert_array_equal(_np(o), _np(r))
    sym = _t(rng.normal(size=(4, 5, 5)).astype(np.float32))
    for o, r in zip(ck.small_eigh(sym @ sym.transpose(-1, -2)),
                    ck.small_eigh_twin(sym @ sym.transpose(-1, -2))):
        np.testing.assert_array_equal(_np(o), _np(r))
    # nothing was launched: the CPU tensors went to the twins
    assert ck.launches == {"warp_banded": 0, "plane_sweep": 0, "sgm_scan": 0, "wta": 0,
                           "hamming_matrix": 0, "depth_filter_update": 0, "small_eig": 0}


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


# ---------------------------------------------------------------------------
# What Python decides about a launch: plans and the roofline work
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", range(32, 257, 32))
def test_sgm_scan_plan(d, dtype):
    itemsize = 2 if dtype == torch.bfloat16 else 4
    for lines in (1, 3, 480, 641):
        plan = ck.sgm_scan_plan(lines, d, dtype)
        # lanes x vectors x 16 bytes cover a D-row exactly, in aligned groups
        assert plan.group in (4, 8, 16, 32) and 32 % plan.group == 0
        row_bytes = d * itemsize
        assert plan.group * plan.vectors * 16 == row_bytes
        depths_per_lane = plan.vectors * 16 // itemsize
        assert depths_per_lane * plan.group == d
        # every row start of either axis is 16-byte aligned from an aligned
        # base: row strides are multiples of the row's bytes
        assert row_bytes % 16 == 0
        for axis_stride in (d, 641 * d):             # elements, axis 1 and axis 0
            assert (axis_stride * itemsize) % 16 == 0
        # a block carries both directions of whole lines
        lines_per_block = 32 // plan.group
        assert plan.threads == 2 * plan.group * lines_per_block == 64
        assert plan.grid * lines_per_block >= lines > (plan.grid - 1) * lines_per_block
        # two rings (cost rows, partial rows) of `stages` rows per thread
        assert plan.stages == (8 if plan.vectors <= 4 else 4)
        assert plan.smem_bytes == 2 * plan.stages * plan.vectors * 16 * plan.threads
        assert plan.smem_bytes <= 64 * 1024 < ck.MAX_DYNAMIC_SMEM
        # the deeper ring wherever both rings of a block fit 64 KB
        assert plan.stages == 8 or 2 * 8 * plan.vectors * 16 * plan.threads > 64 * 1024
    # the main path: 16 lanes a line and direction, 8 bf16 a lane, 8 stages
    if d == 128 and dtype == torch.bfloat16:
        assert (plan.group, depths_per_lane, plan.stages) == (16, 8, 8)


def test_sgm_scan_plan_rejects():
    with pytest.raises(ValueError):
        ck.sgm_scan_plan(8, 48, torch.float32)
    with pytest.raises(ValueError):
        ck.sgm_scan_plan(8, 64, torch.float16)


@pytest.mark.parametrize("h,w,d", [(480, 640, 128), (37, 53, 32), (1, 33, 64),
                                   (8, 30, 64), (9, 31, 96), (16, 128, 256)])
def test_plane_sweep_plan(h, w, d):
    plan = ck.plane_sweep_plan(h, w, d)
    th, tw, db = plan.tile_h, plan.tile_w, plan.tile_d
    # the halo columns fill whole groups of 8 (the gather's thread map), the
    # depth block whole 8-depth store chunks
    assert (tw + 2) % 8 == 0 and db % 8 == 0 and db % 32 == 0
    # the tiles cover the volume and none is empty
    gx, gy, gz = plan.grid
    assert gx * tw >= w > (gx - 1) * tw
    assert gy * th >= h > (gy - 1) * th
    assert gz * db >= d > (gz - 1) * db
    # one output chunk column per thread at most in the box phase
    assert tw * (db // 8) <= plan.threads == 256
    # |diff| of the halo tile (depth run padded by 4 floats), two float4 per
    # (halo row, depth), the reference tile
    want = 4 * (th + 2) * (tw + 2) * (db + 4) + 32 * (th + 2) * db + 4 * (th + 2) * (tw + 2)
    assert plan.smem_bytes == want
    # two blocks per SM, each with its 1 KB reserve, inside the SM's 228 KB
    assert plan.smem_bytes <= ck.MAX_DYNAMIC_SMEM
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    # the float4 reads of a pixel's depth run stay 16-byte aligned
    assert ((db + 4) * 4) % 16 == 0
    # every output chunk (8 depths) starts 16-byte aligned in both dtypes
    for itemsize in (2, 4):
        assert (d * itemsize) % 16 == 0 and (8 * itemsize) % 16 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", range(32, 257, 32))
def test_wta_plan(d, dtype):
    itemsize = 2 if dtype == torch.bfloat16 else 4
    n_vec = d * itemsize // 16
    for npix in (1, 3, 31, 33, 37 * 53, 480 * 640, 481 * 641):
        plan = ck.wta_plan(npix, d, dtype)
        # aligned power-of-two groups inside a warp, whole pixels per warp
        assert plan.group in (4, 8, 16, 32) and 32 % plan.group == 0
        # whole 16-byte vectors per lane, 1 or 2 a part; the group's slots
        # cover the D-row, and no lane is without a vector
        assert plan.vectors in (1, 2)
        assert plan.group * plan.vectors >= n_vec > plan.group * (plan.vectors - 1)
        # the smallest such group: half of it would need more than 2 vectors
        assert plan.group == 4 or plan.group // 2 * 2 < n_vec
        # whole warps, whole groups, within a block's limit
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        assert plan.pixels_per_block * plan.group == plan.threads
        # the grid covers every pixel and no block is empty
        assert plan.grid * plan.pixels_per_block >= npix > (plan.grid - 1) * plan.pixels_per_block
        assert plan.grid <= 2 ** 31 - 1
        # every row start is 16-byte aligned from an aligned base
        assert (d * itemsize) % 16 == 0
    # the main path: 8 lanes a pixel, 2 vectors (16 bf16) a lane and part
    if d == 128 and dtype == torch.bfloat16:
        assert plan[:4] == (8, 2, 256, 32)


def test_wta_plan_rejects():
    with pytest.raises(ValueError):
        ck.wta_plan(8, 48, torch.float32)
    with pytest.raises(ValueError):
        ck.wta_plan(8, 64, torch.float16)


# hand-computed at 640x480x128 bf16 (and 160x512 Hamming with both masks):
# bytes with every input read once and every output written once
_WORK = {
    # img 1,228,800 in; out and coverage 2 x 1,228,800; the 3x3 map 36
    "warp_banded": (dict(h=480, w=640), 3_686_436, 60 * 307_200),
    # volume 39,321,600 x 2; ref + meas 2 x 1,228,800; tables 4 x 128 x 1120 x 4
    "plane_sweep": (dict(h=480, w=640, d=128, itemsize=2),
                    78_643_200 + 2_457_600 + 2_293_760,
                    32 * 39_321_600 + 8 * 1120 * 128),
    # cost in and sum out 2 x 78,643,200; P2 614,400; P1 4
    "sgm_scan": (dict(s=480, x=640, d=128, itemsize=2), 157_286_400 + 614_400 + 4,
                 17 * 39_321_600),
    # two parts 2 x 78,643,200; idx_f 1,228,800 and conf 307,200
    "wta": (dict(h=480, w=640, d=128, itemsize=2, parts=2), 157_286_400 + 1_536_000,
            5 * 39_321_600),
    # state 4, x 1, new state 4 maps of 1,228,800; the mask 307,200
    "depth_filter_update": (dict(h=480, w=640), 9 * 1_228_800 + 307_200, 60 * 307_200),
    # descriptors (160 + 512) x 32; distances 160 x 512 x 4; masks 672
    "hamming_matrix": (dict(n=160, m=512), 21_504 + 327_680 + 672, 24 * 81_920),
    # 128 fp64 9x9 systems in, their eigenvalues and eigenvectors out; a
    # matrix: 8 sweeps x 36 rotations x (18 x 9 + 15) and 81 rank compares
    "small_eig": (dict(batch=128, n=9, itemsize=8), 8 * 128 * (81 + 9 + 81),
                  128 * (8 * 36 * 177 + 81)),
}


@pytest.mark.parametrize("name", sorted(_WORK))
def test_kernel_work(name):
    shape, want_bytes, want_ops = _WORK[name]
    assert set(_WORK) == set(ck.launches)
    got = ck.kernel_work(name, **shape)
    assert got == (want_bytes, want_ops)
    assert all(isinstance(v, int) for v in got)
    # in MB: 3.7, 83.4, 157.9 (315.8 for a frame's two launches), 158.8, 11.4,
    # 0.35, 0.18
    mb = {"warp_banded": 3.7, "plane_sweep": 83.4, "sgm_scan": 157.9, "wta": 158.8,
          "depth_filter_update": 11.4, "hamming_matrix": 0.35, "small_eig": 0.18}[name]
    assert abs(got[0] / 1e6 - mb) < 0.06
    if name == "plane_sweep":
        # the weights and in-bounds tests of one coordinate are counted per
        # table entry, so on an H100 (3.35 TB/s, 67 TFLOP/s) bytes bound it
        assert got[0] / 3.35e12 > got[1] / 67e12
    if name == "depth_filter_update":
        assert ck.kernel_work(name, tau2_map=True, **shape)[0] == want_bytes + 1_228_800
    if name == "hamming_matrix":
        assert ck.kernel_work(name, a_mask=False, b_mask=False, **shape)[0] == want_bytes - 672
    with pytest.raises(KeyError):
        ck.kernel_work("no_such_kernel")


@pytest.mark.parametrize("n,m", [(160, 512), (2048, 2048), (1, 1), (37, 129),
                                 (160, 1), (33, 4097), (1, 4097), (7, 100_000),
                                 (262_140, 1), (262_141, 3), (2_000_000, 130)])
def test_hamming_plan(n, m):
    plan = ck.hamming_plan(n, m)
    assert (plan.tile_m, plan.tile_n, plan.threads) == (128, 4, 128)
    # a thread owns one column, a warp stores 128 contiguous bytes of a row
    gx, gy = plan.grid
    assert gx * plan.tile_n >= n > (gx - 1) * plan.tile_n
    assert gy * plan.tile_m >= m > (gy - 1) * plan.tile_m
    # the first 2 * tile_n threads load the A tile as 16-byte vectors
    assert 2 * plan.tile_n <= plan.threads
    # the row tiles lie along the grid's first extent (CUDA allows 2^31 - 1
    # there), the column tiles along its second (65,535)
    assert gx <= 2 ** 31 - 1 and gy <= 65535
    if (n, m) == (160, 512):        # the loop verification: 160 blocks for 132 SMs
        assert plan.grid == (40, 4)
    if (n, m) == (2048, 2048):
        assert plan.grid == (512, 16)
    with pytest.raises(ValueError):
        ck.hamming_plan(0, m)


@pytest.mark.parametrize("h,w", [(480, 640), (37, 53), (1, 33), (1, 3), (1, 4), (2, 3),
                                 (3, 5), (5, 7), (16, 32), (127, 5)])
def test_depth_filter_update_on_cpu_any_shape(rng, h, w):
    """The wrapper takes any (H, W), a single short row and the dense path's map
    included: on CPU tensors it gives the bits of `ops.depth_filter.update`
    with a scalar or a map tau2, and the reference's values within
    `test_depth_filter_twin_matches_pallas`'s bounds."""
    st, x, tau2, valid = _filter_inputs(rng, h, w, "map")
    state = tdf.FilterState(*map(_t, st))
    out = ck.depth_filter_update(state, _t(x), _t(tau2), _t(valid))
    want = tdf.update(state, _t(x), _t(tau2), _t(valid))
    scalar = ck.depth_filter_update(state, _t(x), 0.01, _t(valid))
    want_scalar = tdf.update(state, _t(x), torch.tensor(0.01), _t(valid))
    ref = jdf.update(jdf.FilterState(*map(jnp.asarray, st)), jnp.asarray(x),
                     jnp.asarray(tau2), jnp.asarray(valid))
    rtol = {"mu": 1e-6, "sigma2": 1e-3, "a": 1e-4, "b": 1e-4}
    for name, o, w_, s_, ws, r in zip(tdf.FilterState._fields, out, want, scalar,
                                      want_scalar, ref):
        assert o.shape == (h, w) and o.dtype == torch.float32
        assert torch.equal(o, w_) and torch.equal(s_, ws), name
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=rtol[name], atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("which", range(3))
def test_warp_banded_twin_nonfinite_positions(rng, which):
    """A map whose positions are NaN or infinite (a NaN survives a clamp and
    would index wildly) gives value 0 and coverage 0 and no error: a
    non-finite position lies in no band. The same maps are in
    `chip_smoke.warp_edge_maps`, where the kernel is held to the twin."""
    import chip_smoke
    name, m = sorted(chip_smoke.nonfinite_warp_maps().items())[which]
    h, w = 9, 13
    g, y_in = warp_pass_positions(_t(m), h, w)
    assert not (torch.isfinite(g).all() and torch.isfinite(y_in).all()), name
    img = _t(rng.uniform(1, 255, (h, w)).astype(np.float32))
    out, cov = ck.projective_warp_banded_twin(img, _t(m), band_x=8, band_y=4)
    assert out.shape == cov.shape == (h, w)
    assert (_np(out) == 0).all() and (_np(cov) == 0).all(), name
    # a finite map through the same code keeps its coverage
    _, cov_id = ck.projective_warp_banded_twin(img, torch.eye(3), band_x=8, band_y=4)
    assert (_np(cov_id) == 1).all()

"""The port's pyramidal LK tracker (`ops.klt.track_points`, on the CPU the
twin of `cuda_kernels.klt_track`) against `cvids_tpu.ops.klt.track_points`.

The same inputs, made from numpy seeds, go through both packages: textured
160x128 image pairs, translated, rotated and with an exposure bias, and
points that include one at the border, one given as invalid, one in a flat
patch (a singular Gram matrix) and one seeded far off. Cases: the
front-end's settings (4 levels x 15 iterations, the forward-backward gate
at 1.5 px, residual < 35, seeded) and the defaults, then N = 1, all points
invalid, radius 3 at 1-4 levels and an odd image size: `valid` equal, `xy`
within KLT_TOL px and the residual within 1e-3. Then the twin's ordered
window sums against float64 sums and written out in their order, and the
kernel's launch plan (its roofline work and a CPU call of the wrapper are
among every kernel's in `tests/test_torch_kernel_twins.py`). The kernel
against the twin on a card is in `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.ops import klt as jklt
from cvids_tpu_torch.ops import cuda_kernels as ck
from cvids_tpu_torch.ops import klt as tklt
from cvids_tpu_torch.ops.image import build_pyramid

KLT_TOL = 1e-3      # px
RES_TOL = 1e-3      # mean absolute intensity
H, W = 128, 160
FRONTEND = dict(levels=4, iters=15, fb_thresh=1.5, max_residual=35.0)
DEFAULTS = dict()


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the twin runs many small ops, which many
    threads slow down when xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _texture(seed, h=H, w=W, dx=0.0, dy=0.0, angle=0.0, bias=0.0, flat=None):
    """A band-limited texture of 12 random sinusoids in [~40, ~210], moved by
    (dx, dy) px and rotated by `angle` about the centre, plus `bias`.
    `flat` (x0, y0, x1, y1) makes that box (in the unmoved frame) constant."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    c, s = np.cos(angle), np.sin(angle)
    xc, yc = xx - w / 2 - dx, yy - h / 2 - dy
    u, v = c * xc + s * yc + w / 2, -s * xc + c * yc + h / 2
    img = np.full((h, w), 125.0)
    for _ in range(12):
        k = rng.uniform(0.05, 0.35)
        th = rng.uniform(0, np.pi)
        img += 7.0 * np.sin(k * (np.cos(th) * u + np.sin(th) * v) + rng.uniform(0, 2 * np.pi))
    if flat is not None:
        x0, y0, x1, y1 = flat
        img[(u >= x0) & (u <= x1) & (v >= y0) & (v <= y1)] = 125.0
    return (img + bias).astype(np.float32)


FLAT = (96.0, 80.0, 156.0, 124.0)     # a constant corner box


def _pair(motion):
    img0 = _texture(1, flat=FLAT)
    img1 = {"translate": lambda: _texture(1, dx=2.3, dy=-1.7, flat=FLAT),
            "rotate": lambda: _texture(1, angle=0.05, flat=FLAT),
            "bias": lambda: _texture(1, dx=-1.1, dy=0.8, bias=12.0, flat=FLAT)}[motion]()
    return img0, img1


def _points(n=40, seed=3):
    """n points: random ones, then the border point, an invalid one (index
    5), a point in the flat box and one seeded 60 px off."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(20, 90, n), rng.uniform(20, 70, n)], -1).astype(np.float32)
    pts[-1] = [2.0, 2.0]                   # at the border: lost
    pts[-2] = [128.0, 104.0]               # in the flat box: no gradient
    valid = np.ones(n, bool)
    valid[5] = False
    init = pts + rng.normal(0, 0.5, pts.shape).astype(np.float32)
    init[-3] += [60.0, -45.0]              # seeded far off
    return pts, valid, init


def _both(img0, img1, pts, valid, init, **kw):
    """(JAX result, port result) as numpy (xy, valid, residual)."""
    rj = jklt.track_points(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                           jnp.asarray(valid), init_xy=None if init is None else jnp.asarray(init),
                           **kw)
    rt = tklt.track_points(_t(img0), _t(img1), _t(pts), _t(valid),
                           init_xy=None if init is None else _t(init), **kw)
    return ([np.asarray(x) for x in rj], [x.numpy() for x in rt])


def _agree(rj, rt):
    np.testing.assert_array_equal(rt[1], rj[1])
    np.testing.assert_allclose(rt[0], rj[0], atol=KLT_TOL, rtol=0)
    np.testing.assert_allclose(rt[2], rj[2], atol=RES_TOL, rtol=0)


@pytest.mark.parametrize("motion", ["translate", "rotate", "bias"])
@pytest.mark.parametrize("settings", ["frontend", "defaults"])
def test_track_points_matches_jax(motion, settings):
    img0, img1 = _pair(motion)
    pts, valid, init = _points()
    kw = FRONTEND if settings == "frontend" else DEFAULTS
    rj, rt = _both(img0, img1, pts, valid, init if settings == "frontend" else None, **kw)
    _agree(rj, rt)
    assert rt[1].sum() >= 25, rt[1]
    assert not rt[1][5] and not rt[1][-1] and not rt[1][-2]


def test_flat_image_keeps_the_seed():
    """A black image: every Gram matrix is 0 (det = 0, inv_det = 0), so no
    step is taken, the points keep their seeds and none is valid."""
    img = np.zeros((H, W), np.float32)
    pts, valid, init = _points(8)
    rj, rt = _both(img, img, pts, valid, init, **FRONTEND)
    _agree(rj, rt)
    np.testing.assert_array_equal(rt[0], init)
    assert not rt[1].any()


@pytest.mark.parametrize("case", ["one point", "all invalid"])
def test_track_points_edge_batches(case):
    img0, img1 = _pair("translate")
    pts, valid, init = _points()
    if case == "one point":
        pts, valid, init = pts[:1], valid[:1], init[:1]
    else:
        valid[:] = False
    rj, rt = _both(img0, img1, pts, valid, init, **FRONTEND)
    _agree(rj, rt)
    assert rt[1].all() if case == "one point" else not rt[1].any()


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_track_points_radius3_odd_image(levels):
    """radius 3 (a 7x7 window, 49 pixels: two columns a lane, the second
    padded) on a 97x131 pair, each level count."""
    h, w = 97, 131
    img0 = _texture(4, h, w)
    img1 = _texture(4, h, w, dx=1.3, dy=0.6)
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(8, w - 8, 24), rng.uniform(8, h - 8, 24)], -1).astype(np.float32)
    rj, rt = _both(img0, img1, pts, np.ones(24, bool), None, radius=3, levels=levels, iters=8,
                   fb_thresh=1.0, max_residual=40.0)
    _agree(rj, rt)
    assert rt[1].sum() >= 12


@pytest.mark.parametrize("p", [1, 31, 32, 33, 49, 441, 449])
def test_lane_sum_matches_float64(p):
    rng = np.random.default_rng(p)
    v = rng.normal(0, 50, (16, p)).astype(np.float32)
    got = ck.lane_sum(_t(v)).numpy().astype(np.float64)
    want = v.astype(np.float64).sum(1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(v).sum(1).max())


def test_lane_sum_order():
    """Lane l adds columns l, l + 32, ... from 0, then the halving adds:
    the sum of 33 values written out in that order, bit for bit."""
    rng = np.random.default_rng(0)
    v = (rng.normal(0, 1, 33) * 1e3 ** rng.integers(0, 3, 33)).astype(np.float32)
    acc = [np.float32(0) for _ in range(32)]
    for i in range(33):
        acc[i % 32] = np.float32(acc[i % 32] + v[i])
    half = 16
    while half:
        acc = [np.float32(acc[i] + acc[i + half]) for i in range(half)]
        half //= 2
    assert ck.lane_sum(_t(v[None])).numpy()[0] == acc[0]


def test_klt_plan():
    """A block a point, a thread a window slot (at most 1024), the summing
    warp's lanes adding `cols` slots each."""
    assert ck.klt_plan(150, 10) == ck.KltPlan(448, 14, 4 * 14 * 32 * 4, 150)
    assert ck.klt_plan(1, 0) == ck.KltPlan(32, 1, 512, 1)
    assert ck.klt_plan(7, 3) == ck.KltPlan(64, 2, 4 * 2 * 32 * 4, 7)
    assert ck.klt_plan(2, 15).threads == 31 * 32         # 961 pixels, 992 slots
    big = ck.klt_plan(3, ck.KLT_MAX_RADIUS)
    assert big.threads == 1024 and big.cols == 76       # 2432 slots, up to 3 a thread
    assert big.smem_bytes <= 48 * 1024            # no opt-in above the static limit
    for n, r in ((0, 10), (5, -1), (5, ck.KLT_MAX_RADIUS + 1)):
        with pytest.raises(ValueError):
            ck.klt_plan(n, r)


def test_wrapper_rejects_mixed_devices():
    img = _t(_texture(2))
    pyr = build_pyramid(img, 2)
    xy = torch.zeros((3, 2))
    with pytest.raises(ValueError):
        ck.klt_track(pyr, pyr, xy.to("meta"), torch.ones(3, dtype=torch.bool), xy)

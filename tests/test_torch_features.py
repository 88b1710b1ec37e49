"""The port's feature front-end against `cvids_tpu.ops` on the CPU.

The same inputs, made from a numpy seed, go through the JAX functions and
the port's: FAST scores bit for bit (integer and random-float images),
keypoint selection with the same points and order (planted ties included),
BRIEF words equal as uint32 and the pattern file across the packages, KLT
positions within 1e-3 px with the same status on translated and rotated
textures at 3 levels, the essential-matrix pose with the JAX draws injected
(the same inliers; the same pose to 1e-4 where every hypothesis is
exact), the held-out vocabulary equal node for node, and the host copies of the renderer equal to the originals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.io import render as jrender
from cvids_tpu.ops import brief as jbrief
from cvids_tpu.ops import fast as jfast
from cvids_tpu.ops import image as jimage
from cvids_tpu.ops import klt as jklt
from cvids_tpu.ops import ransac as jransac
from cvids_tpu_torch.io import render as trender
from cvids_tpu_torch.ops import brief as tbrief
from cvids_tpu_torch.ops import fast as tfast
from cvids_tpu_torch.ops import klt as tklt
from cvids_tpu_torch.ops import ransac as transac

KLT_TOL = 1e-3      # px


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run thousands of small ops, which
    many threads slow down several times over when xdist workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _image(rng, kind, h=96, w=128):
    if kind == "int":
        return rng.integers(0, 256, (h, w)).astype(np.float32)
    return (rng.random((h, w)) * 255).astype(np.float32)


def _texture(h=120, w=160, dx=0.0, dy=0.0, angle=0.0):
    """A smooth band-limited texture, moved by (dx, dy) px and rotated by
    `angle` about the image centre."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    c, s = np.cos(angle), np.sin(angle)
    x0, y0 = xx - w / 2 - dx, yy - h / 2 - dy
    x, y = c * x0 + s * y0 + w / 2, -s * x0 + c * y0 + h / 2
    return (120 + 40 * np.sin(0.31 * x + 0.2 * y) + 30 * np.cos(0.17 * x - 0.41 * y)
            + 20 * np.sin(0.11 * x) * np.cos(0.13 * y)).astype(np.float32)


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("threshold", [12.0, 20.0])
def test_fast_score_map_bit_exact(kind, threshold):
    img = _image(np.random.default_rng(0), kind)
    want = np.asarray(jfast.fast_score_map(jnp.asarray(img), threshold))
    got = tfast.fast_score_map(_t(img), threshold).numpy()
    assert (want > 0).sum() > 100
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tfast.fast_score_map(_t(img), threshold, nms=False).numpy(),
        np.asarray(jfast.fast_score_map(jnp.asarray(img), threshold, nms=False)))


def _ties_score(rng, h=96, w=128):
    """A score map whose cells tie: equal maxima inside a cell, and equal
    cell winners across cells."""
    s = np.zeros((h, w), np.float32)
    ys, xs = rng.integers(0, h, 200), rng.integers(0, w, 200)
    s[ys, xs] = rng.choice([5.0, 7.5, 9.0], 200).astype(np.float32)
    s[3, 3] = s[3, 6] = 11.0       # two maxima in one 8x8 cell
    return s


@pytest.mark.parametrize("case", ["random", "ties", "existing"])
def test_select_keypoints_same_points_and_order(case):
    rng = np.random.default_rng(1)
    score = (np.asarray(jfast.fast_score_map(jnp.asarray(_image(rng, "float")), 12.0))
             if case == "random" else _ties_score(rng))
    kw = {}
    if case == "existing":
        ex = rng.uniform(0, 128, (20, 2)).astype(np.float32)
        ok = rng.random(20) > 0.3
        kw_j = dict(existing_xy=jnp.asarray(ex), existing_valid=jnp.asarray(ok), min_dist=12.0)
        kw = dict(existing_xy=_t(ex), existing_valid=_t(ok), min_dist=12.0)
    else:
        kw_j = {}
    for max_num, cell in ((40, 8), (300, 8), (10, 30)):
        kj = jfast.select_keypoints(jnp.asarray(score), max_num, cell=cell, **kw_j)
        kt = tfast.select_keypoints(_t(score), max_num, cell=cell, **kw)
        np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))
        np.testing.assert_array_equal(kt.score.numpy(), np.asarray(kj.score))
        np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))


def test_brief_pattern_and_descriptors_equal():
    np.testing.assert_array_equal(tbrief.brief_pattern(7), jbrief.brief_pattern(7))
    np.testing.assert_array_equal(tbrief.brief_pattern(3, bits=64), jbrief.brief_pattern(3, bits=64))
    rng = np.random.default_rng(2)
    img = _image(rng, "float", 96, 128)
    xy = np.concatenate([rng.integers(30, 70, (20, 2)), rng.uniform(30, 70, (30, 2))]
                        ).astype(np.float32)
    blurred = np.asarray(jimage.gaussian_blur(jnp.asarray(img), 2.0, radius=4))
    want = np.asarray(jbrief.compute_brief(jnp.asarray(blurred), jnp.asarray(xy), pre_blurred=True))
    got = tbrief.compute_brief(_t(blurred), _t(xy), pre_blurred=True).numpy().view(np.uint32)
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    # with each package's own blur
    want = np.asarray(jbrief.compute_brief(jnp.asarray(img), jnp.asarray(xy)))
    got = tbrief.compute_brief(_t(img), _t(xy)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_brief_pattern_yaml_across_packages(tmp_path):
    pat = jbrief.brief_pattern(seed=3)
    a, b = str(tmp_path / "from_jax.yml"), str(tmp_path / "from_port.yml")
    jbrief.save_brief_pattern_yaml(a, pat)
    tbrief.save_brief_pattern_yaml(b, pat)
    assert open(a).read() == open(b).read()
    np.testing.assert_array_equal(tbrief.load_brief_pattern_yaml(a), jbrief.load_brief_pattern_yaml(b))
    np.testing.assert_array_equal(tbrief.load_brief_pattern_yaml(a), pat)


@pytest.mark.parametrize("motion", ["translate", "rotate"])
def test_track_points_matches(motion):
    rng = np.random.default_rng(3)
    img0 = _texture()
    img1 = _texture(dx=2.3, dy=-1.7) if motion == "translate" else _texture(angle=0.05)
    pts = rng.uniform(20, 100, (40, 2)).astype(np.float32)
    pts[-1] = [2.0, 2.0]                       # at the border: lost
    valid = np.ones(40, bool)
    valid[5] = False
    init = pts + rng.normal(0, 0.5, pts.shape).astype(np.float32)
    for kw in (dict(), dict(fb_thresh=1.5, init_xy=init, max_residual=35.0)):
        rj = jklt.track_points(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                               jnp.asarray(valid), levels=3, iters=10,
                               **{k: (jnp.asarray(v) if k == "init_xy" else v) for k, v in kw.items()})
        rt = tklt.track_points(_t(img0), _t(img1), _t(pts), _t(valid), levels=3, iters=10,
                               **{k: (_t(v) if k == "init_xy" else v) for k, v in kw.items()})
        np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
        assert rt.valid.sum() >= 30
        np.testing.assert_allclose(rt.xy.numpy(), np.asarray(rj.xy), atol=KLT_TOL)
        np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual), atol=1e-3)


def _two_views(rng, n=120, outliers=15):
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], -1)
    ang = 0.08
    r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.5, 0.05, 0.1])
    p1c = pts @ r.T + t
    p0 = (pts[:, :2] / pts[:, 2:]).astype(np.float32)
    p1 = (p1c[:, :2] / p1c[:, 2:]).astype(np.float32)
    p1[:outliers] += rng.uniform(-0.1, 0.1, (outliers, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-10:] = False
    return p0, p1, valid, r, t / np.linalg.norm(t)


@pytest.mark.parametrize("outliers", [0, 15])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_essential_pose_with_jax_draws(seed, outliers):
    """The same minimal samples. Without outliers every hypothesis is
    exact, the same one wins in both packages, and each package's float32
    LAPACK pose is held to the float64 solve of that sample: within float32
    unit roundoff times the condition of the normalized 8-point system's
    nullspace, λmax / (λ2 - λ1) of AᵀA (measured: the unit translation at
    most 0.42 of it, the rotation 0.012; the two packages' translations
    differ by up to 1.2e-3 at seed 0, where the bound is 7.3e-3). With
    outliers many hypotheses tie on the inlier count and rounding picks
    among them, so the inlier sets are held equal and each package's pose
    to the truth."""
    rng = np.random.default_rng(seed)
    p0, p1, valid, r_true, t_true = _two_views(rng, outliers=outliers)
    key = jax.random.PRNGKey(seed)
    want = jransac.essential_pose(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), key)
    gumbel = _t(np.asarray(jax.random.gumbel(key, (128, len(p0)))))
    got = transac.essential_pose(_t(p0), _t(p1), _t(valid), gumbel)
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_pos) == int(want.num_pos)
    idx = np.asarray(jransac._sample_indices(key, 128, 8, len(p0), jnp.asarray(valid)))
    np.testing.assert_array_equal(transac._sample_indices(gumbel, _t(valid), 8).numpy(), idx)
    if outliers == 0:
        thresh = (1.5 / 460.0) ** 2
        f_j = jax.vmap(jransac._eight_point)(jnp.asarray(p0[idx]), jnp.asarray(p1[idx]))
        c_j = np.asarray(jnp.sum((jax.vmap(lambda f: jransac._sampson_error(
            f, jnp.asarray(p0), jnp.asarray(p1)))(f_j) < thresh) & valid[None], axis=1))
        f_t = transac._eight_point(_t(p0[idx]), _t(p1[idx]))
        c_t = torch.sum((transac._sampson_error(f_t, _t(p0), _t(p1)) < thresh)
                        & _t(valid)[None], dim=1).numpy()
        best = int(np.argmax(c_j))
        assert int(np.argmax(c_t)) == best and c_t[best] == c_j[best]
        exact = transac.essential_pose(_t(p0).double(), _t(p1).double(), _t(valid),
                                       gumbel[best:best + 1], jacobi=False)
        bound = 2.0 ** -24 * _eight_point_condition(p0[idx[best]], p1[idx[best]])
        for res in (got, want):
            np.testing.assert_allclose(np.asarray(res.r), exact.r.numpy(), atol=bound)
            np.testing.assert_allclose(np.asarray(res.t), exact.t.numpy(), atol=bound)
        z0, z1 = transac._two_view_depths(got.r, got.t, _t(p0), _t(p1))
        zj0, zj1 = jransac._two_view_depths(want.r, want.t, jnp.asarray(p0), jnp.asarray(p1))
        np.testing.assert_allclose(z0.numpy(), np.asarray(zj0), rtol=1e-2)
        np.testing.assert_allclose(z1.numpy(), np.asarray(zj1), rtol=1e-2)
    for r in (got.r.numpy(), np.asarray(want.r)):
        np.testing.assert_allclose(r, r_true, atol=0.02)


def _eight_point_condition(pa, pb):
    """λmax / (λ2 - λ1) of AᵀA of one sample's normalized 8-point system,
    in float64: how far float32 rounding moves its nullspace vector (F), in
    units of the roundoff."""
    def normalize(p):
        p = p.astype(np.float64) - p.mean(0)
        return p * (np.sqrt(2.0) / np.linalg.norm(p, axis=1).mean())
    (x1, y1), (x2, y2) = normalize(pa).T, normalize(pb).T
    a = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1)], -1)
    lam = np.linalg.eigvalsh(a.T @ a)
    return lam[-1] / (lam[1] - lam[0])


def test_generic_vocabulary_equal():
    from cvids_tpu.server import vocab as jvocab
    from cvids_tpu_torch.server import vocab as tvocab

    want = jvocab.generic_vocabulary(k=8, levels=3)
    got = tvocab.generic_vocabulary(k=8, levels=3, device="cpu")
    for f in ("children", "node_desc", "word_id", "weights"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))
    assert (got.k, got.levels, got.num_words) == (want.k, want.levels, want.num_words)


def test_render_blobs_and_photometric_copies():
    from cvids_tpu.camera import PinholeCamera as JPin
    from cvids_tpu_torch.camera import PinholeCamera as TPin

    rng = np.random.default_rng(4)
    lms = np.stack([rng.uniform(-4, 4, 300), rng.uniform(-3, 3, 300), rng.uniform(3, 9, 300)], -1)
    inten = rng.uniform(60, 180, 300)
    args = (lms, inten, np.eye(3), np.zeros(3), np.eye(3), np.zeros(3))
    jc = JPin.create(150.0, 150.0, 80.0, 60.0, (-0.1, 0.02, 0, 0), 160, 120)
    tc = TPin.create(150.0, 150.0, 80.0, 60.0, (-0.1, 0.02, 0, 0), 160, 120, device="cpu")
    want = jrender.render_blobs(jc, *args, idx_offset=123)
    got = trender.render_blobs(tc, *args, idx_offset=123)
    assert want.std() > 5.0
    np.testing.assert_array_equal(got, want)
    base = rng.uniform(0, 200, (120, 160)).astype(np.float32)
    kw = dict(exposure=1.2, vignette=0.3, noise_std=1.5, shot_noise=0.3, blur_px=3.2,
              blur_dir=(0.3, -1.0))
    np.testing.assert_array_equal(
        trender.apply_photometric(base, np.random.default_rng(9), **kw),
        jrender.apply_photometric(base, np.random.default_rng(9), **kw))
    np.testing.assert_array_equal(trender._render_patch(7, 4, 0.3, -0.2, 3.0),
                                  jrender._render_patch(7, 4, 0.3, -0.2, 3.0))

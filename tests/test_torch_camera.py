"""The port's camera models against `cvids_tpu.camera` on the CPU.

The same float32 inputs, made from a numpy seed, go through the JAX classes
and through the port's, built from the same numbers (`interop.
camera_to_torch` carries a JAX camera's fields across): `project`, `lift`,
`distort`, `undistort_iterative`, `in_view` and the rest of the four models
on the cases of `test_camera.py` and `test_extras.py`, to 1e-4 px and 1e-5
normalized, with those tests' round trips at their own tolerances;
`make_camera` on every model string; the chessboard response, detector and
renderer; the renderer through a camera of either package. The calibrators
are held in `test_torch_calib.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu import camera as jcam
from cvids_tpu.camera import chessboard as jboard
from cvids_tpu.camera import models as jmodels
from cvids_tpu.io import render as jrender
from cvids_tpu.utils.config import CameraConfig as JCameraConfig
from cvids_tpu_torch import camera as tcam
from cvids_tpu_torch import interop
from cvids_tpu_torch.camera import chessboard as tboard
from cvids_tpu_torch.camera import models as tmodels
from cvids_tpu_torch.io import render as trender
from cvids_tpu_torch.utils.config import CameraConfig
from test_camera import EUROC
from test_pipeline import look_at

PX_TOL = 1e-4       # pixels
NORM_TOL = 1e-5     # normalized coordinates


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def jax_camera(kind):
    """`test_camera.py`'s and `test_extras.py`'s cameras."""
    if kind == "pinhole":
        return jcam.PinholeCamera.create(**EUROC)
    if kind == "equidistant":
        return jcam.EquidistantCamera.create(280.0, 280.0, 376.0, 240.0,
                                             (-0.01, 0.02, -0.005, 0.001))
    if kind == "mei":
        return jcam.MeiCamera.create(0.9, 400.0, 400.0, 376.0, 240.0, (-0.1, 0.05, 0.0, 0.0))
    return jcam.ScaramuzzaCamera.create(poly=(-216.0, 0.0, 0.0016, -3.0e-7, 6.0e-10),
                                        c=1.001, d=0.0009, e=-0.0011, cx=376.0, cy=240.0)


def both(kind):
    cj = jax_camera(kind)
    return cj, interop.camera_to_torch(jax.tree_util.tree_map(np.asarray, cj), "cpu")


def points(rng, kind, n=200):
    """Camera-frame points in front of the camera, inside the model's field
    of view, and their normalized coordinates."""
    half = {"pinhole": 0.5, "equidistant": 0.8, "mei": 0.5, "scaramuzza": 0.5}[kind]
    nrm = rng.uniform(-half, half, (n, 2)).astype(np.float32)
    z = rng.uniform(1.0, 10.0, (n, 1)).astype(np.float32)
    return np.concatenate([nrm * z, z], -1), nrm


KINDS = ["pinhole", "equidistant", "mei", "scaramuzza"]


@pytest.mark.parametrize("kind", KINDS)
def test_project_matches_jax(rng, kind):
    cj, ct = both(kind)
    pts, _ = points(rng, kind)
    if kind == "scaramuzza":
        pts[:, 2] *= -1.0       # the OCam convention: the scene lies along -z
    ref = np.asarray(cj.project(jnp.asarray(pts)))
    out = ct.project(_t(pts)).numpy()
    assert out.shape == ref.shape == (200, 2) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=PX_TOL, rtol=1e-6)
    # batch dimensions pass through
    np.testing.assert_allclose(ct.project(_t(pts.reshape(4, 50, 3))).numpy().reshape(-1, 2), out,
                               atol=0, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_lift_matches_jax(rng, kind):
    """`lift` of the pixels the reference projects; the round trip holds at
    the reference tests' tolerances (2e-4 pinhole, 2e-3 equidistant, 5e-3
    Mei; the OCam model returns a ray parallel to the point)."""
    cj, ct = both(kind)
    pts, nrm = points(rng, kind)
    if kind == "scaramuzza":
        px = rng.uniform([80, 60], [670, 420], (64, 2)).astype(np.float32)
        ref = np.asarray(cj.lift(jnp.asarray(px)))
        out = ct.lift(_t(px)).numpy()
        # a ray in centred pixels: |z| is ~216, so 1e-4 px is 5e-7 relative
        np.testing.assert_allclose(out, ref, atol=PX_TOL, rtol=1e-6)
        back = ct.project(_t(out)).numpy()
        err = np.abs(back - px)
        assert np.median(err) < 0.2 and err.max() < 2.0, (np.median(err), err.max())
        return
    px = np.asarray(cj.project(jnp.asarray(pts)))
    ref = np.asarray(cj.lift(jnp.asarray(px)))
    out = ct.lift(_t(px)).numpy()
    np.testing.assert_allclose(out, ref, atol=NORM_TOL)
    roundtrip = {"pinhole": 2e-4, "equidistant": 2e-3, "mei": 5e-3}[kind]
    np.testing.assert_allclose(out, nrm, atol=roundtrip)


def test_pinhole_rest_matches_jax(rng):
    """`distort`, `undistort_iterative`, `project_normalized`,
    `lift_to_ray`, `in_view`, `k_matrix` and `test_camera.py`'s fixed
    cases."""
    cj, ct = both("pinhole")
    _, nrm = points(rng, "pinhole")
    dist = np.asarray(cj.dist)
    np.testing.assert_allclose(tcam.distort(_t(nrm), _t(dist)).numpy(),
                               np.asarray(jcam.distort(jnp.asarray(nrm), jnp.asarray(dist))),
                               atol=NORM_TOL * 1e-1)
    for iters in (1, 8):
        np.testing.assert_allclose(
            tcam.undistort_iterative(_t(nrm), _t(dist), iters).numpy(),
            np.asarray(jcam.undistort_iterative(jnp.asarray(nrm), jnp.asarray(dist), iters)),
            atol=NORM_TOL)
    np.testing.assert_allclose(ct.project_normalized(_t(nrm)).numpy(),
                               np.asarray(cj.project_normalized(jnp.asarray(nrm))), atol=PX_TOL)
    np.testing.assert_array_equal(ct.k_matrix.numpy(), np.asarray(cj.k_matrix))
    # test_project_center, test_no_distortion_is_linear, test_in_view, test_lift_to_ray
    np.testing.assert_allclose(ct.project(torch.tensor([0.0, 0.0, 2.0])).numpy(),
                               [EUROC["cx"], EUROC["cy"]], atol=1e-4)
    lin = tcam.PinholeCamera.create(400.0, 400.0, 320.0, 240.0, (0, 0, 0, 0), 640, 480,
                                    device="cpu")
    np.testing.assert_allclose(lin.project(torch.tensor([[0.1, -0.2, 1.0], [0.0, 0.0, 3.0]])),
                               [[360.0, 160.0], [320.0, 240.0]], atol=1e-4)
    px = np.array([[0.0, 0.0], [751.0, 479.0], [-1.0, 5.0], [400.0, 480.0]], np.float32)
    for margin in (0.0, 3.0):
        np.testing.assert_array_equal(ct.in_view(_t(px), margin).numpy(),
                                      np.asarray(cj.in_view(jnp.asarray(px), margin)))
    np.testing.assert_array_equal(ct.in_view(_t(px)).numpy(), [True, True, False, False])
    rays = ct.lift_to_ray(torch.tensor([[363.0, 248.1], [100.0, 50.0]]))
    np.testing.assert_allclose(
        rays.numpy(), np.asarray(cj.lift_to_ray(jnp.asarray([[363.0, 248.1], [100.0, 50.0]]))),
        atol=NORM_TOL)
    assert rays.shape == (2, 3) and rays[0, 2] == 1.0


def test_scaramuzza_create_fits_its_inverse(rng):
    """`create` without an inverse polynomial fits one (a degree-12 least
    squares in float32, solved through an SVD here and by XLA's `lstsq`
    there, so the coefficients differ while the curve agrees): the round
    trip meets `test_scaramuzza_roundtrip`'s bounds (median 0.2 px, max 2
    px; rays parallel at cos > 0.999) and the two cameras project within
    half of them of each other."""
    cj = jax_camera("scaramuzza")
    ct = tcam.ScaramuzzaCamera.create(poly=(-216.0, 0.0, 0.0016, -3.0e-7, 6.0e-10),
                                      c=1.001, d=0.0009, e=-0.0011, cx=376.0, cy=240.0,
                                      device="cpu")
    assert ct.inv_poly.shape == (13,) and (ct.width, ct.height) == (752, 480)
    px = rng.uniform([80, 60], [670, 420], (64, 2)).astype(np.float32)
    err = np.abs(ct.project(ct.lift(_t(px))).numpy() - px)
    assert np.median(err) < 0.2 and err.max() < 2.0, (np.median(err), err.max())
    pts = (rng.normal(0, 0.4, (64, 3)) + np.array([0, 0, 2.0])).astype(np.float32)
    uv = ct.project(_t(pts))
    rays = ct.lift(uv).numpy()
    cosang = np.sum(rays * pts, -1) / (np.linalg.norm(rays, axis=-1)
                                       * np.linalg.norm(pts, axis=-1))
    assert np.quantile(cosang, 0.1) > 0.999, cosang.min()
    rays_in = np.asarray(cj.lift(jnp.asarray(px)))
    diff = np.abs(ct.project(_t(rays_in)).numpy() - np.asarray(cj.project(jnp.asarray(rays_in))))
    assert np.median(diff) < 0.1 and diff.max() < 1.0, (np.median(diff), diff.max())
    # the forward polynomial back from the inverse one
    fwd_t = tmodels.fit_forward_poly(_t(np.asarray(cj.inv_poly))).numpy()
    fwd_j = np.asarray(jmodels.fit_forward_poly(cj.inv_poly))
    phi = np.linspace(20.0, 200.0, 50)
    np.testing.assert_allclose(np.polyval(fwd_t[::-1], phi), np.polyval(fwd_j[::-1], phi),
                               atol=0.5)


MODEL_STRINGS = ["pinhole", "radtan", "radial-tangential", "equidistant", "kannala_brandt",
                 "kannala-brandt", "fisheye", "mei", "cata", "unified", "PINHOLE", None]


@pytest.mark.parametrize("model", MODEL_STRINGS)
def test_make_camera(model):
    """The factory builds the class the reference's builds, with the same
    fields, from the port's `CameraConfig` and from any object with its
    fields; an unknown model raises, as there (no Scaramuzza branch)."""
    kw = dict(fx=190.0, fy=191.0, cx=160.0, cy=120.0, k1=-0.05, k2=0.01, p1=1e-3, p2=-2e-3,
              width=320, height=240, xi=0.9)
    if model is not None:
        kw["model"] = model
    cj = jcam.make_camera(JCameraConfig(**kw))
    ct = tcam.make_camera(CameraConfig(**kw), device="cpu")
    assert type(ct).__name__ == type(cj).__name__ and ct._fields == cj._fields
    for f, a, b in zip(ct._fields, ct, cj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    assert type(tcam.make_camera(JCameraConfig(**kw), device="cpu")) is type(ct)
    with pytest.raises(ValueError, match="unknown camera model"):
        tcam.make_camera(CameraConfig(model="scaramuzza"), device="cpu")


def test_camera_config_copy():
    import dataclasses
    assert dataclasses.asdict(CameraConfig()) == dataclasses.asdict(JCameraConfig())
    assert [f.name for f in dataclasses.fields(CameraConfig)] == \
        [f.name for f in dataclasses.fields(JCameraConfig)]


@pytest.mark.parametrize("kind", KINDS)
def test_interop_camera_round_trip(kind):
    """A camera crosses by its fields, in both directions, bit for bit;
    the class names, which the renderer and the server dispatch on, stay."""
    cj, ct = both(kind)
    assert type(ct).__name__ == type(cj).__name__
    assert all(isinstance(v, (torch.Tensor, int)) for v in ct)
    back = interop.camera_to_numpy(ct)
    for f, a, b in zip(cj._fields, back, cj):
        assert isinstance(a, (np.ndarray, int)), f
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    again = type(cj)(*(jnp.asarray(v) if isinstance(v, np.ndarray) else v for v in back))
    pts = np.array([[0.1, -0.2, 1.0 if kind != "scaramuzza" else -1.0]], np.float32)
    np.testing.assert_array_equal(np.asarray(again.project(jnp.asarray(pts))),
                                  np.asarray(cj.project(jnp.asarray(pts))))
    # a plain object with the fields, its class named by `kind`
    import types
    bag = types.SimpleNamespace(**{f: np.asarray(v) for f, v in zip(cj._fields, cj)})
    named = interop.camera_to_torch(bag, "cpu", kind=type(cj).__name__)
    assert type(named) is type(ct)
    np.testing.assert_array_equal(named.project(_t(pts)).numpy(), ct.project(_t(pts)).numpy())


@pytest.mark.parametrize("kind", ["pinhole", "equidistant", "mei"])
def test_render_through_either_camera(kind):
    """A camera built by the port and one built by `cvids_tpu` from the same
    numbers render the same image and depth, bit for bit."""
    small = dict(width=160, height=120)
    cj = {"pinhole": lambda: jcam.PinholeCamera.create(100.0, 100.0, 80.0, 60.0,
                                                       (-0.28, 0.07, 1e-4, -2e-4), **small),
          "equidistant": lambda: jcam.EquidistantCamera.create(
              90.0, 90.0, 80.0, 60.0, (-0.01, 0.02, -0.005, 0.001), **small),
          "mei": lambda: jcam.MeiCamera.create(0.9, 170.0, 170.0, 80.0, 60.0,
                                               (-0.1, 0.05, 0.0, 0.0), **small)}[kind]()
    ct = interop.camera_to_torch(jax.tree_util.tree_map(np.asarray, cj), "cpu")
    eye = np.array([1.5 + 1.5 * np.sin(0.3), -2.2, 1.2])
    r_wc = look_at(eye, np.array([1.5, 1.0, 0.5]))
    for a, b in zip(trender.render_textured_scene(ct, r_wc, eye),
                    jrender.render_textured_scene(cj, r_wc, eye)):
        np.testing.assert_array_equal(a, b)


def _board_view(cam_j):
    r = np.eye(3, dtype=np.float32)
    r = (np.array([[np.cos(0.1), -np.sin(0.1), 0], [np.sin(0.1), np.cos(0.1), 0], [0, 0, 1]])
         @ np.array([[1, 0, 0], [0, np.cos(0.15), -np.sin(0.15)],
                     [0, np.sin(0.15), np.cos(0.15)]])).astype(np.float32) @ r
    t = np.array([-0.10, -0.08, 0.5], np.float32)
    return jboard.render_chessboard(5, 6, 0, cam_j, r, t, 0.04), (r, t)


def test_chessboard_response_and_detection():
    """`render_chessboard` through the port's camera gives the reference's
    image and corners; `chessboard_response` agrees to 1e-4 of the map's
    peak; `find_chessboard` returns the same grid (0.05 px) in the same
    order, within a pixel of the true corners; a blank image has no board."""
    w, h = 320, 240
    cj = jcam.PinholeCamera.create(300.0, 300.0, 160.0, 120.0, (-0.15, 0.05, 0.0, 0.0), w, h)
    ct = interop.camera_to_torch(jax.tree_util.tree_map(np.asarray, cj), "cpu")
    (img, uv), (r, t) = _board_view(cj)
    img_t, uv_t = tboard.render_chessboard(5, 6, 0, ct, r, t, 0.04)
    np.testing.assert_allclose(uv_t, uv, atol=PX_TOL)
    # an edge pixel may fall on the other side of a square's border
    assert (img_t != img).mean() < 1e-3
    ref = np.asarray(jboard.chessboard_response(jnp.asarray(img)))
    out = tboard.chessboard_response(_t(img)).numpy()
    assert out.shape == ref.shape == (h, w)
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=1e-4)
    cjx = jboard.find_chessboard(img, 5, 6)
    ctx = tboard.find_chessboard(img, 5, 6, device="cpu")
    assert cjx is not None and ctx is not None and ctx.shape == cjx.shape == (30, 2)
    np.testing.assert_allclose(ctx, cjx, atol=0.05)
    d = np.linalg.norm(ctx[:, None] - uv[None], axis=-1)
    assert np.median(d.min(1)) < 1.0
    assert tboard.find_chessboard(np.full((h, w), 128.0, np.float32), 5, 6, device="cpu") is None


def test_cameras_live_where_asked(monkeypatch):
    """`create`, `make_camera` and the chessboard tools take the card unless
    the caller names a device: without a card they raise and name the
    remedy; with device="cpu" every tensor is on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = {
        "pinhole": lambda **kw: tcam.PinholeCamera.create(1.0, 1.0, 0.0, 0.0, **kw),
        "equidistant": lambda **kw: tcam.EquidistantCamera.create(1.0, 1.0, 0.0, 0.0, **kw),
        "mei": lambda **kw: tcam.MeiCamera.create(0.9, 1.0, 1.0, 0.0, 0.0, **kw),
        "scaramuzza": lambda **kw: tcam.ScaramuzzaCamera.create(
            (-216.0, 0.0, 0.0016), inv_poly=(1.0, 2.0), **kw),
        "make_camera": lambda **kw: tcam.make_camera(CameraConfig(), **kw),
    }
    for name, build in makers.items():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
        cam = build(device="cpu")
        assert all(v.device.type == "cpu" for v in cam if isinstance(v, torch.Tensor)), name
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tboard.find_chessboard(np.zeros((32, 32), np.float32), 3, 3)

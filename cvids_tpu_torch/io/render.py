"""Ray-traced textured scenes with true depth (copy of part of
``cvids_tpu/io/render.py``, so that the port runs without the JAX package):
`render_textured_scene` renders intensity and z-depth of the room of
`default_scene`, and `sample_scene_landmarks` samples points on its
surfaces. numpy only, duck-typed on the camera: anything with `fx`, `fy`,
`cx`, `cy`, `dist` (radtan k1, k2, p1, p2), `width` and `height` renders as
a pinhole camera (``camera.PinholeCamera`` is one); the equidistant and Mei
models are selected by their class names, as in the original. A camera's
fields may be numbers, numpy arrays or tensors on any device: they are read
once a camera, on the host.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["render_textured_scene", "default_scene", "sample_scene_landmarks"]


def _host(x) -> np.ndarray:
    """A camera field as float64 numpy (a tensor comes off its device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _project_np(cam, pts_c: np.ndarray) -> np.ndarray:
    """NumPy projection dispatching on the camera model (pinhole radtan /
    Kannala-Brandt equidistant / Mei): projects (N, 3) camera-frame points
    to (N, 2) pixels."""
    kind = type(cam).__name__
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    if kind == "EquidistantCamera":
        k = _host(cam.k)
        x, y, z = pts_c[:, 0], pts_c[:, 1], pts_c[:, 2]
        r = np.hypot(x, y)
        theta = np.arctan2(r, z)
        t2 = theta * theta
        td = theta * (1 + k[0] * t2 + k[1] * t2 ** 2 + k[2] * t2 ** 3
                      + k[3] * t2 ** 4)
        scale = np.where(r > 1e-9, td / np.maximum(r, 1e-9), 1.0)
        return np.stack([fx * x * scale + cx, fy * y * scale + cy], -1)
    if kind == "MeiCamera":
        xi = float(cam.xi)
        k1, k2, p1, p2 = [float(d) for d in _host(cam.dist)]
        p = pts_c / np.linalg.norm(pts_c, axis=-1, keepdims=True)
        zs = np.maximum(p[:, 2] + xi, 1e-9)
        x, y = p[:, 0] / zs, p[:, 1] / zs
        r2 = x * x + y * y
        rad = k1 * r2 + k2 * r2 * r2
        dx = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = y * rad + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
        return np.stack([fx * (x + dx) + cx, fy * (y + dy) + cy], -1)
    # pinhole + radtan (`ServerCamera::Project`)
    z = np.where(np.abs(pts_c[:, 2:3]) > 1e-9, pts_c[:, 2:3], 1e-9)
    x, y = pts_c[:, 0] / z[:, 0], pts_c[:, 1] / z[:, 0]
    k1, k2, p1, p2 = [float(d) for d in _host(cam.dist)]
    r2 = x * x + y * y
    rad = k1 * r2 + k2 * r2 * r2
    dx = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * rad + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return np.stack([fx * (x + dx) + cx, fy * (y + dy) + cy], -1)


@lru_cache(maxsize=16)
def _ray_grid_cached(key) -> np.ndarray:
    """Unit-norm camera rays for every pixel — depends only on the camera
    intrinsics, so computed once per camera, not once per frame."""
    kind, fx, fy, cx, cy, d0, d1, d2, d3, xi, w, h = key
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    xd = (uu.ravel() - cx) / fx
    yd = (vv.ravel() - cy) / fy
    if kind == "EquidistantCamera":
        # Newton-invert r(θ) (the model's lift, numpy)
        k = (d0, d1, d2, d3)
        td = np.hypot(xd, yd)
        th = td.copy()
        for _ in range(10):
            t2 = th * th
            f = th * (1 + k[0] * t2 + k[1] * t2 ** 2 + k[2] * t2 ** 3
                      + k[3] * t2 ** 4) - td
            df = (1 + 3 * k[0] * t2 + 5 * k[1] * t2 ** 2
                  + 7 * k[2] * t2 ** 3 + 9 * k[3] * t2 ** 4)
            th = th - f / np.maximum(df, 1e-9)
        scale = np.where(td > 1e-9, np.tan(th) / np.maximum(td, 1e-9), 1.0)
        x, y = xd * scale, yd * scale
    elif kind == "MeiCamera":
        x, y = xd.copy(), yd.copy()
        for _ in range(8):
            r2 = x * x + y * y
            rad = d0 * r2 + d1 * r2 * r2
            ddx = x * rad + 2.0 * d2 * x * y + d3 * (r2 + 2.0 * x * x)
            ddy = y * rad + 2.0 * d3 * x * y + d2 * (r2 + 2.0 * y * y)
            x, y = xd - ddx, yd - ddy
        r2 = x * x + y * y
        disc = 1.0 + (1.0 - xi * xi) * r2
        zs = (xi + np.sqrt(np.maximum(disc, 0.0))) / (1.0 + r2)
        zz = np.maximum(zs - xi, 1e-9)
        x, y = zs * x / zz, zs * y / zz
    else:
        x, y = xd.copy(), yd.copy()
        for _ in range(8):   # fixed-point undistort, `server_camera.cpp:21-59`
            r2 = x * x + y * y
            rad = d0 * r2 + d1 * r2 * r2
            ddx = x * rad + 2.0 * d2 * x * y + d3 * (r2 + 2.0 * x * x)
            ddy = y * rad + 2.0 * d3 * x * y + d2 * (r2 + 2.0 * y * y)
            x, y = xd - ddx, yd - ddy
    rays = np.stack([x, y, np.ones_like(x)])            # (3, N) unit-z
    return rays / np.linalg.norm(rays, axis=0, keepdims=True)


def _cam_key(cam):
    kind = type(cam).__name__
    d = _host(cam.k if kind == "EquidistantCamera" else cam.dist)
    xi = float(getattr(cam, "xi", 0.0)) if kind == "MeiCamera" else 0.0
    return (kind, float(cam.fx), float(cam.fy), float(cam.cx),
            float(cam.cy), float(d[0]), float(d[1]), float(d[2]),
            float(d[3]), xi, int(cam.width), int(cam.height))


# ---------------------------------------------------------------------------
# ray-traced textured scenes (for dense-mapping tests: intensity + true depth)
# ---------------------------------------------------------------------------

def _value_noise(p: np.ndarray, scale: float = 2.0) -> np.ndarray:
    """Cheap procedural 3-D texture: layered trigonometric value noise."""
    x, y, z = p[..., 0] * scale, p[..., 1] * scale, p[..., 2] * scale
    v = (np.sin(x * 1.7 + 0.3) * np.cos(y * 2.3 + 1.1)
         + 0.6 * np.sin(y * 3.1 + z * 1.3)
         + 0.4 * np.cos(x * 4.7 - z * 2.9)
         + 0.25 * np.sin((x + y + z) * 7.1))
    return 120.0 + 45.0 * v


def default_scene():
    """Floor z=0, wall y=3, box [1,2]x[0.5,1.5]x[0,1] — the room used by the
    TSDF tests, now with texture for photometric depth estimation."""
    return dict(floor_z=0.0, wall_y=3.0,
                box_lo=np.array([1.0, 0.5, 0.0]),
                box_hi=np.array([2.0, 1.5, 1.0]))


def sample_scene_landmarks(n: int, rng, scene: dict | None = None,
                           extent: float = 4.0) -> np.ndarray:
    """Sample (n, 3) landmark positions ON the scene's surfaces (floor, wall,
    box faces), so feature blobs splatted at them are geometrically
    consistent with the ray-traced depth — required when the same rendered
    frames feed both the sparse front-end and the dense mapper."""
    if scene is None:
        scene = default_scene()
    lo, hi = scene["box_lo"], scene["box_hi"]
    pts = []
    kinds = rng.choice(3, n, p=[0.5, 0.35, 0.15])
    for kind in kinds:
        if kind == 0:     # floor z = floor_z
            pts.append([rng.uniform(-extent, extent),
                        rng.uniform(-extent, min(extent, scene["wall_y"])),
                        scene["floor_z"]])
        elif kind == 1:   # wall y = wall_y
            pts.append([rng.uniform(-extent, extent), scene["wall_y"],
                        rng.uniform(0.0, 2.5)])
        else:             # box: one of the 4 side faces or the top
            face = rng.integers(0, 5)
            x = rng.uniform(lo[0], hi[0])
            y = rng.uniform(lo[1], hi[1])
            z = rng.uniform(lo[2], hi[2])
            if face == 0:
                pts.append([lo[0], y, z])
            elif face == 1:
                pts.append([hi[0], y, z])
            elif face == 2:
                pts.append([x, lo[1], z])
            elif face == 3:
                pts.append([x, hi[1], z])
            else:
                pts.append([x, y, hi[2]])
    return np.asarray(pts, np.float64)


def render_textured_scene(cam, r_wc: np.ndarray, t_wc: np.ndarray,
                          scene: dict | None = None):
    """Ray-trace the scene from camera pose (r_wc = cam axes in world,
    t_wc = camera origin). Returns (intensity (H, W), depth (H, W) z-depth,
    0 where no hit).

    Rays follow the camera's full model: when `cam` carries radtan
    distortion, each pixel is lifted through the iterative undistortion
    (`camera.pinhole.PinholeCamera.lift_to_ray`), so the rendered frames are
    genuinely distorted imagery — the input regime the reference's dense
    mapper undistorts per frame (`sgm_stereo_mapper.cpp:55-123,155-175`)."""
    if scene is None:
        scene = default_scene()
    h, w = cam.height, cam.width
    rn = _ray_grid_cached(_cam_key(cam))      # (3, H*W), unit-norm
    d_w = r_wc @ rn
    o = t_wc
    ts = np.full(h * w, np.inf)
    # floor
    m = d_w[2] < -1e-6
    with np.errstate(divide="ignore"):
        t_f = (scene["floor_z"] - o[2]) / d_w[2]
    ts = np.where(m & (t_f > 0), np.minimum(ts, t_f), ts)
    # wall
    m = np.abs(d_w[1]) > 1e-6
    with np.errstate(divide="ignore"):
        t_w = (scene["wall_y"] - o[1]) / d_w[1]
    ts = np.where(m & (t_w > 0), np.minimum(ts, t_w), ts)
    # box (slab test)
    lo, hi = scene["box_lo"], scene["box_hi"]
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo[:, None] - o[:, None]) / d_w
        t2 = (hi[:, None] - o[:, None]) / d_w
    tn = np.max(np.minimum(t1, t2), 0)
    tf = np.min(np.maximum(t1, t2), 0)
    hit_box = (tn < tf) & (tn > 0)
    ts = np.where(hit_box, np.minimum(ts, tn), ts)

    hit = np.isfinite(ts)
    pts = o[None, :] + np.where(hit, ts, 0.0)[:, None] * d_w.T
    inten = np.where(hit, _value_noise(pts), 15.0)
    depth = np.where(hit, ts * rn[2], 0.0)
    return (inten.reshape(h, w).astype(np.float32),
            depth.reshape(h, w).astype(np.float32))

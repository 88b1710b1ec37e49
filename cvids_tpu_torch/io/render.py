"""Synthetic images (copy of ``cvids_tpu/io/render.py``, so that the port
runs without the JAX package): `render_blobs` splats each landmark's own
procedural texture patch at its projection, `render_textured_scene` renders
intensity and z-depth of the room of `default_scene`,
`sample_scene_landmarks` samples points on its surfaces and
`apply_photometric` adds a rolling camera's nuisances (exposure, vignette,
motion blur, noise). numpy only, duck-typed on the camera: anything with `fx`, `fy`,
`cx`, `cy`, `dist` (radtan k1, k2, p1, p2), `width` and `height` renders as
a pinhole camera (``camera.PinholeCamera`` is one); the equidistant and Mei
models are selected by their class names, as in the original. A camera's
fields may be numbers, numpy arrays or tensors on any device: they are read
once a camera, on the host.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["render_blobs", "render_textured_scene", "default_scene",
           "apply_photometric", "sample_scene_landmarks"]


def _host(x) -> np.ndarray:
    """A camera field as float64 numpy (a tensor comes off its device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


@lru_cache(maxsize=8192)
def _patch_params(idx: int):
    """Per-landmark procedural texture: a fixed random mix of oriented
    sinusoids. Deterministic in the landmark index, so every observation of
    landmark `idx` — from any viewpoint, any agent — renders the same local
    appearance (a fronto-parallel fiducial). Gaussian blobs are radially
    symmetric and therefore indistinguishable to BRIEF's pairwise intensity
    tests; these patches give each landmark a stable, unique descriptor."""
    rng = np.random.default_rng(1000003 * (idx + 1) + 17)
    n = 8
    freq = rng.uniform(0.25, 0.9, n)          # rad/px, survives the σ=2 blur
    theta = rng.uniform(0.0, np.pi, n)
    phase = rng.uniform(0.0, 2 * np.pi, n)
    amp = rng.uniform(0.5, 1.0, n)
    amp /= amp.sum()
    return freq, theta, phase, amp


def _render_patch(idx: int, rad: int, du: float, dv: float,
                  env_sigma: float) -> np.ndarray:
    """Evaluate landmark `idx`'s texture on a (2r+1)² grid centred at the
    subpixel offset (du, dv) — analytic, so projections land at their exact
    subpixel positions instead of being quantised to integer pixels."""
    freq, theta, phase, amp = _patch_params(idx)
    ys, xs = np.mgrid[-rad:rad + 1, -rad:rad + 1].astype(np.float64)
    xs = xs - du
    ys = ys - dv
    tex = np.zeros_like(xs)
    for f, th, ph, a in zip(freq, theta, phase, amp):
        tex += a * np.cos(f * (np.cos(th) * xs + np.sin(th) * ys) + ph)
    env = np.exp(-0.5 * (xs ** 2 + ys ** 2) / env_sigma ** 2)
    return ((0.55 + 0.45 * tex) * env).astype(np.float32)


def _render_patches_batch(idxs: np.ndarray, rad: int, du: np.ndarray,
                          dv: np.ndarray, env_sigma: float) -> np.ndarray:
    """Vectorized `_render_patch` over N landmarks -> (N, 2r+1, 2r+1).

    The per-landmark Python loop was the dominant cost of rendering a frame
    (~0.8 s at 1400 landmarks); batching the 8-sinusoid evaluation over all
    visible landmarks cuts a frame to tens of ms, which is what makes
    camera-rate (10-20 Hz) rendered worlds affordable for tests."""
    n = len(idxs)
    params = np.stack([np.concatenate(_patch_params(int(i))) for i in idxs])
    freq, theta = params[:, 0:8], params[:, 8:16]
    phase, amp = params[:, 16:24], params[:, 24:32]
    grid = np.arange(-rad, rad + 1, dtype=np.float64)
    xs = grid[None, None, :] - du[:, None, None]       # (N, 1, S)
    ys = grid[None, :, None] - dv[:, None, None]       # (N, S, 1)
    # (N, S, S, 8) phase argument, summed over the 8 sinusoids
    arg = (freq[:, None, None, :]
           * (np.cos(theta)[:, None, None, :] * xs[..., None]
              + np.sin(theta)[:, None, None, :] * ys[..., None])
           + phase[:, None, None, :])
    tex = np.einsum("nijk,nk->nij", np.cos(arg), amp)
    env = np.exp(-0.5 * (xs ** 2 + ys ** 2) / env_sigma ** 2)
    out = (0.55 + 0.45 * tex) * env
    assert out.shape == (n, 2 * rad + 1, 2 * rad + 1)
    return out.astype(np.float32)


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


def render_blobs(cam, landmarks: np.ndarray, intensities: np.ndarray,
                 r_wb: np.ndarray, p_wb: np.ndarray,
                 r_cb: np.ndarray, p_bc: np.ndarray,
                 sigma: float = 1.5, background: float = 20.0,
                 base: np.ndarray | None = None,
                 idx_offset: int = 0) -> np.ndarray:
    """Render (H, W) float image for body pose (r_wb, p_wb).

    Each landmark is splatted as its own textured patch (`_patch_params`),
    sized to cover the bulk of the BRIEF test pattern (taps ~ N(0, 9.6 px),
    `ops.brief.brief_pattern`). `base`: optional background image to splat
    onto (e.g. a ray-traced textured scene) instead of the flat gradient.
    `idx_offset` shifts the per-landmark texture identities — distinct
    offsets give DIFFERENT procedural appearances for the same array slots
    (held-out vocabulary worlds must not share textures with test worlds).
    """
    h, w = cam.height, cam.width
    if base is not None:
        img = np.asarray(base, np.float32).copy()
    else:
        img = np.full((h, w), background, np.float32)
        # gentle background gradient so KLT has some signal everywhere
        img += np.linspace(0, 10, w)[None, :]
    pts_b = (landmarks - p_wb) @ r_wb  # world -> body
    pts_c = (pts_b - p_bc) @ r_cb.T
    z = pts_c[:, 2]
    ok = z > 0.2
    px = _project_np(cam, pts_c[ok]).astype(np.float32)
    env_sigma = max(float(sigma), 3.0)
    rad = int(round(4 * env_sigma))
    idx_all = np.nonzero(ok)[0]
    ui = np.floor(px[:, 0]).astype(np.int64)
    vi = np.floor(px[:, 1]).astype(np.int64)
    inb = ((ui >= rad) & (ui < w - rad - 1) & (vi >= rad) & (vi < h - rad - 1))
    if inb.any():
        idxs = idx_all[inb] + int(idx_offset)
        du = (px[inb, 0] - ui[inb]).astype(np.float64)
        dv = (px[inb, 1] - vi[inb]).astype(np.float64)
        patches = _render_patches_batch(idxs, rad, du, dv, env_sigma)
        patches *= intensities[ok][inb][:, None, None].astype(np.float32)
        side = 2 * rad + 1
        offs = np.arange(-rad, rad + 1)
        rows = vi[inb][:, None, None] + offs[None, :, None]   # (N, S, 1)
        cols = ui[inb][:, None, None] + offs[None, None, :]   # (N, 1, S)
        flat = (rows * w + cols).reshape(-1)
        np.add.at(img.reshape(-1), flat,
                  patches.reshape(len(idxs), side, side).reshape(-1))
    return np.clip(img, 0, 255)


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


def apply_photometric(img: np.ndarray, rng, *, exposure: float = 1.0,
                      vignette: float = 0.0, noise_std: float = 0.0,
                      shot_noise: float = 0.0, blur_px: float = 0.0,
                      blur_dir=(1.0, 0.0)) -> np.ndarray:
    """Photometric nuisances of a real rolling camera (VERDICT r3 item 8 —
    the realism slice of the EuRoC gap closable without the dataset; real
    EuRoC needs the reference agents' `equalize: 1`,
    `config/euroc/euroc_config.yaml:44-63`):

    - `exposure`: global gain (auto-exposure flicker when varied per frame);
    - `vignette`: cos^4-style falloff strength toward the corners (static);
    - `blur_px` / `blur_dir`: directional motion blur — a 5-tap average
      along the flow direction, `blur_px` total extent in pixels;
    - `noise_std` / `shot_noise`: additive Gaussian read noise + intensity-
      proportional shot noise (std = shot_noise * sqrt(I)).
    """
    h, w = img.shape
    out = img.astype(np.float64)
    if blur_px > 0.0:
        d = np.asarray(blur_dir, np.float64)
        n = np.linalg.norm(d)
        d = d / n if n > 1e-9 else np.array([1.0, 0.0])
        acc = np.zeros_like(out)
        taps = 5
        for k in range(taps):
            s = (k / (taps - 1) - 0.5) * blur_px
            dx, dy = d * s
            ix = np.clip(np.arange(w) + dx, 0, w - 1)
            iy = np.clip(np.arange(h) + dy, 0, h - 1)
            x0 = np.floor(ix).astype(int)
            y0 = np.floor(iy).astype(int)
            fx_ = ix - x0
            fy_ = iy - y0
            x1 = np.minimum(x0 + 1, w - 1)
            y1 = np.minimum(y0 + 1, h - 1)
            row0 = out[y0][:, x0] * (1 - fx_) + out[y0][:, x1] * fx_
            row1 = out[y1][:, x0] * (1 - fx_) + out[y1][:, x1] * fx_
            acc += row0 * (1 - fy_)[:, None] + row1 * fy_[:, None]
        out = acc / taps
    if vignette > 0.0:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        r2 = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2)
        out = out * np.maximum(1.0 - vignette * r2 / 2.0, 0.1) ** 2
    out = out * exposure
    if shot_noise > 0.0:
        out = out + rng.normal(0.0, 1.0, out.shape) * shot_noise * np.sqrt(
            np.maximum(out, 0.0))
    if noise_std > 0.0:
        out = out + rng.normal(0.0, noise_std, out.shape)
    return np.clip(out, 0.0, 255.0).astype(np.float32)

"""Chessboard corner detection + intrinsic calibration from boards (port of
``cvids_tpu/camera/chessboard.py``).

The roles of camodocal's chessboard detector (`Chessboard.cc`) and of the
`intrinsic_calib.cc` CLI. `chessboard_response` is tensor code: a ring-based
corner response over the whole image, replayed on the card as one CUDA
graph an image shape. Peaks, their ordering into the
(rows × cols) grid through a homography from the board's extremal corners,
Zhang's initialization and the board renderer are host-side numpy, copied
from the JAX package (detection is calibration time, latency-insensitive).
The calibrators run where `device` says (None: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.image import gaussian_blur
from ..utils.cuda_graph import GraphedCall
from .models import calibrate_pinhole

__all__ = ["chessboard_response", "find_chessboard", "calibrate_chessboards",
           "render_chessboard"]


def chessboard_response(img: torch.Tensor, sigma: float = 1.0,
                        radius: int = 4) -> torch.Tensor:
    """Inner-corner response map (H, W), ring-based (ChESS-style).

    Samples a 16-point ring around every pixel (`roll` shifts) and projects
    it onto angular harmonics: an inner chessboard corner alternates
    dark/light TWICE around the ring (strong period-2 component), while
    edges and single-square outer corners alternate once (period-1).
    Response = |period-2|² − |period-1|², which is what keeps outer board
    corners and edges out of the peak list."""
    g = gaussian_blur(img.to(torch.float32), sigma, radius=2)
    n = 16
    ang = 2.0 * np.pi * np.arange(n) / n
    c1 = torch.zeros_like(g)
    s1 = torch.zeros_like(g)
    c2 = torch.zeros_like(g)
    s2 = torch.zeros_like(g)
    for k in range(n):
        dx = int(round(radius * np.cos(ang[k])))
        dy = int(round(radius * np.sin(ang[k])))
        ring = torch.roll(g, (-dy, -dx), (0, 1))
        c1 = c1 + ring * float(np.cos(ang[k]))
        s1 = s1 + ring * float(np.sin(ang[k]))
        c2 = c2 + ring * float(np.cos(2 * ang[k]))
        s2 = s2 + ring * float(np.sin(2 * ang[k]))
    resp = (c2 * c2 + s2 * s2) - (c1 * c1 + s1 * s1)
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    m = radius + 3
    inside = (xx >= m) & (xx < w - m) & (yy >= m) & (yy < h - m)
    return torch.where(inside, resp, torch.zeros_like(resp))


# the JAX package's `jax.jit` of the response: on the card one CUDA graph an
# image shape and dtype, kept for the process as a jit's cache is
_response_program = GraphedCall(chessboard_response)


def _nms_peaks(resp: np.ndarray, num: int, min_dist: int = 8) -> np.ndarray:
    """Greedy non-max suppression: top `num` peaks ≥ min_dist apart, with
    quadratic subpixel refinement. Host-side (tiny)."""
    r = resp.copy()
    h, w = r.shape
    out = []
    for _ in range(num):
        idx = int(np.argmax(r))
        y, x = divmod(idx, w)
        if r[y, x] <= 0:
            break
        # subpixel: 1-D parabola in x and y
        def subpix(c0, cm, cp):
            den = cm + cp - 2 * c0
            return 0.5 * (cm - cp) / den if den < -1e-12 else 0.0
        dx = subpix(r[y, x], r[y, max(x - 1, 0)], r[y, min(x + 1, w - 1)]) \
            if 0 < x < w - 1 else 0.0
        dy = subpix(r[y, x], r[max(y - 1, 0), x], r[min(y + 1, h - 1), x]) \
            if 0 < y < h - 1 else 0.0
        out.append((x + dx, y + dy))
        y0, y1 = max(0, y - min_dist), min(h, y + min_dist + 1)
        x0, x1 = max(0, x - min_dist), min(w, x + min_dist + 1)
        r[y0:y1, x0:x1] = 0.0
    return np.asarray(out, np.float32)


def _order_grid(pts: np.ndarray, rows: int, cols: int) -> np.ndarray | None:
    """Order scattered corner points into a (rows*cols, 2) row-major grid via
    a homography fitted from the 4 extremal corners (tolerates the mild
    perspective/distortion of a calibration view)."""
    if len(pts) < rows * cols:
        return None
    c = pts.mean(0)
    d = pts - c
    # extremal corners along the two diagonal directions
    # x+y minimal at TL / maximal at BR; x−y maximal at TR / minimal at BL
    s, t = d[:, 0] + d[:, 1], d[:, 0] - d[:, 1]
    corners = pts[[np.argmin(s), np.argmax(t), np.argmax(s), np.argmin(t)]]
    # target unit grid corners (TL, TR, BR, BL) in (col, row)
    tgt = np.array([[0, 0], [cols - 1, 0], [cols - 1, rows - 1],
                    [0, rows - 1]], np.float64)
    # DLT homography from the 4 correspondences
    a = []
    for (x, y), (u, v) in zip(corners, tgt):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, vt = np.linalg.svd(np.asarray(a))
    hmat = vt[-1].reshape(3, 3)
    ph = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1) @ hmat.T
    grid = ph[:, :2] / ph[:, 2:3]
    order = np.full(rows * cols, -1, np.int64)
    used = np.zeros(len(pts), bool)
    for rr in range(rows):
        for cc in range(cols):
            dist = np.linalg.norm(grid - np.array([cc, rr]), axis=1)
            dist[used] = np.inf
            j = int(np.argmin(dist))
            if dist[j] > 0.45:   # no corner near this grid node
                return None
            order[rr * cols + cc] = j
            used[j] = True
    return pts[order]


def find_chessboard(img: np.ndarray, rows: int, cols: int,
                    min_dist: int = 8, device=None) -> np.ndarray | None:
    """Detect the (rows × cols) inner-corner grid of a chessboard.

    Returns (rows*cols, 2) subpixel corners in row-major order, or None if
    the board is not found (the calibration CLI skips such frames). The
    response map is computed on `device` (None: the card)."""
    dev = resolve_device(device)
    resp = _response_program(torch.as_tensor(np.asarray(img), device=dev)).cpu().numpy()
    # take extra peaks to survive spurious responses, then grid-fit
    pts = _nms_peaks(resp, rows * cols + 8, min_dist=min_dist)
    if len(pts) < rows * cols:
        return None
    # keep the strongest rows*cols ... try grid-fit with progressively fewer
    for n in range(rows * cols, len(pts) + 1):
        ordered = _order_grid(pts[:n], rows, cols)
        if ordered is not None:
            return ordered
    return None


def _dlt_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Plane homography src (N,2) -> dst (N,2) by normalized DLT."""
    def norm_t(p):
        c = p.mean(0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-9)
        return np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
    ts, td = norm_t(src), norm_t(dst)
    sh = (np.concatenate([src, np.ones((len(src), 1))], 1) @ ts.T)
    dh = (np.concatenate([dst, np.ones((len(dst), 1))], 1) @ td.T)
    a = []
    for (x, y, _), (u, v, _) in zip(sh, dh):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, vt = np.linalg.svd(np.asarray(a))
    hmat = np.linalg.inv(td) @ vt[-1].reshape(3, 3) @ ts
    return hmat / hmat[2, 2]


def _zhang_focal(homs: list, cx: float, cy: float) -> float:
    """Focal from plane homographies with a fixed principal point (the
    closed form of Zhang's method that OpenCV's initIntrinsicParams uses):
    both constraints are linear in 1/f² once H is principal-point centered."""
    tmat = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
    a, b = [], []
    for h in homs:
        hc = tmat @ h
        h1, h2 = hc[:, 0], hc[:, 1]
        a.append([h1[0] * h2[0] + h1[1] * h2[1]]); b.append(-h1[2] * h2[2])
        a.append([h1[0] ** 2 + h1[1] ** 2 - h2[0] ** 2 - h2[1] ** 2])
        b.append(h2[2] ** 2 - h1[2] ** 2)
    x = np.linalg.lstsq(np.asarray(a), np.asarray(b), rcond=None)[0][0]
    return 1.0 / np.sqrt(max(x, 1e-12))


def _pose_from_homography(h: np.ndarray, kmat: np.ndarray) -> np.ndarray:
    """[rvec(3), tvec(3)] board->camera from H = K [r1 r2 t]."""
    b = np.linalg.inv(kmat) @ h
    lam = 1.0 / max(np.linalg.norm(b[:, 0]), 1e-9)
    if b[2, 2] * lam < 0:
        lam = -lam
    r1, r2, t = lam * b[:, 0], lam * b[:, 1], lam * b[:, 2]
    r3 = np.cross(r1, r2)
    u, _, vt = np.linalg.svd(np.stack([r1, r2, r3], axis=1))
    r = u @ vt
    # rotation vector via log map
    ang = np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))
    if ang < 1e-9:
        rvec = np.zeros(3)
    else:
        rvec = ang / (2 * np.sin(ang)) * np.array(
            [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return np.concatenate([rvec, t]).astype(np.float32)


def _scaramuzza_lift_norm_np(p: np.ndarray, px: np.ndarray) -> np.ndarray:
    """Pixels -> normalized-plane coords for calibration params
    [b0..b5, C, D, E, cx, cy] by Newton-inverting the inverse polynomial
    ρ(θ) = φ. Unlike the model's forward-poly lift this never leaves the
    fitted θ range, so it is safe for re-seeding poses mid-calibration."""
    b = np.asarray(p[:6], np.float64)
    c_, d_, e_ = float(p[6]), float(p[7]), float(p[8])
    xc = px[:, 0] - float(p[9])
    yc = px[:, 1] - float(p[10])
    inv = 1.0 / (c_ - d_ * e_)
    xa = inv * (xc - d_ * yc)
    ya = inv * (-e_ * xc + c_ * yc)
    phi = np.hypot(xa, ya)
    th = -np.pi / 2 + phi / max(b[1], 1e-6)
    for _ in range(50):
        r = np.polyval(b[::-1], th) - phi
        dr = np.polyval(np.polyder(b[::-1]), th)
        th = th - r / np.where(np.abs(dr) > 1e-9, dr, 1e-9)
    tan_a = np.tan(th + np.pi / 2)        # incidence angle from the axis
    s = np.where(phi > 1e-9, tan_a / np.maximum(phi, 1e-9),
                 1.0 / max(b[1], 1e-6))
    return np.stack([xa * s, ya * s], -1)


def calibrate_chessboards(images: list, rows: int, cols: int,
                          square_size: float, width: int, height: int,
                          iters: int = 30, model: str = "pinhole", device=None):
    """End-to-end intrinsic calibration from chessboard views (the
    `intrinsic_calib.cc` CLI role, incl. its `--camera-model` switch):
    detect boards, init intrinsics/poses by Zhang's homography method,
    refine with the model's joint GN calibration.

    model: "pinhole" ([fx, fy, cx, cy, k1, k2, p1, p2]), "equidistant"
    ([fx, fy, cx, cy, k2, k3, k4, k5] — camodocal EquidistantCamera),
    "mei" ([xi, fx, fy, cx, cy, k1, k2, p1, p2] — camodocal CataCamera), or
    "scaramuzza" ([b0..b5 inverse-poly, C, D, E, cx, cy] — camodocal
    OCAMCamera; the returned camera carries the fitted forward polynomial).
    Returns (params, poses, rms, used) with used = per-image detection mask;
    params, poses and rms are tensors on `device` (None: the card), where
    detection and the solves run."""
    dev = resolve_device(device)
    from .models import (calibrate_equidistant, calibrate_mei,
                         calibrate_scaramuzza)

    obj = np.zeros((rows * cols, 3), np.float32)
    obj[:, 0] = np.tile(np.arange(cols), rows) * square_size
    obj[:, 1] = np.repeat(np.arange(rows), cols) * square_size
    obj_all, img_all, homs, used = [], [], [], []
    for im in images:
        c = find_chessboard(im, rows, cols, device=dev)
        used.append(c is not None)
        if c is not None:
            obj_all.append(obj)
            img_all.append(c)
            homs.append(_dlt_homography(obj[:, :2], c))
    if not obj_all:
        raise ValueError("no chessboards found")
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    v, n = len(obj_all), rows * cols
    obj_j = torch.as_tensor(np.stack(obj_all), device=dev)
    img_j = torch.as_tensor(np.stack(img_all), device=dev)
    valid_j = torch.ones((v, n), dtype=torch.bool, device=dev)

    def f32(values):
        return torch.as_tensor(np.asarray(values, np.float32), device=dev)

    # stage 1: near-axis views only (max corner radius < 60% of the image
    # half-diagonal), where every model is pinhole-like and Zhang's
    # homography init is trustworthy. Wide-coverage corner views join in
    # stage 2 with poses re-initialized from the stage-1 model — the
    # camodocal pattern (estimateIntrinsics on easy geometry, then joint
    # Ceres refinement over everything, `intrinsic_calib.cc:1-247`).
    # Initializing everything at once sends the fisheye/Mei solves into
    # low-residual degenerate basins (measured: rms 2.2 with 10^4-scale
    # parameters).
    radius = np.array([np.hypot(c[:, 0] - cx, c[:, 1] - cy).max()
                       for c in img_all])
    near = radius < 0.6 * float(np.hypot(cx, cy))
    if not near.any():
        near[:] = True
    homs_near = [h for h, m_ in zip(homs, near) if m_]
    f = _zhang_focal(homs_near, cx, cy)
    kmat = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])

    if model == "pinhole":
        init = f32([f, f, cx, cy, 0, 0, 0, 0])
        solve = calibrate_pinhole

        def make_cam(p):
            from .pinhole import PinholeCamera
            return PinholeCamera(p[0], p[1], p[2], p[3], p[4:8], width, height)
    elif model == "equidistant":
        # Zhang's focal is the small-angle (r = f·θ ≈ f·tanθ) estimate;
        # polynomial terms start at 0 (camodocal inits k2..k5 = 0 too)
        from .models import EquidistantCamera
        init = f32([f, f, cx, cy, 0, 0, 0, 0])
        solve = calibrate_equidistant
        make_cam = lambda p: EquidistantCamera(p[0], p[1], p[2], p[3],
                                               p[4:8], width, height)
    elif model == "mei":
        # near the axis the Mei projection behaves like a pinhole with
        # focal f/(1+xi); camodocal inits xi = 1, so seed fx = 2·f_zhang
        from .models import MeiCamera
        init = f32([1.0, 2 * f, 2 * f, cx, cy, 0, 0, 0, 0])
        solve = calibrate_mei
        make_cam = lambda p: MeiCamera(p[0], p[1], p[2], p[3], p[4],
                                       p[5:9], width, height)
    elif model == "scaramuzza":
        # near the axis ρ(θ) ≈ f·(θ + π/2) (incidence angle from the
        # axis), which reproduces the pinhole small-angle radius r ≈ f·α;
        # affine starts at identity, like camodocal's OCAM init
        from .models import ScaramuzzaCamera, fit_forward_poly
        init = f32([f * np.pi / 2, f, 0, 0, 0, 0, 1.0, 0.0, 0.0, cx, cy])
        solve = calibrate_scaramuzza

        def make_cam(p):
            # fit the forward polynomial only over the θ range the data
            # constrains: the calibrated inverse polynomial is garbage
            # outside the observed sensor radii, and letting the fit see
            # the extrapolated region corrupts it everywhere
            b = p[:6].cpu().numpy().astype(np.float64)
            c_, d_, e_ = float(p[6]), float(p[7]), float(p[8])
            xs = np.concatenate([ci[:, 0] for ci in img_all]) - float(p[9])
            ys = np.concatenate([ci[:, 1] for ci in img_all]) - float(p[10])
            inv_s = 1.0 / (c_ - d_ * e_)
            xa = inv_s * (xs - d_ * ys)
            ya = inv_s * (-e_ * xs + c_ * ys)
            phi_max = float(np.hypot(xa, ya).max())
            th = -np.pi / 2 + phi_max / max(b[1], 1e-6)   # ρ ≈ b0 + b1·θ
            for _ in range(30):                            # Newton on ρ(θ)=φ
                r_ = np.polyval(b[::-1], th) - phi_max
                dr = np.polyval(np.polyder(b[::-1]), th)
                th = th - r_ / (dr if abs(dr) > 1e-9 else 1e-9)
            # fit over the OBSERVED θ range (capped just below 0 to stay
            # clear of the θ→0 tan regime) — a hard clamp at -0.3 would
            # truncate the fit inside the data for FOVs beyond ~146° and
            # leave the forward polynomial extrapolating over the outer FOV
            poly = fit_forward_poly(p[:6],
                                    theta_max=float(min(th, -0.02)))
            return ScaramuzzaCamera(poly, p[:6], p[6], p[7], p[8],
                                    p[9], p[10], width, height)
    else:
        raise ValueError(f"unknown camera model {model!r}")

    poses0 = np.stack([_pose_from_homography(h, kmat) for h in homs])
    idx_near = np.nonzero(near)[0]
    params, _, _ = solve(obj_j[idx_near], img_j[idx_near],
                         valid_j[idx_near], init,
                         f32(poses0[idx_near]),
                         iters=max(iters // 2, 10))

    # stage 2: all views; every pose re-initialized by lifting the detected
    # corners through the stage-1 model (onto the distortion-free
    # normalized plane) and decomposing the obj->normalized homography
    # with K = I
    if model == "scaramuzza":
        def lift_norm(c_px):
            return _scaramuzza_lift_norm_np(params.cpu().numpy(), c_px)
    else:
        cam1 = make_cam(params)

        def lift_norm(c_px):
            norm = cam1.lift(f32(c_px)).cpu().numpy()
            if norm.shape[-1] == 3:   # projective-ray lift
                norm = norm[:, :2] / np.maximum(norm[:, 2:3], 1e-9)
            return norm

    eye = np.eye(3)
    poses1 = np.empty((v, 6), np.float32)
    for i, c in enumerate(img_all):
        norm = lift_norm(c)
        hn = _dlt_homography(obj[:, :2], norm)
        poses1[i] = _pose_from_homography(hn, eye)
    params, poses, rms = solve(obj_j, img_j, valid_j, params,
                               f32(poses1), iters=iters)
    return params, poses, rms, np.asarray(used)


def render_chessboard(rows: int, cols: int, square_px: int, cam,
                      r_wc: np.ndarray, t_wc: np.ndarray,
                      square_size: float) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic calibration view: renders a chessboard plane through a
    camera model (supersampled), returning (image, true inner corners).
    Test/replay utility — the counterpart of pointing a real camera at a
    board. `cam` is one of the port's cameras, on any device."""
    dev = cam.cx.device
    h, w = cam.height, cam.width
    ss = 2
    yy, xx = np.mgrid[0:h * ss, 0:w * ss]
    px = np.stack([(xx + 0.5) / ss - 0.5, (yy + 0.5) / ss - 0.5], -1)
    norm = cam.lift(torch.as_tensor(px.reshape(-1, 2).astype(np.float32),
                                    device=dev)).cpu().numpy()
    if norm.shape[-1] == 3:   # projective-ray lift (Scaramuzza)
        rays = norm
    else:
        rays = np.concatenate([norm, np.ones((len(norm), 1), np.float32)], 1)
    # intersect with board plane z=0 in world: X = R rays*s + t, X_z = 0
    rc = r_wc.T  # world->cam is (r_wc, t_wc): x_cam = r_wc X + t_wc
    # ray in world: X(s) = rc @ (rays*s - t_wc)
    dir_w = rays @ rc.T
    org_w = -(rc @ t_wc)
    s = -org_w[2] / np.where(np.abs(dir_w[:, 2]) > 1e-9, dir_w[:, 2], 1e-9)
    pts_w = org_w[None] + dir_w * s[:, None]
    bx = pts_w[:, 0] / square_size
    by = pts_w[:, 1] / square_size
    # a (cols+1) x (rows+1)-square board => rows*cols INNER corners at
    # board coords (1..cols, 1..rows) * square_size
    inside = (bx >= 0) & (bx <= cols + 1) & (by >= 0) & (by <= rows + 1) & (s > 0)
    checker = ((np.floor(bx).astype(int) + np.floor(by).astype(int)) % 2 == 0)
    img = np.where(inside & checker, 40.0, 220.0).astype(np.float32)
    img = img.reshape(h * ss, w * ss).reshape(h, ss, w, ss).mean((1, 3))
    # true inner corners: board points ((c+1)*sq, (r+1)*sq, 0) projected
    corners_w = np.zeros((rows * cols, 3), np.float32)
    corners_w[:, 0] = (np.tile(np.arange(cols), rows) + 1) * square_size
    corners_w[:, 1] = (np.repeat(np.arange(rows), cols) + 1) * square_size
    pc = corners_w @ r_wc.T + t_wc
    uv = cam.project(torch.as_tensor(pc.astype(np.float32), device=dev)).cpu().numpy()
    return img, uv

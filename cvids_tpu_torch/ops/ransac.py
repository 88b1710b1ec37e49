"""Batched-hypothesis RANSAC: PnP, fundamental matrix and the essential-matrix
pose (port of ``cvids_tpu/ops/ransac.py``).

Fixed-shape hypothesis sweeps: all minimal sets are sampled up front, solved
in one batched linear-algebra pass, and scored against all points with one
matrix of residuals; the first hypothesis with the most inliers wins.

Sampling takes its randomness as a tensor: `gumbel` is (num_hyp, n) standard
Gumbel noise, and each hypothesis takes the `sample_size` largest entries of
noise + log(valid) — the Gumbel-top-k draw of the JAX package with the noise
supplied by the caller (`gumbel_noise` draws its uniforms from a CPU
`torch.Generator`), so the same noise tensor gives the same hypotheses on the
CPU, on the card and in `cvids_tpu`.

`jacobi` (None: whether the inputs lie on the card) picks the linear
algebra of the 8-point F, the PnP's DLT and the essential matrix's
decomposition. True: float64 systems, their eigenvectors from the Jacobi
kernel `cuda_kernels.small_eigh`, each 3×3 SVD taken through the
eigenvectors of MᵀM and each 3×3 determinant by cofactors, so nothing reads
a device value back to the host and a call can be captured in a CUDA graph.
False: the JAX package's float32 arithmetic through torch.linalg's `eigh`,
`svd` and `det` (LAPACK on the CPU), whose error checks wait for the card.

All functions operate on normalized (undistorted) image coordinates. The
6×6 Gauss-Newton solve is torch.linalg's `solve_ex`, which checks nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import resolve_device
from ..geometry import matrix_to_quat, quat_to_matrix, so3_exp, so3_hat

__all__ = ["pnp_ransac", "fundamental_ransac", "essential_pose", "refine_pose_gn",
           "PnPResult", "FResult", "EPoseResult", "gumbel_noise"]


class PnPResult(NamedTuple):
    q: torch.Tensor            # (4,) rotation R_cw as a quaternion (w,x,y,z)
    r: torch.Tensor            # (3, 3) rotation R_cw
    t: torch.Tensor            # (3,)   t_cw:  x_cam = R_cw x_world + t_cw
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor
    ok: torch.Tensor           # bool: enough inliers (reference gate: >= 15)


class FResult(NamedTuple):
    f: torch.Tensor            # (3, 3)
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor


class EPoseResult(NamedTuple):
    r: torch.Tensor            # (3, 3) R_c1<-c0
    t: torch.Tensor            # (3,) unit translation, cam1 frame
    inliers: torch.Tensor      # (N,) bool (epipolar inliers)
    num_pos: torch.Tensor      # cheirality votes of the winning decomposition
    ok: torch.Tensor


def gumbel_noise(num_hyp: int, n: int, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """(num_hyp, n) float32 standard Gumbel noise on `device` (None: the
    card, `cvids_tpu_torch.default_device()`): the uniforms
    come from the CPU `generator` (the same uniforms whatever the device)
    and cross to the device through pinned memory; the two logs run there.
    The CPU's and the card's `log` need not round alike, so the noise agrees
    across devices only to an ulp or so; `chip_smoke.py` checks that the
    hypotheses it picks are the same."""
    device = resolve_device(device)
    u = torch.rand((num_hyp, n), generator=generator, dtype=torch.float32)
    if device.type == "cuda":
        u = u.pin_memory().to(device, non_blocking=True)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample_indices(gumbel: torch.Tensor, valid: torch.Tensor,
                    sample_size: int) -> torch.Tensor:
    """(num_hyp, sample_size) indices drawn with probability ∝ valid, without
    replacement within a hypothesis: the top entries of gumbel + logits. A
    stable sort breaks ties toward the lower index, as `lax.top_k` does
    (masked entries, -1e9 + g, tie in fp32)."""
    zero = torch.zeros((), device=gumbel.device)
    logits = torch.where(valid, zero, torch.full((), -1e9, device=gumbel.device))
    g = gumbel + logits[None]
    return torch.sort(g, dim=1, descending=True, stable=True).indices[:, :sample_size]


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3) matrices by cofactors: no factorization
    and no read back."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _svd3_jacobi(m: torch.Tensor):
    """(..., 3, 3) -> (u, s, vt) of M = U diag(s) Vᵀ, s descending, through
    the Jacobi kernel: V and s² are MᵀM's eigenpairs, U's first two columns
    M v / s, its third their cross product signed so that det(U) det(V) is
    the sign of det(M) (+1 for a singular M), as M v₃ / s₃ would be; a zero
    least singular value (a rank-2 F) divides nothing. The signs of the
    pairs (u_i, v_i) are a valid SVD's; which of them LAPACK would return
    is not asked."""
    from . import cuda_kernels

    lead = m.shape[:-2]
    m = m.reshape(-1, 3, 3)
    lam, v = cuda_kernels.small_eigh(m.transpose(-1, -2) @ m)
    v = v.flip(-1)                                               # descending
    s = torch.sqrt(torch.clamp(lam.flip(-1), min=0.0))
    tiny = torch.full((), 1e-300 if m.dtype == torch.float64 else 1e-30,
                      dtype=m.dtype, device=m.device)
    u12 = (m @ v[..., :2]) / torch.maximum(s[..., None, :2], tiny)
    one = torch.ones((), dtype=m.dtype, device=m.device)
    sign = (torch.where(_det3(m) < 0, -one, one)
            * torch.where(_det3(v) < 0, -one, one))
    u3 = torch.linalg.cross(u12[..., 0], u12[..., 1], dim=-1) * sign[:, None]
    u = torch.cat([u12, u3[..., None]], dim=-1)
    return (u.reshape(lead + (3, 3)), s.reshape(lead + (3,)),
            v.transpose(-1, -2).reshape(lead + (3, 3)))


def _dlt_pose(pts3d: torch.Tensor, obs: torch.Tensor, jacobi: bool | None = None):
    """6-point DLT for [R|t] per hypothesis: pts3d (K, S, 3), obs (K, S, 2)
    normalized coords -> (R (K, 3, 3), t (K, 3)).

    P = [R|t] up to scale is the nullspace of the 2S×12 system (eigenvector
    of AᵀA with the smallest eigenvalue); R is projected onto SO(3) by SVD
    and scale and sign are fixed by cheirality. The eigenvector's sign is
    chosen so that det(P[:, :3]) >= 0 — the JAX package takes LAPACK's sign
    as it comes, which for det < 0 yields R composed with a half-turn.

    `jacobi` (None: whether pts3d lies on the card): True poses the system
    in float64 (AᵀA squares the condition of a system whose columns mix
    metres with normalized coordinates), takes AᵀA's eigenvectors from
    `cuda_kernels.small_eigh` and the SVD of P[:, :3] through `_svd3_jacobi`,
    and returns float32; False is the JAX package's float32 LAPACK."""
    if jacobi is None:
        jacobi = pts3d.is_cuda
    out_dtype = pts3d.dtype
    if jacobi:
        from . import cuda_kernels

        pts3d, obs = pts3d.double(), obs.double()
        eigh, svd, det = cuda_kernels.small_eigh, _svd3_jacobi, _det3
    else:
        eigh, svd, det = torch.linalg.eigh, torch.linalg.svd, torch.linalg.det
    k, s = pts3d.shape[:2]
    x, y = obs[..., 0], obs[..., 1]
    xh = torch.cat([pts3d, torch.ones((k, s, 1), dtype=pts3d.dtype,
                                      device=pts3d.device)], dim=-1)   # (K, S, 4)
    zeros = torch.zeros_like(xh)
    rows_x = torch.cat([xh, zeros, -x[..., None] * xh], dim=-1)         # (K, S, 12)
    rows_y = torch.cat([zeros, xh, -y[..., None] * xh], dim=-1)
    a = torch.cat([rows_x, rows_y], dim=1)                              # (K, 2S, 12)
    _, v = eigh(a.transpose(-1, -2) @ a)
    p = v[..., :, 0].reshape(k, 3, 4)
    p = torch.where((det(p[..., :3]) < 0)[:, None, None], -p, p)
    r_raw, t_raw = p[..., :3], p[..., 3]
    u, sv, vt = svd(r_raw)
    scale = torch.mean(sv, dim=-1)
    r = u @ vt
    d = det(r)
    u_fix = torch.cat([u[..., :2], -u[..., 2:]], dim=-1)     # last column negated
    r = torch.where((d < 0)[:, None, None], u_fix @ vt, r)
    t = t_raw / torch.where(torch.abs(scale) > 1e-12, scale,
                            torch.full((), 1e-12, dtype=scale.dtype,
                                       device=scale.device))[:, None]
    t = torch.where((d < 0)[:, None], -t, t)
    z = (pts3d @ r.transpose(-1, -2) + t[:, None, :])[..., 2]
    flip = torch.sum(torch.sign(z), dim=-1) < 0
    r = torch.where(flip[:, None, None], -r, r)   # -R is improper: such a hypothesis scores badly
    t = torch.where(flip[:, None], -t, t)
    return r.to(out_dtype), t.to(out_dtype)


def _reproj_residuals(r, t, pts3d, obs):
    """Reprojection error of each point under each pose: r (..., 3, 3),
    t (..., 3) -> (..., N); inf behind the camera."""
    pc = pts3d @ r.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    proj = pc[..., :2] / torch.where(torch.abs(z) > 1e-9, z,
                                     torch.full((), 1e-9, device=z.device))[..., None]
    err = torch.linalg.vector_norm(proj - obs, dim=-1)
    return torch.where(z > 1e-6, err, torch.full((), math.inf, device=z.device))


def pnp_ransac(pts3d: torch.Tensor, obs: torch.Tensor, valid: torch.Tensor,
               gumbel: torch.Tensor, sample_size: int = 6,
               inlier_thresh: float = 10.0 / 460.0, min_inliers: int = 15,
               refine_iters: int = 5, jacobi: bool | None = None) -> PnPResult:
    """RANSAC PnP on normalized coordinates, one hypothesis per row of
    `gumbel` (num_hyp, N).

    Mirrors the reference's `PnPRANSAC` (`server_keyframe.cpp:418-497`):
    threshold ≈ 10 px at focal 460, accept if ≥ `min_inliers` (MIN_LOOP_NUM).
    Hypotheses are 6-point DLT poses (`jacobi`: see `_dlt_pose`), refined by
    masked Gauss-Newton on the best hypothesis' inliers."""
    idx = _sample_indices(gumbel, valid, sample_size)                   # (K, S)
    rs, ts = _dlt_pose(pts3d[idx], obs[idx], jacobi)
    errs = _reproj_residuals(rs, ts, pts3d, obs)                        # (K, N)
    inl = (errs < inlier_thresh) & valid[None]
    best = torch.argmax(torch.sum(inl, dim=1)).reshape(1)   # a tensor index: no host read
    r, t = refine_pose_gn(rs[best][0], ts[best][0], pts3d, obs, inl[best][0],
                          iters=refine_iters)
    inliers = (_reproj_residuals(r, t, pts3d, obs) < inlier_thresh) & valid
    num = torch.sum(inliers)
    return PnPResult(matrix_to_quat(r), r, t, inliers, num, num >= min_inliers)


def refine_pose_gn(r0, t0, pts3d, obs, weight_mask, iters: int = 5):
    """Gauss-Newton refinement of (R, t) minimizing masked reprojection
    error, fixed iterations; left-multiplicative SO(3) update R <- exp(dw) R.
    The 6×6 solve skips torch's error check, which would wait for the card."""
    mask = weight_mask.to(pts3d.dtype)
    n = pts3d.shape[0]
    eye3 = torch.eye(3, dtype=pts3d.dtype, device=pts3d.device)
    eye6 = torch.eye(6, dtype=pts3d.dtype, device=pts3d.device)
    r, t = r0, t0
    for _ in range(iters):
        pc = pts3d @ r.T + t                                            # (N, 3)
        z = torch.where(torch.abs(pc[:, 2]) > 1e-9, pc[:, 2],
                        torch.full((), 1e-9, device=pc.device))
        proj = pc[:, :2] / z[:, None]
        res = (proj - obs) * mask[:, None]                              # (N, 2)
        inv_z = 1.0 / z
        zero = torch.zeros_like(inv_z)
        j_proj = torch.stack([
            torch.stack([inv_z, zero, -pc[:, 0] * inv_z * inv_z], -1),
            torch.stack([zero, inv_z, -pc[:, 1] * inv_z * inv_z], -1),
        ], dim=1)                                                       # (N, 2, 3)
        j_pose = torch.cat([-so3_hat(pc), eye3.expand(n, 3, 3)], dim=2)  # (N, 3, 6)
        j = torch.einsum("nij,njk->nik", j_proj, j_pose) * mask[:, None, None]
        jt = j.reshape(-1, 6)
        h = jt.T @ jt + 1e-8 * eye6
        g = jt.T @ res.reshape(-1)
        dx = torch.linalg.solve_ex(h, -g[:, None])[0][:, 0]
        r = quat_to_matrix(so3_exp(dx[:3])) @ r
        t = t + dx[3:]
    return r, t


def _eight_point(p1: torch.Tensor, p2: torch.Tensor, jacobi: bool | None = None) -> torch.Tensor:
    """Normalized 8-point algorithm per hypothesis: (K, S>=8, 2)
    correspondences -> F (K, 3, 3). F's sign is free (the Sampson error
    does not see it).

    `jacobi` (None: whether p1 lies on the card) picks the eigensolver. True:
    float64 throughout, the eigenproblems through `cuda_kernels.small_eigh`,
    the Jacobi kernel on the card (its twin on the CPU), which reads nothing
    back; where a sample determines F (not all on one plane, not a pure
    image translation), F is then that of the points but for its rounding
    to float32, whichever eigensolver computes it. False: float32 through
    LAPACK, the JAX package's arithmetic on the CPU: AᵀA squares the
    system's condition, so its F is ~1e-3 off (`tests/test_torch_small_eig.py`),
    and the JAX parity tests hold inliers and cheirality votes that sit on
    their thresholds."""
    from . import cuda_kernels     # as the reference's `ops` binds no kernel module

    if jacobi is None:
        jacobi = p1.is_cuda
    eigh = cuda_kernels.small_eigh if jacobi else torch.linalg.eigh
    out_dtype = p1.dtype
    if jacobi:
        p1, p2 = p1.double(), p2.double()

    def normalize(p):
        c = torch.mean(p, dim=1)                                        # (K, 2)
        d = torch.mean(torch.linalg.vector_norm(p - c[:, None], dim=-1), dim=1)
        s = math.sqrt(2.0) / torch.clamp(d, min=1e-9)                   # (K,)
        zero = torch.zeros_like(s)
        one = torch.ones_like(s)
        tm = torch.stack([s, zero, -s * c[:, 0], zero, s, -s * c[:, 1],
                          zero, zero, one], dim=-1).reshape(-1, 3, 3)
        return (p - c[:, None]) * s[:, None, None], tm

    n1, t1 = normalize(p1)
    n2, t2 = normalize(p2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)                      # (K, S, 9)
    _, v = eigh(a.transpose(-1, -2) @ a)
    f = v[..., :, 0].reshape(-1, 3, 3)
    # the rank-2 projection U diag(s1, s2, 0) Vᵀ of F's SVD is F (I - v3 v3ᵀ),
    # v3 the right singular vector of the least singular value: the
    # eigenvector of FᵀF with the least eigenvalue
    _, vf = eigh(f.transpose(-1, -2) @ f)
    v3 = vf[..., :, 0:1]                                                # (K, 3, 1)
    f2 = f - (f @ v3) @ v3.transpose(-1, -2)
    return (t2.transpose(-1, -2) @ f2 @ t1).to(out_dtype)


def _sampson_error(f: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Sampson distance of every correspondence under every F: f (K, 3, 3),
    p1, p2 (N, 2) -> (K, N)."""
    h1 = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=1)
    h2 = torch.cat([p2, torch.ones_like(p2[:, :1])], dim=1)
    fx1 = h1 @ f.transpose(-1, -2)      # (K, N, 3) = F x1
    ftx2 = h2 @ f                       # (K, N, 3) = F^T x2
    num = torch.sum(h2 * fx1, dim=-1) ** 2
    den = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def fundamental_ransac(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
                       gumbel: torch.Tensor,
                       inlier_thresh: float = (3.0 / 460.0) ** 2,
                       jacobi: bool | None = None) -> FResult:
    """RANSAC fundamental matrix on normalized coords, one 8-point hypothesis
    per row of `gumbel` (num_hyp, N). Mirrors `FundmantalMatrixRANSAC`
    (`server_keyframe.cpp:382-413`): a 3-px threshold at the virtual focal.
    `jacobi`: see `_eight_point`."""
    idx = _sample_indices(gumbel, valid, 8)
    fs = _eight_point(p1[idx], p2[idx], jacobi)                         # (K, 3, 3)
    inl = (_sampson_error(fs, p1, p2) < inlier_thresh) & valid[None]
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts).reshape(1)                  # a tensor index: no host read
    return FResult(fs[best][0], inl[best][0], counts[best][0])


def _two_view_depths(r: torch.Tensor, t: torch.Tensor, p0: torch.Tensor,
                     p1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point depths (z0, z1) for cam0 rays p0 and cam1 rays p1 (N, 2)
    under x1 z1 = R x0 z0 + t, 2-unknown least squares per correspondence;
    r (..., 3, 3), t (..., 3) -> (..., N) each."""
    x0 = torch.cat([p0, torch.ones_like(p0[:, :1])], dim=1)        # (N, 3)
    x1 = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=1)
    a0 = x0 @ r.transpose(-1, -2)                                  # (..., N, 3) = R x0
    aa = torch.sum(a0 * a0, -1)
    bb = torch.sum(x1 * x1, -1)
    ab = torch.sum(a0 * x1, -1)
    a_t = torch.sum(a0 * t[..., None, :], -1)
    b_t = torch.sum(x1 * t[..., None, :], -1)
    det = aa * bb - ab * ab
    safe = torch.where(torch.abs(det) > 1e-12, det, torch.full((), 1e-12, device=det.device))
    z0 = (-a_t * bb + ab * b_t) / safe
    z1 = (-a_t * ab + aa * b_t) / safe
    return z0, z1


def essential_pose(p0: torch.Tensor, p1: torch.Tensor, valid: torch.Tensor,
                   gumbel: torch.Tensor, jacobi: bool | None = None) -> EPoseResult:
    """Relative camera pose from 2-view normalized correspondences: RANSAC
    essential matrix (normalized coordinates make F = E, a 1.5 px threshold
    at the virtual focal), one hypothesis per row of `gumbel` (num_hyp, N),
    then the four-fold decomposition with a cheirality vote (the
    `cv::recoverPose` role: the pre-VI-init visual pose bootstrap). U and V
    are taken with det +1, so the candidate set is the same whatever signs
    the SVD picks; the first candidate with the most votes wins.

    `jacobi` (None: whether p0 lies on the card): True takes F from the
    float64 Jacobi 8-point and its SVD in float64 through `_svd3_jacobi`
    (reads nothing back); False is the JAX package's float32 LAPACK."""
    if jacobi is None:
        jacobi = p0.is_cuda
    fres = fundamental_ransac(p0, p1, valid, gumbel, inlier_thresh=(1.5 / 460.0) ** 2,
                              jacobi=jacobi)
    if jacobi:
        u, _, vt = _svd3_jacobi(fres.f.double())
        u, vt = u.to(fres.f.dtype), vt.to(fres.f.dtype)
        det = _det3
    else:
        u, _, vt = torch.linalg.svd(fres.f)
        det = torch.linalg.det
    u = u * torch.sign(det(u))
    vt = vt * torch.sign(det(vt))
    # U W and U Wᵀ, W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]], as column
    # permutations with signs (exact, and no host copy of W)
    uw = torch.stack([u[:, 1], -u[:, 0], u[:, 2]], dim=-1)
    uwt = torch.stack([-u[:, 1], u[:, 0], u[:, 2]], dim=-1)
    r_a, r_b = uw @ vt, uwt @ vt
    t_a = u[:, 2]
    cand_r = torch.stack([r_a, r_a, r_b, r_b])
    cand_t = torch.stack([t_a, -t_a, t_a, -t_a])
    mask = fres.inliers & valid
    z0, z1 = _two_view_depths(cand_r, cand_t, p0, p1)                # (4, N)
    votes = torch.sum((z0 > 0) & (z1 > 0) & mask, dim=1)
    best = torch.argmax(votes).reshape(1)                   # a tensor index: no host read
    n_in = torch.sum(mask)
    v_best = votes[best][0]
    ok = (v_best >= 0.7 * torch.clamp(n_in, min=1)) & (n_in >= 8)
    return EPoseResult(cand_r[best][0], cand_t[best][0], fres.inliers, v_best, ok)

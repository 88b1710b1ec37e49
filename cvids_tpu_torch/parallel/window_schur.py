"""Landmark-sharded Schur-complement sliding-window VI bundle adjustment
(port of ``cvids_tpu/parallel/window_schur.py``).

The distributed form of `vio.window_ba.solve_window_fast`: the camera system
is replicated and the landmarks are sharded over a `Mesh`.

- each rank builds its landmarks' reprojection residuals, 3x3 Hessian
  blocks and their Schur contribution to the reduced camera system from the
  closed-form Jacobians (`reprojection_jacobians`), as the single-device
  solve does; the camera-only factors (IMU, anchors, bias priors) are
  differentiated on every rank and added once;
- ONE all-reduce per LM iteration carries the packed reduced system,
  2·(15K)² + 2·15K + 1 floats for a K-keyframe window whatever the
  landmark count; one more carries the three landmark terms of the gain
  ratio, and one the trial state's cost, as in the JAX body;
- the (15K)-wide damped solve and the accept/reject run replicated; the
  landmark back-substitution is local;
- on NCCL ranks on the card one iteration, its three all-reduces included,
  is a CUDA graph replayed `iters` times.
"""

from __future__ import annotations

import functools

import torch

from ..vio import window_ba as ba
from ..vio.window_ba import WindowMeasurements, WindowState
from .audit import summarize_collectives
from .mesh import Mesh

__all__ = ["solve_window_schur_sharded"]


def _pad_rows(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim)


def _total_cost(reduce, meas, anchor_weight, s):
    """The window's cost over every rank's landmarks (one all-reduce)."""
    proj = 0.5 * torch.sum(ba.reprojection_residuals(s, meas) ** 2)
    return (0.5 * torch.sum(ba._cam_residuals(s, meas, anchor_weight) ** 2)
            + reduce(proj.reshape(1))[0])


def _iteration(reduce, meas: WindowMeasurements, anchor_weight: float, st: WindowState,
               lam: torch.Tensor, cost: torch.Tensor
               ) -> tuple[WindowState, torch.Tensor, torch.Tensor]:
    """One LM iteration of the sharded Schur solve on this rank's padded
    landmarks `meas`, `reduce` summing across the ranks (three calls):
    (state, lambda, cost) -> the next three, with no read-back, so that
    NCCL ranks can replay it as a CUDA graph."""
    k = st.p.shape[0]
    pc, p6 = 15 * k, 6 * k
    dev, f32 = st.p.device, st.p.dtype
    zc = torch.zeros(pc, dtype=f32, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye_k = torch.eye(k, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    def in_cam(pose_part: torch.Tensor) -> torch.Tensor:
        """A pose-block (6K, 6K) matrix or (6K,) vector in the (15K) layout."""
        out = torch.zeros((pc,) * pose_part.dim(), dtype=f32, device=dev)
        out[(slice(0, p6),) * pose_part.dim()] = pose_part
        return out

    # replicated camera-only system
    def cam_res_dc(dc):
        return ba._cam_residuals(ba.retract_cam(st, dc), meas, anchor_weight)
    r_cam = cam_res_dc(zc)
    j_cam = torch.func.jacfwd(cam_res_dc)(zc)

    # this rank's landmarks
    r, j_pose, j_lm = ba.reprojection_jacobians(st, meas)
    h_ll = torch.einsum("klra,klrb->lab", j_lm, j_lm)                 # (Ll, 3, 3)
    g_l = torch.einsum("klra,klr->la", j_lm, r)
    h_pl = torch.einsum("klra,klrb->klab", j_pose, j_lm)              # (K, Ll, 6, 3)
    h_pp = torch.einsum("klra,klrb->kab", j_pose, j_pose)             # (K, 6, 6)
    g_p = torch.einsum("klra,klr->ka", j_pose, r)
    h_ll_d = h_ll + lam * (torch.diag_embed(torch.diagonal(h_ll, dim1=-2, dim2=-1))
                           + 1e-6 * eye3)
    observed = torch.einsum("lab->l", torch.abs(h_ll)) > 1e-12
    h_ll_inv = torch.linalg.inv_ex(torch.where(observed[:, None, None], h_ll_d, eye3))[0]
    w_mat = h_pl @ h_ll_inv[None]                                      # (K, Ll, 6, 3)
    packed = reduce(torch.cat([
        in_cam(ba._pose_block_to_cam(torch.einsum("kab,km->kamb", h_pp, eye_k), k)).reshape(-1),
        in_cam(ba._pose_block_to_cam(torch.einsum("klab,mlcb->kamc", w_mat, h_pl),
                                     k)).reshape(-1),
        in_cam(ba._to_cam(g_p, k)),
        in_cam(ba._to_cam(torch.einsum("klab,lb->ka", w_mat, g_l), k)),
        (0.5 * torch.sum(r ** 2)).reshape(1)]))
    h_cc = j_cam.T @ j_cam + packed[:pc * pc].reshape(pc, pc)
    schur = packed[pc * pc:2 * pc * pc].reshape(pc, pc)
    g_c = j_cam.T @ r_cam + packed[2 * pc * pc:2 * pc * pc + pc]
    wg = packed[2 * pc * pc + pc:2 * pc * pc + 2 * pc]
    h_red = h_cc + torch.diag(lam * (torch.diagonal(h_cc) + 1e-6)) - schur
    dc = ba._equilibrated_solve(h_red, g_c - wg)

    # local landmark back-substitution
    dc_pose = ba._from_cam(dc, k)                                      # (K, 6)
    rhs = -g_l - torch.einsum("klab,ka->lb", h_pl, dc_pose)
    dl = torch.where(observed[:, None], (h_ll_inv @ rhs[..., None])[..., 0], zero)
    st_new = ba.retract_cam(st, dc)._replace(lm=st.lm + dl)
    cost_new = _total_cost(reduce, meas, anchor_weight, st_new)

    # Nielsen gain ratio; the landmark terms reduced in one call
    lterms = reduce(torch.stack([
        2.0 * torch.einsum("ka,klab,lb->", dc_pose, h_pl, dl),
        torch.einsum("la,lab,lb->", dl, h_ll, dl), torch.sum(g_l * dl)]))
    pred = -(g_c @ dc + lterms[2]) - 0.5 * (dc @ (h_cc @ dc) + lterms[0] + lterms[1])
    return ba._lm_update(cost_new < cost, st_new, st, lam, cost_new, cost, pred)


def solve_window_schur_sharded(mesh: Mesh, state: WindowState, meas: WindowMeasurements,
                               iters: int = 8, init_lambda: float = 1e-3,
                               anchor_weight: float = 1e3, audit_label: str | None = None
                               ) -> tuple[WindowState, torch.Tensor]:
    """LM with Schur landmark elimination, the landmarks sharded over
    `mesh`; returns (state, cost) at the original landmark capacity, the
    same on every rank.

    Same contract as `solve_window_fast` without a prior: a prior raises
    ValueError (a dense prior couples all landmarks and belongs on the
    replicated path). The landmark axis is padded to a multiple of the mesh
    size with invalid landmarks. On a mesh of W > 1 ranks the solve issues
    3 * iters + 2 all-reduces: the first cost, three an iteration, and the
    landmarks gathered at the end (a zero-filled (L', 3) buffer: gloo has no
    all-gather of CUDA tensors). On NCCL ranks on the card the iteration
    (`_iteration`, the rank's padded measurements bound to it) is a CUDA
    graph replayed `iters` times (`Mesh.graphed`); the first cost and the
    gather run eagerly. `audit_label`: when set, rank 0 prints the solve's
    collectives (`summarize_collectives`) under this label."""
    if meas.prior is not None:
        raise ValueError("sharded Schur solve does not support a prior")
    l = state.lm.shape[0]
    pad = (-l) % mesh.size
    mine = mesh.block(l + pad)
    n_logged = len(mesh.log)
    meas_loc = meas._replace(obs=_pad_rows(torch.nan_to_num(meas.obs), pad, 1)[:, mine],
                             vis=_pad_rows(meas.vis, pad, 1)[:, mine])
    st = state._replace(lm=_pad_rows(state.lm, pad, 0)[mine],
                        lm_valid=_pad_rows(state.lm_valid, pad, 0)[mine])
    step = functools.partial(mesh.graphed(_iteration), mesh.all_reduce, meas_loc,
                             anchor_weight)
    lam = torch.full((), init_lambda, dtype=st.p.dtype, device=st.p.device)
    cost = _total_cost(mesh.all_reduce, meas_loc, anchor_weight, st)
    for _ in range(iters):
        st, lam, cost = step(st, lam, cost)

    lm_all = torch.zeros((l + pad, 3), dtype=st.p.dtype, device=st.p.device)
    lm_all[mine] = st.lm
    out = st._replace(lm=mesh.all_reduce(lm_all)[:l], lm_valid=state.lm_valid)
    if audit_label is not None and mesh.rank == 0:
        print(f"  {summarize_collectives(mesh.log[n_logged:], audit_label)}", flush=True)
    return out, cost

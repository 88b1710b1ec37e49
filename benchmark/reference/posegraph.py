"""Plain NumPy and PyTorch reference of the pose graph's answers on the
benchmark's keyframes. It imports nothing of the program.

Every feature is an exact observation of a seeded landmark, and a keyframe's
window points are given in the same odometry frame as its pose, so the 4-DoF
loop edge between two keyframes has one right value, worked out here from
the generator's camera poses (`loop_edges`). The odometry drifts (the
generator's `drift`), so the world poses after a solve are not the truth:
they are the minimum of the 4-DoF pose graph over the keyframes' odometry
and the loop edges, which `optimize` finds by Gauss-Newton in float64 with
a direct solve, to convergence.

The program's conventions (`server/posegraph.py`, `server/optimizer.py`):
a loop edge (i, j) holds t_ij = R_wb(i)^T (p_j - p_i) in body i's frame and
yaw_ij = yaw_j - yaw_i; the world is the first agent's odometry frame;
R = Rz(yaw) Ry(pitch) Rx(roll), pitch and roll held at the odometry's; a
keyframe's sequential edges join it to the keyframes up to `max_back` before
it in arrival order that belong to its agent, measured from the odometry,
unit weights and no robust loss; a loop edge weighs its translation by
`t_weight` and its yaw by `yaw_weight`, and scales its weighted residual r by
sqrt(huber / |r|) where |r| > huber.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def yaw_of(r: np.ndarray) -> np.ndarray:
    return np.arctan2(r[..., 1, 0], r[..., 0, 0])


def wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def loop_edges(r_wb: np.ndarray, p_wb: np.ndarray, i: np.ndarray, j: np.ndarray):
    """(t_ij (E, 3), yaw_ij (E,)) of the edges (i, j)."""
    t = np.einsum("eba,eb->ea", r_wb[i], p_wb[j] - p_wb[i])
    return t, wrap(yaw_of(r_wb[j]) - yaw_of(r_wb[i]))


def round_to(x: np.ndarray, dtype: str) -> np.ndarray:
    """x rounded to a lower float format (the control), as float64."""
    return torch.from_numpy(np.asarray(x, np.float64)).to(getattr(torch, dtype)).double().numpy()


def quat_to_r(q: np.ndarray) -> np.ndarray:
    """(..., 4) unit quaternions (w, x, y, z) -> (..., 3, 3), float64."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    m = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def ypr_of(r: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 3) (yaw, pitch, roll) of R = Rz Ry Rx."""
    yaw = np.arctan2(r[..., 1, 0], r[..., 0, 0])
    cy, sy = np.cos(yaw), np.sin(yaw)
    pitch = np.arctan2(-r[..., 2, 0], r[..., 0, 0] * cy + r[..., 1, 0] * sy)
    roll = np.arctan2(r[..., 0, 2] * sy - r[..., 1, 2] * cy, -r[..., 0, 1] * sy + r[..., 1, 1] * cy)
    return np.stack([yaw, pitch, roll], -1)


def _rot(yaw: torch.Tensor, pr: torch.Tensor, d_yaw: bool = False) -> torch.Tensor:
    """Rz(yaw) Ry(pitch) Rx(roll), or its derivative in yaw."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    o, z = torch.ones_like(yaw), torch.zeros_like(yaw)
    rz = (torch.stack([-s, -c, z, c, -s, z, z, z, z], -1) if d_yaw
          else torch.stack([c, -s, z, s, c, z, z, z, o], -1)).reshape(yaw.shape + (3, 3))
    cp, sp = torch.cos(pr[..., 0]), torch.sin(pr[..., 0])
    cr, sr = torch.cos(pr[..., 1]), torch.sin(pr[..., 1])
    ry = torch.stack([cp, z, sp, z, o, z, -sp, z, cp], -1).reshape(yaw.shape + (3, 3))
    rx = torch.stack([o, z, z, z, cr, -sr, z, sr, cr], -1).reshape(yaw.shape + (3, 3))
    return rz @ ry @ rx


@dataclass
class Edges:
    """4-DoF constraints i -> j, float64."""
    i: np.ndarray
    j: np.ndarray
    t_ij: np.ndarray         # (E, 3)
    yaw_ij: np.ndarray       # (E,)
    t_weight: np.ndarray     # (E,)
    yaw_weight: np.ndarray   # (E,)
    huber: np.ndarray        # (E,), inf for none


def sequential_edges(ypr: np.ndarray, p: np.ndarray, client: np.ndarray,
                     max_back: int) -> Edges:
    """Each node's edges to the nodes up to `max_back` before it of its own
    client, measured from the odometry (ypr (N, 3), p (N, 3))."""
    n = len(p)
    js = np.repeat(np.arange(n), max_back)
    is_ = js - np.tile(np.arange(1, max_back + 1), n)
    keep = is_ >= 0
    is_, js = is_[keep], js[keep]
    keep = client[is_] == client[js]
    is_, js = is_[keep], js[keep]
    r = rot_ypr(ypr[is_])
    t = np.einsum("eba,eb->ea", r, p[js] - p[is_])
    e = len(is_)
    return Edges(is_, js, t, wrap(ypr[js, 0] - ypr[is_, 0]), np.ones(e), np.ones(e),
                 np.full(e, np.inf))


def rot_ypr(ypr: np.ndarray) -> np.ndarray:
    """R = Rz Ry Rx of (..., 3) (yaw, pitch, roll), float64."""
    t = torch.from_numpy(np.asarray(ypr, np.float64))
    return _rot(t[..., 0], t[..., 1:]).numpy()


def join(*edges: Edges) -> Edges:
    return Edges(*(np.concatenate([getattr(e, f) for e in edges])
                   for f in ("i", "j", "t_ij", "yaw_ij", "t_weight", "yaw_weight", "huber")))


def optimize(yaw: np.ndarray, t: np.ndarray, pr: np.ndarray, edges: Edges, fixed: int,
             device="cpu", iters: int = 50, tol: float = 1e-12):
    """The 4-DoF pose graph's minimum by Gauss-Newton (Huber by reweighting)
    with a dense direct solve in float64, from (yaw, t) with node `fixed`
    held: (yaw (N,), t (N, 3), iterations). Nodes on no edge stay put."""
    dev = torch.device(device)

    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    yaw, t, pr = f64(yaw).clone(), f64(t).clone(), f64(pr)
    i = torch.as_tensor(edges.i, dtype=torch.int64, device=dev)
    j = torch.as_tensor(edges.j, dtype=torch.int64, device=dev)
    m_t, m_yaw = f64(edges.t_ij), f64(edges.yaw_ij)
    w_t, w_y, hub = f64(edges.t_weight), f64(edges.yaw_weight), f64(edges.huber)
    n, e = len(yaw), len(i)
    free = torch.zeros(n, dtype=torch.bool, device=dev)
    free[i] = True
    free[j] = True
    free[fixed] = False
    var_free = free.repeat_interleave(4)
    quad = torch.arange(4, device=dev)
    idx = torch.cat([4 * i[:, None] + quad, 4 * j[:, None] + quad], 1)          # (E, 8)
    done = 0
    for done in range(1, iters + 1):
        r_i = _rot(yaw[i], pr[i])
        d = t[j] - t[i]
        res = torch.cat([(torch.einsum("eba,eb->ea", r_i, d) - m_t) * w_t[:, None],
                         (torch.remainder(yaw[j] - yaw[i] - m_yaw + np.pi, 2 * np.pi)
                          - np.pi)[:, None] * w_y[:, None]], 1)
        rn = torch.linalg.vector_norm(res, dim=1)
        hw = torch.where(rn > hub, torch.sqrt(hub / rn.clamp(min=1e-300)), torch.ones_like(rn))
        jac = torch.zeros((e, 4, 8), dtype=torch.float64, device=dev)
        jac[:, :3, 0] = torch.einsum("eba,eb->ea", _rot(yaw[i], pr[i], d_yaw=True), d)
        jac[:, :3, 1:4] = -r_i.transpose(1, 2)
        jac[:, :3, 5:8] = r_i.transpose(1, 2)
        jac[:, 3, 0], jac[:, 3, 4] = -1.0, 1.0
        rows = torch.stack([w_t, w_t, w_t, w_y], 1) * hw[:, None]
        jac = jac * rows[:, :, None]
        res = res * hw[:, None]
        h = torch.zeros((4 * n, 4 * n), dtype=torch.float64, device=dev)
        h.index_put_((idx[:, :, None].expand(e, 8, 8), idx[:, None, :].expand(e, 8, 8)),
                     jac.transpose(1, 2) @ jac, accumulate=True)
        g = torch.zeros(4 * n, dtype=torch.float64, device=dev)
        g.index_put_((idx,), torch.einsum("eri,er->ei", jac, res), accumulate=True)
        h[~var_free] = 0.0
        h[:, ~var_free] = 0.0
        h[~var_free, ~var_free] = 1.0
        g[~var_free] = 0.0
        dx = -torch.linalg.solve(h, g).reshape(n, 4)
        del h
        yaw = torch.remainder(yaw + dx[:, 0] + np.pi, 2 * np.pi) - np.pi
        t = t + dx[:, 1:]
        if float(dx.abs().max()) < tol:
            break
    return yaw.cpu().numpy(), t.cpu().numpy(), done


def to_gauge(yaw: np.ndarray, p: np.ndarray, frm: tuple, to: tuple):
    """Poses (yaw, p) moved by the 4-DoF transform, a yaw about the vertical
    and a translation, that takes the pose `frm` = (yaw, p) to `to`: the
    pose graph's cost does not change under it."""
    dyaw = to[0] - frm[0]
    c, s = np.cos(dyaw), np.sin(dyaw)
    rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return wrap(yaw + dyaw), (p - frm[1]) @ rz.T + to[1]

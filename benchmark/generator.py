"""The keyframe session of a cell, made from the seed on the device.

A frozen rewrite, in PyTorch for the card, of the program's ray-traced room
(`cvids_tpu_torch/io/render.py`: `default_scene`, `render_textured_scene`,
`sample_scene_landmarks`) and of `chip_smoke.scene_stream`'s packets: agents
on arcs in front of the room, each camera looking at the box, and per
keyframe the landmarks the camera sees unoccluded as window and extra
features (exact normalized coordinates, the agent's odometry-frame points
and one 256-bit descriptor a landmark).

The agents oscillate along their arcs: keyframe i of agent a sits at grid
position g = (i + phase_a) mod 2P of a triangle wave with P steps a sweep,
so an agent revisits its places every sweep and the agents' arcs overlap,
which closes loops within and across agents. Only the P + 1 distinct views
of each agent are rendered; a keyframe's packet shares its view's arrays.
What the seed draws: the landmarks, their descriptors, each agent's phase,
its odometry frame's offset (agent 0's frame is the world) and the
direction of its odometry's drift. The drift is what a visual-inertial
odometry leaves unobservable, yaw and translation, growing at a fixed rate
a keyframe (the traffic's `drift`): keyframe k of an agent reports its pose
and its window points in its odometry frame moved by Rz(k w) and k v, so a
loop edge, measured from one keyframe's points and another's observations,
is exact, while the odometry between keyframes is off by (w, v) a step and
the pose graph's solve has work to do. Every seed gives the same number of
agents, views, image sizes and keyframes, and the same drift rates.

Everything here is parameterised by the traffic file (`traffic/*.json`) and
the configuration file (`configs/*.json`); nothing names a cell.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from cvids_tpu_torch.io.msgs import KeyframePacket

R_CB = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float32)  # body FLU -> camera

SCENE = dict(floor_z=0.0, wall_y=3.0, box_lo=(1.0, 0.5, 0.0), box_hi=(2.0, 1.5, 1.0))


@dataclass
class Session:
    """One cell's keyframes in submission order, with their ground truth."""
    packets: list            # KeyframePacket, time order
    agent: np.ndarray        # (N,) agent of each keyframe
    view: np.ndarray         # (N,) index into the agent's views
    r_wc: np.ndarray         # (A, V, 3, 3) float64 camera axes in world, per agent and view
    t_wc: np.ndarray         # (A, V, 3) float64 camera centre in world
    k: np.ndarray            # (3, 3) float32 pinhole K of the dense images
    yaw_off: np.ndarray      # (A,) odometry-frame yaw offsets
    t_off: np.ndarray        # (A, 3) odometry-frame offsets
    local: np.ndarray        # (N,) each keyframe's index among its agent's
    drift_yaw: np.ndarray    # (A,) odometry yaw drift a keyframe, rad
    drift_t: np.ndarray      # (A, 3) odometry translation drift a keyframe, m

    def truth_body(self, n: int):
        """(R_wb (n, 3, 3), p_wb (n, 3)) in the world of keyframes 0..n-1."""
        r = self.r_wc[self.agent[:n], self.view[:n]] @ R_CB.astype(np.float64)
        return r, self.t_wc[self.agent[:n], self.view[:n]]


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera axes in world (z toward the target, x level, y down)."""
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], 1)


def quat_wxyz(r: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation matrix (Shepperd)."""
    m = np.asarray(r, np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q) * (1.0 if q[0] >= 0 else -1.0)


def rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def sample_landmarks(n: int, gen: torch.Generator, device, extent: float = 4.0) -> torch.Tensor:
    """(n, 3) float64 points on the room's surfaces: 50 % floor, 35 % wall,
    15 % on the box's four sides and top (`sample_scene_landmarks`'s mix)."""
    u = torch.rand((n, 5), generator=gen, dtype=torch.float64, device=device)
    lo = torch.tensor(SCENE["box_lo"], dtype=torch.float64, device=device)
    hi = torch.tensor(SCENE["box_hi"], dtype=torch.float64, device=device)
    kind = torch.bucketize(u[:, 0].contiguous(), torch.tensor([0.5, 0.85], dtype=torch.float64, device=device),
                           right=True)
    face = torch.clamp((u[:, 1] * 5).long(), max=4)
    a, b = u[:, 2], u[:, 3]
    wall = SCENE["wall_y"]
    floor = torch.stack([(2 * a - 1) * extent, -extent + b * (min(extent, wall) + extent),
                         torch.full_like(a, SCENE["floor_z"])], -1)
    wallp = torch.stack([(2 * a - 1) * extent, torch.full_like(a, wall), 2.5 * b], -1)
    box = lo + torch.stack([a, b, u[:, 4]], -1) * (hi - lo)
    sides = box.clone()
    sides[face == 0, 0] = lo[0]
    sides[face == 1, 0] = hi[0]
    sides[face == 2, 1] = lo[1]
    sides[face == 3, 1] = hi[1]
    sides[face == 4, 2] = hi[2]
    return torch.where((kind == 0)[:, None], floor, torch.where((kind == 1)[:, None], wallp, sides))


def ray_grid(cam: dict, device) -> torch.Tensor:
    """(3, H*W) unit rays of every pixel of a pinhole + radtan camera (the
    renderer's fixed-point undistortion, 8 iterations), float64."""
    w, h = cam["width"], cam["height"]
    d0, d1, d2, d3 = cam["dist"]
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    xd = ((uu - cam["cx"]) / cam["fx"]).reshape(-1)
    yd = ((vv - cam["cy"]) / cam["fy"]).reshape(-1)
    x, y = xd.clone(), yd.clone()
    for _ in range(8):
        r2 = x * x + y * y
        rad = d0 * r2 + d1 * r2 * r2
        x = xd - (x * rad + 2.0 * d2 * x * y + d3 * (r2 + 2.0 * x * x))
        y = yd - (y * rad + 2.0 * d3 * x * y + d2 * (r2 + 2.0 * y * y))
    rays = torch.stack([x, y, torch.ones_like(x)])
    return rays / torch.linalg.norm(rays, dim=0, keepdim=True)


def project(cam: dict, pts_c: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels through pinhole + radtan."""
    z = torch.where(pts_c[..., 2].abs() > 1e-9, pts_c[..., 2], torch.full_like(pts_c[..., 2], 1e-9))
    x, y = pts_c[..., 0] / z, pts_c[..., 1] / z
    k1, k2, p1, p2 = cam["dist"]
    r2 = x * x + y * y
    rad = k1 * r2 + k2 * r2 * r2
    dx = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * rad + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return torch.stack([cam["fx"] * (x + dx) + cam["cx"], cam["fy"] * (y + dy) + cam["cy"]], -1)


def render(cam: dict, rays: torch.Tensor, r_wc: torch.Tensor, t_wc: torch.Tensor):
    """Intensity and z-depth (V, H, W) of the textured room seen from V
    camera poses (`render_textured_scene`'s ray cast and value noise)."""
    h, w = cam["height"], cam["width"]
    d = torch.einsum("vij,jn->vin", r_wc, rays)                      # (V, 3, HW)
    o = t_wc[:, :, None]
    ts = torch.full(d[:, 0].shape, math.inf, dtype=d.dtype, device=d.device)
    t_f = (SCENE["floor_z"] - o[:, 2]) / d[:, 2]
    ts = torch.where((d[:, 2] < -1e-6) & (t_f > 0), torch.minimum(ts, t_f), ts)
    t_w = (SCENE["wall_y"] - o[:, 1]) / d[:, 1]
    ts = torch.where((d[:, 1].abs() > 1e-6) & (t_w > 0), torch.minimum(ts, t_w), ts)
    lo = torch.tensor(SCENE["box_lo"], dtype=d.dtype, device=d.device)[None, :, None]
    hi = torch.tensor(SCENE["box_hi"], dtype=d.dtype, device=d.device)[None, :, None]
    t1, t2 = (lo - o) / d, (hi - o) / d
    tn = torch.amax(torch.minimum(t1, t2), 1)
    tf = torch.amin(torch.maximum(t1, t2), 1)
    hit_box = (tn < tf) & (tn > 0)
    ts = torch.where(hit_box, torch.minimum(ts, tn), ts)
    hit = torch.isfinite(ts)
    tt = torch.where(hit, ts, torch.zeros_like(ts))
    p = (o + tt[:, None] * d) * 2.0                                   # value-noise scale 2
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    v = (torch.sin(x * 1.7 + 0.3) * torch.cos(y * 2.3 + 1.1) + 0.6 * torch.sin(y * 3.1 + z * 1.3)
         + 0.4 * torch.cos(x * 4.7 - z * 2.9) + 0.25 * torch.sin((x + y + z) * 7.1))
    inten = torch.where(hit, 120.0 + 45.0 * v, torch.full_like(v, 15.0))
    depth = torch.where(hit, ts * rays[2][None], torch.zeros_like(ts))
    return inten.reshape(-1, h, w).to(torch.float32), depth.reshape(-1, h, w).to(torch.float32)


def make_session(config: dict, traffic: dict, seed: int, device, n_keyframes: int) -> Session:
    """The cell's session of `n_keyframes` keyframes (a multiple of the
    agents), from `seed`. Images are rendered on `device` in one batch an
    agent and kept on the host (the program takes numpy images)."""
    device = torch.device(device)
    cam = config["camera"]
    n_agents = config["agents"]
    steps = traffic["steps_per_sweep"]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    rng = np.random.default_rng(seed)
    landmarks = sample_landmarks(traffic["landmarks"], gen, device)
    descs = rng.integers(0, 2 ** 32, size=(traffic["landmarks"], 8), dtype=np.uint32)
    phase = rng.integers(0, 2 * steps, n_agents)
    yaw_off = np.concatenate([[0.0], rng.uniform(0.2, 0.8, n_agents - 1)
                              * rng.choice([-1.0, 1.0], n_agents - 1)])
    t_off = np.concatenate([np.zeros((1, 3)), rng.uniform(-2.0, 2.0, (n_agents - 1, 3))
                            * np.array([1.0, 1.0, 0.1])])
    drift = traffic["drift"]
    drift_yaw = drift["yaw_rad_per_kf"] * rng.choice([-1.0, 1.0], n_agents)
    v = rng.normal(size=(n_agents, 3))
    drift_t = drift["t_m_per_kf"] * v / np.linalg.norm(v, axis=1, keepdims=True)
    arc = traffic["arc"]
    n_views = steps + 1
    r_wc = np.zeros((n_agents, n_views, 3, 3))
    t_wc = np.zeros((n_agents, n_views, 3))
    for a in range(n_agents):
        for g in range(n_views):
            ang = arc["start_rad"] + arc["span_rad"] * g / steps
            radius = arc["radius_m"] + arc["radius_step_m"] * a
            eye = np.array([arc["center"][0] + radius * math.sin(ang),
                            arc["center"][1] - arc["back_step_m"] * a,
                            arc["height_m"] + arc["height_step_m"] * a])
            target = np.array([arc["target"][0] + 0.1 * a, arc["target"][1], arc["target"][2]])
            r_wc[a, g], t_wc[a, g] = look_at(eye, target), eye
    with_images = traffic["images"]
    rays = ray_grid(cam, device)
    k = np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]],
                 np.float32)
    w, h = cam["width"], cam["height"]
    max_feats = traffic["max_features"]
    images, view_feats = [], []
    for a in range(n_agents):
        rw = torch.from_numpy(r_wc[a]).to(device)
        tw = torch.from_numpy(t_wc[a]).to(device)
        inten, depth = render(cam, rays, rw, tw)
        pts_c = torch.einsum("nj,vjk->vnk", landmarks, rw) - torch.einsum("vj,vjk->vk", tw, rw)[:, None]
        z = pts_c[..., 2]
        px = project(cam, pts_c)
        px = torch.nan_to_num(px, nan=-1.0).clamp(-1.0, 1e6)
        u, v = torch.round(px[..., 0]).long(), torch.round(px[..., 1]).long()
        inside = (z > 0.5) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        dz = depth[torch.arange(n_views, device=device)[:, None], v.clamp(0, h - 1), u.clamp(0, w - 1)]
        seen = (inside & ((dz - z).abs() < 0.05 * z)).cpu().numpy()
        pts_np = pts_c.cpu().numpy()
        feats = []
        for g in range(n_views):
            idx = np.nonzero(seen[g])[0][:max_feats]
            uv = (pts_np[g, idx, :2] / pts_np[g, idx, 2:3]).astype(np.float32)
            feats.append((idx, uv))
        view_feats.append(feats)
        images.append(list(inten.cpu().numpy()) if with_images else [None] * n_views)
    lm = landmarks.cpu().numpy()
    # the odometry frames: world -> agent a's frame
    r_lw = [rot_z(-yaw_off[a]) for a in range(n_agents)]
    view_packets = []      # per agent and view: (odometry pose, points, shared arrays)
    for a in range(n_agents):
        per = []
        for g in range(n_views):
            idx, uv = view_feats[a][g]
            ones = np.ones(len(idx), bool)
            r_wb = r_wc[a, g] @ R_CB.astype(np.float64)
            per.append((r_lw[a] @ (t_wc[a, g] - t_off[a]), r_lw[a] @ r_wb,
                        (lm[idx] - t_off[a]) @ r_lw[a].T,
                        dict(win_uv=uv, win_ids=idx.astype(np.int64), win_desc=descs[idx],
                             win_valid=ones, ext_uv=uv, ext_desc=descs[idx],
                             ext_valid=ones.copy(), image=images[a][g])))
        view_packets.append(per)
    n_rounds = -(-n_keyframes // n_agents)
    agent = np.tile(np.arange(n_agents), n_rounds)
    i_round = np.repeat(np.arange(n_rounds), n_agents)
    grid = (i_round + phase[agent]) % (2 * steps)
    view = np.where(grid <= steps, grid, 2 * steps - grid)
    dt = 1.0 / traffic["keyframe_hz"]
    packets = []
    for a, i, g in zip(agent, i_round, view):
        p_odo, r_odo, pts_odo, shared = view_packets[a][g]
        rz, tz = rot_z(drift_yaw[a] * i), drift_t[a] * i
        packets.append(KeyframePacket(
            client_id=int(a), timestamp=float(i) * dt, r_cb=R_CB, p_bc=np.zeros(3, np.float32),
            p_wb=(rz @ p_odo + tz).astype(np.float32), q_wb=quat_wxyz(rz @ r_odo).astype(np.float32),
            win_pts3d=(pts_odo @ rz.T + tz).astype(np.float32), **shared))
    return Session(packets=packets, agent=agent, view=view, r_wc=r_wc, t_wc=t_wc, k=k,
                   yaw_off=yaw_off, t_off=t_off, local=i_round, drift_yaw=drift_yaw,
                   drift_t=drift_t)

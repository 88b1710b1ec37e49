"""What decides `correct`: the program's answers from the window against the
plain references of `benchmark/reference/`, each number beside its limit.

- Pose graph: every loop edge against the exact geometry of the generator;
  the loops accepted in the window against the keyframes to which the
  geometry gives a loop; the share of loops that PCM keeps; and the world
  poses after the server's final solve against the reference's minimum of
  the same graph (the same keyframes, the odometry's sequential edges and
  the kept loops at their true values), in the gauge of the solve's anchor
  (`reference/posegraph.py`).
- Dense depth: the reference cycles sampled in the window. The reference
  follows the program from its own state where it has to: the filter at
  the cycle's start (which it could only work out by following every
  earlier cycle) and the server's world estimates of the reference and of
  each measurement as they were fused (an asynchronous solve moves them at
  times the reference cannot follow; the final poses are judged above). It
  works out the reference image's maps and landmark bias
  itself and checks them against the program's, forms each frame's
  matrices and warp choice, fuses the cycle, publishes the depth map and
  compares it with the program's; then propagates its own filter to the
  next reference and compares that with the program's next start
  (`reference/dense.py`).
- Map: a copy of the TSDF voxels taken before the window, into which the
  reference integrates every depth map the program published in the window
  (the program's maps, judged above on the sample) at the pose the server
  published it with, with its own reference images, then compares every
  voxel the window touched (`reference/tsdf.py`). The published pose is
  held to the reference's final pose of that keyframe (`map_pose_err`), as
  near as the solves after the map allow.

With `control`, the program's answers are replaced by the reference's own
in the next lower precision (the cost volume in fp8 instead of bf16, the
poses and voxels in bf16 instead of fp32): that run has to come out not
correct.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .reference import dense as rd
from .reference import posegraph as rp
from .reference import tsdf as rt

R_CB = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])  # the generator's body -> camera

# each number's limit (at most / at least), set between the largest reading of sound runs
# and the smallest of the control: PERF.md section 2 gives both readings
LIMITS = {
    "clients_aligned": ("min", 1.0),
    "loop_share": ("min", 0.5),
    "loop_kept_share": ("min", 0.75),
    "loop_t_err_m": ("max", 1e-5),
    "loop_yaw_err_rad": ("max", 3e-6),
    "pose_p_err_m": ("max", 3e-5),
    "pose_yaw_err_rad": ("max", 3e-5),
    "maps_in_window": ("min", 1),
    "dense_cycles_checked": ("min", 1),
    "dense_start_err": ("max", 1e-3),
    "dense_depth_mismatch": ("max", 5e-3),
    "dense_propagate_mismatch": ("max", 1e-2),
    "map_pose_err": ("max", 2.5e-3),
    "tsdf_voxel_mismatch": ("max", 1e-2),
}


@dataclass
class Outputs:
    """What the program answered, taken after the window and the final solve."""
    n_keyframes: int
    loops_before: int
    window_start: int                # the store index of the window's first keyframe
    loop_i: np.ndarray
    loop_j: np.ndarray
    loop_t: np.ndarray
    loop_yaw: np.ndarray
    loop_valid: np.ndarray
    loop_pcm_ok: np.ndarray
    world_p: np.ndarray
    world_yaw: np.ndarray
    aligned: np.ndarray              # (agents,)
    published: list = field(default_factory=list)   # the window's depth records, in order
    cycles: list = field(default_factory=list)      # recorded dense cycles
    tsdf_before: tuple | None = None                # (sdf, weight, color, slot_of)
    tsdf_after: tuple | None = None


def _world(server, idx: int) -> tuple:
    """The server's 4-DoF world estimate of keyframe `idx` as it stands:
    (yaw, pitch, roll, position)."""
    st = server.graph.store
    return (float(st.world_yaw[idx]), float(st.world_pr[idx, 0]), float(st.world_pr[idx, 1]),
            st.world_p[idx].copy())


def _clone_start(ds) -> dict:
    st = ds.state
    return {"ref_img": st.ref_img.clone(), "grad": st.grad.clone(), "penalty": st.penalty.clone(),
            "bias": None if st.sparse_bias is None else st.sparse_bias.clone(),
            "filt": [t.clone() for t in st.filt]}


class CycleRecorder:
    """Follows one client's dense cycles between keyframes, outside the
    program's calls: from the first reference that starts after
    `after` window keyframes, it keeps the program's state at the cycle's
    start, the cycle's measurement keyframes with the server's world
    estimates of the reference and the measurement as each was fused, and
    the program's filter at the next start.

    The world estimates are read under the pose graph's lock after each
    keyframe. The server's solver thread may write new ones back while a
    keyframe is processed, before or after the dense step read them; the
    estimates the step used are then unknown. So where the reference's
    estimate moved since the keyframe before, the cycle is given up and
    the recorder waits for the client's next reference."""

    def __init__(self, client: int, after: int):
        self.client, self.after = client, after
        self.state = "wait"
        self.rec = {"client": client}
        self.given_up = 0
        self._ref_seen = None

    def observe(self, server, store_idx: int, window_count: int) -> None:
        if self.state == "done":
            return
        with server.graph._lock:
            ref_now = _world(server, self.rec["ref"]) if self.state == "fusing" else None
            mine = int(server.graph.store.client[store_idx]) == self.client
            here = _world(server, store_idx) if mine else None
        seen, self._ref_seen = self._ref_seen, ref_now
        ds = server.dense_state.get(self.client)
        if not mine or ds is None:
            return
        if self.state == "fusing" and not _same(ref_now, seen):
            self.given_up += 1
            self.state, self.after = "wait", window_count + 1
            self.rec = {"client": self.client}
            return
        if self.state == "wait":
            if window_count >= self.after and ds.ref_index == store_idx and ds.since_ref == 0:
                self.rec.update(ref=store_idx, meas=[], worlds=[], s0=_clone_start(ds))
                self.state = "fusing"
                with server.graph._lock:
                    self._ref_seen = _world(server, store_idx)
        elif self.state == "fusing":
            self.rec["meas"].append(store_idx)
            self.rec["worlds"].append((ref_now, here))
            if ds.ref_index == store_idx:
                self.rec["s1_filt"] = [t.clone() for t in ds.state.filt]
                self.state = "done"


def _same(a, b) -> bool:
    return b is not None and a[:3] == b[:3] and np.array_equal(a[3], b[3])


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = float(b.abs().max().clamp(min=1e-12))
    return float((a.float() - b.float()).abs().max()) / scale


def depth_mismatch(prog: torch.Tensor, ref: torch.Tensor, rel: float = 1e-3) -> float:
    """Share of pixels published by one side only, or published by both at
    depths more than `rel` apart."""
    pv, rv = prog > 0, ref > 0
    bad = (pv != rv) | (pv & rv & ((prog - ref).abs() > rel * ref))
    return float(bad.float().mean())


def filter_mismatch(prog: list, ref: rd.Filter, rel: float = 1e-4) -> float:
    bad = torch.zeros_like(ref.mu, dtype=torch.bool)
    for p, r in zip(prog, ref):
        bad |= (p - r).abs() > rel * r.abs().clamp(min=1e-6)
    return float(bad.float().mean())


class Judge:
    def __init__(self, session, config: dict, device):
        self.ses, self.config, self.dev = session, config, torch.device(device)
        self.cam = config["camera"]
        self.k = session.k.astype(np.float64)
        self.numbers: dict = {}
        self.map_work: dict = {}
        d = config["dense"]
        self.p = rd.dense_params(d)
        self.grid = rd.remap_grid(self.cam, d["height"], d["width"], self.dev)

    def image(self, store_idx: int) -> torch.Tensor:
        return rd.dense_image(self.ses.packets[store_idx].image, self.grid, self.dev)

    # ------------------------------------------------------------ pose graph

    def revisits(self, start: int, n: int) -> int:
        """Keyframes start..n-1 that the geometry gives a loop: some earlier
        keyframe sees at least `min_loop_matches` of the same landmarks and
        is another agent's, or its own agent's at least `min_gap` keyframes
        back."""
        s, cfg = self.ses, self.config["server"]
        n_views = int(s.view.max()) + 1
        key = s.agent[:n] * n_views + s.view[:n]
        ids = {}
        for idx in range(n):
            ids.setdefault(int(key[idx]), s.packets[idx].win_ids)
        seen = np.zeros((max(ids) + 1, 1 + max(int(v.max(initial=0)) for v in ids.values())),
                        np.int32)
        for k, v in ids.items():
            seen[k, v] = 1
        shared = (seen @ seen.T)[key[:n, None], key[None, start:n]]
        earlier = np.arange(n)[:, None] < np.arange(start, n)[None, :]
        near = (s.agent[:n, None] == s.agent[None, start:n]) & (
            s.local[None, start:n] - s.local[:n, None] < cfg["min_gap"])
        return int((earlier & ~near & (shared >= cfg["min_loop_matches"])).any(0).sum())

    def posegraph(self, out: Outputs, control: bool) -> None:
        """Loop edges against the geometry; accepted loops against the
        revisits the geometry gives; the world poses after the final solve
        against the reference's minimum of the same graph, compared in the
        gauge of the solve's anchor."""
        n, ses, cfg = out.n_keyframes, self.ses, self.config["server"]
        r_wb, p_wb = ses.truth_body(n)
        i, j = out.loop_i.astype(np.int64), out.loop_j.astype(np.int64)
        t_true, yaw_true = rp.loop_edges(r_wb, p_wb, i, j)
        t_prog, yaw_prog = out.loop_t.astype(np.float64), out.loop_yaw.astype(np.float64)
        if control:
            t_prog, yaw_prog = rp.round_to(t_true, "bfloat16"), rp.round_to(yaw_true, "bfloat16")
        used = out.loop_valid & out.loop_pcm_ok
        self.numbers["clients_aligned"] = float(out.aligned.mean())
        self.numbers["loop_share"] = (len(i) - out.loops_before) / max(
            1, self.revisits(out.window_start, n))
        kept = used[out.loops_before:]
        self.numbers["loop_kept_share"] = float(kept.mean()) if len(kept) else 0.0
        self.numbers["loop_t_err_m"] = float(np.linalg.norm(t_prog - t_true, axis=1).max()) if len(i) else 0.0
        self.numbers["loop_yaw_err_rad"] = float(np.abs(rp.wrap(yaw_prog - yaw_true)).max()) if len(i) else 0.0

        # the final solve's graph: keyframes from the oldest loop it uses on,
        # anchored at the world agent's first there (`CollaborativePoseGraph._solve`)
        self.solved = None
        if not used.any():
            self.numbers["pose_p_err_m"] = self.numbers["pose_yaw_err_rad"] = float("inf")
            return
        lo = int(i[used].min())
        agent = ses.agent[lo:n]
        anchor = int(np.nonzero(agent == ses.agent[0])[0][0])
        odo = np.stack([p.q_wb for p in ses.packets[lo:n]])
        ypr = rp.ypr_of(rp.quat_to_r(odo))
        p_odo = np.stack([p.p_wb for p in ses.packets[lo:n]]).astype(np.float64)
        e = int(used.sum())
        loops = rp.Edges(i[used] - lo, j[used] - lo, t_true[used], yaw_true[used],
                         np.full(e, cfg["loop_t_weight"]), np.full(e, cfg["loop_yaw_weight"]),
                         np.full(e, cfg["loop_huber"]))
        edges = rp.join(rp.sequential_edges(ypr, p_odo, agent, cfg["seq_back"]), loops)
        yaw0 = rp.yaw_of(r_wb[lo:n])
        ref_yaw, ref_p, _ = rp.optimize(yaw0, p_wb[lo:n], ypr[:, 1:], edges, anchor, self.dev)
        wyaw, wp = out.world_yaw[lo:n].astype(np.float64), out.world_p[lo:n].astype(np.float64)
        if control:
            wyaw, wp = rp.round_to(ref_yaw, "bfloat16"), rp.round_to(ref_p, "bfloat16")
        # the program's world, taken to the reference's by their anchors
        gauge = ((wyaw[anchor], wp[anchor]), (ref_yaw[anchor], ref_p[anchor]))
        self.solved = (lo, ref_yaw, ref_p, gauge)
        wyaw, wp = rp.to_gauge(wyaw, wp, *gauge)
        self.numbers["pose_p_err_m"] = float(np.linalg.norm(wp - ref_p, axis=1).max())
        self.numbers["pose_yaw_err_rad"] = float(np.abs(rp.wrap(wyaw - ref_yaw)).max())

    # ------------------------------------------------------------ dense

    def _cycle(self, rec: dict, prec: rd.Precision, s0_filt: list):
        """The reference's run of one recorded cycle from the program's start
        filter: (its start maps and bias, published depth, next filter)."""
        p, k = self.p, self.k.astype(np.float32)
        ses = self.ses
        ref = rec["ref"]
        img = self.image(ref)
        bias = rd.reference_bias(p, ses.packets[ref], k, self.dev)
        st = rd.start(p, prec, img, bias, rd.Filter(*s0_filt))

        def pose(idx, world):
            pkt = ses.packets[idx]
            return rd.camera_pose(world, pkt.r_cb, pkt.p_bc)

        last = (None, None, None)
        for m, (w_ref, w_m) in zip(rec["meas"], rec["worlds"]):
            rel = rd.relative(*pose(ref, w_ref), *pose(m, w_m))
            a, b = rd.frame_maps(k, *rel)
            dx, dy = rd.warp_shift_bounds_np(a, p.height, p.width, step=4)
            a_t, b_t = (torch.from_numpy(np.asarray(x, np.float32)).to(self.dev) for x in (a, b))
            meas = self.image(m)
            st = rd.fuse(p, prec, st, meas, a_t, b_t, bool(dx < 88.0 and dy < 40.0))
            last = (meas, a_t, b_t)
        depth = rd.published_depth(p, st, *last)
        kt = torch.from_numpy(k).to(self.dev)
        r_no, t_no = (torch.from_numpy(np.asarray(x, np.float32)).to(self.dev) for x in rel)
        filt = rd.propagate(st.filt, r_no, t_no, kt, torch.linalg.inv(kt))
        return (img, st.grad, st.penalty, bias), depth, filt

    def dense(self, out: Outputs, control: bool) -> None:
        volume = rd.Precision(self.config["dense"]["dtype"])
        lower = rd.Precision("float8_e5m2")
        by_ref = {r["ref_index"]: r for r in out.published}
        start_err, depth_bad, prop_bad, checked = 0.0, 0.0, 0.0, 0
        for rec in out.cycles:
            if "s1_filt" not in rec or rec["ref"] not in by_ref:
                continue
            starts, depth, filt = self._cycle(rec, volume, rec["s0"]["filt"])
            if control:
                c_starts, prog_depth, c_filt = self._cycle(rec, lower, rec["s0"]["filt"])
                prog_starts, prog_filt = c_starts[:3] + (lower.to(c_starts[3]),), list(c_filt)
            else:
                s0 = rec["s0"]
                prog_starts = (s0["ref_img"], s0["grad"], s0["penalty"], s0["bias"])
                prog_depth = torch.from_numpy(by_ref[rec["ref"]]["depth"]).to(self.dev)
                prog_filt = rec["s1_filt"]
            for mine, theirs in zip(starts, prog_starts):
                if (mine is None) != (theirs is None):
                    start_err = max(start_err, 1.0)
                elif mine is not None:
                    start_err = max(start_err, _rel_err(theirs, volume.to(mine)
                                                        if mine.ndim == 3 else mine))
            depth_bad = max(depth_bad, depth_mismatch(prog_depth, depth))
            prop_bad = max(prop_bad, filter_mismatch(prog_filt, filt))
            checked += 1
        self.numbers["maps_in_window"] = float(len(out.published))
        self.numbers["dense_cycles_checked"] = float(checked)
        self.numbers["dense_start_err"] = start_err
        self.numbers["dense_depth_mismatch"] = depth_bad
        self.numbers["dense_propagate_mismatch"] = prop_bad

    # ------------------------------------------------------------ map

    def tsdf(self, out: Outputs, control: bool) -> None:
        p = rt.tsdf_params(self.config["tsdf"])
        sdf, weight, color, slot_of = out.tsdf_before
        vol = rt.Volume(p, sdf.clone(), weight.clone(), color.clone(), slot_of)
        kf32 = self.k.astype(np.float32)
        pose_err = 0.0 if self.solved is not None else float("inf")
        for rec in out.published:
            depth = torch.from_numpy(rec["depth"]).to(self.dev)
            img = self.image(rec["ref_index"])
            if self.solved is not None:
                lo, ref_yaw, ref_p, gauge = self.solved
                w = rec["ref_index"] - lo
                if control:
                    yaw, pos = rp.round_to(ref_yaw[w], "bfloat16"), rp.round_to(ref_p[w], "bfloat16")
                else:
                    yaw, pos = rp.to_gauge(rp.yaw_of(rec["r_wc"].astype(np.float64) @ R_CB),
                                           rec["t_wc"].astype(np.float64), *gauge)
                pose_err = max(pose_err, float(np.linalg.norm(pos - ref_p[w])),
                               float(np.abs(rp.wrap(yaw - ref_yaw[w]))))
            self.map_work[rec["ref_index"]] = vol.integrate(
                depth, img[..., None].expand(-1, -1, 3), kf32, rec["r_wc"], rec["t_wc"])
        self.numbers["map_pose_err"] = pose_err
        if control:
            prog = rt.Volume(p, sdf.clone(), weight.clone(), color.clone(), slot_of)
            for rec in out.published:
                depth = torch.from_numpy(rec["depth"]).to(self.dev)
                img = self.image(rec["ref_index"])
                prog.integrate(depth, img[..., None].expand(-1, -1, 3), kf32, rec["r_wc"],
                               rec["t_wc"], round_to=torch.bfloat16)
            p_sdf, p_w, p_c, p_slot = prog.sdf, prog.weight, prog.color, prog.row_of
        else:
            p_sdf, p_w, p_c, p_slot = out.tsdf_after
        keys = sorted(vol.touched | (set(p_slot) - set(slot_of)))
        s = p.chunk_size
        z = torch.zeros((1, s, s, s), device=self.dev)
        zc = torch.zeros((1, s, s, s, 3), device=self.dev)

        def gather(tsdf, tw, tc, rows, key_list):
            idx = [rows.get(c) for c in key_list]
            take = torch.tensor([-1 if r is None else r for r in idx], device=self.dev)
            ok = (take >= 0)[:, None, None, None]
            t = take.clamp(min=0)
            return (torch.where(ok, tsdf.to(self.dev)[t], z), torch.where(ok, tw.to(self.dev)[t], z),
                    torch.where(ok[..., None], tc.to(self.dev)[t], zc))

        if not keys:
            self.numbers["tsdf_voxel_mismatch"] = 0.0
            return
        a = gather(p_sdf, p_w, p_c, p_slot, keys)
        b = gather(vol.sdf, vol.weight, vol.color, vol.row_of, keys)
        seen = (a[1] > 0) | (b[1] > 0)
        bad = (((a[0] - b[0]).abs() > 1e-3) | ((a[1] - b[1]).abs() > 1e-3)
               | ((a[2] - b[2]).abs() > 0.05).any(-1)) & seen
        self.numbers["tsdf_voxel_mismatch"] = float(bad.sum()) / max(float(seen.sum()), 1.0)

    def verdict(self) -> tuple[bool, dict]:
        """(correct, {number: {value, limit, bound}}) over the numbers taken."""
        out, ok = {}, True
        for name, value in self.numbers.items():
            bound, limit = LIMITS[name]
            good = value <= limit if bound == "max" else value >= limit
            ok &= bool(good) and bool(np.isfinite(value))
            out[name] = {"value": value, "limit": limit, "bound": bound}
        return ok, out

"""Both `AgentFrontend`s on `chip_smoke.py` phase 8's full-size frames, in
lockstep, through every packet, on the CPU.

`tests/test_torch_frontend.py` holds the port's front-end to the JAX
package's in lockstep at 320x240 and only up to the first packet. This
probe runs the same harness at phase 8's size: 752x480 EuRoC radtan frames
at 20 Hz with 200 Hz IMU (`chip_smoke.agent_sequences(agent_config(),
seed=...)`), every frame through `process_frame`, to the end of each
agent's sequence. Each frame the port starts from the JAX front-end's state
(the test's `_start_from`, plus the camera-rate tracker's state: the IMU
buffer, the last keyframe's time, pose, features and rays, the propagated
pose), and the port's `_gumbel` is fed the JAX front-end's RANSAC draws
(the test's `_Recorder`); the JAX DLT takes the port's eigenvector sign.

Per frame it compares the tracks; per keyframe it prints one JSON line:
the share of the JAX front-end's tracks the port also tracks and their
largest position difference, the largest |dp| and |dq| over the window's
keyframes, the packet's |dp_wb| and |dq_wb|, the common landmarks and the
share of equal descriptor bits, and which of the test's tolerances the
frame exceeds. The last line sums the run: frames, keyframes, packets,
the worst of each figure, the frames beyond a tolerance and the seconds.

    python3 dev/torch_probe_frontend_lockstep.py [--seeds 3 1] [--agents 0 1] [--frames N]
        [--jax-zero-safe-norm]

With `--jax-zero-safe-norm` the JAX window solve's per-landmark residual
gets a norm whose derivative at a zero residual is finite (see
`zero_safe_residual`): the run that tells whether that one op explains the
departures found without it.

About 25 minutes a seed and agent on 4 CPU cores (the JAX front-end
compiles its shapes first).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import test_torch_frontend as tf  # noqa: E402

# the camera-rate tracker's state, carried across with the window's
CAMERA_RATE_STATE = ("_kf_t", "_kf_feat_xy", "_kf_norm")


def start_from(fe_t, fe_j) -> None:
    """The test's lockstep start, plus `process_frame`'s own state."""
    tf._start_from(fe_t, fe_j)
    for name in CAMERA_RATE_STATE:
        v = getattr(fe_j, name)
        setattr(fe_t, name, {k: np.array(x, copy=True) for k, x in v.items()}
                if isinstance(v, dict) else v)
    fe_t._imu_buf = [tuple(np.array(x, copy=True) for x in row) for row in fe_j._imu_buf]
    fe_t._kf_state = (None if fe_j._kf_state is None
                      else tuple(np.array(x, np.float32, copy=True) for x in fe_j._kf_state))
    prop = getattr(fe_j, "_prop_pose", None)
    fe_t._prop_pose = None if prop is None else tuple(np.array(x, np.float32) for x in prop)


def zero_safe_residual():
    """`cvids_tpu.vio.window_ba._proj_residual_one_lm` with a residual norm
    whose derivative at a zero residual is 0 instead of NaN (the same values
    everywhere). `jnp.linalg.norm`'s derivative at 0 is 0/0, and the JAX
    window solve takes its Jacobians by `jacfwd`: one landmark that
    reprojects exactly onto its observation makes the reduced system NaN,
    and the solve rejects every later LM step (the port's closed-form
    Jacobians stay finite there). Installed by `--jax-zero-safe-norm`."""
    import jax
    import jax.numpy as jnp

    from cvids_tpu.geometry import quat_inverse, quat_to_matrix

    def residual(p, q, kf_valid, lm_valid_one, r_cb, p_bc, pix_weight, huber_delta, lm_pt, obs,
                 vis):
        r_bw = jax.vmap(lambda qq: quat_to_matrix(quat_inverse(qq)))(q)
        pts_b = jnp.einsum("kij,kj->ki", r_bw, lm_pt[None] - p)
        pts_c = jnp.einsum("ij,kj->ki", r_cb, pts_b - p_bc[None])
        z = pts_c[:, 2]
        safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
        proj = pts_c[:, :2] / safe_z[:, None]
        valid = vis & (z > 0.05) & kf_valid & lm_valid_one
        r = (proj - jnp.nan_to_num(obs)) * pix_weight
        sq = jnp.sum(r * r, axis=-1, keepdims=True)
        rn = jnp.where(sq > 0, jnp.sqrt(jnp.where(sq > 0, sq, 1.0)), 0.0)
        w = jnp.sqrt(jnp.minimum(1.0, huber_delta / jnp.maximum(rn, 1e-9)))
        return jnp.where(valid[:, None], r * w, 0.0).reshape(-1)
    return residual


def jax_config(cfg_t):
    from cvids_tpu.utils.config import AgentConfig, CameraConfig
    from cvids_tpu.vio.imu import ImuNoise
    from cvids_tpu_torch import interop

    d = interop.agent_config_to_dict(cfg_t)
    cam_d, imu_d = d.pop("camera"), d.pop("imu")
    return AgentConfig(camera=CameraConfig(**cam_d), imu=ImuNoise(**imu_d), **d)


def run_agent(seq, cfg_t, cid, n_frames, seed) -> dict:
    from cvids_tpu.ops import ransac as jransac
    from cvids_tpu.vio.frontend import AgentFrontend as JFrontend
    from cvids_tpu_torch.vio.frontend import AgentFrontend as TFrontend

    fe_j = JFrontend(jax_config(cfg_t), client_id=cid)
    fe_t = TFrontend(cfg_t, client_id=cid, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(jransac, "_dlt_pose", tf._dlt_pose_port_sign)
    rec = tf._Recorder(mp)
    queue, missed = [], [0]

    def replay(n):
        if not queue or queue[0][0] != n:
            missed[0] += 1
            return fe_t.__class__._gumbel(fe_t, n)
        return queue.pop(0)[1]

    fe_t._gumbel = replay
    worst = {"track_share": 1.0, "feat_px": 0.0, "win_p": 0.0, "win_q": 0.0, "pkt_p": 0.0,
             "pkt_q": 0.0, "lm_share": 1.0, "desc_bits": 1.0, "pts_m": 0.0}
    beyond, rows, t0 = {}, [], time.perf_counter()
    n_kf = n_pk = kf_differs = pk_differs = ransac_differs = 0
    prev_t = None
    for fi in range(min(n_frames, len(seq["cam_t"]))):
        t = seq["cam_t"][fi]
        if prev_t is None:
            sel = (seq["imu_t"] >= t - 0.1) & (seq["imu_t"] < t)
            imu = (np.zeros((0, 3)), seq["acc"][sel], np.zeros(0))
        else:
            sel = (seq["imu_t"] >= prev_t) & (seq["imu_t"] < t)
            imu = (seq["gyr"][sel], seq["acc"][sel], np.diff(np.append(seq["imu_t"][sel], t)))
        prev_t = t
        if fi > 0:
            start_from(fe_t, fe_j)
        old_id, kf0 = fe_j.next_id, fe_j.kf_count
        pkt_j = fe_j.process_frame(t, seq["images"][fi], *imu)
        queue.extend(rec.noise())
        pkt_t = fe_t.process_frame(t, seq["images"][fi], *imu)
        ransac_differs += len(queue) > 0 or missed[0] > 0
        queue.clear()
        missed[0] = 0
        tracked = [{int(f): xy for f, xy, v in zip(fe.feat_id, fe.feat_xy, fe.feat_valid)
                    if v and f < old_id} for fe in (fe_t, fe_j)]
        common = sorted(set(tracked[0]) & set(tracked[1]))
        share = len(common) / len(tracked[1]) if tracked[1] else 1.0
        feat_px = (float(np.abs(np.asarray([tracked[0][f] for f in common])
                                - np.asarray([tracked[1][f] for f in common])).max())
                   if common else 0.0)
        row = {"frame": fi, "track_share": share, "feat_px": feat_px}
        is_kf_j, is_kf_t = fe_j.kf_count > kf0, fe_t.kf_count > kf0
        kf_differs += is_kf_j != is_kf_t
        pk_differs += (pkt_j is None) != (pkt_t is None)
        if is_kf_j:
            n_kf += 1
            kf = np.asarray(fe_j.state.kf_valid)
            row.update(keyframe=fe_j.kf_count, vi=bool(fe_j.vi_initialized),
                       win_p=float(np.abs(fe_t.state.p.numpy()[kf]
                                          - np.asarray(fe_j.state.p)[kf]).max(initial=0.0)),
                       win_q=float(np.abs(fe_t.state.q.numpy()[kf]
                                          - np.asarray(fe_j.state.q)[kf]).max(initial=0.0)))
            if not fe_j.vi_initialized:     # the visual scale is free: compare the shape
                unit = lambda p: p / max(np.linalg.norm(p), 1e-9)     # noqa: E731
                row["win_p"] = float(np.abs(unit(fe_t.state.p.numpy()[kf])
                                            - unit(np.asarray(fe_j.state.p)[kf])).max(initial=0.0))
        if pkt_j is not None and pkt_t is not None:
            n_pk += 1
            c, it, ij = np.intersect1d(pkt_t.win_ids, pkt_j.win_ids, return_indices=True)
            bits = np.unpackbits((pkt_t.win_desc[it] ^ pkt_j.win_desc[ij]).view(np.uint8))
            row.update(pkt_p=float(np.abs(pkt_t.p_wb - pkt_j.p_wb).max()),
                       pkt_q=float(np.abs(pkt_t.q_wb - pkt_j.q_wb).max()),
                       p_wb=[round(float(x), 5) for x in pkt_j.p_wb],
                       q_wb=[round(float(x), 5) for x in pkt_j.q_wb],
                       lm_common=int(len(c)), lm_jax=int(len(pkt_j.win_ids)),
                       lm_share=len(c) / max(len(pkt_j.win_ids), 1),
                       desc_bits=1.0 - float(bits.mean()) if len(bits) else 1.0,
                       pts_m=float(np.abs(pkt_t.win_pts3d[it] - pkt_j.win_pts3d[ij]).max(initial=0.0)))
        over = [k for k, tol in (("track_share", tf.ID_AGREE), ("lm_share", tf.ID_AGREE),
                                 ("desc_bits", tf.DESC_AGREE)) if k in row and row[k] < tol]
        over += [k for k, tol in (("feat_px", tf.FEAT_TOL),
                                  ("win_p", tf.WIN_TOL if row.get("vi") else tf.SHAPE_TOL),
                                  ("win_q", tf.ROT_TOL), ("pkt_p", tf.POSE_TOL),
                                  ("pkt_q", tf.POSE_TOL), ("pts_m", tf.PTS_TOL))
                 if k in row and row[k] > tol]
        for k in over:
            beyond.setdefault(k, []).append(fi)
        for k in worst:
            if k in row:
                worst[k] = (min if k in ("track_share", "lm_share", "desc_bits") else max)(
                    worst[k], row[k])
        if is_kf_j or over:
            row.update(agent=cid, seed=seed, beyond=over)
            print(json.dumps(row), flush=True)
        rows.append(row)
    return {"seed": seed, "agent": cid, "frames": len(rows), "keyframes": n_kf, "packets": n_pk,
            "keyframe_decisions_differ": kf_differs, "packet_presence_differs": pk_differs,
            "frames_with_other_ransac_calls": ransac_differs, "worst": worst,
            "frames_beyond_tolerance": beyond, "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[3])
    ap.add_argument("--agents", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--frames", type=int, default=10 ** 6)
    ap.add_argument("--workers", type=int, default=4, help="render processes")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--jax-zero-safe-norm", action="store_true",
                    help="give the JAX window solve a residual norm with a finite derivative "
                         "at 0 (`zero_safe_residual`)")
    args = ap.parse_args()
    if args.jax_zero_safe_norm:
        from cvids_tpu.vio import window_ba as jba
        jba._proj_residual_one_lm = zero_safe_residual()
    torch.set_num_threads(args.threads)
    cfg_t = cs.agent_config()
    t_all = time.perf_counter()
    for seed in args.seeds:
        t0 = time.perf_counter()
        seqs = cs.agent_sequences(cfg_t, seed=seed, workers=args.workers)
        print(json.dumps({"seed": seed, "rendered_s": time.perf_counter() - t0,
                          "frames": [len(s["cam_t"]) for s in seqs]}), flush=True)
        for cid in args.agents:
            print(json.dumps({"summary": run_agent(seqs[cid], cfg_t, cid, args.frames, seed)}),
                  flush=True)
    print(json.dumps({"probe_seconds": time.perf_counter() - t_all}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""test_fisheye_e2e.py on the port: an equidistant (Kannala-Brandt) two-agent
rig through `AgentFrontend`, end to end.

The reference test's camera, trajectories, seeds and bounds: two agents'
EuRoC-format sequences written by the port's `euroc_synth` (a mild
equidistant fisheye, 320x240, 10 Hz frames, 200 Hz IMU) and read back with
`load_euroc`/`load_agent_config`; each agent's frames through the port's
`AgentFrontend` (the camera model survives the sensor.yaml round trip and
the factory builds an `EquidistantCamera`, whose lift the front-end uses);
the packets through `CollaborativePoseGraph` with a generic vocabulary.
Bounds: >= 6 packets an agent, >= 1 loop, both clients aligned, ATE sim3 <
15 cm an agent. `run_fisheye_rig` also drives `chip_smoke.py`'s fisheye
phase on the card.
"""

import numpy as np
import pytest


def fisheye_config():
    from cvids_tpu_torch.utils.config import AgentConfig, CameraConfig

    cam = CameraConfig(fx=150.0, fy=150.0, cx=160.0, cy=120.0, k1=-0.01, k2=0.02,
                       p1=-0.005, p2=0.001, width=320, height=240, model="equidistant")
    return AgentConfig(camera=cam, fast_threshold=12.0, min_feature_dist=16, keyframe_freq=2.5)


def run_fisheye_rig(root, device="cpu", tracer=None):
    """Write, read and run the reference test's rig on `device`; returns
    (front-ends, sequences, packets per agent, the pose graph)."""
    from cvids_tpu_torch.io import euroc, euroc_synth, synthetic
    from cvids_tpu_torch.server import posegraph, vocab
    from cvids_tpu_torch.vio.frontend import AgentFrontend

    cfg = fisheye_config()
    roots = []
    for cid, phase in enumerate((0.0, 0.45)):
        path = f"{root}/agent{cid}"
        traj = synthetic.Trajectory.circle(radius=4.0, omega=0.35, height_amp=0.2, phase=phase,
                                           speed_mod=0.3, speed_mod_freq=0.9)
        euroc_synth.write_euroc_sequence(path, cfg=cfg, trajectory=traj, duration=7.0,
                                         cam_rate=10.0, imu_rate=200.0, num_landmarks=1000,
                                         seed=31 + cid, world_seed=77)
        roots.append(path)
    seqs = [euroc.load_euroc(r) for r in roots]
    cfgs = [euroc.load_agent_config(r) for r in roots]
    assert cfgs[0].camera.model == "equidistant"
    fes = [AgentFrontend(c, cid, device=device, tracer=tracer) for cid, c in enumerate(cfgs)]
    assert type(fes[0].cam).__name__ == "EquidistantCamera"
    packets = [[] for _ in seqs]
    for cid, (seq, fe) in enumerate(zip(seqs, fes)):
        prev_t = None
        for fi in range(len(seq.cam_t)):
            t = seq.cam_t[fi]
            img = seq.load_image(fi)
            if prev_t is None:
                sel = (seq.imu_t >= t - 0.1) & (seq.imu_t < t)
                pkt = fe.process_frame(t, img, np.zeros((0, 3)), seq.acc[sel], np.zeros(0))
            else:
                sel = (seq.imu_t >= prev_t) & (seq.imu_t < t)
                dts = np.diff(np.append(seq.imu_t[sel], t))
                pkt = fe.process_frame(t, img, seq.gyr[sel], seq.acc[sel], dts)
            prev_t = t
            if pkt is not None:
                packets[cid].append(pkt)
    voc = vocab.generic_vocabulary(k=8, levels=3, device=device)
    fx = float(cfgs[0].camera.fx)
    server = posegraph.CollaborativePoseGraph(
        voc, posegraph.ServerConfig(kf_capacity=128, optimize_every=20, pnp_thresh=10.0 / fx),
        device=device)
    for p in sorted([p for pk in packets for p in pk], key=lambda p: p.timestamp):
        server.add_keyframe(p)
    server.optimize()
    return fes, seqs, packets, server


def fisheye_ate_cm(server, seqs) -> list[float]:
    from cvids_tpu_torch.utils.metrics import ate_rmse

    out = []
    for cid, seq in enumerate(seqs):
        tr = server.trajectory(cid)
        gt_p = np.stack([np.interp(tr[:, 0], seq.gt_t, seq.gt_p[:, k]) for k in range(3)], -1)
        out.append(ate_rmse(tr[:, 1:4], gt_p, "sim3") * 100)
    return out


@pytest.mark.slow
def test_fisheye_equidistant_two_agent_e2e(tmp_path):
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        _, seqs, packets, server = run_fisheye_rig(str(tmp_path))
    finally:
        torch.set_num_threads(n)
    try:
        assert all(len(p) >= 6 for p in packets), [len(p) for p in packets]
        assert server.loop_count >= 1, "no loop closures on the fisheye rig"
        assert server.clients[0].aligned and server.clients[1].aligned
        ates = fisheye_ate_cm(server, seqs)
        assert all(a < 15.0 for a in ates), f"fisheye ATE {ates} cm"
    finally:
        server.close()

"""The port's programs (`cvids_tpu_torch/apps`) at a tiny size on the CPU
(`--device cpu`): `run_synthetic` with its TUM, viewer and plot outputs,
`run_euroc` on two sequences written by the port's EuRoC writer, and
`agent_process` publishing to a socket server, whose saved record equals
what arrived. The card is their default (`test_torch_ops.py`'s
`test_default_device_is_the_card`); `chip_smoke.py` phase 10 runs them there
at their own sizes.
"""

import json

import numpy as np
import pytest

from cvids_tpu.io import tum as jtum
from cvids_tpu_torch.apps import agent_process, run_euroc, run_synthetic
from cvids_tpu_torch.io import euroc_synth, synthetic, transport
from cvids_tpu_torch.server import vocab
from cvids_tpu_torch.utils.config import AgentConfig, CameraConfig


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Two agents' 0.15 s sequences (4 frames) at 160x120 in
    test_full_topology.py's room, and a small tree vocabulary in the DBoW2
    binary format. (On the CPU a front-end's KLT call takes ~1 s.)"""
    base = tmp_path_factory.mktemp("apps")
    cam = CameraConfig(fx=115.25, fy=114.9, cx=80.5, cy=60.25, k1=-0.28, k2=0.07, p1=0.0001,
                       p2=-0.0002, width=160, height=120)
    cfg = AgentConfig(camera=cam, fast_threshold=12.0, min_feature_dist=16, equalize=True,
                      keyframe_freq=2.5)
    out = []
    for cid, phase in enumerate((0.0, 0.45)):
        traj = synthetic.Trajectory.circle(radius=1.5, omega=0.5, height_amp=0.15, phase=phase,
                                           center=(0.0, 0.0, 1.3), speed_mod=0.3,
                                           speed_mod_freq=0.9)
        out.append(euroc_synth.write_euroc_sequence(
            str(base / f"agent{cid}"), cfg=cfg, trajectory=traj, duration=0.15, cam_rate=20.0,
            imu_rate=200.0, num_landmarks=300, seed=21 + cid, world_seed=7,
            scene=dict(floor_z=0.0, wall_y=3.0, box_lo=np.array([1.9, 0.6, 0.0]),
                       box_hi=np.array([2.9, 1.6, 0.9])), gyr_noise=2e-4, acc_noise=0.005))
    voc = str(base / "tree.bin")
    vocab.save_dbow_binary(voc, vocab.synthesize_tree_vocabulary(k=4, levels=2))
    return out, voc


def test_run_synthetic(tmp_path, capsys):
    prefix = str(tmp_path / "pose")
    rc = run_synthetic.main(["--device", "cpu", "--agents", "2", "--duration", "8",
                             "--landmarks", "150", "--tum-prefix", prefix,
                             "--viewer", str(tmp_path / "v.html"),
                             "--plot", str(tmp_path / "traj.png")])
    assert rc == 0
    out = capsys.readouterr().out
    ates = [float(line.split("ATE")[1].split()[0]) for line in out.splitlines() if "ATE" in line]
    assert len(ates) == 2 and max(ates) < 5.0, out
    assert "aligned: [True, True]" in out
    for cid in (0, 1):
        rows = jtum.read_tum(f"{prefix}{cid}.txt")
        assert rows.shape[1] == 8 and len(rows) >= 8
    html = (tmp_path / "v.html").read_text()
    state = json.loads(html.split("let STATE=", 1)[1].split("; const LIVE=", 1)[0])
    assert len(state["agents"]) == 2
    assert (tmp_path / "traj.png").stat().st_size > 1000


def test_run_euroc(roots, tmp_path, capsys):
    (r0, r1), voc = roots
    prefix = str(tmp_path / "pose")
    assert run_euroc.main(["--seq", r0, "--seq", r1, "--device", "cpu", "--vocab", voc,
                           "--kf-stride", "2", "--tum-prefix", prefix]) == 0
    out = capsys.readouterr().out
    assert "agent 0: 0 keyframes (2 selected, 2 frames)" in out, out
    assert "agent 1:" in out and "background solves" in out, out
    assert run_euroc.main(["--seq", str(tmp_path / "absent"), "--device", "cpu"]) == 2


def test_agent_process_sends_what_it_saved(roots, tmp_path):
    """One agent in this process: every packet it published arrives, equal
    to the codec dict it saved, bit for bit."""
    (r0, _), _ = roots
    got = []
    srv = transport.CollaborativeSocketServer(got.append, match_tol=1e-3)
    try:
        rc = agent_process.main(["--seq", r0, "--client", "0", "--port", str(srv.port),
                                 "--out", str(tmp_path / "sent.npz"), "--device", "cpu"])
        assert rc == 0 and srv.drain(timeout=20.0)
    finally:
        srv.stop()
    sent, frame_ms, keyframe = agent_process.load_sent(str(tmp_path / "sent.npz"))
    assert len(frame_ms) == len(keyframe) == 4 and keyframe[0]
    assert len(sent) == len(got)
    from cvids_tpu_torch.io import codec

    for d, pkt in zip(sent, got):
        back = codec.encode_packet(pkt)
        assert sorted(back) == sorted(d)
        for k in d:
            assert back[k].dtype == d[k].dtype and np.array_equal(back[k], d[k]), k

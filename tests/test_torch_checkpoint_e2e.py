"""test_checkpoint_e2e.py on the port: a server checkpointed mid-mission,
restored in a fresh process, ends with the same final map.

The reference test's world (two drifting agents, packets without pixels),
server configuration, split and bounds, with the port's
`CollaborativePoseGraph` on the CPU: an uninterrupted run; a run that
ingests half the packets, saves (`utils.checkpoint.save_server`) and is
discarded; a spawned process that builds a fresh server, loads the file and
ingests the rest (its RANSAC noise generator starts afresh, as the JAX
package's key chain restarts at PRNGKey(0): neither package saves it). The
resumed run must reach the uninterrupted run's keyframe count, loop count
and alignment, with world positions and yaws within 1e-4.
"""

import multiprocessing as mp
import os

import numpy as np

from cvids_tpu_torch.io import multiagent
from cvids_tpu_torch.io.synthetic import Trajectory


def _world():
    """The reference test's deterministic 2-agent drifting world."""
    rng = np.random.default_rng(7)
    n_lm = 160
    landmarks = np.stack([rng.uniform(-10, 10, n_lm), rng.uniform(-10, 10, n_lm),
                          rng.uniform(0.2, 3, n_lm)], -1)
    descs = multiagent.landmark_descriptors(n_lm)
    agents = [
        multiagent.AgentSim(Trajectory.circle(radius=4.0, omega=0.5),
                            drift_yaw_rate=0.002, drift_t_rate=0.004),
        multiagent.AgentSim(Trajectory.circle(radius=4.0, omega=0.5, phase=0.8),
                            yaw_offset=0.6, t_offset=np.array([1.0, -2.0, 0.0]),
                            drift_yaw_rate=-0.001, drift_t_rate=0.003),
    ]
    packets, gt = multiagent.generate_packets(agents, landmarks, descs, duration=18.0,
                                              kf_rate=1.0, max_feats=60, seed=3)
    return packets, gt, descs


def _make_server(descs, device="cpu"):
    from cvids_tpu_torch.server import posegraph, vocab

    voc = vocab.train_vocabulary(descs, k=5, levels=2, seed=0, device=device)
    cfg = posegraph.ServerConfig(kf_capacity=128, max_win=64, max_ext=64, max_loops=64,
                                 optimize_every=10**9)
    return posegraph.CollaborativePoseGraph(voc, cfg, device=device)


def _finish(server, packets, start):
    for _, _, _, pkt in packets[start:]:
        server.add_keyframe(pkt)
    server.optimize()
    n = int(server.store.count)
    return dict(count=n, loop_count=int(server.loop_count),
                world_p=np.array(server.store.world_p[:n]),
                world_yaw=np.array(server.store.world_yaw[:n]),
                aligned=[bool(server.clients[c].aligned) for c in range(2)])


def _resume_child(ckpt_path, out_path, split, device="cpu"):
    import torch

    from cvids_tpu_torch.utils import checkpoint

    torch.set_num_threads(1)
    packets, _, descs = _world()
    server = _make_server(descs, device)
    checkpoint.load_server(ckpt_path, server)
    out = _finish(server, packets, split)
    server.close()
    np.savez(out_path, **{k: v for k, v in out.items() if k != "aligned"},
             aligned=np.asarray(out["aligned"]))
    os._exit(0)


def resume_in_fresh_process(ckpt_path, out_path, split, device="cpu") -> dict:
    """Run `_resume_child` in a spawned process; its final map."""
    p = mp.get_context("spawn").Process(target=_resume_child,
                                        args=(ckpt_path, out_path, split, device))
    p.start()
    p.join(timeout=600)
    assert p.exitcode == 0, p.exitcode
    return dict(np.load(out_path))


def assert_same_map(res: dict, ref: dict) -> None:
    assert int(res["count"]) == ref["count"]
    assert int(res["loop_count"]) == ref["loop_count"], (int(res["loop_count"]),
                                                         ref["loop_count"])
    assert list(res["aligned"]) == ref["aligned"]
    np.testing.assert_allclose(res["world_p"], ref["world_p"], atol=1e-4)
    np.testing.assert_allclose(np.unwrap(res["world_yaw"]), np.unwrap(ref["world_yaw"]),
                               atol=1e-4)
    assert np.isfinite(res["world_p"]).all()


def test_midrun_checkpoint_fresh_process_resume(tmp_path):
    from cvids_tpu_torch.utils import checkpoint

    packets, _, descs = _world()
    split = len(packets) // 2

    ref_server = _make_server(descs)
    ref = _finish(ref_server, packets, 0)
    ref_server.close()
    assert ref["loop_count"] >= 1 and all(ref["aligned"])

    server_a = _make_server(descs)
    for _, _, _, pkt in packets[:split]:
        server_a.add_keyframe(pkt)
    ckpt = str(tmp_path / "mid.npz")
    checkpoint.save_server(ckpt, server_a)
    server_a.close()
    del server_a

    res = resume_in_fresh_process(ckpt, str(tmp_path / "resumed.npz"), split)
    assert_same_map(res, ref)

"""The traffic generator: one session a seed, another for another seed, the
same sizes for every seed, and packets that are exact observations of the
generator's own geometry."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import generator
from benchmark.tests import tiny

HERE = Path(__file__).resolve().parents[1]


def session(cfg_name, traffic_name, seed, n=80):
    config = json.loads((HERE / "configs" / f"{cfg_name}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{traffic_name}.json").read_text())
    tiny.patch(config, traffic)
    return generator.make_session(config, traffic, seed, "cpu", n)


def packet_arrays(p):
    return [p.p_wb, p.q_wb, p.win_pts3d, p.win_uv, p.win_ids, p.win_desc, p.ext_uv, p.ext_desc,
            p.image]


@pytest.mark.parametrize("cfg", ["server4_rs640", "server4_euroc752"])
def test_same_seed_same_session(cfg):
    a = session(cfg, "dense_backlog", 2 ** 40 + 3)
    b = session(cfg, "dense_backlog", 2 ** 40 + 3)
    assert len(a.packets) == len(b.packets) == 80
    for pa, pb in zip(a.packets, b.packets):
        assert pa.client_id == pb.client_id and pa.timestamp == pb.timestamp
        for x, y in zip(packet_arrays(pa), packet_arrays(pb)):
            assert np.array_equal(x, y)


def test_another_seed_another_session_of_the_same_sizes():
    a = session("server4_rs640", "dense_backlog", 7)
    b = session("server4_rs640", "dense_backlog", 8)
    assert [p.client_id for p in a.packets] == [p.client_id for p in b.packets]
    assert all(p.image.shape == q.image.shape for p, q in zip(a.packets, b.packets))
    assert not np.array_equal(a.packets[0].win_desc, b.packets[0].win_desc)
    assert not np.array_equal(a.view, b.view) or not np.allclose(a.t_off, b.t_off)


def test_posegraph_traffic_sends_no_images():
    s = session("server4_rs640", "posegraph_backlog", 5)
    assert all(p.image is None for p in s.packets)


def test_packets_observe_the_true_geometry():
    """Each window feature is its landmark's exact normalized projection from
    the keyframe's true camera, and the odometry pose and points map to the
    true ones through the keyframe's drift and the agent's frame offset;
    the drift grows by the traffic's rates a keyframe."""
    s = session("server4_rs640", "dense_backlog", 11)
    for n in (0, 5, 37, 79):
        p = s.packets[n]
        a, v, k = s.agent[n], s.view[n], s.local[n]
        r_wc, t_wc = s.r_wc[a, v], s.t_wc[a, v]
        r_lw = generator.rot_z(-s.yaw_off[a])
        r_d, t_d = generator.rot_z(s.drift_yaw[a] * k), s.drift_t[a] * k
        pts_w = (p.win_pts3d.astype(np.float64) - t_d) @ r_d @ r_lw + s.t_off[a]
        pc = (pts_w - t_wc) @ r_wc
        assert np.allclose(pc[:, :2] / pc[:, 2:], p.win_uv, atol=2e-6)
        assert np.allclose(r_lw.T @ (r_d.T @ (p.p_wb - t_d)) + s.t_off[a], t_wc, atol=1e-5)
    drift = json.loads((HERE / "traffic" / "dense_backlog.json").read_text())["drift"]
    assert np.allclose(np.abs(s.drift_yaw), drift["yaw_rad_per_kf"])
    assert np.allclose(np.linalg.norm(s.drift_t, axis=1), drift["t_m_per_kf"])
    assert s.local[4 * 19 + 2] == 19 and s.agent[4 * 19 + 2] == 2


def test_oscillation_revisits_views():
    s = session("server4_rs640", "dense_backlog", 3, n=4 * 30)
    for a in range(4):
        views = s.view[s.agent == a]
        assert views.min() >= 0 and views.max() <= 12
        assert np.all(np.abs(np.diff(views)) == 1)

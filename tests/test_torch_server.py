"""The server slice as a whole: the two-agent stream of `test_server.py`
through `cvids_tpu`'s `CollaborativePoseGraph` and through the port's, on the
CPU, with the JAX key chain's Gumbel noise injected into the port's RANSAC,
on the dense-vocabulary path and on the tree-vocabulary path
(`TreeVocabulary` + `SparseBowDatabase`, the reference's DBoW2 scale); the
port's pipelined and background-solve modes on their own; its store growth
and trajectory export; its copies of the packet and stream generators
(`cvids_tpu_torch.io`) against `cvids_tpu.io`. (One file, so the JAX server
compiles once.)
"""

import jax
import numpy as np
import pytest
import torch

from cvids_tpu.io import multiagent as jma
from cvids_tpu.io.synthetic import Trajectory as JTrajectory
from cvids_tpu.server import posegraph as jpg
from cvids_tpu.server import vocab as jvoc
from cvids_tpu_torch import interop
from cvids_tpu_torch.io import multiagent
from cvids_tpu_torch.io.msgs import KeyframePacket
from cvids_tpu_torch.io.synthetic import Trajectory
from cvids_tpu_torch.server import posegraph as tpg
from cvids_tpu_torch.server.keyframe import KeyframeStore
from cvids_tpu_torch.server.vocab import BowDatabase, SparseBowDatabase


class JaxKeyChain:
    """The port's RANSAC noise, drawn as `cvids_tpu`'s server draws it: the
    server key starts at PRNGKey(0); each dispatched cascade splits
    (key_server, key) = split(key_server), then (key_f, key_p) = split(key);
    F-RANSAC draws gumbel(key_f, (128, n)), then PnP gumbel(key_p, (128, n)).
    The port asks for F's noise, then PnP's, once per dispatch."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)
        self.key_p = None

    def __call__(self, num_hyp, n):
        if self.key_p is None:
            self.key, key = jax.random.split(self.key)
            key_f, self.key_p = jax.random.split(key)
            g = jax.random.gumbel(key_f, (num_hyp, n))
        else:
            g, self.key_p = jax.random.gumbel(self.key_p, (num_hyp, n)), None
        return torch.from_numpy(np.array(g))


@pytest.fixture(scope="module")
def world():
    """`test_server.py`'s landmark shell and vocabulary."""
    rng = np.random.default_rng(1)
    n_lm = 300
    landmarks = np.stack([rng.uniform(-14, 14, n_lm), rng.uniform(-14, 14, n_lm),
                          rng.uniform(0.2, 4.0, n_lm)], -1)
    descs = multiagent.landmark_descriptors(n_lm)
    voc = jvoc.train_vocabulary(descs, k=8, levels=2, seed=0)
    return landmarks, descs, voc


def small_config(mod):
    """`test_server.small_config()` of either package."""
    return mod.ServerConfig(kf_capacity=256, max_win=64, max_ext=128, max_loops=256,
                            optimize_every=15, lm_iters=8, cg_iters=40,
                            min_loop_matches=12, pcm_min_edges=10)


def two_agents(ma=multiagent, traj=Trajectory):
    """`test_two_agent_alignment_and_ate`'s agents: client 1 with a frame
    offset and drift (of the port's generator, or of `ma` and `traj`)."""
    return [
        ma.AgentSim(traj.circle(radius=5.0, omega=0.45, center=(0.0, 0.0, 1.5))),
        ma.AgentSim(traj.circle(radius=5.0, omega=0.45, phase=1.5, center=(2.0, 1.0, 1.5)),
                    yaw_offset=0.4, t_offset=np.array([2.0, -1.0, 0.3]),
                    drift_yaw_rate=0.0005, drift_t_rate=0.002),
    ]


def both_streams(landmarks, descs, **kwargs):
    """The two-agent stream from `cvids_tpu.io` (for the JAX server) and
    from the port's copy (for the port's). Returns (jax packets, port
    packets, ground truth)."""
    packets_j, gt = jma.generate_packets(two_agents(jma, JTrajectory), landmarks, descs,
                                         **kwargs)
    packets_t, _ = multiagent.generate_packets(two_agents(), landmarks, descs, **kwargs)
    return packets_j, packets_t, gt


def ate(server, gt, cid):
    st = server.store
    sel = np.nonzero(st.client[:st.count] == cid)[0]
    errs = [np.linalg.norm(st.world_p[k] - gt[(cid, int(st.local_index[k]))][0]) for k in sel]
    return np.sqrt(np.mean(np.square(errs))), len(sel)


def loop_edges(server):
    return {(int(i), int(j)) for i, j in zip(server.loop_i[:server.loop_count],
                                             server.loop_j[:server.loop_count])}


def run_both(packets_j, packets_t, voc_j, voc_t):
    """Stream each package's packets through its server; returns (jax,
    port) after flush(final=False), with the accepted edge sets taken
    there."""
    servers = [jpg.CollaborativePoseGraph(voc_j, small_config(jpg)),
               tpg.CollaborativePoseGraph(voc_t, small_config(tpg), device="cpu",
                                          noise=JaxKeyChain())]
    for s, packets in zip(servers, (packets_j, packets_t)):
        for _, _, _, pkt in packets:
            s.add_keyframe(pkt)
        s.flush(final=False)
    return servers


def assert_same_run(sj, st, gt):
    """Same alignment, same accepted and PCM-kept loop edges; world poses
    after optimize() within the 4-DoF solver's parity tolerance (1e-3 m,
    1e-3 rad, `test_torch_optimizer.py`)."""
    assert [c.aligned for c in st.clients[:2]] == [c.aligned for c in sj.clients[:2]] == [True, True]
    assert loop_edges(st) == loop_edges(sj)
    assert st.loop_count > 5
    sj.optimize()
    st.optimize()
    k = sj.loop_count
    np.testing.assert_array_equal(st.loop_pcm_ok[:k], sj.loop_pcm_ok[:k])
    n = sj.store.count
    np.testing.assert_allclose(st.store.world_p[:n], sj.store.world_p[:n], atol=1e-3)
    dyaw = st.store.world_yaw[:n] - sj.store.world_yaw[:n]
    assert np.abs(np.arctan2(np.sin(dyaw), np.cos(dyaw))).max() < 1e-3
    assert ate(st, gt, 0)[0] < 0.05 and ate(st, gt, 1)[0] < 0.25


def test_two_agent_stream_matches_jax(world):
    landmarks, descs, voc = world
    packets_j, packets_t, gt = both_streams(landmarks, descs, duration=28.0, kf_rate=1.0,
                                            max_feats=60)
    voc_t = interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc), "cpu")
    sj, st = run_both(packets_j, packets_t, voc, voc_t)
    assert isinstance(st.db, BowDatabase)
    assert_same_run(sj, st, gt)


def test_two_agent_stream_matches_jax_tree_vocabulary(world):
    landmarks, descs, _ = world
    # k=10, levels=4 -> 10^4 words, trained as `test_server.py` trains it
    tree_j = jvoc.tree_from_trained(jvoc.train_vocabulary(descs, k=10, levels=4, seed=1))
    tree_t = interop.tree_vocabulary_to_torch(tree_j)
    packets_j, packets_t, gt = both_streams(landmarks, descs, duration=28.0, kf_rate=1.0,
                                            max_feats=60)
    sj, st = run_both(packets_j, packets_t, tree_j, tree_t)
    assert isinstance(st.db, SparseBowDatabase)
    assert_same_run(sj, st, gt)
    # the sparse stores hold the same words
    np.testing.assert_array_equal(st.db.ids.numpy(), np.asarray(sj.db.ids))


def test_pipelined_detection_matches_synchronous(world):
    """The port's two-stage ingest pipeline accepts exactly the loops that
    resolving both in-flight stages after every keyframe accepts."""
    landmarks, descs, voc = world
    agents = [
        multiagent.AgentSim(Trajectory.circle(radius=5.0, omega=0.5),
                            drift_yaw_rate=0.0005, drift_t_rate=0.002),
        multiagent.AgentSim(Trajectory.circle(radius=5.0, omega=0.5, phase=1.2),
                            yaw_offset=0.3, t_offset=np.array([1.0, -0.5, 0.1])),
    ]
    packets, _ = multiagent.generate_packets(agents, landmarks, descs, duration=24.0,
                                             kf_rate=1.0, max_feats=60)
    voc_t = interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc), "cpu")

    def run(sync: bool):
        server = tpg.CollaborativePoseGraph(voc_t, small_config(tpg), device="cpu")
        for _, _, _, pkt in packets:
            server.add_keyframe(pkt)
            if sync:
                server.flush(final=False)   # resolve both pipeline stages
        server.flush(final=False)
        aligned = [c.aligned for c in server.clients[:2]]
        server.close()
        return loop_edges(server), aligned

    edges_sync, aligned_sync = run(sync=True)
    edges_pipe, aligned_pipe = run(sync=False)
    assert aligned_sync == aligned_pipe == [True, True]
    assert len(edges_sync) > 5
    assert edges_sync == edges_pipe


def test_async_optimize_meets_ate(world):
    """Background solves on the worker thread; after flush() the ATE bounds
    of `test_server.py` hold and close() joins the thread."""
    landmarks, descs, voc = world
    packets, gt = multiagent.generate_packets(two_agents(), landmarks, descs,
                                              duration=28.0, kf_rate=1.0, max_feats=60)
    cfg = small_config(tpg)
    cfg.async_optimize = True
    cfg.optimize_period_s = 0.2
    server = tpg.CollaborativePoseGraph(
        interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc), "cpu"), cfg,
        device="cpu")
    try:
        for _, _, _, pkt in packets:
            server.add_keyframe(pkt)
        server.flush(final=True)
        assert server.clients[0].aligned and server.clients[1].aligned
        assert server.solve_count >= 1
        assert ate(server, gt, 0)[0] < 0.05
        assert ate(server, gt, 1)[0] < 0.25
    finally:
        server.close()
    assert server._opt_thread is None


def test_store_growth_and_trajectory(world):
    """Capacity tiers double instead of raising; the export is TUM rows with
    unit quaternions."""
    st = KeyframeStore(capacity=8, max_win=4, max_ext=4)
    pkt = KeyframePacket(
        client_id=0, timestamp=1.5, p_wb=np.array([1, 2, 3], np.float32),
        q_wb=np.array([1, 0, 0, 0], np.float32), r_cb=np.eye(3, dtype=np.float32),
        p_bc=np.zeros(3, np.float32), win_pts3d=np.ones((2, 3), np.float32),
        win_uv=np.ones((2, 2), np.float32), win_ids=np.arange(2, dtype=np.int64),
        win_desc=np.full((2, 8), 7, np.uint32), win_valid=np.ones(2, bool),
        ext_uv=np.ones((3, 2), np.float32), ext_desc=np.full((3, 8), 9, np.uint32),
        ext_valid=np.ones(3, bool), image=None)
    for k in range(20):
        st.add(pkt, k)
    assert st.capacity == 32 and st.count == 20
    assert st.timestamp[0] == 1.5 and (st.win_desc[0, :2] == 7).all()
    assert st.local_index[19] == 19 and (st.client[20:] == -1).all()

    landmarks, descs, voc = world
    packets, _ = multiagent.generate_packets(two_agents()[:1], landmarks, descs,
                                             duration=6.0, kf_rate=1.0, max_feats=60)
    tree = interop.tree_vocabulary_to_torch(jvoc.tree_from_trained(voc))
    server = tpg.CollaborativePoseGraph(tree, small_config(tpg), device="cpu")
    server.loop_i = server.loop_i[:2]
    for name in ("loop_j", "loop_t", "loop_yaw", "loop_inter", "loop_valid", "loop_pcm_ok"):
        setattr(server, name, getattr(server, name)[:2])
    for _, _, _, p in packets:
        server.add_keyframe(p)
    for k in range(3):                                     # past the loop capacity
        server._record_loop(0, 6, {"t_ij": np.zeros(3, np.float32),
                                   "q_bibj": np.array([1, 0, 0, 0], np.float32)}, False)
    assert server.loop_count == 3 and len(server.loop_i) == 4
    tr = server.trajectory(0)
    assert tr.shape == (len(packets), 8)
    np.testing.assert_allclose(np.linalg.norm(tr[:, 4:], axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("setup", ["two_agents", "noisy_modulated"])
def test_io_copies_match_jax(world, setup):
    """`cvids_tpu_torch.io` (the port's copy of the packet schema and the
    multi-agent generator) gives the same packets, bit for bit, and the same
    ground truth as `cvids_tpu.io`, with and without pixel noise."""
    landmarks, _, _ = world
    descs = multiagent.landmark_descriptors(len(landmarks), seed=7)
    np.testing.assert_array_equal(descs, jma.landmark_descriptors(len(landmarks), seed=7))
    if setup == "two_agents":
        agents_j, agents_t, kwargs = two_agents(jma, JTrajectory), two_agents(), {}
    else:
        def agents(ma, traj):
            return [ma.AgentSim(traj.circle(radius=6.0, omega=0.3, phase=0.3, speed_mod=0.5),
                                yaw_offset=-0.2, t_offset=np.array([0.5, 1.0, 0.0]),
                                drift_yaw_rate=0.001),
                    ma.AgentSim(traj.circle(radius=4.0, speed_mod=0.3))]
        agents_j, agents_t = agents(jma, JTrajectory), agents(multiagent, Trajectory)
        kwargs = {"pix_noise": 0.002, "seed": 5}
    pj, gt_j = jma.generate_packets(agents_j, landmarks, descs, duration=9.0, max_feats=50,
                                    **kwargs)
    pt, gt_t = multiagent.generate_packets(agents_t, landmarks, descs, duration=9.0,
                                           max_feats=50, **kwargs)
    assert len(pt) == len(pj) == 20
    for (tj, cj, kj, a), (tt, ct, kt, b) in zip(pj, pt):
        assert (tj, cj, kj) == (tt, ct, kt)
        assert isinstance(b, KeyframePacket)
        for name, va in vars(a).items():
            vb = getattr(b, name)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype, name
                np.testing.assert_array_equal(vb, va, err_msg=name)
            else:
                assert vb == va, name
    assert gt_t.keys() == gt_j.keys()
    for key, (p, q) in gt_j.items():
        np.testing.assert_array_equal(gt_t[key][0], p)
        np.testing.assert_array_equal(gt_t[key][1], q)

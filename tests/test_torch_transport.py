"""The port's cross-process transport against `cvids_tpu.io.transport`, on
the CPU.

test_transport.py's matching-and-drops and drain cases run on the port; the
JAX package's sender feeds the port's server and the port's sender the JAX
package's, and every packet arrives equal to what was sent, bit for bit.
The departure the port makes (a sink that raises stops the ingest, and
`drain` raises it at once instead of waiting out its timeout) is held
here. Two spawned processes stream fixed `multiagent` packets into a port
`CollaborativePoseGraph`; the whole front-end topology (test_full_topology.py
on the port) is a `slow` case, as the JAX one is.
"""

import multiprocessing as mp
import os
import time

import numpy as np
import pytest

from cvids_tpu_torch.io import codec, transport
from cvids_tpu_torch.io.msgs import KeyframePacket

N_LANDMARKS = 120


def _mini_packet(cid, t, with_image=True, seed=0, cls=KeyframePacket):
    """test_transport.py's packet, as either package's class."""
    rng = np.random.default_rng(seed + int(t * 1000) + cid)
    n = 4
    return cls(
        client_id=cid, timestamp=t,
        p_wb=rng.normal(size=3).astype(np.float32),
        q_wb=np.array([1, 0, 0, 0], np.float32),
        r_cb=np.eye(3, dtype=np.float32), p_bc=np.zeros(3, np.float32),
        win_pts3d=rng.normal(size=(n, 3)).astype(np.float32),
        win_uv=rng.normal(size=(n, 2)).astype(np.float32),
        win_ids=np.arange(n, dtype=np.int64),
        win_desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
        win_valid=np.ones(n, bool),
        ext_uv=rng.normal(size=(n, 2)).astype(np.float32),
        ext_desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
        ext_valid=np.ones(n, bool),
        image=(rng.uniform(0, 255, (8, 8)).astype(np.float32) if with_image else None))


def _same_wire(a, b) -> bool:
    """Two packets (of either package) carry the same codec dict."""
    da, db = codec.encode_packet(a), codec.encode_packet(b)
    return sorted(da) == sorted(db) and all(
        np.asarray(da[k]).dtype == np.asarray(db[k]).dtype
        and np.array_equal(np.asarray(da[k]), np.asarray(db[k])) for k in da)


def test_socket_matching_and_drops():
    got = []
    srv = transport.CollaborativeSocketServer(got.append, match_tol=1e-3)
    try:
        s0 = transport.AgentSocketSender("127.0.0.1", srv.port)
        s1 = transport.AgentSocketSender("127.0.0.1", srv.port)
        for i in range(5):
            s0.send_packet(_mini_packet(0, 1.0 + 0.5 * i))
            s1.send_packet(_mini_packet(1, 1.2 + 0.5 * i))
        # an orphan image (its AgentMsg "lost"): dropped once a newer msg
        # arrives, without blocking the queue
        s0.sock.sendall(transport._pack(transport._KIND_IMG, {
            "client_id": np.int64(0), "timestamp": np.float64(99.0),
            "image": np.zeros((4, 4), np.float32)}))
        # an orphan msg (image "lost"), then one more good pair
        s0.send_packet(_mini_packet(0, 100.0, with_image=False))
        s0.send_packet(_mini_packet(0, 101.0))
        s0.close()
        s1.close()
        assert srv.drain(timeout=20.0)
    finally:
        srv.stop()
    assert len(got) == 11, len(got)
    assert srv.packets_matched == 11
    assert srv.msgs_dropped >= 1
    assert srv.imgs_dropped >= 1
    by_client = {}
    for p in got:
        by_client.setdefault(p.client_id, []).append(p.timestamp)
    assert by_client[0] == sorted(by_client[0])
    assert len(by_client[1]) == 5
    match = [p for p in got if p.timestamp == 101.0][0]
    assert _same_wire(match, _mini_packet(0, 101.0))
    assert srv.max_queued >= 1


def test_drain_waits_for_first_connection():
    srv = transport.CollaborativeSocketServer(lambda p: None)
    try:
        assert not srv.drain(timeout=0.4)
        s = transport.AgentSocketSender("127.0.0.1", srv.port)
        s.send_packet(_mini_packet(0, 1.0))
        s.close()
        assert srv.drain(timeout=20.0)
        assert srv.packets_matched == 1
        assert not srv.drain(timeout=0.4, min_conns=2)
    finally:
        srv.stop()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wire_crosses_packages(direction):
    """One package's sender, the other's server: every packet arrives,
    decoded to the arrays that were sent, bit for bit."""
    from cvids_tpu.io import msgs as jmsgs
    from cvids_tpu.io import transport as jtransport

    send_mod, srv_mod, cls = ((jtransport, transport, jmsgs.KeyframePacket)
                              if direction == "jax_to_port"
                              else (transport, jtransport, KeyframePacket))
    got = []
    srv = srv_mod.CollaborativeSocketServer(got.append, match_tol=1e-3)
    sent = [_mini_packet(c, 1.0 + 0.5 * i + 0.1 * c, cls=cls) for i in range(4) for c in (0, 1)]
    try:
        s = send_mod.AgentSocketSender("127.0.0.1", srv.port)
        for p in sent:
            s.send_packet(p)
        s.close()
        assert srv.drain(timeout=20.0)
    finally:
        srv.stop()
    assert len(got) == len(sent) and srv.msgs_dropped == srv.imgs_dropped == 0
    key = lambda p: (p.client_id, p.timestamp)       # noqa: E731
    for a, b in zip(sorted(got, key=key), sorted(sent, key=key)):
        assert _same_wire(a, b)


def test_ingest_error_raises_at_once():
    """The departure from the JAX server: a sink that raises stops the
    ingest, and `drain` raises its error within a second instead of waiting
    out its 30 s timeout; `stop` then does not raise it again. A server
    whose `drain` was never called raises the error from `stop`."""
    def failing(pkt):
        if pkt.timestamp > 1.5:
            raise ValueError("sink failed on purpose")

    for call_drain in (True, False):
        srv = transport.CollaborativeSocketServer(failing, match_tol=1e-3)
        s = transport.AgentSocketSender("127.0.0.1", srv.port)
        for i in range(4):
            s.send_packet(_mini_packet(0, 1.0 + 0.5 * i))
        s.close()
        t0 = time.perf_counter()
        if call_drain:
            with pytest.raises(RuntimeError, match="sink failed on purpose") as err:
                srv.drain(timeout=30.0)
            assert time.perf_counter() - t0 < 1.0
            assert isinstance(err.value.__cause__, ValueError)
            srv.stop()
        else:
            while srv.error is None and time.perf_counter() - t0 < 5.0:
                time.sleep(0.01)
            with pytest.raises(RuntimeError, match="sink failed on purpose"):
                srv.stop()
        # two packets in, the third raised, the fourth was never taken
        assert srv.packets_matched == 3


def _stream():
    """test_utils.py's server world with two agents: fixed `multiagent`
    packets, each with a small image so that the two streams pair."""
    from cvids_tpu_torch.io import multiagent
    from cvids_tpu_torch.io.synthetic import Trajectory

    rng = np.random.default_rng(0)
    landmarks = np.stack([rng.uniform(-10, 10, N_LANDMARKS), rng.uniform(-10, 10, N_LANDMARKS),
                          rng.uniform(0.2, 3, N_LANDMARKS)], -1)
    descs = multiagent.landmark_descriptors(N_LANDMARKS)
    agents = [multiagent.AgentSim(Trajectory.circle(radius=4.0, omega=0.5, phase=ph))
              for ph in (0.0, 1.0)]
    packets, _ = multiagent.generate_packets(agents, landmarks, descs, duration=6.0,
                                             kf_rate=1.0, max_feats=30)
    for _, _, k, pkt in packets:
        pkt.image = np.full((6, 8), k, np.float32)
    return descs, [(cid, pkt) for _, cid, _, pkt in packets]


def _send_stream(cid, port):
    """A spawned agent: its client's packets of `_stream`, over TCP."""
    sender = transport.AgentSocketSender("127.0.0.1", port)
    try:
        for c, pkt in _stream()[1]:
            if c == cid:
                sender.send_packet(pkt)
    finally:
        sender.close()


def test_two_processes_stream_into_pose_graph():
    """Two spawned processes each publish one agent's packets; the port's
    `CollaborativePoseGraph` on the CPU ingests every one, equal to what was
    sent, in each client's order."""
    from cvids_tpu_torch.server import posegraph, vocab

    descs, stream = _stream()
    voc = vocab.train_vocabulary(descs, k=5, levels=2, seed=0, device="cpu")
    graph = posegraph.CollaborativePoseGraph(
        voc, posegraph.ServerConfig(kf_capacity=64, max_win=32, max_ext=64, max_loops=32,
                                    optimize_every=10000), device="cpu")
    got = []

    def sink(pkt):
        got.append(pkt)
        graph.add_keyframe(pkt)

    srv = transport.CollaborativeSocketServer(sink, match_tol=1e-3)
    procs = [mp.get_context("spawn").Process(target=_send_stream, args=(c, srv.port))
             for c in (0, 1)]
    try:
        for p in procs:
            p.start()
        t0 = time.perf_counter()
        while not srv.drain(timeout=1.0, min_conns=2):
            assert all(p.exitcode in (None, 0) for p in procs), [p.exitcode for p in procs]
            assert time.perf_counter() - t0 < 60.0, "did not drain"
        for p in procs:
            p.join(timeout=30.0)
            assert p.exitcode == 0
    finally:
        srv.stop()
        graph.close()
        for p in procs:
            if p.is_alive():
                p.terminate()
    assert srv.packets_matched == len(stream) and srv.msgs_dropped == srv.imgs_dropped == 0
    assert graph.store.count == len(stream)
    for cid in (0, 1):
        mine = [p for c, p in stream if c == cid]
        arrived = [p for p in got if p.client_id == cid]
        assert len(arrived) == len(mine)
        assert all(_same_wire(a, b) for a, b in zip(arrived, mine))


W, H = 320, 240
SCENE = dict(floor_z=0.0, wall_y=3.0, box_lo=np.array([1.9, 0.6, 0.0]),
             box_hi=np.array([2.9, 1.6, 0.9]))


@pytest.mark.slow
def test_socket_full_topology(tmp_path):
    """test_full_topology.py on the port, on the CPU: two spawned agent
    processes (`apps.agent_process`) read EuRoC-format sequences and stream
    over TCP into a `CollaborativeServer` with background solves, dense
    depth through the remap grid, TSDF and a mesh; the same bounds."""
    from cvids_tpu_torch.apps import agent_process
    from cvids_tpu_torch.camera import PinholeCamera
    from cvids_tpu_torch.dense import estimator
    from cvids_tpu_torch.io import euroc, euroc_synth, synthetic
    from cvids_tpu_torch.mapping import mesh as mesh_mod
    from cvids_tpu_torch.mapping.tsdf import TsdfConfig
    from cvids_tpu_torch.server import pipeline, posegraph, vocab
    from cvids_tpu_torch.utils.config import AgentConfig, CameraConfig
    from cvids_tpu_torch.utils.metrics import ate_rmse

    cam = CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0, k1=-0.28, k2=0.07, p1=1e-4,
                       p2=-2e-4, width=W, height=H)
    cfg_agent = AgentConfig(camera=cam, fast_threshold=12.0, min_feature_dist=16, equalize=True,
                            keyframe_freq=2.5)
    roots = []
    for cid, phase in enumerate((0.0, 0.45)):
        traj = synthetic.Trajectory.circle(radius=1.5, omega=0.5, height_amp=0.15, phase=phase,
                                           center=(0.0, 0.0, 1.3), speed_mod=0.3,
                                           speed_mod_freq=0.9)
        root = str(tmp_path / f"agent{cid}")
        euroc_synth.write_euroc_sequence(
            root, cfg=cfg_agent, trajectory=traj, duration=8.0, cam_rate=20.0, imu_rate=200.0,
            num_landmarks=1400, seed=21 + cid, world_seed=7, scene=SCENE, gyr_noise=2e-4,
            acc_noise=0.005, photometric=dict(flicker=0.15, vignette=0.3, noise_std=1.5,
                                              shot_noise=0.3, exposure_time=0.008))
        roots.append(root)
    voc = vocab.generic_vocabulary(k=8, levels=3, device="cpu")
    pcfg = pipeline.PipelineConfig(
        server=posegraph.ServerConfig(kf_capacity=256, optimize_every=20,
                                      pnp_thresh=10.0 / cam.fx, async_optimize=True),
        dense=estimator.DenseConfig(height=H, width=W, num_depths=64, dep_sample=0.015,
                                    tau2_scale=0.5),
        tsdf=TsdfConfig(voxel_size=0.1, capacity=2048, carving=False),
        min_fused_frames=2, ref_advance=3)
    server = pipeline.CollaborativeServer(voc, pcfg, device="cpu")
    for cid in range(2):
        server.set_client_camera(cid, PinholeCamera.create(
            cam.fx, cam.fy, cam.cx, cam.cy, (cam.k1, cam.k2, cam.p1, cam.p2), W, H,
            device="cpu"))
    srv = transport.CollaborativeSocketServer(server, match_tol=1e-3)
    procs = [mp.get_context("spawn").Process(
        target=agent_process.agent_main,
        args=(roots[c], c, srv.port, str(tmp_path / f"sent{c}.npz"), "cpu", 1)) for c in range(2)]
    try:
        for p in procs:
            p.start()
        t0 = time.perf_counter()
        while not srv.drain(timeout=2.0, min_conns=2):
            assert all(p.exitcode in (None, 0) for p in procs), [p.exitcode for p in procs]
            assert time.perf_counter() - t0 < 2400.0, "did not drain"
        for p in procs:
            p.join(timeout=120.0)
            assert p.exitcode == 0
    finally:
        srv.stop()
        for p in procs:
            if p.is_alive():
                p.terminate()
    assert srv.packets_matched >= 16, srv.packets_matched
    g = server.graph
    g.flush()
    g.close()
    assert g.solve_count >= 1, "background optimizer never solved"
    assert g.loop_count >= 1, "no loop closures over the socket path"
    assert g.clients[0].aligned and g.clients[1].aligned
    for cid, root in enumerate(roots):
        seq = euroc.load_euroc(root)
        sent, _, _ = agent_process.load_sent(str(tmp_path / f"sent{cid}.npz"))
        assert len(sent) == int((server.graph.store.client[:g.store.count] == cid).sum())
        tr = server.trajectory(cid)
        assert len(tr) >= 8
        gt_p = np.stack([np.interp(tr[:, 0], seq.gt_t, seq.gt_p[:, k]) for k in range(3)], -1)
        ate_cm = ate_rmse(tr[:, 1:4], gt_p, "sim3") * 100
        assert ate_cm < 10.0, f"agent {cid} ATE {ate_cm:.1f} cm (topology)"
    assert server.depth_maps_published >= 2
    mesh_path = str(tmp_path / "scene.ply")
    assert server.save_mesh(mesh_path) > 300
    verts, _, _ = mesh_mod.read_ply(mesh_path)
    assert np.isfinite(np.asarray(verts, np.float64)).all()
    os.remove(mesh_path)

"""The six CUDA kernels against their PyTorch twins, the front-end's and
the server's CUDA graphs (the dense frame, the 4-DoF solve) against their
eager calls, the deployment topology and the multi-GPU dry run on two ranks
that share the card, on a CUDA card.

    python -m pytest tests/test_torch_cuda.py        # on a machine with a card and nvcc

Each kernel runs at one small and one ragged shape, on inputs from
`chip_smoke.py`'s input functions, and must equal its twin (the depth filter within
`chip_smoke.FILTER_MAX_ULP` ulp). Without a CUDA device every test here
skips, with the reason printed; the condition is a string, so it is
evaluated when a test is set up and not while the module is imported. This
is a quick check on a machine that has a card; `chip_smoke.py` phase 3 is
the full one (the path's shapes, every edge shape, the memory audit).
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))   # chip_smoke.py

import chip_smoke as cs  # noqa: E402
from cvids_tpu_torch.ops import costvolume, cuda_kernels as ck  # noqa: E402

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA device")]

SMALL, RAGGED = "small", "ragged"
VOLUME_SHAPES = {SMALL: (16, 32, 32), RAGGED: (37, 53, 96)}      # h, w, d


def _volume(rng, shape, dev, dtype=torch.bfloat16):
    return torch.from_numpy(rng.uniform(0, 50, shape).astype(np.float32)).to(dev).to(dtype)


def _same(out, ref):
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(o, r), (o.float() - r.float()).abs().max().item()


@pytest.fixture
def dev():
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kind", [SMALL, RAGGED])
def test_warp_banded_kernel(kind, dev):
    h, w, _ = VOLUME_SHAPES[kind]
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
    for name, m in cs.warp_edge_maps(h, w, 8, 4).items():
        m_t = torch.from_numpy(m).to(dev)
        _same(ck.projective_warp_banded(img, m_t, 8, 4),
              ck.projective_warp_banded_twin(img, m_t, 8, 4))


@pytest.mark.parametrize("kind", [SMALL, RAGGED])
def test_plane_sweep_kernel(kind, dev):
    h, w, d = VOLUME_SHAPES[kind]
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
    k = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)
    m = torch.from_numpy(cs.rotation_homography(k, 0.03)).to(dev)
    b = torch.from_numpy(k @ np.array([-0.1, 0.02, 0.01], np.float32)).to(dev)
    inv = (torch.arange(d, dtype=torch.float32, device=dev) + 1.0) * 0.02
    pos = [p.contiguous() for p in costvolume._sweep_positions(m, b, inv, h, w)]
    meas = img.flip(1).contiguous()
    for dt in (torch.float32, torch.bfloat16):
        _same(ck.plane_sweep(img, meas, *pos, out_dtype=dt),
              ck.plane_sweep_twin(img, meas, *pos, out_dtype=dt))


@pytest.mark.parametrize("kind", [SMALL, RAGGED])
def test_sgm_scan_kernel(kind, dev):
    shape = VOLUME_SHAPES[kind]
    rng = np.random.default_rng(2)
    for dt in (torch.float32, torch.bfloat16):
        cost = _volume(rng, shape, dev, dt)
        p2 = _volume(rng, shape[:2], dev, dt) + 30.0
        for axis in (0, 1):
            _same(ck.sgm_scan_bidir(cost, p2, 7.0, axis=axis),
                  ck.sgm_scan_bidir_twin(cost, p2, 7.0, axis=axis))


@pytest.mark.parametrize("kind", [SMALL, RAGGED])
def test_wta_kernel(kind, dev):
    shape = VOLUME_SHAPES[kind]
    rng = np.random.default_rng(3)
    for dt in (torch.float32, torch.bfloat16):
        first = _volume(rng, shape, dev, dt)
        parts = [first, first.flip(2).contiguous(), first.roll(1, 2), first.roll(3, 2)]
        for n in (1, 2, 4):
            _same(ck.wta(*parts[:n]), ck.wta_twin(*parts[:n]))


@pytest.mark.parametrize("kind", [SMALL, RAGGED])
def test_depth_filter_kernel(kind, dev):
    h, w = {SMALL: (16, 32), RAGGED: (37, 53)}[kind]       # 37 * 53 = 7 * 256 + 169 pixels
    rng = np.random.default_rng(4)
    st, x, valid = cs.filter_inputs(rng, dev, h, w)
    tau2_map = torch.from_numpy(rng.uniform(1e-3, 0.05, (h, w)).astype(np.float32)).to(dev)
    for tau2 in (0.02, tau2_map):
        cs.filter_agree(ck.depth_filter_update(st, x, tau2, valid),
                        ck.depth_filter_update_twin(st, x, tau2, valid), f"filter {h}x{w}")


@pytest.mark.parametrize("kind", [SMALL, RAGGED])
def test_hamming_kernel(kind, dev):
    n, m = {SMALL: (32, 128), RAGGED: (37, 129)}[kind]
    rng = np.random.default_rng(5)
    a, b, av, bv = cs.hamming_inputs(rng, dev, n, m)
    for masks in ((None, None), (av, None), (None, bv), (av, bv)):
        _same(ck.hamming_matrix(a, b, *masks), ck.hamming_matrix_twin(a, b, *masks))


def test_launch_takes_a_device_without_an_index(dev):
    """`cuda_kernels._launch` resolves "cuda" to the current card, as
    `torch.cuda.current_stream` does."""
    before = dict(ck.launches)
    ck.empty_launch("cuda")
    ck.empty_launch(torch.device("cuda"))
    ck.empty_launch(dev)
    torch.cuda.synchronize()
    assert ck.launches == before        # the empty kernel is not counted


def _klt_inputs(dev):
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    img0 = 120 + 40 * np.sin(0.31 * xx + 0.2 * yy) + 30 * np.cos(0.17 * xx - 0.41 * yy)
    img1 = 120 + 40 * np.sin(0.31 * (xx - 1.5) + 0.2 * yy) + 30 * np.cos(0.17 * (xx - 1.5) - 0.41 * yy)
    xy = rng.uniform(20, 76, (32, 2)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)   # noqa: E731
    return t(img0), t(img1), t(xy), torch.ones(32, dtype=torch.bool, device=dev), t(xy), 1.5


def test_graphed_klt_equals_eager(dev):
    """The front-end's KLT call replayed as a CUDA graph gives the eager
    call's bits, on fresh inputs after the capture too."""
    from cvids_tpu_torch.utils.cuda_graph import GraphedCall
    from cvids_tpu_torch.vio import frontend

    call = GraphedCall(frontend._track_points)
    args = _klt_inputs(dev)
    for shift in (0.0, 0.7):
        moved = (args[0], args[1], args[2] + shift, args[3], args[4] + shift, args[5])
        _same(tuple(call(*moved)), tuple(frontend._track_points(*moved)))
    assert len(call.graphs) == 1 and call.replays == 2


def _window_problem(dev):
    """test_vio.py's window problem (K=11, L=40), made by the port alone."""
    from cvids_tpu_torch.geometry import yaw_of
    from cvids_tpu_torch.io import synthetic
    from cvids_tpu_torch.vio import imu, window_ba

    seq = synthetic.generate_sequence(synthetic.Trajectory.circle(radius=5.0, omega=0.5),
                                      duration=5.0, kf_rate=2.0, num_landmarks=40, seed=3)
    rng = np.random.default_rng(0)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)    # noqa: E731
    g, a, dt, v = synthetic.imu_slices(seq)
    zero = torch.zeros(3, device=dev)
    pre = imu.preintegrate(f(g), f(a), f(dt), zero, zero, sample_valid=torch.as_tensor(v, device=dev))
    k, n = len(seq.times_kf), seq.landmarks.shape[0]
    st = window_ba.WindowState(
        p=f(seq.p_gt + rng.normal(0, 0.1, (k, 3))), q=f(seq.q_gt), v=f(seq.v_gt),
        bg=torch.zeros((k, 3), device=dev), ba=torch.zeros((k, 3), device=dev),
        lm=f(seq.landmarks + rng.normal(0, 0.1, (n, 3))),
        kf_valid=torch.ones(k, dtype=torch.bool, device=dev),
        lm_valid=torch.as_tensor(seq.vis.sum(0) >= 2, device=dev))
    meas = window_ba.WindowMeasurements(
        obs=f(np.nan_to_num(seq.obs)), vis=torch.as_tensor(seq.vis, device=dev), pre=pre,
        pre_valid=torch.ones(k - 1, dtype=torch.bool, device=dev),
        r_cb=f([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]), p_bc=zero,
        pix_weight=460.0, huber_delta=5.0, bias_weight=10.0, prior=None,
        anchor_p=f(seq.p_gt[0]), anchor_yaw=yaw_of(f(seq.q_gt[0])))
    return st, meas


def test_graphed_solve_equals_eager(dev):
    """The window solve replayed as a CUDA graph gives the eager call's
    bits, on a second state after the capture too."""
    from cvids_tpu_torch.utils.cuda_graph import GraphedCall
    from cvids_tpu_torch.vio import window_ba as tba

    st, m = _window_problem(dev)
    call = GraphedCall(lambda s, mm: tba.solve_window_fast(s, mm, iters=4))
    for shift in (0.0, 0.05):
        s = st._replace(p=st.p + shift)
        got, want = call(s, m), tba.solve_window_fast(s, m, iters=4)
        _same(tuple(got[0]) + (got[1],), tuple(want[0]) + (want[1],))
    assert len(call.graphs) == 1 and call.replays == 2


def test_topology_on_the_card(dev, tmp_path):
    """`chip_smoke.py` phase 9's transport at a small size: two spawned
    agent processes (`apps.agent_process`, the card by default) read
    EuRoC-format sequences written by the port and stream over TCP into a
    `CollaborativeServer` on the card with background solves; both exit 0
    and every packet they sent arrives equal, with nothing dropped."""
    import multiprocessing

    from cvids_tpu_torch.apps import agent_process
    from cvids_tpu_torch.camera import make_camera
    from cvids_tpu_torch.dense.estimator import DenseConfig
    from cvids_tpu_torch.io import codec, euroc_synth, synthetic, transport
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.server.pipeline import CollaborativeServer
    from cvids_tpu_torch.utils.config import CameraConfig

    cam = CameraConfig(fx=115.25, fy=114.9, cx=80.5, cy=60.25, k1=-0.28, k2=0.07, p1=1e-4,
                       p2=-2e-4, width=160, height=120)
    cfg = cs.agent_config(cam)
    roots = []
    for cid, phase in enumerate((0.0, 0.45)):
        traj = synthetic.Trajectory.circle(radius=1.5, omega=0.5, height_amp=0.15, phase=phase,
                                           center=(0.0, 0.0, 1.3), speed_mod=0.3,
                                           speed_mod_freq=0.9)
        roots.append(euroc_synth.write_euroc_sequence(
            str(tmp_path / f"agent{cid}"), cfg=cfg, trajectory=traj, duration=3.0, cam_rate=20.0,
            imu_rate=200.0, num_landmarks=600, seed=21 + cid, world_seed=7, scene=cs.AGENT_SCENE,
            gyr_noise=2e-4, acc_noise=0.005))
    dense = DenseConfig(height=120, width=160, num_depths=32, dep_sample=0.015 * 200.0 / cam.fx)
    server = CollaborativeServer(vocab.synthesize_tree_vocabulary(k=4, levels=3),
                                 cs.agent_pipeline_config(cam, dense, async_optimize=True))
    for cid in range(2):
        server.set_client_camera(cid, make_camera(cam))
    got = {0: [], 1: []}
    submit = server.submit
    server.submit = lambda pkt: (got[int(pkt.client_id)].append(codec.encode_packet(pkt)),
                                 submit(pkt))
    srv = transport.CollaborativeSocketServer(server, match_tol=1e-3)
    outs = [str(tmp_path / f"sent{cid}.npz") for cid in range(2)]
    procs = [multiprocessing.get_context("spawn").Process(
        target=agent_process.agent_main, args=(roots[cid], cid, srv.port, outs[cid]))
        for cid in range(2)]
    try:
        for p in procs:
            p.start()
        t0 = time.perf_counter()
        while not srv.drain(timeout=1.0, min_conns=2):
            assert all(p.exitcode in (None, 0) for p in procs), [p.exitcode for p in procs]
            assert time.perf_counter() - t0 < 300.0, "did not drain"
        for p in procs:
            p.join(timeout=60.0)
        assert [p.exitcode for p in procs] == [0, 0]
        server.graph.flush()
    finally:
        srv.stop()
        for p in procs:
            if p.is_alive():
                p.terminate()
        server.close()
    assert srv.msgs_dropped == srv.imgs_dropped == 0
    for cid in range(2):
        sent, frame_ms, _ = agent_process.load_sent(outs[cid])
        assert len(frame_ms) == 61 and len(sent) == len(got[cid])
        assert all(cs.same_codec_dicts(a, b) for a, b in zip(sent, got[cid]))
    assert server.graph.store.count == sum(len(v) for v in got.values())


def test_two_gloo_ranks_on_one_card(dev):
    """`entry.dryrun_multichip` at its toy shapes on two gloo ranks that
    share the card (`chip_smoke.py` phase 11's layout on a one-card
    machine): every rank's tensors on the card, the dense step and the TSDF
    blocks equal to one process's bit for bit, the five dense kernels
    launched on each rank, no collective in either, and the solves and
    windows by their formulas (`chip_smoke.multichip_checks`)."""
    from cvids_tpu_torch.entry import dryrun_multichip, dryrun_problems

    res = dryrun_multichip(2, backend="gloo", device=dev, production=False)
    cs.multichip_checks(res, dryrun_problems(2, dev, production=False), 2, dev)


def _dense_inputs(dev, h=48, w=64, d=32):
    """A small textured plane (chip_smoke's), its config, and its warp and
    a rotation, each with its warp choice: banded, and the exact warp."""
    from cvids_tpu_torch.dense import estimator

    rng = np.random.default_rng(4)
    focal = 40.0
    cfg = estimator.DenseConfig(height=h, width=w, num_depths=d,
                                dep_sample=1.0 / (cs.BASELINE * focal * 2))
    ref, meas, a, b, k = cs.textured_plane(rng, h, w, focal=focal)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)  # noqa: E731
    a_rot = cs.rotation_homography(k, 0.25)
    return cfg, t(ref), t(meas), (t(a), True), (t(a_rot), False), t(b), t(k)


def _same_bits(x, y):
    return torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


def test_graphed_dense_frames_equal_eager(dev):
    """Five graphed dense frames (`DenseStep`) equal five eager ones bit for
    bit: both warps, and a reference roll with a sparse bias between."""
    from cvids_tpu_torch.dense import estimator
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs

    cfg, ref, meas, (a, gate), (a_rot, gate_rot), b, k = _dense_inputs(dev)
    uv = torch.tensor([[10.0, 10.0], [30.0, 20.0], [50.0, 40.0]], device=dev)
    bias = estimator.splat_sparse(cfg, uv, torch.full((3,), 0.3, device=dev),
                                  torch.ones(3, dtype=torch.bool, device=dev))
    eager, graphed = estimator.DenseStep(cfg), estimator.DenseStep(cfg)
    for step in (eager, graphed):
        step.init_reference(ref)
    frames = [(a, gate), (a_rot, gate_rot), "roll", (a, gate), (a_rot, gate_rot), (a, gate)]
    for frame in frames:
        if frame == "roll":
            for step in (eager, graphed):
                step.propagate_reference(ref, torch.eye(3, device=dev),
                                         torch.zeros(3, device=dev), k, sparse_bias=bias)
            continue
        with disable_graphs():
            eager.fuse(meas, frame[0], b, frame[1])
        graphed.fuse(meas, frame[0], b, frame[1])
        for x, y in zip((eager.state.mean_cost, eager.state.count, *eager.state.filt,
                         eager.state.num_frames),
                        (graphed.state.mean_cost, graphed.state.count, *graphed.state.filt,
                         graphed.state.num_frames)):
            assert _same_bits(x, y)
    # one graph per (warp, bias) variant, all four used
    assert len(graphed.graphs.graphs) == 4 and graphed.graphs.replays == 5


def test_graphed_dense_frame_counts_its_launches(dev):
    """A replay adds its capture's kernel launches to `cuda_kernels.launches`
    (the capture itself adds none): six a banded frame."""
    from cvids_tpu_torch.dense import estimator

    cfg, ref, meas, (a, gate), _, b, _ = _dense_inputs(dev)
    step = estimator.DenseStep(cfg)
    step.init_reference(ref)
    step.fuse(meas, a, b, gate)        # the capture: its warm-up ran the kernels once
    ck.reset_launches()
    for _ in range(3):
        step.fuse(meas, a, b, gate)
    assert ck.launches == {"warp_banded": 3, "plane_sweep": 3, "sgm_scan": 6, "wta": 3,
                           "hamming_matrix": 0, "depth_filter_update": 3}


def _solve_problem(dev, n, seed):
    from cvids_tpu_torch.entry import _graph

    rng = np.random.default_rng(seed)
    m = n - n // 8
    loops = (np.array([0, 3]), np.array([m - 1, m - 4]), rng.normal(0, 1, (2, 3)),
             rng.normal(0, 0.1, 2))
    nodes, edges = _graph(rng.uniform(-3, 3, n), rng.normal(size=(n, 3)), dev, loops)
    return nodes._replace(valid=torch.arange(n, device=dev) < m), edges


def test_graphed_solve_equals_eager_at_two_tiers(dev):
    """`optimize_pose_graph_graphed` equals `optimize_pose_graph` bit for
    bit at two tier sizes, one graph each."""
    from cvids_tpu_torch.server import optimizer as opt

    for n in (64, 128):
        nodes, edges = _solve_problem(dev, n, n)
        got = opt.optimize_pose_graph_graphed(nodes, edges, 3, 15)
        again = opt.optimize_pose_graph_graphed(nodes, edges, 3, 15)
        want = opt.optimize_pose_graph(nodes, edges, 3, 15)
        for x, y, z in zip(got, again, want):
            assert _same_bits(x, z) and _same_bits(y, z)


def test_capture_on_a_worker_thread(dev):
    """A solve captured on a worker thread, on its own stream, while the
    main thread keeps allocating and launching, equals the eager solve."""
    import threading

    from cvids_tpu_torch.server import optimizer as opt

    nodes, edges = _solve_problem(dev, 256, 7)
    got = {}

    def worker():
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            got["out"] = [x.cpu() for x in opt.optimize_pose_graph_graphed(nodes, edges, 4, 25)]

    th = threading.Thread(target=worker)
    th.start()
    busy = 0
    while th.is_alive() or busy == 0:
        # no random draws: PyTorch forbids them on any thread during a capture
        x = torch.full((512, 512), 1.0 + busy % 7, device=dev)
        float((x @ x).sum())
        busy += 1
    th.join()
    want = opt.optimize_pose_graph(nodes, edges, 4, 25)
    assert all(_same_bits(x, y.cpu()) for x, y in zip(got["out"], want))

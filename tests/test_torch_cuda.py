"""The ten CUDA kernels against their PyTorch twins, the front-end's and
the server's CUDA graphs (the front-end's track step, re-detection, packet
image program, preintegration, window solve and marginalization, its
pre-init essential pose and VI bootstrap; the calibrators' residuals and
Jacobian and the chessboard response; the dense
frame, the 4-DoF solve, the pose graph's loop-verification cascade and BoW
query-and-insert, one capture a capacity tier; a published map's chunk walk
and mesh batch) against their eager calls, the deployment topology and the
multi-GPU dry run on two ranks that share the card, on a CUDA card; with two
cards, the sharded solve's and window's graphs on two NCCL ranks against
their eager runs.

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


@pytest.mark.parametrize("n", [1, 2, 3, 5, 9, 11, 12])
def test_small_eig_kernel(n, dev):
    rng = np.random.default_rng(n)
    for b in (128, 5):
        x = torch.from_numpy(rng.normal(size=(b, n, n))).to(dev)
        for dtype in (torch.float32, torch.float64):
            a = (x @ x.transpose(-1, -2)).to(dtype).contiguous()
            got, want = ck.small_eigh(a), ck.small_eigh_twin(a)
            assert all(g.dtype == dtype for g in got)
            assert all(cs._same_bits(g, w) for g, w in zip(got, want))


def test_klt_track_kernel(dev):
    """The tracker against its twin, bit for bit: a 160x120 pair at the
    front-end's settings and `chip_smoke.klt_edge_cases` (one point, 33,
    all invalid, no gate, radius 3 at 1-4 levels, radius 0 and 24, seeds
    off the image); one launch a call."""
    rng = np.random.default_rng(7)
    cases = [("front-end", cs.klt_inputs(rng, dev, 120, 160, 40, 4), cs.KLT_ARGS)]
    for what, args, kw in cases + cs.klt_edge_cases(rng, dev):
        before = ck.launches["klt_track"]
        got = ck.klt_track(*args, **kw)
        assert ck.launches["klt_track"] == before + 1
        ref = ck.klt_track_twin(*args, **kw)
        assert all(cs._same_bits(a, b) for a, b in zip(got, ref)), what


def test_klt_plan_matches_library(dev):
    for n in (1, 33, 150):
        for radius in (0, 3, 10, 24):
            assert ck.compiled_klt_plan(n, radius) == ck.klt_plan(n, radius)


def test_fundamental_ransac_reads_nothing_back(dev):
    """The F-RANSAC (the Jacobi kernel for its float64 eigenproblems) under
    sync debug mode "error": a host sync would raise. Its hypotheses are
    the CPU's float64 ones (`_eight_point(..., jacobi=False)` on float64
    points) but for rounding, on two views of a scene in depth, where every
    8-point sample determines its F."""
    from cvids_tpu_torch.ops import ransac

    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, (150, 3))
    pts[:, 2] += 6.0
    yaw = 0.1
    r = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    pc2 = pts @ r.T + np.array([0.4, 0.1, 0.05])
    p1, p2 = (torch.from_numpy((x[:, :2] / x[:, 2:3]).astype(np.float32)).to(dev)
              for x in (pts, pc2))
    valid = torch.ones(150, dtype=torch.bool, device=dev)
    noise = torch.from_numpy(rng.gumbel(size=(128, 150)).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fr = ransac.fundamental_ransac(p1, p2, valid, noise)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(fr.num_inliers) > 100
    idx = ransac._sample_indices(noise, valid, 8)
    f = ransac._eight_point(p1[idx], p2[idx])
    ref = ransac._eight_point(p1[idx].double().cpu(), p2[idx].double().cpu(), jacobi=False)
    f, ref = (x / x.flatten(1).norm(dim=1)[:, None, None] for x in (f.double().cpu(), ref))
    err = torch.minimum((f - ref).abs().amax((1, 2)), (f + ref).abs().amax((1, 2)))
    # the twin on the CPU: median 1.0e-8, largest 9.5e-7 (a sample near a
    # degenerate one)
    assert float(err.median()) < 1e-7 and float(err.max()) < 1e-5


def test_graphed_marginalization_equals_eager(dev):
    """The marginalization's Schur complement replayed as a CUDA graph
    gives the eager call's bits."""
    from cvids_tpu_torch.utils.cuda_graph import GraphedCall
    from cvids_tpu_torch.vio import window_ba as tba

    st, m = _window_problem(dev)
    dying = m.vis[0] & ~m.vis[1:].any(0)
    call = GraphedCall(tba.marg_schur_cam)
    for shift in (0.0, 0.05):
        s = st._replace(p=st.p + shift)
        _same(call(s, m, dying), tba.marg_schur_cam(s, m, dying))
    assert len(call.graphs) == 1 and call.replays == 2


def _blob_frontend(dev, setup=None):
    """test_frontend.py's blob world (12 keyframes at 320x240, made by the
    port alone) through an `AgentFrontend` on the card (`setup(fe)` first,
    if given): (the front-end, [(image, imu) a keyframe])."""
    from cvids_tpu_torch.geometry.hostmath import quat_to_matrix_np
    from cvids_tpu_torch.io import render, synthetic
    from cvids_tpu_torch.utils.config import AgentConfig, CameraConfig
    from cvids_tpu_torch.vio.frontend import AgentFrontend

    rng = np.random.default_rng(0)
    traj = synthetic.Trajectory.circle(radius=4.0, omega=0.35, height_amp=0.2, speed_mod=0.3,
                                       speed_mod_freq=0.9)
    seq = synthetic.generate_sequence(traj, duration=6.0, kf_rate=2.0, imu_rate=200.0,
                                      num_landmarks=0, gyr_noise=0.0005, acc_noise=0.01,
                                      bg=(0.001, -0.001, 0.0005), ba=(0.005, -0.01, 0.02))
    lms = np.stack([rng.uniform(-12, 12, 400), rng.uniform(-12, 12, 400),
                    rng.uniform(0.0, 3.5, 400)], -1)
    intens = rng.uniform(80, 200, 400)
    cam = CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
                       width=320, height=240)
    cfg = AgentConfig(camera=cam, fast_threshold=12.0, min_feature_dist=24,
                      max_solver_iterations=10)
    fe = AgentFrontend(cfg, device=dev)
    if setup is not None:
        setup(fe)
    cpu_cam = AgentFrontend(cfg, device="cpu").cam
    g, a, dt, vmask = synthetic.imu_slices(seq)
    r_cb, p_bc = np.asarray(cfg.r_cb, np.float32), np.asarray(cfg.p_bc, np.float32)
    frames = []
    for i in range(len(seq.times_kf)):
        r_wb = quat_to_matrix_np(seq.q_gt[i].astype(np.float32)).astype(np.float32)
        img = render.render_blobs(cpu_cam, lms, intens, r_wb, seq.p_gt[i], r_cb, p_bc)
        imu = ((np.zeros((0, 3)), seq.acc[:5], np.zeros(0)) if i == 0 else
               (g[i - 1][vmask[i - 1]], a[i - 1][vmask[i - 1]], dt[i - 1][vmask[i - 1]]))
        fe.process_keyframe(seq.times_kf[i], img, *imu)
        frames.append((img, imu))
    return fe, frames


def test_frontend_graphs_equal_eager(dev):
    """test_frontend.py's blob world through an `AgentFrontend` on the
    card: every compiled program of the front-end (track step, re-detection,
    packet image program, preintegration, window solve, marginalization) is
    captured and replayed, each replay gives its eager call's bits, and no
    eager call reads a value back (`chip_smoke.graph_checks`)."""
    fe, frames = _blob_frontend(dev)
    assert fe.vi_initialized and fe._prior is not None
    cs.graph_checks(fe, frames[-2][0], frames[-1][0], frames[-1][1])


def test_frontend_once_programs_equal_eager(dev):
    """The same run's once-an-agent programs: the pre-init essential pose
    and the VI bootstrap's two solves, each captured and replayed in the
    run, and on the inputs of its last call a fresh graph's replay gives
    the eager call's bits (`chip_smoke.graphed_against_eager`)."""
    from cvids_tpu_torch.ops import ransac
    from cvids_tpu_torch.vio import frontend, initializer

    rec = {}
    fe, _ = _blob_frontend(dev, setup=lambda f: rec.update(cs.record_once_programs(f)))
    assert fe.vi_initialized
    fns = {"essential_pose": ransac.essential_pose, "gyro_bias": initializer.calibrate_gyro_bias,
           "alignment": frontend._align_step}
    for name, r in rec.items():
        assert r.args and r.captures == 1 and r.replays == len(r.args), (name, r.captures)
        out = cs.graphed_against_eager(fns[name], r.args[-1], runs=2)
        assert out["bits_equal"] and out["captures"] == 1, (name, out)


@pytest.mark.parametrize("model", list(cs.CALIB_CASES))
def test_calibrator_graphs_equal_eager(model, dev):
    """`calibrate_chessboards` on the card (test_extras.py's camera and
    views at 320x240, 3 iterations): each solve's residual and Jacobian
    programs are captured once and replayed, and on their last call's
    inputs a fresh graph's replay gives the eager call's bits; so does the
    chessboard response on a view."""
    from unittest import mock

    from cvids_tpu_torch.camera import chessboard, models

    cam = cs.calib_camera(model, dev, 320, 240)
    views = cs.board_views(cam, cs.PINHOLE_BOARD_POSES if model == "pinhole" else cs.BOARD_POSES)
    cs._RecordingCall.made = []
    with mock.patch.object(models, "GraphedCall", cs._RecordingCall):
        chessboard.calibrate_chessboards(views, *cs.CALIB_BOARD, 320, 240, iters=3, model=model,
                                         device=dev)
    made = cs._RecordingCall.made
    assert made and len(made) % 2 == 0
    for call in made:
        assert call.inner.captures == 1 and call.inner.replays >= 1
        assert cs.graphed_against_eager(call.inner.fn, call.last, runs=2)["bits_equal"]
    out = cs.graphed_against_eager(chessboard.chessboard_response,
                                   (torch.as_tensor(views[0], device=dev),), runs=2)
    assert out["bits_equal"]


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


def test_window_lm_kernel(dev):
    """The window kernel equals its twin bit for bit at the front-end's
    window (K = 10, 600 slots, a 150-row prior, 8 iterations) and at
    `chip_smoke.window_lm_edge_cases` (no prior, Huber, invalid slots, no
    landmark, 1 and 25 iterations, rejected steps, K = 12, 13 and 21 with
    1100 slots, K = 2)."""
    cases = [("path", *cs.window_lm_inputs(dev), cs.WLM_ITERS, 1e-3)]
    cases += cs.window_lm_edge_cases(dev)
    for what, st, m, iters, lam in cases:
        got, ref = ck.window_lm(st, m, iters, lam), ck.window_lm_twin(st, m, iters, lam)
        for a, b in zip(tuple(got[0]) + (got[1],), tuple(ref[0]) + (ref[1],)):
            assert _same_bits(a, b), what


def test_window_lm_plan_matches_library(dev):
    for k in (1, 2, 10, 12, 13, 21):
        for l in (0, 37, 600):
            for p in (0, 15 * k):
                assert ck.window_lm_plan(k, l, p) == ck.compiled_window_lm_plan(k, l, p)


def test_solve_window_fast_launches_the_kernel_once(dev):
    """On the card `solve_window_fast` is one window_lm launch a call, eager
    or replayed in the front-end's solve graph (a capture's warm-up call
    counts one), at K = 21 too, and a window past the kernel's 21 keyframes
    raises."""
    from cvids_tpu_torch.utils.cuda_graph import GraphedCall
    from cvids_tpu_torch.vio import frontend, window_ba as tba

    st, m = cs.window_lm_inputs(dev, k=5, n_lm=60, seed=3)
    ck.reset_launches()
    tba.solve_window_fast(st, m, iters=4)
    assert ck.launches["window_lm"] == 1
    call = GraphedCall(frontend._solve_window_fast)
    ck.reset_launches()
    for _ in range(3):
        call(st, m, 4)
    assert ck.launches["window_lm"] == 4 and call.replays == 3 and call.captures == 1
    st21, m21 = cs.window_lm_inputs(dev, k=21, n_lm=60, seed=5)
    ck.reset_launches()
    tba.solve_window_fast(st21, m21, iters=2)
    assert ck.launches["window_lm"] == 1
    st22, m22 = cs.window_lm_inputs(dev, k=22, n_lm=20, prior=False)
    with pytest.raises(ValueError):
        tba.solve_window_fast(st22, m22)


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


def test_nccl_sharded_graphs_equal_eager(dev):
    """On two NCCL ranks, a card each, `entry.dryrun_multichip`'s toy
    phases: the sharded 4-DoF solve and window replay one captured LM
    iteration (one capture a program, 2 and 2 replays a run), and their
    results equal their eager runs under `disable_graphs()` bit for bit,
    the calls issued equal call for call; `chip_smoke.multichip_checks`
    holds both to phase 11's bounds."""
    from cvids_tpu_torch.entry import dryrun_multichip, dryrun_problems

    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA devices for two NCCL ranks, has "
                    f"{torch.cuda.device_count()}")
    res = dryrun_multichip(2, backend="nccl", production=False)
    cs.multichip_checks(res, dryrun_problems(2, dev, production=False), 2, dev)
    for name, fields in (("toy_graph", ("t", "yaw")), ("toy_window", ("p", "q", "lm", "cost"))):
        for f in fields:
            for rerun in ("replayed", "eager"):
                _same(res[name][f], res[name][rerun][f])
        calls = [res["phases"][name + s]["calls"] for s in ("", "_replayed", "_eager")]
        assert calls[0] == calls[1] == calls[2] and len(calls[0]) > 0
    assert all(r["graphs"] == {"_lm_step": [1, 4], "_iteration": [1, 4]} for r in res["ranks"])


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
    landmarks = (np.array([[10.0, 10.0], [30.0, 20.0], [50.0, 40.0]], np.float32),
                 np.full(3, 0.3, np.float32), np.ones(3, bool))
    inputs = estimator.roll_inputs(np.eye(3), np.zeros(3), k.cpu().numpy(), landmarks, dev)
    k_inv = torch.linalg.inv(k)
    eager, graphed = estimator.DenseStep(cfg), estimator.DenseStep(cfg)
    for step in (eager, graphed):
        step.init_reference(ref)
    frames = [(a, gate), (a_rot, gate_rot), "roll", (a, gate), (a_rot, gate_rot), (a, gate)]
    for frame in frames:
        if frame == "roll":
            with disable_graphs():
                eager.roll(ref, inputs, k_inv)
            graphed.roll(ref, inputs, k_inv)
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
                           "hamming_matrix": 0, "depth_filter_update": 3, "small_eig": 0,
                           "klt_track": 0, "tsdf_integrate": 0}


def _dense_buffers(state):
    """(name, tensor) of every buffer a dense step writes."""
    named = [(n, getattr(state, n)) for n in ("ref_img", "grad", "penalty", "mean_cost",
                                              "count", "num_frames")]
    named += list(zip(state.filt._fields, state.filt))
    return named + ([("sparse_bias", state.sparse_bias)] if state.sparse_bias is not None else [])


def test_graphed_rolls_equal_eager(dev):
    """Five reference rolls replayed as CUDA graphs (`DenseStep.roll`, with
    landmarks at two tiers and with none) equal the same rolls under
    `disable_graphs()` bit for bit in every buffer they write, and so do the
    graphed frames fused after them; the buffers never move, and a roll of a
    signature seen before captures nothing. The splat's ring of shifted
    windows is the reference's loop of rolls, bit for bit."""
    from cvids_tpu_torch.dense import estimator
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs
    from test_torch_roll import splat_by_rolls

    cfg, ref, meas, (a, gate), _, b, k = _dense_inputs(dev)
    rng = np.random.default_rng(11)
    axis = np.array([1.0, 1.0, 0.2]) / np.linalg.norm([1.0, 1.0, 0.2])
    skew = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    r_no = (np.eye(3) + np.sin(0.04) * skew + (1 - np.cos(0.04)) * skew @ skew).astype(np.float32)
    t_no = np.array([-0.05, 0.01, 0.03], np.float32)
    h, w = cfg.height, cfg.width
    eager, graphed = estimator.DenseStep(cfg), estimator.DenseStep(cfg)
    for step in (eager, graphed):
        step.init_reference(ref)
    addresses = None
    for i, p in enumerate([100, 300, None, 200, None]):     # tiers 256, 512, none, 256, none
        with disable_graphs():
            eager.fuse(meas, a, b, gate)
        graphed.fuse(meas, a, b, gate)
        for (name, x), (_, y) in zip(_dense_buffers(eager.state), _dense_buffers(graphed.state)):
            assert _same_bits(x, y), f"frame before roll {i}: {name}"
        landmarks = None if p is None else (
            rng.uniform([-2.0, -2.0], [w + 2.0, h + 2.0], (p, 2)).astype(np.float32),
            rng.uniform(0.2, 1.5, p).astype(np.float32), rng.random(p) < 0.9)
        if landmarks is not None:
            lm = [torch.from_numpy(x).to(dev) for x in landmarks]
            assert _same_bits(estimator.splat_sparse(cfg, *lm), splat_by_rolls(cfg, *lm))
        inputs = estimator.roll_inputs(r_no, t_no, k.cpu().numpy(), landmarks, dev)
        k_inv = torch.linalg.inv(k)
        captures = graphed.rolls.captures
        new_ref = (meas, ref)[i % 2]
        with disable_graphs():
            eager.roll(new_ref, inputs, k_inv)
        graphed.roll(new_ref, inputs, k_inv)
        named = _dense_buffers(graphed.state)
        assert [n for n, _ in named] == [n for n, _ in _dense_buffers(eager.state)]
        for (name, x), (_, y) in zip(_dense_buffers(eager.state), named):
            assert _same_bits(x, y), f"roll {i}: {name}"
        assert graphed.rolls.captures == captures + (i < 3), f"roll {i}"
        ptrs = {n: x.data_ptr() for n, x in named}
        assert addresses is None or all(addresses.get(n, v) == v for n, v in ptrs.items())
        addresses = {**(addresses or {}), **ptrs}
    with disable_graphs():
        eager.fuse(meas, a, b, gate)
    graphed.fuse(meas, a, b, gate)
    for (name, x), (_, y) in zip(_dense_buffers(eager.state), _dense_buffers(graphed.state)):
        assert _same_bits(x, y), f"last frame: {name}"
    assert graphed.rolls.replays == 5 and len(graphed.rolls.graphs) == 3
    assert eager.rolls.replays == 0 and eager.rolls.captures == 0


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


def _server_cascade_inputs(dev, rng, n_win=160, n_ext=512):
    """A loop verification at the server's shapes (`ServerConfig`'s 160
    window and 512 extra features): the new keyframe's window features, a
    posed old keyframe that sees most of them, the two RANSAC noises."""
    from cvids_tpu_torch.ops import ransac

    pts = rng.uniform(-2, 2, (n_win, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    yaw = 0.1
    r = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    pc = (pts @ r.T + np.array([0.3, 0.1, 0.0])).astype(np.float32)
    ext_desc = rng.integers(0, 2 ** 32, (n_ext, 8), dtype=np.uint32)
    ext_uv = rng.uniform(-0.5, 0.5, (n_ext, 2)).astype(np.float32)
    ext_uv[:n_win] = pc[:, :2] / pc[:, 2:3]
    win_desc = ext_desc[:n_win].copy()
    win_desc[:30] = ext_desc[200:230]                     # planted wrong matches
    gen = torch.Generator().manual_seed(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)   # noqa: E731
    return (t(win_desc.view(np.int32)), t(np.ones(n_win, bool)), t(pts[:, :2] / pts[:, 2:3]),
            t(pts), t(ext_desc.view(np.int32)), t(np.ones(n_ext, bool)), t(ext_uv),
            ransac.gumbel_noise(128, n_win, gen, device=dev),
            ransac.gumbel_noise(128, n_win, gen, device=dev), 10.0 / 460.0, 15, True)


def test_graphed_cascade_equals_eager(dev):
    """The loop verification cascade (Hamming match, F-RANSAC and PnP on
    the Jacobi kernel) at the server's shapes: one capture, and each replay
    reads nothing back (sync debug mode "error") and gives the eager call's
    bits; it accepts the planted pose."""
    from cvids_tpu_torch.server.posegraph import _match_and_pnp
    from cvids_tpu_torch.utils.cuda_graph import GraphedCall, disable_graphs

    rng = np.random.default_rng(0)
    call = GraphedCall(_match_and_pnp)
    args = _server_cascade_inputs(dev, rng)
    other = _server_cascade_inputs(dev, np.random.default_rng(1))
    call(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call(*args)
        again = call(*other)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with disable_graphs():
        want = _match_and_pnp(*args)
    leaves = torch.utils._pytree.tree_leaves
    assert all(cs._same_bits(x, y) for x, y in zip(leaves(got), leaves(want)))
    assert call.captures == 1 and call.replays == 3 and len(call.graphs) == 1
    res = got[0]
    assert bool(res.ok) and int(res.num_inliers) >= 100, int(res.num_inliers)
    assert bool(again[0].ok)


def test_ransac_on_the_card_reads_nothing_back(dev):
    """`pnp_ransac` and `essential_pose` on card tensors take the Jacobi
    path (`jacobi=None`): no host sync (sync debug mode "error"), and the
    results of the twin's float64 path on the CPU but for rounding."""
    from cvids_tpu_torch.ops import ransac

    rng = np.random.default_rng(2)
    args = _server_cascade_inputs(torch.device("cpu"), rng)
    pts, obs, valid, g = args[3], args[2], args[1], args[7]
    obs2 = args[6][:160]
    for fn, inputs in ((ransac.pnp_ransac, (pts, obs2, valid, g)),
                       (ransac.essential_pose, (obs, obs2, valid, g))):
        on_card = [x.to(dev) for x in inputs]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(*on_card)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = fn(*inputs, jacobi=True)
        assert bool(got.ok) == bool(want.ok)
        assert torch.equal(got.inliers.cpu(), want.inliers)
        assert float((got.r.cpu() - want.r).abs().max()) < 1e-5


def test_bow_programs_one_capture_per_tier(dev):
    """Each database's query-and-insert program through three store
    growths: one capture a tier, replays equal to an eager database's, the
    superseded tiers released (`chip_smoke.bow_tier_checks`)."""
    from cvids_tpu_torch.server import vocab

    cs.bow_tier_checks(dev, vocab.synthesize_tree_vocabulary(10, 3, seed=0), n_frames=40)


def test_server_ingest_graphs_equal_eager_with_background_solves(dev):
    """A two-agent stream through `CollaborativePoseGraph` on the card with
    background solves (the worker captures its solves while ingest captures
    its programs): the cascade one capture, the BoW step one a tier, and
    every replay equal to its eager rerun (`chip_smoke.IngestRecorder`)."""
    from cvids_tpu_torch.server import vocab

    packets, _ = cs.server_stream(2, 40.0)
    server, stats = cs.server_run(dev, packets, vocab.synthesize_tree_vocabulary(10, 4, seed=0),
                                  sync_window=(10, 20), record=True)
    rec = stats["recorder"].compare()
    assert server.loop_count > 0 and server.solve_count > 0
    assert rec["cascade_calls"] > 0 and rec["cascade_captures"] == 1
    assert rec["bow_calls"] == len(packets) and rec["bow_captures"] == rec["bow_tiers"]
    assert rec["cascade_differ"] == 0 and rec["bow_differ"] == 0, rec


@pytest.mark.parametrize("kind", [SMALL, RAGGED])
def test_tsdf_integrate_kernel(kind, dev):
    """The TSDF kernel against its twin bit for bit: a 60x80 frame into 50
    chunks of 8³ (stride-0 colour), or a ragged 37x53 one into chunks of
    7³ (the voxel loop's ragged pass, a contiguous colour); one launch a
    call."""
    rng = np.random.default_rng(8)
    if kind == SMALL:
        inp = cs.tsdf_inputs(rng, dev, 60, 80, 60.0, m=50, capacity=128)
    else:
        inp = cs.tsdf_inputs(rng, dev, 37, 53, 30.0, cfg_kw=dict(chunk_size=7), m=40,
                             stride0=False, off_image=True, capacity=64)
    cfg, pool, *rest = inp
    got, ref = cs._pool_copy(pool), cs._pool_copy(pool)
    before = ck.launches["tsdf_integrate"]
    ck.tsdf_integrate(cfg, got, *rest)
    assert ck.launches["tsdf_integrate"] == before + 1
    ck.tsdf_integrate_twin(cfg, ref, *rest)
    assert all(cs._same_bits(a, b) for a, b in zip(got, ref))
    assert (got.weight != pool.weight).any()


def test_tsdf_plan_matches_library(dev):
    for m in (1, 1000):
        for s in (1, 7, 8, 9):
            assert ck.tsdf_plan(m, s) == ck.compiled_tsdf_plan(m, s)


def _map_frames(rng, n, h=120, w=160):
    """n frames of a tilted wall at 2-6 m from cameras turning about it."""
    k = np.array([[115.0, 0, w / 2], [0, 115.0, h / 2], [0, 0, 1]], np.float32)
    for i in range(n):
        vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
        depth = (2.0 + 4.0 * uu / w + 0.4 * np.sin(vv / 10.0)).astype(np.float32)
        depth[rng.random((h, w)) < 0.1] = 0.0
        r_wc = cs.rotation_homography(np.eye(3, dtype=np.float32), 0.1 * i, 0.05)
        yield depth, np.repeat(depth[..., None] * 40.0, 3, -1), k, r_wc, \
            np.array([0.1 * i, 0.0, 0.0], np.float32)


def test_graphed_walk_equals_eager_and_cpu(dev):
    """The chunk walk on the card: one capture a depth shape, its replays'
    chunks equal to the eager walk's and to the CPU's."""
    from cvids_tpu_torch.mapping import tsdf
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs

    cfg = tsdf.TsdfConfig()
    vol = tsdf.TsdfVolume(cfg, device=dev)
    cpu = tsdf.TsdfVolume(cfg, device="cpu")
    for depth, _, k, r_wc, t_wc in _map_frames(np.random.default_rng(0), 3):
        got = vol._touched_chunks(torch.from_numpy(depth).to(dev), k, r_wc, t_wc)
        with disable_graphs():
            eager = vol._touched_chunks(depth, k, r_wc, t_wc)
        want = cpu._touched_chunks(depth, k, r_wc, t_wc)
        assert len(got) > 50
        np.testing.assert_array_equal(got, eager)
        np.testing.assert_array_equal(got, want)
    assert vol.walk_graph.captures == 1 and vol.walk_graph.replays == 3


def test_integrate_launches_once_per_map_and_graphed_mesh(dev):
    """`integrate` on a card volume: one `tsdf_integrate` launch a map, the
    volume equal to the CPU's bit for bit (the twin on the same chunks);
    then `extract_mesh`: one replay a 256-chunk batch, the eager path's
    triangles bit for bit, and a new pool (growth) clears its graphs."""
    from cvids_tpu_torch.mapping import mesh, tsdf
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs

    cfg = tsdf.TsdfConfig(voxel_size=0.05, capacity=256)
    vol = tsdf.TsdfVolume(cfg, device=dev)
    cpu = tsdf.TsdfVolume(cfg, device="cpu")
    before = ck.launches["tsdf_integrate"]
    frames = list(_map_frames(np.random.default_rng(1), 4))
    for frame in frames:
        vol.integrate(*frame)
        cpu.integrate(*frame)
    assert ck.launches["tsdf_integrate"] == before + len(frames)
    assert vol.slot_of == cpu.slot_of and vol.capacity > 256
    for a, b in zip(vol.pool, cpu.pool):
        assert cs._same_bits(a.cpu(), b)
    replays = vol.mesh_graph.replays
    got = mesh.extract_mesh(vol)
    assert vol.mesh_graph.replays - replays == -(-len(vol.slot_of) // mesh.MESH_BATCH)
    with disable_graphs():
        eager = mesh.extract_mesh(vol)
    assert len(got[0]) > 1000
    for a, b in zip(got, eager):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert vol.mesh_graph.graphs
    vol._grow()
    assert not vol.mesh_graph.graphs

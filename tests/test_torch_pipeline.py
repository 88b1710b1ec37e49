"""The whole collaborative server on the CPU: `test_pipeline.py`'s orbit of
the rendered room through `cvids_tpu`'s `CollaborativeServer` and through
the port's — keyframes with images, the pose graph, per-client dense depth,
TSDF fusion, the mesh — with the JAX key chain's RANSAC noise injected into
the port; the port's `AddDisturbance`; the remap grids of distorted,
fisheye and Mei clients and one dense step on remapped images. (One file,
so the JAX pipeline compiles once.)

Two inputs are routed so that both pipelines see the same numbers:

- Both gate the banded alignment warp on the host, but `cvids_tpu` runs
  its banded kernel only on a TPU and takes the exact warp on the CPU; the
  two warps resample differently (two 1-D passes against one bilinear
  fetch), so the parity run routes the port's banded warp to the exact one
  as well.
- The port builds each keyframe's camera rotation on the host in float64
  (`hostmath.ypr_to_r_np`), `cvids_tpu` in float32 through XLA; the
  warps' matrices then differ by ~1e-8, which moves the first published
  map beyond 1e-4 relative at 7 % of its pixels (the subpixel parabola of
  flat costs amplifies it). The parity run gives the port the float32
  rotation. With the same inputs the dense steps agree to ~2e-6.
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu import camera as jcamera
from cvids_tpu.dense import estimator as jest
from cvids_tpu.geometry import ypr_to_r as jypr_to_r
from cvids_tpu.io import multiagent as jma
from cvids_tpu.mapping.tsdf import TsdfConfig as JTsdfConfig
from cvids_tpu.server import pipeline as jpipe
from cvids_tpu.server import posegraph as jpg
from cvids_tpu.server import vocab as jvoc
from cvids_tpu_torch import camera, interop
from cvids_tpu_torch.dense import estimator as testimator
from cvids_tpu_torch.io import multiagent, render
from cvids_tpu_torch.io.msgs import KeyframePacket
from cvids_tpu_torch.io.synthetic import Trajectory, quat_from_matrix_np
from cvids_tpu_torch.mapping.mesh import read_ply
from cvids_tpu_torch.ops import cuda_kernels
from cvids_tpu_torch.ops.image import projective_warp_mxu
from cvids_tpu_torch.server import pipeline as tpipe
from cvids_tpu_torch.server import posegraph as tpg
from test_pipeline import look_at
from test_torch_server import JaxKeyChain

H, W = 120, 160
N_KF = 14


def orbit_packets(rng):
    """`test_full_pipeline_dense_to_mesh`'s 14 keyframes orbiting the
    textured room (the port's render copy, identical to the original), as
    the field dicts of a `KeyframePacket`; the vocabulary of its landmarks."""
    cam = camera.PinholeCamera.create(100.0, 100.0, W / 2, H / 2, width=W, height=H,
                                      device="cpu")
    n_lm = 200
    landmarks = np.stack([rng.uniform(-4, 4, n_lm), rng.uniform(-3, 2.5, n_lm),
                          rng.uniform(0, 2, n_lm)], -1)
    descs = multiagent.landmark_descriptors(n_lm)
    r_cb = multiagent.R_CB_DEFAULT
    target = np.array([1.5, 1.0, 0.5])
    fields = []
    for i in range(N_KF):
        ang = -0.6 + 1.2 * i / N_KF
        eye = np.array([1.5 + 1.5 * np.sin(ang), -2.2, 1.2])
        r_wc = look_at(eye, target)
        inten, _ = render.render_textured_scene(cam, r_wc, eye)
        r_wb = r_wc @ r_cb
        pts_c = ((landmarks - eye) @ r_wb) @ r_cb.T
        idxs = np.nonzero(pts_c[:, 2] > 0.5)[0][:30]
        uv = pts_c[idxs, :2] / pts_c[idxs, 2:3]
        fields.append(dict(
            client_id=0, timestamp=float(i), p_wb=eye.astype(np.float32),
            q_wb=quat_from_matrix_np(r_wb).astype(np.float32), r_cb=r_cb,
            p_bc=np.zeros(3, np.float32), win_pts3d=landmarks[idxs].astype(np.float32),
            win_uv=uv.astype(np.float32), win_ids=idxs.astype(np.int64),
            win_desc=descs[idxs], win_valid=np.ones(len(idxs), bool),
            ext_uv=uv.astype(np.float32), ext_desc=descs[idxs],
            ext_valid=np.ones(len(idxs), bool), image=inten))
    return fields, cam.k_matrix.numpy(), jvoc.train_vocabulary(descs, k=5, levels=2, seed=0)


def jax_config():
    """`test_pipeline.py`'s configuration, with fp32 volumes."""
    return jpipe.PipelineConfig(
        server=jpg.ServerConfig(kf_capacity=64, max_win=32, max_ext=64,
                                max_loops=32, optimize_every=10000),
        dense=jest.DenseConfig(height=H, width=W, num_depths=48,
                               dep_sample=(1.0 / 0.6 - 1.0 / 8.0) / 48,
                               pi1=4.0, pi2=16.0, tau2_scale=0.5, dtype="float32"),
        tsdf=JTsdfConfig(voxel_size=0.12, capacity=4096, carving=False),
        min_fused_frames=2, ref_advance=3)


@pytest.fixture(scope="module")
def both_servers():
    fields, k, voc = orbit_packets(np.random.default_rng(0))
    cfg = jax_config()
    sj = jpipe.CollaborativeServer(voc, cfg)
    st = tpipe.CollaborativeServer(
        interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc), "cpu"),
        interop.pipeline_config_to_torch(cfg), device="cpu", noise=JaxKeyChain())
    jax_route = [mock.patch.object(jest, "fuse_measurement",
                                   jest.fuse_measurement.__wrapped__)]
    port_route = [mock.patch.object(cuda_kernels, "projective_warp_banded",
                                    lambda img, m: projective_warp_mxu(img, m)),
                  mock.patch.object(tpipe, "ypr_to_r_np",
                                    lambda ypr: np.asarray(jypr_to_r(jnp.asarray(ypr))))]
    for s, packet, patches in ((sj, jma.KeyframePacket, jax_route),
                               (st, KeyframePacket, port_route)):
        s.set_client_intrinsics(0, k)
        for f in fields:
            s.submit(packet(**f))
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            assert s.process() == N_KF
    yield sj, st
    st.close()


def test_pipeline_matches_jax(both_servers, tmp_path):
    """The same published depth maps (count and reference keyframes), depth
    agreeing to 1e-4 relative at >= 99.5 % of the pixels either package
    publishes (measured on the four maps: 100 %, 100 %, 99.994 %, 100 %),
    the same allocated chunks, mesh triangle counts within 1 %, and the
    same tracer spans."""
    sj, st = both_servers
    assert st.depth_maps_published == sj.depth_maps_published >= 2
    assert [r["ref_index"] for r in st.depth_records] == \
        [r["ref_index"] for r in sj.depth_records]
    for rt, rj in zip(st.depth_records, sj.depth_records):
        dt, dj = rt["depth"], rj["depth"]
        assert dt.shape == dj.shape == (H, W) and dt.dtype == np.float32
        shown = (dt > 0) | (dj > 0)
        agree = np.isclose(dt, dj, rtol=1e-4, atol=0.0)[shown].mean()
        # the WTA's argmin ties may flip where the two packages' cost sums
        # round differently
        assert agree >= 0.995, (rt["ref_index"], agree)
        np.testing.assert_allclose(rt["r_wc"], rj["r_wc"], atol=1e-6)
        np.testing.assert_allclose(rt["t_wc"], rj["t_wc"], atol=1e-6)
    assert set(st.volume.slot_of) == set(sj.volume.slot_of)
    assert len(st.volume.slot_of) > 20
    nt = st.save_mesh(str(tmp_path / "port.ply"))
    nj = sj.save_mesh(str(tmp_path / "jax.ply"))
    assert abs(nt - nj) <= 0.01 * nj and nt > 100
    verts, t, _ = read_ply(str(tmp_path / "port.ply"))
    assert t == nt and (np.abs(verts[:, 2]) < 0.1).sum() > 50   # the floor
    assert set(st.tracer.totals) == set(sj.tracer.totals) >= {"ingest", "depth", "fuse", "mesh"}
    st.optimize()
    assert "optimize" in st.tracer.totals
    assert st.trajectory(0).shape == (N_KF, 8)


def test_disturbance_injection(tmp_path):
    """`test_pipeline.test_disturbance_injection` on the port:
    `AddDisturbance` fires when the store reaches 16 keyframes and shifts
    every accepted loop's yaw by exactly 0.2°; tiny images exercise the
    thumbnails and the loop-overlay pair. (The JAX test's threshold of 10
    comes before the first loop, which closes at keyframe 15, one orbit
    being 12.6 s, so there it checks nothing.)"""
    rng = np.random.default_rng(0)
    n_lm = 60
    landmarks = np.stack([rng.uniform(-10, 10, n_lm), rng.uniform(-10, 10, n_lm),
                          rng.uniform(0.2, 3, n_lm)], -1)
    descs = multiagent.landmark_descriptors(n_lm)
    voc = jvoc.train_vocabulary(descs, k=5, levels=2, seed=0)
    cfg = tpipe.PipelineConfig(
        server=tpg.ServerConfig(kf_capacity=64, max_win=32, max_ext=64,
                                max_loops=32, optimize_every=10000),
        dense_enabled=False, disturbance_after=16)
    server = tpipe.CollaborativeServer(
        interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc), "cpu"), cfg,
        device="cpu")
    agents = [multiagent.AgentSim(Trajectory.circle(radius=5.0, omega=0.5))]
    packets, _ = multiagent.generate_packets(agents, landmarks, descs, duration=20.0,
                                             kf_rate=1.0, max_feats=30)
    yaw_before = None
    for _, _, _, pkt in packets:
        g = server.graph
        if g.store.count == 16 and g.loop_count > 0:
            yaw_before = g.loop_yaw[:g.loop_count].copy()
        server.submit(dataclasses.replace(pkt, image=rng.uniform(0, 255, (24, 32))))
        server.process()
    assert yaw_before is not None and len(yaw_before)
    after = server.graph.loop_yaw[:len(yaw_before)]
    np.testing.assert_allclose(after - yaw_before, np.deg2rad(0.2), atol=1e-6)
    assert server.graph.last_loop is not None and server._loop_overlay_pair is not None
    assert len(server.thumbs) == len(packets) and len(server.images) <= 9
    server.close()


CLIENT_CAMERAS = {
    "undistorted": lambda: jcamera.PinholeCamera.create(100.0, 105.0, 80.0, 60.0,
                                                        (0.0, 0.0, 0.0, 0.0), W, H),
    "radtan": lambda: jcamera.PinholeCamera.create(100.0, 105.0, 80.0, 60.0,
                                                   (-0.28, 0.07, 1e-4, -2e-4), W, H),
    "equidistant": lambda: jcamera.EquidistantCamera.create(
        90.0, 92.0, 80.0, 60.0, (-0.01, 0.02, -0.005, 0.001), W, H),
    "mei": lambda: jcamera.MeiCamera.create(0.9, 170.0, 172.0, 80.0, 60.0,
                                            (-0.1, 0.05, 0.0, 0.0), W, H),
}


@pytest.fixture(scope="module")
def camera_servers():
    """Both packages' servers at a small dense size, with no keyframes."""
    descs = multiagent.landmark_descriptors(40)
    voc = jvoc.train_vocabulary(descs, k=4, levels=2, seed=0)
    cfg = dataclasses.replace(jax_config(), dense=jest.DenseConfig(
        height=H, width=W, num_depths=16, dep_sample=(1.0 / 0.6 - 1.0 / 8.0) / 16,
        dtype="float32"))
    sj = jpipe.CollaborativeServer(voc, cfg)
    st = tpipe.CollaborativeServer(
        interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc), "cpu"),
        interop.pipeline_config_to_torch(cfg), device="cpu")
    yield sj, st
    st.close()


@pytest.mark.parametrize("kind", list(CLIENT_CAMERAS))
def test_set_client_camera(camera_servers, kind):
    """`set_client_camera` raises for no camera the JAX server takes: it
    installs the camera's K; an undistorted pinhole gets no remap grid; a
    radtan pinhole, an equidistant and a Mei camera get the JAX server's
    grid to 1e-3 px, as a tensor on the server's device; an image rendered
    through the camera is remapped as the reference remaps it (bilinear
    weights in float32: 1e-3 of 255)."""
    sj, st = camera_servers
    cid = list(CLIENT_CAMERAS).index(kind)
    cj = CLIENT_CAMERAS[kind]()
    ct = interop.camera_to_torch(jax.tree_util.tree_map(np.asarray, cj), "cpu")
    sj.set_client_camera(cid, cj)
    st.set_client_camera(cid, ct)
    np.testing.assert_array_equal(st._client_k[cid], sj._client_k[cid])
    eye = np.array([1.6, -2.2, 1.2])
    img, _ = render.render_textured_scene(ct, look_at(eye, np.array([1.5, 1.0, 0.5])), eye)
    if kind == "undistorted":
        assert cid not in st._undistort_grid and cid not in sj._undistort_grid
        np.testing.assert_array_equal(st._undistort(cid, img).numpy(), img)
        return
    grid = st._undistort_grid[cid]
    assert isinstance(grid, torch.Tensor) and grid.device == st.device
    assert grid.shape == (H, W, 2) and grid.dtype == torch.float32 and grid.is_contiguous()
    np.testing.assert_allclose(grid.numpy(), sj._undistort_grid[cid], atol=1e-3)
    # the grid moves pixels (by several at the corners), the centre stays
    ident = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).astype(np.float32)
    shift = np.linalg.norm(grid.numpy() - ident, axis=-1)
    assert shift.max() > 3.0 and shift[60, 80] < 0.05, (shift.max(), shift[60, 80])
    out = st._undistort(cid, img).numpy()
    np.testing.assert_allclose(out, np.asarray(sj._undistort(cid, img)), atol=1e-3 * 255)
    # a second call replaces the client's grid and K
    st.set_client_camera(cid, interop.camera_to_torch(
        jax.tree_util.tree_map(np.asarray, CLIENT_CAMERAS["undistorted"]()), "cpu"))
    assert cid in st._undistort_grid    # as in the reference: an old grid stays until replaced
    st.set_client_camera(cid, ct)


def test_dense_step_on_remapped_images(camera_servers):
    """One dense step on images rendered through a radtan camera and
    remapped by each server: reference and measurement through
    `_undistort`, `init_reference` and one `fuse_measurement` in each
    package. The filter's depth agrees to 1e-4 relative at >= 99.5 % of the
    pixels (this file's tolerance for published maps), and the remapped
    pair gives a much better photometric match than the raw pair, so the
    remap does something."""
    sj, st = camera_servers
    cid = 7
    cj = CLIENT_CAMERAS["radtan"]()
    ct = interop.camera_to_torch(jax.tree_util.tree_map(np.asarray, cj), "cpu")
    sj.set_client_camera(cid, cj)
    st.set_client_camera(cid, ct)
    target = np.array([1.5, 1.0, 0.5])
    eyes = [np.array([1.5, -2.2, 1.2]), np.array([1.62, -2.2, 1.2])]
    poses = [look_at(e, target) for e in eyes]
    raw = [render.render_textured_scene(ct, r, e)[0] for r, e in zip(poses, eyes)]
    pin = interop.camera_to_torch(
        jax.tree_util.tree_map(np.asarray, CLIENT_CAMERAS["undistorted"]()), "cpu")
    ideal = render.render_textured_scene(pin, poses[0], eyes[0])[0]
    rem_t = [st._undistort(cid, im) for im in raw]
    rem_j = [sj._undistort(cid, im) for im in raw]
    for a, b in zip(rem_t, rem_j):      # the same float32 expression in the same order
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-4)
    inner = (slice(15, -15), slice(20, -20))
    err_remap = np.abs(rem_t[0].numpy() - ideal)[inner].mean()
    err_raw = np.abs(raw[0] - ideal)[inner].mean()
    assert err_remap < 2.0 and err_raw > 4 * err_remap, (err_remap, err_raw)
    k = st._client_k[cid].astype(np.float64)
    r_mr = poses[1].T @ poses[0]
    t_mr = poses[1].T @ (eyes[0] - eyes[1])
    a_mat = (k @ r_mr @ np.linalg.inv(k)).astype(np.float32)
    b_vec = (k @ t_mr).astype(np.float32)
    jc, tc = sj.cfg.dense, st.cfg.dense
    js = jest.init_reference(jc, rem_j[0])
    # the reference's step runs eagerly, as in `both_servers`: compiled, XLA
    # reassociates the cost sums and 4 % of the pixels move beyond 1e-4
    js = jest.fuse_measurement.__wrapped__(jc, js, rem_j[1], jnp.asarray(a_mat),
                                           jnp.asarray(b_vec))
    ts = testimator.init_reference(tc, rem_t[0])
    with mock.patch.object(cuda_kernels, "projective_warp_banded",
                           lambda img, m: projective_warp_mxu(img, m)):
        ts = testimator.fuse_measurement(tc, ts, rem_t[1], torch.from_numpy(a_mat),
                                         torch.from_numpy(b_vec))
    mu_t, mu_j = ts.filt.mu.numpy(), np.asarray(js.filt.mu)
    agree = np.isclose(mu_t, mu_j, rtol=1e-4, atol=0.0).mean()
    assert agree >= 0.995, agree
    assert int(ts.num_frames) == int(js.num_frames) == 1


def small_port_vocabulary():
    descs = multiagent.landmark_descriptors(40)
    voc = jvoc.train_vocabulary(descs, k=4, levels=2, seed=0)
    return interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc), "cpu")

"""The whole collaborative server on the CPU: `test_pipeline.py`'s orbit of
the rendered room through `cvids_tpu`'s `CollaborativeServer` and through
the port's — keyframes with images, the pose graph, per-client dense depth,
TSDF fusion, the mesh — with the JAX key chain's RANSAC noise injected into
the port; the port's `AddDisturbance`; its camera guard. (One file, so the
JAX pipeline compiles once.)

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

from cvids_tpu.dense import estimator as jest
from cvids_tpu.geometry import ypr_to_r as jypr_to_r
from cvids_tpu.io import multiagent as jma
from cvids_tpu.mapping.tsdf import TsdfConfig as JTsdfConfig
from cvids_tpu.server import pipeline as jpipe
from cvids_tpu.server import posegraph as jpg
from cvids_tpu.server import vocab as jvoc
from cvids_tpu_torch import interop
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
    cam = render.Pinhole(100.0, 100.0, W / 2, H / 2, W, H)
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
    return fields, cam.k_matrix, jvoc.train_vocabulary(descs, k=5, levels=2, seed=0)


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


def test_set_client_camera():
    """An undistorted pinhole installs its K and no remap grid; other
    cameras wait for the camera models."""
    server = tpipe.CollaborativeServer(small_port_vocabulary(), tpipe.PipelineConfig(),
                                       device="cpu")
    cam = render.Pinhole(200.0, 210.0, 160.0, 120.0, 320, 240)
    server.set_client_camera(2, cam)
    np.testing.assert_array_equal(server._client_k[2], cam.k_matrix)
    assert not server._undistort_grid
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        server.set_client_camera(3, dataclasses.replace(cam, dist=(-0.28, 0.07, 0.0, 0.0)))
    assert 3 not in server._client_k


def small_port_vocabulary():
    descs = multiagent.landmark_descriptors(40)
    voc = jvoc.train_vocabulary(descs, k=4, levels=2, seed=0)
    return interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc), "cpu")

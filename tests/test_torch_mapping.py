"""The port's mapping modules against `cvids_tpu` on the CPU: the chunked
TSDF volume (`test_tsdf.py`'s 8-view sphere with carving on and off, pool
growth and drops, point-cloud fusion, `sdf_at`), marching tetrahedra, mesh
extraction and PLY, the relaxation smoother, checkpoints across the two
packages, the TSDF and pipeline-config converters of `interop`, and the
port's copies of the renderer and the tracer.

The JAX volume pads each frame's chunk batch with inactive copies of slot
0, and its scatter lets a stale copy win over slot 0's own update, so the
chunk in slot 0 never integrates in `cvids_tpu`; the port updates it. Most
comparisons below therefore keep slot 0 out of use in both volumes (one
`free.remove(0)` each), and `test_slot_zero_integrates` holds the port's
slot 0 to the JAX kernel run on unpadded batches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.camera import PinholeCamera
from cvids_tpu.io import multiagent as jma
from cvids_tpu.io import render as jrender
from cvids_tpu.io.synthetic import Trajectory as JTrajectory
from cvids_tpu.mapping import mesh as jmesh
from cvids_tpu.mapping import tsdf as jtsdf
from cvids_tpu.ops import marching_cubes as jmc
from cvids_tpu.server import optimizer as jopt
from cvids_tpu.server import pipeline as jpipe
from cvids_tpu.server import posegraph as jpg
from cvids_tpu.server import vocab as jvoc
from cvids_tpu.server.smooth_optimizer import smooth_euler_relax as jrelax
from cvids_tpu.utils import checkpoint as jckpt
from cvids_tpu.utils import tracing as jtracing
from cvids_tpu_torch import interop
from cvids_tpu_torch.io import multiagent
from cvids_tpu_torch.io import render
from cvids_tpu_torch.io.synthetic import Trajectory
from cvids_tpu_torch.mapping import mesh, tsdf
from cvids_tpu_torch.ops import marching_cubes
from cvids_tpu_torch.server import pipeline as tpipe
from cvids_tpu_torch.server import posegraph as tpg
from cvids_tpu_torch.server.smooth_optimizer import smooth_euler_relax
from cvids_tpu_torch.utils import checkpoint, tracing
from test_posegraph_opt import simulate_drifting_chain
from test_tsdf import H, K, W, look_at, render_sphere_depth

# sdf and color: the same fp32 operations, but XLA may fuse or reorder them
SDF_ATOL = 1e-5


def sphere_frames():
    """`test_tsdf.sphere_volume`'s 8 views of a 0.4 m sphere at 60x80."""
    center = np.array([0.0, 0.0, 1.0])
    for ang in np.linspace(0, 2 * np.pi, 8, endpoint=False):
        eye = center + 1.8 * np.array([np.cos(ang), np.sin(ang), 0.3])
        r_wc = look_at(eye, center)
        depth = np.nan_to_num(render_sphere_depth(center, 0.4, r_wc, eye), nan=0.0)
        yield depth, np.full((H, W, 3), 128.0), K, r_wc.astype(np.float32), eye.astype(np.float32)


def volumes(reserve_slot0=True, **kwargs):
    """A JAX volume and the port's, with the same config."""
    jv = jtsdf.TsdfVolume(jtsdf.TsdfConfig(**kwargs))
    tv = tsdf.TsdfVolume(tsdf.TsdfConfig(**kwargs), device="cpu")
    if reserve_slot0:
        jv.free.remove(0)
        tv.free.remove(0)
    return jv, tv


def assert_same_volume(jv, tv, rtol=0.0):
    """Same allocation and tables; weights exact; sdf and color within
    SDF_ATOL (and `rtol` relative)."""
    assert tv.slot_of == jv.slot_of and list(tv.slot_of) == list(jv.slot_of)
    assert tv.capacity == jv.capacity and tv.pool.sdf.shape[0] == tv.capacity
    np.testing.assert_array_equal(tv.coords_np, jv.coords_np)
    np.testing.assert_array_equal(tv.occupied_np, jv.occupied_np)
    assert tv.free == jv.free and tv.dirty == jv.dirty
    assert tv.dropped_chunks == jv.dropped_chunks
    np.testing.assert_array_equal(tv.pool.weight.numpy(), np.asarray(jv.pool.weight))
    for name in ("sdf", "color"):
        np.testing.assert_allclose(getattr(tv.pool, name).numpy(),
                                   np.asarray(getattr(jv.pool, name)),
                                   atol=SDF_ATOL, rtol=rtol, err_msg=name)


@pytest.fixture(scope="module")
def sphere_pair():
    jv, tv = volumes(voxel_size=0.05, capacity=2048, carving=True)
    for frame in sphere_frames():
        jv.integrate(*frame)
        tv.integrate(*frame)
    return jv, tv


@pytest.mark.parametrize("carving", [True, False])
def test_sphere_integration_matches_jax(sphere_pair, carving):
    if carving:
        jv, tv = sphere_pair
    else:
        jv, tv = volumes(voxel_size=0.05, capacity=2048, carving=False)
        for frame in sphere_frames():
            jv.integrate(*frame)
            tv.integrate(*frame)
    assert len(tv.slot_of) > 20
    assert_same_volume(jv, tv)
    # sdf_at: the nearest-voxel lookup around the surface
    pts = np.random.default_rng(0).uniform([-0.6, -0.6, 0.4], [0.6, 0.6, 1.6], (500, 3))
    (sj, wj), (st, wt) = jv.sdf_at(pts), tv.sdf_at(pts)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_allclose(st, sj, atol=SDF_ATOL)
    assert (wt > 0).mean() > 0.1


def test_slot_zero_integrates():
    """Without the reservation the port's volume equals the JAX kernel run
    on each frame's chunks unpadded (the JAX host's allocation, one
    `_integrate_kernel` call per frame), slot 0 included; the JAX volume
    itself leaves slot 0 unintegrated."""
    cfg = dict(voxel_size=0.05, capacity=2048, carving=True)
    jv, tv = volumes(reserve_slot0=False, **cfg)
    ref = jtsdf.TsdfVolume(jtsdf.TsdfConfig(**cfg))
    for depth, color, k, r_wc, t_wc in sphere_frames():
        jv.integrate(depth, color, k, r_wc, t_wc)
        tv.integrate(depth, color, k, r_wc, t_wc)
        slots = ref._alloc(ref._touched_chunks(depth, k, r_wc, t_wc))
        ref.pool = jtsdf._integrate_kernel(
            ref.cfg, ref.pool, jnp.asarray(slots), jnp.asarray(ref.coords_np[slots]),
            jnp.ones(len(slots), bool), jnp.asarray(depth, jnp.float32),
            jnp.asarray(color, jnp.float32), jnp.asarray(k), jnp.asarray(r_wc.T),
            jnp.asarray(-r_wc.T @ t_wc))
    assert ref.slot_of == tv.slot_of == jv.slot_of
    np.testing.assert_array_equal(tv.pool.weight.numpy(), np.asarray(ref.pool.weight))
    np.testing.assert_allclose(tv.pool.sdf.numpy(), np.asarray(ref.pool.sdf), atol=SDF_ATOL)
    assert tv.pool.weight[0].sum() > 0 and float(jnp.sum(jv.pool.weight[0])) == 0.0


@pytest.mark.parametrize("max_capacity", [None, 16])
def test_pool_growth_and_drops_match_jax(max_capacity):
    """`test_tsdf`'s flat wall from a 16-chunk pool: the same doubling tiers
    (unbounded) or the same dropped-chunk count (capped at 16)."""
    jv, tv = volumes(voxel_size=0.05, capacity=16, max_capacity=max_capacity)
    for v in (jv, tv):
        v.integrate(np.full((H, W), 1.0), np.zeros((H, W, 3)), K,
                    np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    assert_same_volume(jv, tv)
    if max_capacity is None:
        assert tv.capacity > 16 and tv.dropped_chunks == 0
    else:
        assert tv.capacity == 16 and tv.dropped_chunks > 0


def test_integrate_points_matches_jax():
    """`test_tsdf.test_point_cloud_fusion_mode`'s plane, three times. The
    scatter-adds may sum in another order: sdf and color within 1e-5
    relative; weights (sums of ±1 and 0.5) exact."""
    jv, tv = volumes(reserve_slot0=False, voxel_size=0.1, capacity=512, carving=True)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-1.0, 1.0, 4000), rng.uniform(-1.0, 1.0, 4000),
                    np.zeros(4000)], -1)
    cols = rng.uniform(0, 255, (4000, 3))
    for _ in range(3):
        for v in (jv, tv):
            v.integrate_points(pts, cols, np.array([0.0, 0.0, 1.0]))
    assert_same_volume(jv, tv, rtol=1e-5)
    probe = np.stack([rng.uniform(-0.5, 0.5, 64), rng.uniform(-0.5, 0.5, 64),
                      np.full(64, 0.15)], -1)
    (sj, wj), (st, wt) = jv.sdf_at(probe), tv.sdf_at(probe)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_allclose(st, sj, atol=SDF_ATOL, rtol=1e-5)


def test_marching_tets_matches_jax():
    """Random (B, 9, 9, 9) blocks, a fifth of the weights zero: the same
    validity masks; vertices, colors and normals within 1e-5."""
    rng = np.random.default_rng(3)
    b, n = 6, 9
    sdf = rng.uniform(-1, 1, (b, n, n, n)).astype(np.float32)
    wgt = (rng.random((b, n, n, n)) > 0.2).astype(np.float32) * 3.0
    col = rng.uniform(0, 255, (b, n, n, n, 3)).astype(np.float32)
    origin = rng.uniform(-2, 2, (b, 3)).astype(np.float32)
    ref = jax.vmap(lambda s, w, o, c: jmc.marching_tets(s, w, o, 0.1, c))(
        jnp.asarray(sdf), jnp.asarray(wgt), jnp.asarray(origin), jnp.asarray(col))
    out = marching_cubes.marching_tets(torch.from_numpy(sdf), torch.from_numpy(wgt),
                                       torch.from_numpy(origin), 0.1, torch.from_numpy(col))
    (vj, okj, cj, nj), (vt, okt, ct, nt) = ref, out
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.sum() > 100
    for name, a, r in (("verts", vt, vj), ("colors", ct, cj), ("normals", nt, nj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(marching_cubes.TET_TABLE, jmc.TET_TABLE)


def test_mesh_and_ply_match_jax(sphere_pair, tmp_path):
    """The sphere's mesh: the same triangles in the same order within 1e-5;
    either package's `write_ply` writes the same bytes, and `read_ply`
    reads them back."""
    jv, tv = sphere_pair
    vj, cj, nj = jmesh.extract_mesh(jv)
    vt, ct, nt = mesh.extract_mesh(tv, batch=7)     # several batches, ragged
    assert len(vt) == len(vj) > 200
    for name, a, r in (("verts", vt, vj), ("colors", ct, cj), ("normals", nt, nj)):
        assert a.dtype == np.float32 and a.shape == r.shape, name
        np.testing.assert_allclose(a, r, atol=1e-5, err_msg=name)
    pj, pt = tmp_path / "jax.ply", tmp_path / "port.ply"
    for with_extras in (True, False):
        extras = (cj, nj) if with_extras else (None, None)
        jmesh.write_ply(str(pj), vj, *extras)
        mesh.write_ply(str(pt), vj, *extras)
        assert pt.read_bytes() == pj.read_bytes()
    mesh.write_ply(str(pt), vt, ct, nt)
    v2, t, n2 = mesh.read_ply(str(pt))
    assert t == len(vt)
    np.testing.assert_array_equal(v2, vt.reshape(-1, 3))
    np.testing.assert_array_equal(n2, nt.reshape(-1, 3))
    empty = mesh.extract_mesh(tsdf.TsdfVolume(tsdf.TsdfConfig(capacity=8), device="cpu"))
    assert all(x.shape == (0, 3, 3) for x in empty)


def test_smooth_relax_matches_jax(rng):
    """`test_extras.test_smooth_relax_reduces_error`'s drifting chain with
    one exact loop edge: the port's nodes within 1e-5 of the JAX ones, and
    the loop error shrinks."""
    n = 40
    yaw_gt, t_gt, yaw_est, t_est = simulate_drifting_chain(rng, n)
    nodes = jopt.PoseGraphNodes(
        yaw=jnp.asarray(yaw_est, jnp.float32), pr=jnp.zeros((n, 2), jnp.float32),
        t=jnp.asarray(t_est, jnp.float32), valid=jnp.ones(n, bool),
        fixed=jnp.arange(n) == 0)
    seq = jopt.make_sequential_edges(nodes.yaw, nodes.pr, nodes.t,
                                     jnp.zeros(n, jnp.int32), nodes.valid)
    r0 = np.array([[np.cos(yaw_gt[0]), -np.sin(yaw_gt[0]), 0],
                   [np.sin(yaw_gt[0]), np.cos(yaw_gt[0]), 0], [0, 0, 1]])
    loops = jopt.PoseGraphEdges(
        i=jnp.asarray([0]), j=jnp.asarray([n - 1]),
        t_ij=jnp.asarray((r0.T @ (t_gt[-1] - t_gt[0]))[None], jnp.float32),
        yaw_ij=jnp.asarray([yaw_gt[-1] - yaw_gt[0]], jnp.float32),
        t_weight=jnp.asarray([10.0]), yaw_weight=jnp.asarray([10.0]),
        valid=jnp.ones(1, bool), huber=jnp.asarray([np.inf], jnp.float32))
    edges = jopt.PoseGraphEdges(*[jnp.concatenate([a, b]) for a, b in zip(seq, loops)])
    ref = jrelax(nodes, edges, sweeps=30, mix=0.7)
    as_np = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    out = smooth_euler_relax(interop.nodes_to_torch(as_np(nodes), "cpu"),
                             interop.edges_to_torch(as_np(edges), "cpu"), sweeps=30, mix=0.7)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-5)
    np.testing.assert_allclose(out.yaw.numpy(), np.asarray(ref.yaw), atol=1e-5)
    assert np.linalg.norm(out.t.numpy()[-1] - t_gt[-1]) < np.linalg.norm(t_est[-1] - t_gt[-1])


# ---------- checkpoints across the packages ----------


def server_pair(tree: bool):
    """`test_utils.test_server_checkpoint_roundtrip`'s one-agent stream
    through a JAX server and the port's (dense or tree vocabulary)."""
    rng = np.random.default_rng(0)
    n_lm = 120
    landmarks = np.stack([rng.uniform(-10, 10, n_lm), rng.uniform(-10, 10, n_lm),
                          rng.uniform(0.2, 3, n_lm)], -1)
    descs = multiagent.landmark_descriptors(n_lm)
    voc = jvoc.train_vocabulary(descs, k=5, levels=2, seed=0)
    if tree:
        voc_j = jvoc.tree_from_trained(voc)
        voc_t = interop.tree_vocabulary_to_torch(voc_j)
    else:
        voc_j = voc
        voc_t = interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc), "cpu")

    def cfg(mod):
        return mod.ServerConfig(kf_capacity=64, max_win=32, max_ext=64, max_loops=32,
                                optimize_every=10000)

    pj, _ = jma.generate_packets([jma.AgentSim(JTrajectory.circle(radius=4.0, omega=0.5))],
                                 landmarks, descs, duration=5.0, kf_rate=1.0, max_feats=30)
    pt, _ = multiagent.generate_packets(
        [multiagent.AgentSim(Trajectory.circle(radius=4.0, omega=0.5))],
        landmarks, descs, duration=5.0, kf_rate=1.0, max_feats=30)
    sj = jpg.CollaborativePoseGraph(voc_j, cfg(jpg))
    st = tpg.CollaborativePoseGraph(voc_t, cfg(tpg), device="cpu")
    for s, packets in ((sj, pj), (st, pt)):
        for _, _, _, pkt in packets:
            s.add_keyframe(pkt)
    fresh = (lambda: jpg.CollaborativePoseGraph(voc_j, cfg(jpg)),
             lambda: tpg.CollaborativePoseGraph(voc_t, cfg(tpg), device="cpu"))
    return sj, st, fresh, pt[-1][3]


def assert_same_server(a, b):
    """Every store, loop and database array, the counts and the clients."""
    for f in checkpoint._STORE_FIELDS:
        np.testing.assert_array_equal(getattr(a.store, f), getattr(b.store, f), err_msg=f)
    for f in checkpoint._LOOP_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for f in ("vectors", "ids", "vals", "client", "client_dev"):
        if hasattr(a.db, f):
            np.testing.assert_array_equal(np.asarray(getattr(a.db, f)),
                                          np.asarray(getattr(b.db, f)), err_msg=f)
    assert (a.store.count, a.loop_count, a.db.count, a.world_client) == \
        (b.store.count, b.loop_count, b.db.count, b.world_client)
    for ca, cb in zip(a.clients, b.clients):
        for f in ("registered", "aligned", "yaw_wl", "yaw_drift", "kf_count"):
            assert getattr(ca, f) == getattr(cb, f), f
        for f in ("t_wl", "t_drift", "r_cb", "p_bc"):
            np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f), err_msg=f)


@pytest.mark.parametrize("tree", [False, True], ids=["dense", "tree"])
def test_server_checkpoint_crosses_packages(tmp_path, tree):
    """A JAX server's checkpoint loads into the port's server and a port
    server's into JAX's, array for array; the restored port server goes on
    ingesting."""
    sj, st, (fresh_j, fresh_t), last = server_pair(tree)
    jckpt.save_server(str(tmp_path / "jax.npz"), sj)
    checkpoint.save_server(str(tmp_path / "port.npz"), st)
    into_t, into_j = fresh_t(), fresh_j()
    checkpoint.load_server(str(tmp_path / "jax.npz"), into_t)
    jckpt.load_server(str(tmp_path / "port.npz"), into_j)
    assert_same_server(into_t, sj)
    assert_same_server(into_j, st)
    assert into_t.add_keyframe(last)["index"] == sj.store.count


def test_tsdf_checkpoint_crosses_packages(sphere_pair, tmp_path):
    jv, tv = sphere_pair
    jckpt.save_tsdf(str(tmp_path / "jax.npz"), jv)
    checkpoint.save_tsdf(str(tmp_path / "port.npz"), tv)
    into_t = tsdf.TsdfVolume(tsdf.TsdfConfig(voxel_size=0.05, capacity=16), device="cpu")
    into_j = jtsdf.TsdfVolume(jtsdf.TsdfConfig(voxel_size=0.05, capacity=16))
    checkpoint.load_tsdf(str(tmp_path / "jax.npz"), into_t)
    jckpt.load_tsdf(str(tmp_path / "port.npz"), into_j)
    for a, b in ((into_t, jv), (into_j, tv)):
        assert a.slot_of == b.slot_of and a.capacity == b.capacity and a.free == b.free
        np.testing.assert_array_equal(a.coords_np, b.coords_np)
        np.testing.assert_array_equal(a.occupied_np, b.occupied_np)
        for x, y in zip(a.pool, b.pool):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------- interop ----------


def test_tsdf_volume_interop_round_trip(sphere_pair):
    """JAX volume -> port -> numpy -> JAX volume: the pool and every host
    table survive; the carried port volume goes on integrating as the JAX
    one does."""
    jv, tv = sphere_pair
    carried = interop.tsdf_volume_to_torch(jv, "cpu")
    assert carried.cfg == tv.cfg
    assert_same_volume(jv, carried)
    back = interop.tsdf_volume_to_numpy(carried)
    assert back.cfg == dataclasses.asdict(jv.cfg)
    jv2 = jtsdf.TsdfVolume(jtsdf.TsdfConfig(**back.cfg))
    for name, value in vars(back).items():
        if name != "cfg":
            setattr(jv2, name, value)
    jv2.pool = jtsdf.ChunkPool(*map(jnp.asarray, back.pool))
    assert_same_volume(jv2, carried)
    frame = next(sphere_frames())
    jv2.integrate(*frame)
    carried.integrate(*frame)
    assert_same_volume(jv2, carried)


def test_pipeline_config_interop():
    cfg = jpipe.PipelineConfig(
        server=jpg.ServerConfig(kf_capacity=64, max_win=32, async_optimize=True),
        dense=jpipe.estimator.DenseConfig(height=120, width=160, num_depths=48,
                                          dtype="float32"),
        tsdf=jtsdf.TsdfConfig(voxel_size=0.12, carving=False, max_capacity=64),
        min_fused_frames=3, ref_advance=4, disturbance_after=10)
    out = interop.pipeline_config_to_torch(cfg)
    assert isinstance(out, tpipe.PipelineConfig)
    assert dataclasses.asdict(out) == dataclasses.asdict(cfg)


# ---------- host copies ----------


@pytest.mark.parametrize("distorted", [False, True])
def test_render_copy_matches_jax(distorted):
    """The port's renderer gives the same intensity and depth, bit for bit,
    from several poses, for a pinhole camera with and without radtan
    distortion; `sample_scene_landmarks` gives the same points from one
    seed."""
    dist = (-0.28, 0.07, 1e-4, -2e-4) if distorted else (0.0, 0.0, 0.0, 0.0)
    jcam = PinholeCamera.create(100.0, 100.0, 80.0, 60.0, dist, 160, 120)
    # the JAX camera keeps its coefficients in float32
    tcam = interop.camera_to_torch(jax.tree_util.tree_map(np.asarray, jcam), "cpu")
    np.testing.assert_array_equal(tcam.k_matrix.numpy(), np.asarray(jcam.k_matrix))
    target = np.array([1.5, 1.0, 0.5])
    for ang in (-0.6, 0.0, 0.5):
        eye = np.array([1.5 + 1.5 * np.sin(ang), -2.2, 1.2])
        r_wc = look_at(eye, target)
        for a, b in zip(render.render_textured_scene(tcam, r_wc, eye),
                        jrender.render_textured_scene(jcam, r_wc, eye)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        render.sample_scene_landmarks(300, np.random.default_rng(4)),
        jrender.sample_scene_landmarks(300, np.random.default_rng(4)))


def test_tracer_copy_matches_jax():
    """The same spans and counts as the JAX tracer; the port also keeps
    each span's samples and can open profiler ranges."""
    tj, tt = jtracing.Tracer(), tracing.Tracer(use_profiler=True)
    for t in (tj, tt):
        for name in ("ingest", "depth", "ingest", "fuse"):
            with t.span(name):
                pass
        t.count("loops", 3)
    assert dict(tt.counts) == dict(tj.counts)
    assert set(tt.totals) == set(tj.totals)
    assert [len(v) for v in tt.samples.values()] == [2, 1, 1]
    assert tt.report().splitlines()[0].split(":")[0].strip() in tt.totals
    tt.reset()
    assert not tt.totals and not tt.samples and tt.mean_ms("ingest") == 0.0

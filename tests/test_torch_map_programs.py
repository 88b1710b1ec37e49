"""The published map's programs on the port against the JAX package's, on
the CPU: the TSDF integrate (`cuda_kernels.tsdf_integrate_twin`, the plain
version of the hand kernel `csrc/tsdf_integrate.cu`, against
`cvids_tpu.mapping.tsdf._integrate_kernel`), the fixed-shape chunk walk
(`mapping.tsdf.walk_keys` through `TsdfVolume._touched_chunks`, against
the JAX volume's numpy walk) and the padded mesh batch
(`mapping.mesh.extract_mesh` with its vectorised neighbour table, against
the JAX package's), with the kernel's work and launch plan.

Inputs are made with numpy from seeds and handed to both packages. sdf and
colour within `SDF_ATOL` (`test_torch_mapping.py`'s: the same fp32
operations, but XLA may order the two 3x3 products' sums otherwise);
weights, chunk arrays and triangle counts exact. ~20 s on one core.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvids_tpu.mapping import mesh as jmesh
from cvids_tpu.mapping import tsdf as jtsdf
from cvids_tpu_torch.mapping import mesh, tsdf
from cvids_tpu_torch.ops import cuda_kernels as ck
from test_torch_mapping import SDF_ATOL, sphere_frames, volumes

H, W = 60, 80
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)


def _rotation(rng, scale=0.3) -> np.ndarray:
    """A random rotation near the identity (Rodrigues of a small vector)."""
    w = rng.normal(0.0, scale, 3)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _frame(rng, h=H, w=W, holes=0.1):
    """A depth map (a tilted, rippled wall at ~1-3 m with holes and a few
    depths past max_depth), a colour image and a camera -> world pose."""
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = 1.2 + 1.5 * uu / w + 0.3 * np.sin(vv / 7.0) + rng.normal(0, 0.01, (h, w))
    depth[rng.random((h, w)) < holes] = 0.0
    depth[rng.random((h, w)) < 0.01] = 25.0
    color = rng.uniform(0, 255, (h, w, 3))
    return (depth.astype(np.float32), color.astype(np.float32),
            _rotation(rng).astype(np.float32), rng.normal(0, 0.2, 3).astype(np.float32))


def _chunks(rng, cfg, depth, r_wc, t_wc, m):
    """m distinct chunk coordinates: chunks the frame's walk touches, then
    chunks behind the camera and far off it (no voxel of them in the
    image)."""
    vol = tsdf.TsdfVolume(cfg, device="cpu")
    touched = vol._touched_chunks(depth, K, r_wc, t_wc)
    chunk = cfg.voxel_size * cfg.chunk_size
    behind = np.floor((t_wc - 2.0 * r_wc[:, 2]) / chunk).astype(np.int32)
    off = [behind + np.array([i, 0, 0], np.int32) for i in range(3)]
    off += [np.array([400 + i, -300, 250], np.int32) for i in range(3)]
    coords = np.unique(np.concatenate([touched, np.stack(off)]), axis=0)
    rng.shuffle(coords)
    assert len(coords) >= m
    # at least the off-image ones and as many touched ones as fit
    keep = [c for c in coords if any((c == o).all() for o in off)][:max(0, m - 1)]
    keep += [c for c in coords if not any((c == o).all() for o in off)][:m - len(keep)]
    return np.stack(keep).astype(np.int32)


def _pool(rng, capacity, s):
    """A pool mid-run: a third of the voxels never seen, the rest with
    weights in (0, 100] (some at the cap) and sdf within the band."""
    shape = (capacity, s, s, s)
    wgt = rng.uniform(0.5, 100.0, shape).astype(np.float32)
    wgt[rng.random(shape) < 0.33] = 0.0
    wgt[rng.random(shape) < 0.05] = 100.0
    sdf = rng.uniform(-0.1, 0.1, shape).astype(np.float32)
    col = rng.uniform(0, 255, shape + (3,)).astype(np.float32)
    return sdf, wgt, col


def _both_integrate(cfg_kw, m, seed, slot0=False, stride0=False):
    """One frame into m chunks through the JAX kernel and the port's twin,
    from the same pool; returns (jax pool, port pool, slots) as numpy."""
    rng = np.random.default_rng(seed)
    cfg_t, cfg_j = tsdf.TsdfConfig(**cfg_kw), jtsdf.TsdfConfig(**cfg_kw)
    depth, color, r_wc, t_wc = _frame(rng)
    if stride0:         # the server's colour: its grey image on three channels
        color = np.repeat(color[..., :1], 3, -1)
    coords = _chunks(rng, cfg_t, depth, r_wc, t_wc, m)
    capacity = m + 9
    slots = rng.permutation(capacity)[:m].astype(np.int64)
    if slot0 and 0 not in slots:
        slots[m // 2] = 0
    pool = _pool(rng, capacity, cfg_t.chunk_size)
    r_cw = np.ascontiguousarray(r_wc.T)
    t_cw = (-r_wc.T @ t_wc).astype(np.float32)
    jp = jtsdf._integrate_kernel(cfg_j, jtsdf.ChunkPool(*(jnp.asarray(a) for a in pool)),
                                 jnp.asarray(slots.astype(np.int32)), jnp.asarray(coords),
                                 jnp.ones(m, bool), jnp.asarray(depth), jnp.asarray(color),
                                 jnp.asarray(K), jnp.asarray(r_cw), jnp.asarray(t_cw))
    tp = tsdf.ChunkPool(*(torch.from_numpy(a.copy()) for a in pool))
    color_t = (torch.from_numpy(color[..., 0].copy())[..., None].expand(-1, -1, 3)
               if stride0 else torch.from_numpy(color))
    ck.tsdf_integrate_twin(cfg_t, tp, torch.from_numpy(slots), torch.from_numpy(coords),
                           torch.from_numpy(depth), color_t, torch.from_numpy(K),
                           torch.from_numpy(r_cw), torch.from_numpy(t_cw))
    return [np.asarray(a) for a in jp], [a.numpy() for a in tp], slots, pool


INTEGRATE_CASES = {
    "carving": (dict(voxel_size=0.05), 65, {}),
    "no carving": (dict(voxel_size=0.05, carving=False), 63, {}),
    "trunc_quad": (dict(voxel_size=0.05, trunc_quad=0.02), 65, {}),
    "one chunk": (dict(voxel_size=0.05), 1, {}),
    "300 chunks": (dict(voxel_size=0.02), 300, {}),
    "slot 0": (dict(voxel_size=0.05), 63, dict(slot0=True)),
    "stride-0 colour": (dict(voxel_size=0.05), 65, dict(stride0=True)),
    "chunks of 5": (dict(voxel_size=0.05, chunk_size=5), 65, {}),
}


@pytest.mark.parametrize("case", sorted(INTEGRATE_CASES))
def test_integrate_twin_matches_jax(case):
    """The twin against `_integrate_kernel` on all-active chunks (no
    padding, so no slot-0 loss: the JAX volume's padded batches lose slot
    0's frame, the port's one departure, `test_slot_zero_integrates`).
    Weights exact; sdf and colour within SDF_ATOL."""
    cfg_kw, m, kw = INTEGRATE_CASES[case]
    (js, jw, jc), (ts, tw, tc), slots, (s0, w0, c0) = _both_integrate(cfg_kw, m, 7, **kw)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_allclose(ts, js, atol=SDF_ATOL, rtol=0)
    np.testing.assert_allclose(tc, jc, atol=SDF_ATOL, rtol=1e-6)
    # the chunks outside `slots` are untouched; a touched frame updates some
    others = np.setdiff1d(np.arange(len(w0)), slots)
    np.testing.assert_array_equal(tw[others], w0[others])
    np.testing.assert_array_equal(ts[others], s0[others])
    changed = (tw != w0).any(axis=(1, 2, 3))
    if m > 1:
        assert changed.sum() >= min(10, m // 2)


def test_integrate_twin_leaves_off_image_chunks():
    """Chunks behind the camera and far away: no voxel of them projects
    into the image, so nothing changes."""
    rng = np.random.default_rng(11)
    cfg = tsdf.TsdfConfig(voxel_size=0.05)
    depth, color, r_wc, t_wc = _frame(rng)
    chunk = cfg.voxel_size * cfg.chunk_size
    behind = np.floor((t_wc - 2.0 * r_wc[:, 2]) / chunk).astype(np.int32)
    coords = np.stack([behind, behind + 1, np.array([400, -300, 250], np.int32)])
    sdf, wgt, col = _pool(rng, 3, cfg.chunk_size)
    pool = tsdf.ChunkPool(*(torch.from_numpy(a.copy()) for a in (sdf, wgt, col)))
    ck.tsdf_integrate_twin(cfg, pool, torch.arange(3), torch.from_numpy(coords),
                           torch.from_numpy(depth), torch.from_numpy(color),
                           torch.from_numpy(K), torch.from_numpy(np.ascontiguousarray(r_wc.T)),
                           torch.from_numpy(-r_wc.T @ t_wc))
    for a, b in zip(pool, (sdf, wgt, col)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_integrate_chunks_routes_cpu_batches():
    """`integrate_chunks` on CPU tensors runs the twin, which passes over
    its chunks `batch` at a time: any batch gives the one-batch result bit
    for bit. A tensor on a device that is neither raises."""
    rng = np.random.default_rng(3)
    cfg = tsdf.TsdfConfig(voxel_size=0.05)
    depth, color, r_wc, t_wc = _frame(rng)
    coords = torch.from_numpy(_chunks(rng, cfg, depth, r_wc, t_wc, 40))
    base = _pool(rng, 50, cfg.chunk_size)
    slots = torch.from_numpy(rng.permutation(50)[:40].astype(np.int64))
    args = (torch.from_numpy(depth), torch.from_numpy(color), torch.from_numpy(K),
            torch.from_numpy(np.ascontiguousarray(r_wc.T)), torch.from_numpy(-r_wc.T @ t_wc))
    out = []
    for batch in (None, 1024, 7):
        pool = tsdf.ChunkPool(*(torch.from_numpy(a.copy()) for a in base))
        if batch is None:
            tsdf.integrate_chunks(cfg, pool, slots, coords, *args)
        else:
            ck.tsdf_integrate_twin(cfg, pool, slots, coords.to(torch.int32), *args, batch=batch)
        out.append(pool)
    for other in out[1:]:
        for a, b in zip(out[0], other):
            assert torch.equal(a, b)
    assert (out[0].weight.numpy() != base[1]).any()
    with pytest.raises(ValueError):
        tsdf.integrate_chunks(cfg, out[0], slots.to("meta"), coords, *args)


# ---------------------------------------------------------------------------
# The chunk walk
# ---------------------------------------------------------------------------


def _walks(cfg_kw, depth, r_wc, t_wc, k=K):
    jv = jtsdf.TsdfVolume(jtsdf.TsdfConfig(capacity=8, **cfg_kw))
    tv = tsdf.TsdfVolume(tsdf.TsdfConfig(capacity=8, **cfg_kw), device="cpu")
    return jv._touched_chunks(depth, k, r_wc, t_wc), tv._touched_chunks(depth, k, r_wc, t_wc)


WALK_CASES = {
    "defaults": dict(),
    "fine voxels": dict(voxel_size=0.02),
    "no carving": dict(voxel_size=0.05, carving=False),
    "trunc_quad": dict(voxel_size=0.05, trunc_quad=0.05),
    "near range": dict(voxel_size=0.05, min_depth=0.5, max_depth=2.2),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_matches_jax(case, seed):
    """The fixed-shape walk names the JAX walk's chunks, in its order."""
    rng = np.random.default_rng(100 + seed)
    depth, _, r_wc, t_wc = _frame(rng, holes=0.2)
    want, got = _walks(WALK_CASES[case], depth, r_wc, t_wc)
    assert got.dtype == np.int32 and got.shape[1] == 3 and len(got) > 20
    np.testing.assert_array_equal(got, want)


def test_walk_matches_jax_on_float64_poses_and_a_larger_image():
    """A float64 pose and K (the server passes float64), 120x160 with a
    4x-ragged edge (118 x 157)."""
    rng = np.random.default_rng(5)
    depth, _, r_wc, t_wc = _frame(rng, 118, 157)
    k = np.array([[115.25, 0, 78.5], [0, 115.25, 59.0], [0, 0, 1]])
    want, got = _walks({}, depth, r_wc.astype(np.float64), t_wc.astype(np.float64) + 0.013, k)
    np.testing.assert_array_equal(got, want)


def test_walk_of_an_invalid_depth_is_empty():
    depth = np.zeros((H, W), np.float32)
    depth[::2] = 50.0                       # past max_depth
    depth[1::4] = np.nan
    want, got = _walks({}, depth, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    assert want.shape == got.shape == (0, 3) and got.dtype == np.int32


def test_walk_of_a_surface_but_no_carving_ray():
    """Valid depth only off the carving grid (every 16th pixel): the band
    is walked, the march has no ray."""
    depth = np.zeros((H, W), np.float32)
    depth[4::16, 4::16] = 1.7
    want, got = _walks({}, depth, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("side", ["under", "over"])
def test_walk_march_count_at_an_integer(side):
    """The farthest depth puts (max_d - min_depth) / step just under or
    just over an integer: the march's sample count is np.arange's."""
    cfg = tsdf.TsdfConfig(voxel_size=0.05)
    step = cfg.voxel_size * cfg.chunk_size * 0.8
    exact = np.float32(cfg.min_depth + 7 * step)
    far = np.nextafter(exact, np.float32(0 if side == "under" else 100))
    while (side == "under") != ((float(far) - cfg.min_depth) / step < 7):
        far = np.nextafter(far, np.float32(0 if side == "under" else 100))
    assert len(np.arange(cfg.min_depth, float(far), step)) == (7 if side == "under" else 8)
    depth = np.full((H, W), 1.0, np.float32)
    depth[16, 32] = far                     # on the carving grid
    rng = np.random.default_rng(9)
    want, got = _walks(dict(voxel_size=0.05), depth, _rotation(rng).astype(np.float32),
                       np.zeros(3, np.float32))
    np.testing.assert_array_equal(got, want)


def test_carving_march_is_numpys_arange():
    """The march's depths are np.arange's values for any farthest depth."""
    cfg = tsdf.TsdfConfig()
    march = tsdf.carving_march(cfg)
    step = cfg.voxel_size * cfg.chunk_size * 0.8
    for far in np.random.default_rng(0).uniform(cfg.min_depth, cfg.max_depth, 200):
        far = float(np.float32(far))
        want = np.arange(cfg.min_depth, far, step)
        np.testing.assert_array_equal(march[:len(want)], want)


def test_integrate_takes_a_tensor_depth():
    """A depth tensor and its numpy copy give the same volume."""
    rng = np.random.default_rng(4)
    depth, color, r_wc, t_wc = _frame(rng)
    vols = [tsdf.TsdfVolume(tsdf.TsdfConfig(voxel_size=0.05, capacity=256), device="cpu")
            for _ in range(2)]
    vols[0].integrate(depth, color, K, r_wc, t_wc)
    vols[1].integrate(torch.from_numpy(depth), color, K, r_wc, t_wc)
    assert vols[0].slot_of == vols[1].slot_of
    for a, b in zip(vols[0].pool, vols[1].pool):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The mesh batch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sphere_pair():
    """`test_torch_mapping`'s sphere, slot 0 reserved (the JAX volume loses
    its frames), without carving."""
    jv, tv = volumes(voxel_size=0.05, capacity=2048, carving=False)
    for frame in sphere_frames():
        jv.integrate(*frame)
        tv.integrate(*frame)
    return jv, tv


def _neighbour_slots_loop(vol, chunks):
    """The dict lookup that `_neighbour_slots` vectorises."""
    table = np.full((len(chunks), 8), -1, np.int64)
    for i, c in enumerate(chunks):
        for n in range(8):
            table[i, n] = vol.slot_of.get((c[0] + (n & 1), c[1] + ((n >> 1) & 1),
                                           c[2] + (n >> 2)), -1)
    return table


def test_neighbour_table_is_the_dict_lookup(sphere_pair):
    _, tv = sphere_pair
    chunks = list(tv.slot_of)
    extra = [(c[0] - 1, c[1], c[2] + 1) for c in chunks[:40]] + [(2 ** 20 - 1, 0, 0),
                                                               (-2 ** 20, 5, -7)]
    for cs in (chunks, chunks[::3] + extra):
        np.testing.assert_array_equal(mesh._neighbour_slots(tv, cs),
                                      _neighbour_slots_loop(tv, cs))
    empty = tsdf.TsdfVolume(tsdf.TsdfConfig(capacity=8), device="cpu")
    assert (mesh._neighbour_slots(empty, chunks[:5]) == -1).all()


@pytest.mark.parametrize("batch", [mesh.MESH_BATCH, 100])
def test_padded_mesh_matches_jax(sphere_pair, batch):
    """The padded batches (the sphere's chunks are not a multiple of the
    batch) give the JAX package's triangles in its order."""
    jv, tv = sphere_pair
    assert len(tv.slot_of) % batch
    vj, cj, nj = jmesh.extract_mesh(jv)
    vt, ct, nt = mesh.extract_mesh(tv, batch=batch)
    assert len(vt) == len(vj) > 200
    for name, a, r in (("verts", vt, vj), ("colors", ct, cj), ("normals", nt, nj)):
        np.testing.assert_allclose(a, r, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n,rows", [(1, [64]), (64, [64]), (65, [128]), (256, [256]),
                                    (257, [256, 64]), (385, [256, 192])])
def test_last_batch_pads_to_a_tier(sphere_pair, monkeypatch, n, rows):
    """Full batches of 256 chunks, then the rest padded to a multiple of 64
    (one graph a batch size on the card)."""
    _, tv = sphere_pair
    seen = []

    def batch(*args):
        seen.append(args[3].shape[0])
        return mesh.mesh_batch(*args)

    monkeypatch.setattr(tv, "mesh_graph", batch)
    chunks = (list(tv.slot_of) * (n // len(tv.slot_of) + 1))[:n]
    vt, _, _ = mesh.extract_mesh(tv, chunks)
    assert seen == rows and len(vt) > 0


def test_mesh_of_a_chunk_subset_matches_jax(sphere_pair):
    jv, tv = sphere_pair
    chunks = list(tv.slot_of)[5::4]
    vj, _, _ = jmesh.extract_mesh(jv, chunks)
    vt, _, _ = mesh.extract_mesh(tv, chunks)
    assert len(vt) == len(vj) > 0
    np.testing.assert_allclose(vt, vj, atol=1e-5)


def test_pad_rows_make_no_triangle(sphere_pair):
    """A batch of only padding (no neighbour anywhere) marks no slot
    valid."""
    _, tv = sphere_pair
    s = tv.cfg.chunk_size
    _, ok, _, _ = mesh.mesh_batch(tv.pool.sdf.reshape(-1), tv.pool.weight.reshape(-1),
                                  tv.pool.color.reshape(-1, 3),
                                  torch.full((3, 8), -1, dtype=torch.int64),
                                  torch.zeros((3, 3)), tv.cfg.voxel_size, s)
    assert ok.shape == (3, s ** 3 * 12) and not ok.any()


def test_a_new_pool_clears_the_mesh_graphs():
    """Growth (and any new pool) clears the graphs bound to the old pool."""
    vol = tsdf.TsdfVolume(tsdf.TsdfConfig(voxel_size=0.05, capacity=4), device="cpu")
    calls = []
    vol.mesh_graph.clear = lambda: calls.append(1)
    assert vol._grow() and calls == [1] and vol.capacity == 8


# ---------------------------------------------------------------------------
# The kernel's work and launch plan
# ---------------------------------------------------------------------------


def test_tsdf_kernel_work():
    """At most (every voxel updated, every pool word written, a contiguous
    colour): per voxel sdf and weight read (8 bytes), its colour read (12)
    and its five words written (20); depth and colour samples 16 a pixel,
    at most h·w pixels; per chunk its slot and coordinates; K, R, t. With
    the data's counts, only the updated voxels' colour and the changed
    words count, and a stride-0 grey colour 4 bytes a pixel. Bound by
    bytes on an H100 either way."""
    vox, px = 1000 * 512, 480 * 640
    most = ck.kernel_work("tsdf_integrate", m=1000, s=8, h=480, w=640)
    assert most == (40 * vox + 16 * px + 20 * 1000 + 84, 82 * vox)
    assert abs(most[0] / 1e6 - 25.4) < 0.05
    seen = ck.kernel_work("tsdf_integrate", m=1000, s=8, h=480, w=640, updated=150_000,
                          written=700_000, color_px=4)
    assert seen == (8 * vox + 12 * 150_000 + 4 * 700_000 + 8 * px + 20 * 1000 + 84,
                    55 * vox + 27 * 150_000)
    # one chunk of a large image reads at most one sample a voxel
    one = ck.kernel_work("tsdf_integrate", m=1, s=8, h=480, w=640, updated=0, written=0)
    assert one == (8 * 512 + 16 * 512 + 20 + 84, 55 * 512)
    for nbytes, ops in (most, seen):
        assert nbytes / 3.35e12 > ops / 67e12


@pytest.mark.parametrize("m,s", [(1, 8), (1000, 8), (65, 5), (3, 7), (2, 9), (7, 1),
                                 (131_072, 8), (1, 16)])
def test_tsdf_plan(m, s):
    """256 threads a chunk's block, each looping over ceil(s³ / 256)
    voxels; one block a chunk."""
    plan = ck.tsdf_plan(m, s)
    assert plan == ck.TsdfPlan(256, -(-s ** 3 // 256), m)
    assert plan.threads * plan.loops >= s ** 3 > plan.threads * (plan.loops - 1)


def test_tsdf_plan_rejects():
    for m, s in ((0, 8), (5, 0)):
        with pytest.raises(ValueError):
            ck.tsdf_plan(m, s)

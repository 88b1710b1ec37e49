"""The plain references on small hand-built cases, the dense reference held
to the program's own plain path on one frame, the comparisons, and the
roofline's work counts at 640x480x128 worked out by hand."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark import check, work
from benchmark.reference import dense as rd
from benchmark.reference import posegraph as rp
from benchmark.reference import tsdf as rt


def rot_z(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def test_loop_edges_by_hand():
    r = np.stack([rot_z(0.0), rot_z(math.pi / 2)])
    p = np.array([[1.0, 2.0, 0.5], [1.0, 3.0, 0.5]])
    t, yaw = rp.loop_edges(r, p, np.array([0, 1]), np.array([1, 0]))
    assert np.allclose(t[0], [0.0, 1.0, 0.0]) and np.isclose(yaw[0], math.pi / 2)
    # from body 1 (turned +90 deg) the point 1 m along world -y lies along body -x
    assert np.allclose(t[1], [-1.0, 0.0, 0.0]) and np.isclose(yaw[1], -math.pi / 2)
    assert np.allclose(rp.round_to(np.array([1.0 + 2 ** -10]), "bfloat16"), [1.0])


def test_pose_graph_minimum_by_hand():
    """Three nodes on a line, odometry 1 m a step, a loop from the first to
    the third that reads 2.3 m: least squares puts them at 0, 1.1, 2.2 m;
    the same graph turned and moved keeps its minimum in the anchor's gauge."""
    z3 = np.zeros(3)
    seq = rp.sequential_edges(np.zeros((3, 3)), np.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0]]),
                              np.zeros(3, int), max_back=1)
    assert list(seq.i) == [0, 1] and list(seq.j) == [1, 2]
    loop = rp.Edges(np.array([0]), np.array([2]), np.array([[2.3, 0.0, 0.0]]), np.zeros(1),
                    np.ones(1), np.full(1, 0.1), np.full(1, np.inf))
    yaw, p, it = rp.optimize(z3, np.zeros((3, 3)), np.zeros((3, 2)), rp.join(seq, loop), 0)
    assert np.allclose(p[:, 0], [0.0, 1.1, 2.2]) and np.allclose(p[:, 1:], 0) and it < 10
    assert np.allclose(yaw, 0.0)
    yaw2, p2 = rp.to_gauge(yaw, p, (0.0, p[0]), (math.pi / 2, np.array([5.0, 0.0, 1.0])))
    assert np.allclose(p2, [[5.0, 0.0, 1.0], [5.0, 1.1, 1.0], [5.0, 2.2, 1.0]])
    assert np.allclose(yaw2, math.pi / 2)


def test_tsdf_plane_by_hand():
    """A fronto-parallel wall 2 m ahead: after one map the voxels within the
    truncation band hold their signed distance to it, weight 1, and the
    depth's colour; a second identical map leaves the sdf and doubles the
    weight."""
    p = rt.Tsdf(voxel_size=0.1, chunk_size=8, trunc_scale=2.0, trunc_quad=0.0, carving=False,
                carve_weight=0.5, max_weight=100.0, min_depth=0.3, max_depth=10.0)
    h, w = 48, 64
    k = np.array([[40.0, 0, 32.0], [0, 40.0, 24.0], [0, 0, 1]])
    z = torch.zeros((0, 8, 8, 8))
    vol = rt.Volume(p, z, z.clone(), torch.zeros((0, 8, 8, 8, 3)), {})
    depth = torch.full((h, w), 2.0)
    color = torch.full((h, w, 3), 7.0)
    r_wc, t_wc = np.eye(3), np.array([0.05, 0.05, 0.0])
    n = vol.integrate(depth, color, k.astype(np.float32), r_wc, t_wc)
    assert n["chunks"] > 0 and n["updated"] > 0
    key = (0, 0, 2)            # z in [1.6, 2.4): the wall's chunk straight ahead
    row = vol.row_of[key]
    zc = 1.6 + (torch.arange(8) + 0.5) * 0.1
    expect = torch.clamp(2.0 - zc, -0.2, 0.2)
    inside = (2.0 - zc).abs() < 0.2
    sdf_line = vol.sdf[row, :, 0, 0]
    assert torch.allclose(sdf_line[inside], expect[inside], atol=1e-5)
    assert torch.all(vol.weight[row, inside, 0, 0] == 1.0)
    assert torch.allclose(vol.color[row, inside, 0, 0], torch.full((int(inside.sum()), 3), 7.0))
    vol.integrate(depth, color, k.astype(np.float32), r_wc, t_wc)
    assert torch.allclose(vol.sdf[row, :, 0, 0][inside], expect[inside], atol=1e-5)
    assert torch.all(vol.weight[row, inside, 0, 0] == 2.0)


def test_comparisons_by_hand():
    ref = torch.tensor([[1.0, 2.0], [0.0, 3.0]])
    assert check.depth_mismatch(ref.clone(), ref) == 0.0
    prog = torch.tensor([[1.0, 2.01], [1.0, 3.0]])
    assert check.depth_mismatch(prog, ref) == 0.5    # one depth 0.5 % off, one published alone
    f = rd.Filter(*(torch.ones(2, 2) for _ in range(4)))
    assert check.filter_mismatch([torch.ones(2, 2)] * 4, f) == 0.0
    g = [torch.ones(2, 2)] * 3 + [torch.tensor([[1.0, 1.0], [1.0, 1.1]])]
    assert check.filter_mismatch(g, f) == 0.25


def _small_frame(seed=0, h=40, w=48):
    g = torch.Generator().manual_seed(seed)
    ref = 100 + 40 * torch.rand((h, w), generator=g)
    meas = torch.roll(ref, 2, 1) + torch.rand((h, w), generator=g)
    a = torch.eye(3)
    b = torch.tensor([8.0, 0.5, 0.02])
    return ref, meas, a, b


@pytest.mark.parametrize("banded", [False, True])
def test_dense_reference_follows_the_programs_plain_path(banded):
    """One frame fused by the reference at bf16 equals the program's CPU
    frame bit for bit; at fp8 it does not."""
    from cvids_tpu_torch.dense import estimator
    h, w = 40, 48
    cfg = estimator.DenseConfig(height=h, width=w, num_depths=32, dep_sample=0.05)
    p = rd.dense_params(dataclasses.asdict(cfg))
    ref, meas, a, b = _small_frame()
    uv = torch.tensor([[10.0, 12.0], [30.0, 20.0]])
    inv_d = torch.tensor([0.5, 0.8])
    valid = torch.tensor([True, True])
    prog = estimator.init_reference(cfg, ref, sparse_uv=uv, sparse_inv_depth=inv_d,
                                    sparse_valid=valid)
    prog = estimator.fuse_measurement(cfg, prog, meas, a, b, banded_warp=banded)
    prec = rd.Precision("bfloat16")
    bias = rd.splat_sparse(p, uv, inv_d, valid)
    mine = rd.start(p, prec, ref, bias, rd.init_filter(h, w, "cpu"))
    mine = rd.fuse(p, prec, mine, meas, a, b, banded)
    assert torch.equal(mine.mean_cost, prog.mean_cost)
    for x, y in zip(mine.filt, prog.filt):
        assert torch.equal(x, y)
    low = rd.Precision("float8_e5m2")
    ctrl = rd.fuse(p, low, rd.start(p, low, ref, bias, rd.init_filter(h, w, "cpu")), meas, a, b,
                   banded)
    assert not torch.equal(ctrl.filt.mu, prog.filt.mu)


def test_work_counts_by_hand():
    """640 x 480 x 128 at bf16: 307,200 pixels, 39,321,600 samples."""
    px, vol = 307_200, 39_321_600
    nbytes, ops = work.dense_step_work(480, 640, 128, 2)
    assert nbytes == 4 * px + 72 + 12 * px + 4 * vol * 2 + vol * 2 + 32 * px
    assert nbytes == 407_961_672
    assert ops == 120 * px + 75 * vol == 2_985_984_000
    assert work.bound_s(nbytes, ops) == pytest.approx(407_961_672 / 3.35e12)
    # PERF.md's map: 198 chunks, 8,984 voxels in the band, none carved
    nb, op = work.tsdf_work(198, 8, 480, 640, 8984, 0)
    assert nb == 8 * 101_376 + 12 * 8984 + 4 * 5 * 8984 + 8 * 101_376 + 20 * 198 + 84
    assert nb == pytest.approx(2.0e6, rel=0.05)
    assert op == 55 * 101_376 + 27 * 8984

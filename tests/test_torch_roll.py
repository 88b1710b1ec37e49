"""A dense reference roll as the server runs it, on the CPU: the landmarks
padded to a tier (`estimator.roll_inputs`) splat the unpadded landmarks'
bias bit for bit, `roll_reference` writes what the splat and
`propagate_reference(..., out=...)` write, the cached Sobel taps and K⁻¹
give the uncached bits, and the server's roll blocks the host only for
K⁻¹, once a client.
The graphed roll on a card is `test_torch_cuda.py`'s."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cvids_tpu_torch.dense import estimator as te
from cvids_tpu_torch.ops import image
from cvids_tpu_torch.server import vocab
from cvids_tpu_torch.server.pipeline import (CollaborativeServer, PipelineConfig,
                                             _DenseClientState)

H, W, D = 24, 32, 8
CFG = te.DenseConfig(height=H, width=W, num_depths=D)
K = np.array([[30.0, 0.0, 16.0], [0.0, 30.0, 12.0], [0.0, 0.0, 1.0]], np.float32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _assert_same(x, y, what=""):
    assert x.dtype == y.dtype and x.shape == y.shape, what
    assert torch.equal(_bits(x), _bits(y)), what


def _landmarks(rng, p):
    """`p` landmarks: some off the image, some invalid, and the last few on
    the pixels of earlier ones (rounding to them from other sub-pixel
    positions) at other depths, so that the last must win those pixels."""
    uv = rng.uniform([-3.0, -3.0], [W + 3.0, H + 3.0], (p, 2)).astype(np.float32)
    inv = rng.uniform(0.1, 2.0, p).astype(np.float32)
    valid = rng.random(p) < 0.8
    for i in range(max(0, p - 4), p):
        j = i - max(1, p // 2)
        if j >= 0:
            uv[i] = np.round(uv[j]) + rng.uniform(-0.4, 0.4, 2).astype(np.float32)
            valid[i] = valid[j] = True
    return uv, inv, valid


def splat_by_rolls(cfg, uv, inv_depth, valid, radius=4):
    """`te.splat_sparse` with its dilation as the reference writes it: a
    `torch.roll` of the depth and of the hit map per tap (`test_torch_cuda.py`
    holds the splat to it on a card)."""
    h, w = cfg.height, cfg.width
    dev = uv.device
    n, p = h * w, uv.shape[0]
    px, py = torch.round(uv[:, 0]).to(torch.int64), torch.round(uv[:, 1]).to(torch.int64)
    ok = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, torch.where(ok, py * w + px, n), torch.arange(p, device=dev), "amax")
    hit_b = winner[:n] >= 0
    padded = torch.cat([inv_depth.to(torch.float32), torch.zeros(1, device=dev)])
    depth_map = padded[torch.where(hit_b, winner[:n], p)].reshape(h, w)
    hit = hit_b.to(torch.float32).reshape(h, w)
    acc_d, acc_w = torch.zeros((h, w), device=dev), torch.zeros((h, w), device=dev)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            wgt = 1.0 / (1.0 + np.hypot(dy, dx))
            shifted_d = torch.roll(depth_map, (dy, dx), (0, 1))
            shifted_h = torch.roll(hit, (dy, dx), (0, 1))
            acc_d = acc_d + shifted_d * shifted_h * wgt
            acc_w = acc_w + shifted_h * wgt
    mean_d = torch.where(acc_w > 0, acc_d / torch.clamp(acc_w, min=1e-9),
                         torch.zeros((), device=dev))
    hyp = torch.as_tensor(cfg.inv_depths, device=dev)
    bias = torch.abs(hyp[None, None, :] - mean_d[..., None]) / cfg.dep_sample
    return bias * cfg.sparse_ratio * torch.clamp(acc_w, max=1.0)[..., None]


@pytest.mark.parametrize("p", [1, 40, 300])
def test_splat_is_the_loop_of_rolls(p):
    uv, inv, valid = (torch.from_numpy(a) for a in _landmarks(np.random.default_rng(p), p))
    _assert_same(te.splat_sparse(CFG, uv, inv, valid), splat_by_rolls(CFG, uv, inv, valid))


@pytest.mark.parametrize("p", [0, 1, 255, 256, 257])
def test_padded_splat_is_the_unpadded_splat(p):
    rng = np.random.default_rng(p)
    uv, inv, valid = _landmarks(rng, p)
    *_, padded = te.unpack_roll_inputs(
        te.roll_inputs(np.eye(3), np.zeros(3), K, (uv, inv, valid), "cpu"))
    assert len(padded[0]) == te.landmark_tier(p) == (256 if p <= 256 else 512)
    assert not padded[2][p:].any()
    want = te.splat_sparse(CFG, torch.from_numpy(uv), torch.from_numpy(inv),
                           torch.from_numpy(valid))
    _assert_same(te.splat_sparse(CFG, *padded), want)
    if p > 4:
        # radius 0: the bias at a shared pixel is the last landmark's
        bias0 = te.splat_sparse(CFG, *padded, radius=0)
        i = p - 1
        x, y = (int(v) for v in np.round(uv[i]))
        if 0 <= x < W and 0 <= y < H:
            hyp = torch.from_numpy(CFG.inv_depths)
            d = torch.tensor(inv[i])
            _assert_same(bias0[y, x],
                         torch.abs(hyp - d) / CFG.dep_sample * CFG.sparse_ratio * 1.0)


def test_roll_inputs_are_one_buffer_of_the_host_values():
    rng = np.random.default_rng(1)
    r, t = rng.normal(size=(3, 3)), rng.normal(size=3)
    uv, inv, valid = _landmarks(rng, 40)
    buf = te.roll_inputs(r, t, K, (uv, inv, valid), "cpu")
    got = te.unpack_roll_inputs(buf)
    for x, want in zip(got[:3], (r, t, K)):
        _assert_same(x, torch.from_numpy(np.asarray(want, np.float32)))
    for x, want in zip(got[3], (uv, inv, valid)):
        _assert_same(x[:40], torch.from_numpy(want))
    assert buf.shape == (3 * 128 + 4 * 256,)
    # views of the one buffer, each where an allocation of its own would start
    views = (*got[:3], *got[3][:2])
    assert all(x.data_ptr() % 512 == buf.data_ptr() % 512 for x in views)
    assert all(x.untyped_storage().data_ptr() == buf.data_ptr() for x in views)
    assert te.unpack_roll_inputs(te.roll_inputs(r, t, K, None, "cpu"))[3] is None


def _state(rng, bias: bool) -> te.DenseState:
    """A reference's state with a filter that has seen frames."""
    st = te.init_reference(CFG, torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)))
    filt = st.filt._replace(
        mu=torch.from_numpy(rng.uniform(0.2, 1.5, (H, W)).astype(np.float32)),
        sigma2=torch.from_numpy(rng.uniform(0.01, 5.0, (H, W)).astype(np.float32)),
        a=torch.from_numpy(rng.uniform(1, 30, (H, W)).astype(np.float32)),
        b=torch.from_numpy(rng.uniform(1, 30, (H, W)).astype(np.float32)))
    st.mean_cost.uniform_(0, 40)
    st.count.fill_(3)
    st.num_frames.fill_(4)
    return st._replace(filt=filt, sparse_bias=torch.full((H, W, D), 7.0, dtype=CFG.torch_dtype)
                       if bias else None)


def _clone(st: te.DenseState) -> te.DenseState:
    return type(st)(*(None if x is None else
                      type(x)(*(y.clone() for y in x)) if isinstance(x, tuple) else x.clone()
                      for x in st))


def _states_same(a: te.DenseState, b: te.DenseState):
    for name in ("ref_img", "grad", "mean_cost", "count", "penalty", "num_frames"):
        _assert_same(getattr(a, name), getattr(b, name), name)
    for name, x, y in zip(a.filt._fields, a.filt, b.filt):
        _assert_same(x, y, name)
    assert (a.sparse_bias is None) == (b.sparse_bias is None)
    if a.sparse_bias is not None:
        _assert_same(a.sparse_bias, b.sparse_bias, "sparse_bias")


def _pose(rng):
    ang = 0.05
    r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    return r.astype(np.float32), rng.normal(0, 0.05, 3).astype(np.float32)


@pytest.mark.parametrize("p", [None, 3, 300])
def test_roll_reference_is_the_splat_and_propagate_reference(p):
    rng = np.random.default_rng(7)
    new_ref = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
    r_no, t_no = _pose(rng)
    lm = None if p is None else _landmarks(rng, p)
    old = _state(rng, True)
    new = _clone(old)
    inputs = te.roll_inputs(r_no, t_no, K, lm, "cpu")
    k_t = te.unpack_roll_inputs(inputs)[2]
    bias = None if lm is None else te.splat_sparse(CFG, *(torch.from_numpy(a) for a in lm))
    want = te.propagate_reference(CFG, old, new_ref, torch.from_numpy(r_no),
                                  torch.from_numpy(t_no), torch.from_numpy(K),
                                  sparse_bias=bias, out=old)
    if lm is None:
        new = new._replace(sparse_bias=None)
    te.roll_reference(CFG, new, new_ref, inputs, torch.linalg.inv(k_t))
    _states_same(new, want)
    # the step's roll: its bias buffer kept while a reference has none
    step = te.DenseStep(CFG)
    step.init_reference(old.ref_img)
    want = te.init_reference(CFG, old.ref_img)
    for _ in range(2):
        got = step.roll(new_ref, inputs, torch.linalg.inv(k_t))
        want = te.propagate_reference(CFG, want, new_ref, torch.from_numpy(r_no),
                                      torch.from_numpy(t_no), torch.from_numpy(K),
                                      sparse_bias=bias)
        _states_same(got, want)


def test_cached_sobel_taps_and_k_inv_give_the_uncached_bits():
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
    smooth, diff = torch.tensor([1.0, 2.0, 1.0]), torch.tensor([-1.0, 0.0, 1.0])
    gx, gy = image.sobel(img)
    _assert_same(gx, image._conv1d(image._conv1d(img, diff, 1), smooth, 0))
    _assert_same(gy, image._conv1d(image._conv1d(img, diff, 0), smooth, 1))
    assert image._sobel_taps(img.device)[0] is image._sobel_taps(img.device)[0]
    k_t = te.unpack_roll_inputs(te.roll_inputs(np.eye(3), np.zeros(3), K, None, "cpu"))[2]
    _assert_same(torch.linalg.inv(k_t), torch.linalg.inv(torch.from_numpy(K)))


def test_server_roll_blocks_only_to_invert_k_once_a_client():
    """`CollaborativeServer._roll` on the CPU: the state the splat and
    `propagate_reference` of the same inputs give, and no blocking transfer
    but K⁻¹'s, once a client."""
    rng = np.random.default_rng(5)
    voc = vocab.synthesize_tree_vocabulary(4, 2, seed=0)
    server = CollaborativeServer(voc, PipelineConfig(dense=CFG), device="cpu")
    pts = np.concatenate([rng.uniform([-0.5, -0.4], [0.5, 0.4], (30, 2)),
                          rng.uniform(1.0, 3.0, (30, 1))], 1).astype(np.float32)
    pkt = SimpleNamespace(win_pts3d=pts, win_valid=np.ones(30, bool), q_wb=np.array([1.0, 0, 0, 0]),
                          p_wb=np.zeros(3), p_bc=np.zeros(3), r_cb=np.eye(3))
    ds = _DenseClientState(te.DenseStep(CFG))
    first = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
    ds.step.init_reference(first)
    want = te.init_reference(CFG, first)
    tr = server.tracer
    k_invs = []
    for _ in range(2):
        img_t = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
        r_no, t_no = _pose(rng)
        with tr.span("depth"):
            server._roll(ds, pkt, K, r_no, t_no, img_t)
        k_invs.append(ds.k_inv[1])
        uv, inv, valid = server._sparse_from_packet(pkt, K)
        want = te.propagate_reference(
            CFG, want, img_t, torch.from_numpy(r_no), torch.from_numpy(t_no), torch.from_numpy(K),
            sparse_bias=te.splat_sparse(CFG, torch.from_numpy(uv), torch.from_numpy(inv),
                                        torch.from_numpy(valid)))
        _states_same(ds.state, want)
    assert tr.counts["depth_sync"] == 1 and k_invs[0] is k_invs[1]
    assert tr.counts["roll_graph"] == 0      # nothing replays on the CPU

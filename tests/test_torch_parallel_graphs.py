"""The sharded programs as CUDA graphs, on the CPU: what decides that a
mesh captures, the collective log's record and replay, and the refactored
sharded solves against the bodies they replaced.

On NCCL ranks on the card `shard_posegraph_solve` and
`solve_window_schur_sharded` replay one captured LM iteration
(`Mesh.graphed`); on gloo, on the CPU and on one rank they run that
iteration eagerly. Here the ranks are gloo ranks on the CPU (`launch`, one
intra-op thread a rank), so these tests hold the eager path's bits and the
bookkeeping; the replays are held to the eager runs on two NCCL cards by
`tests/test_torch_cuda.py` and on four by `chip_smoke.py --multichip`.
The problems are small (a 96-node graph with loops, a K = 6 / L = 37
window) and the port's own (`entry`'s problem helpers), so no JAX runs here.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cvids_tpu_torch import entry, parallel
from cvids_tpu_torch.parallel import mesh as pmesh
from cvids_tpu_torch.parallel import window_schur as ws
from cvids_tpu_torch.server import optimizer as topt
from cvids_tpu_torch.utils import cuda_graph
from cvids_tpu_torch.vio import window_ba as ba

LM_ITERS, CG_ITERS = 3, 12
WINDOW_ITERS = 4


def _graph_problem(world: int):
    """A 96-node chain with 16 loop edges, perturbed, its edges padded for
    `world` ranks."""
    rng = np.random.default_rng(5)
    n, nl = 96, 16
    yaw = np.cumsum(rng.normal(0, 0.02, n))
    t = np.cumsum(rng.normal(0, 0.1, (n, 3)), 0)
    li = rng.integers(0, n // 2, nl)
    lj = li + rng.integers(n // 4, n // 2, nl)
    loops = (li, lj, t[lj] - t[li], yaw[lj] - yaw[li])
    nodes, edges = entry._graph(yaw, t, "cpu", loops)
    nodes = nodes._replace(yaw=nodes.yaw + torch.from_numpy(rng.normal(0, 0.02, n)).float(),
                           t=nodes.t + torch.from_numpy(rng.normal(0, 0.05, (n, 3))).float())
    return nodes, parallel.pad_edges_for_sharding(edges, world)


def _window_problem():
    """A K = 6 / L = 37 window of projected landmarks, 60 % seen, with
    pixel noise (37 does not split evenly over 2 or 3 ranks)."""
    rng = np.random.default_rng(6)
    kk, ll = 6, 37
    lm = rng.normal(0, 2.0, (ll, 3)) + np.array([0, 0, 6.0])
    p = np.cumsum(rng.normal(0, 0.05, (kk, 3)), 0)
    obs = (lm[None, :, :2] - p[:, None, :2]) / (lm[None, :, 2:] - p[:, None, 2:])
    obs = obs + rng.normal(0, 2e-3, obs.shape)
    vis = rng.uniform(size=(kk, ll)) < 0.6
    state, meas = entry._window(p, lm + rng.normal(0, 0.05, lm.shape), obs, vis, 8, 460.0,
                                50.0, "cpu")
    return state, meas


def _replaced_window_solve(mesh, state, meas, iters, init_lambda=1e-3, anchor_weight=1e3):
    """The sharded window solve's loop as it stood before its iteration
    became `window_schur._iteration`: closures built per iteration, the
    cost and the Schur system inline. The reference the refactor is held
    to, bit for bit."""
    k, l = state.p.shape[0], state.lm.shape[0]
    pc, p6 = 15 * k, 6 * k
    dev, f32 = state.p.device, state.p.dtype
    pad = (-l) % mesh.size
    mine = mesh.block(l + pad)
    lm_loc = ws._pad_rows(state.lm, pad, 0)[mine]
    meas_loc = meas._replace(obs=ws._pad_rows(torch.nan_to_num(meas.obs), pad, 1)[:, mine],
                             vis=ws._pad_rows(meas.vis, pad, 1)[:, mine])
    st = state._replace(lm=lm_loc, lm_valid=ws._pad_rows(state.lm_valid, pad, 0)[mine])
    zc = torch.zeros(pc, dtype=f32, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye_k = torch.eye(k, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    def total_cost(s):
        proj = 0.5 * torch.sum(ba.reprojection_residuals(s, meas_loc) ** 2)
        return (0.5 * torch.sum(ba._cam_residuals(s, meas_loc, anchor_weight) ** 2)
                + mesh.all_reduce(proj.reshape(1))[0])

    def in_cam(pose_part):
        out = torch.zeros((pc,) * pose_part.dim(), dtype=f32, device=dev)
        out[(slice(0, p6),) * pose_part.dim()] = pose_part
        return out

    lam = torch.full((), init_lambda, dtype=f32, device=dev)
    cost = total_cost(st)
    for _ in range(iters):
        def cam_res_dc(dc, s=st):
            return ba._cam_residuals(ba.retract_cam(s, dc), meas_loc, anchor_weight)
        r_cam = cam_res_dc(zc)
        j_cam = torch.func.jacfwd(cam_res_dc)(zc)
        r, j_pose, j_lm = ba.reprojection_jacobians(st, meas_loc)
        h_ll = torch.einsum("klra,klrb->lab", j_lm, j_lm)
        g_l = torch.einsum("klra,klr->la", j_lm, r)
        h_pl = torch.einsum("klra,klrb->klab", j_pose, j_lm)
        h_pp = torch.einsum("klra,klrb->kab", j_pose, j_pose)
        g_p = torch.einsum("klra,klr->ka", j_pose, r)
        h_ll_d = h_ll + lam * (torch.diag_embed(torch.diagonal(h_ll, dim1=-2, dim2=-1))
                               + 1e-6 * eye3)
        observed = torch.einsum("lab->l", torch.abs(h_ll)) > 1e-12
        h_ll_inv = torch.linalg.inv_ex(torch.where(observed[:, None, None], h_ll_d, eye3))[0]
        w_mat = h_pl @ h_ll_inv[None]
        packed = mesh.all_reduce(torch.cat([
            in_cam(ba._pose_block_to_cam(torch.einsum("kab,km->kamb", h_pp, eye_k), k)).reshape(-1),
            in_cam(ba._pose_block_to_cam(torch.einsum("klab,mlcb->kamc", w_mat, h_pl),
                                         k)).reshape(-1),
            in_cam(ba._to_cam(g_p, k)),
            in_cam(ba._to_cam(torch.einsum("klab,lb->ka", w_mat, g_l), k)),
            (0.5 * torch.sum(r ** 2)).reshape(1)]))
        h_cc = j_cam.T @ j_cam + packed[:pc * pc].reshape(pc, pc)
        schur = packed[pc * pc:2 * pc * pc].reshape(pc, pc)
        g_c = j_cam.T @ r_cam + packed[2 * pc * pc:2 * pc * pc + pc]
        wg = packed[2 * pc * pc + pc:2 * pc * pc + 2 * pc]
        h_red = h_cc + torch.diag(lam * (torch.diagonal(h_cc) + 1e-6)) - schur
        dc = ba._equilibrated_solve(h_red, g_c - wg)
        dc_pose = ba._from_cam(dc, k)
        rhs = -g_l - torch.einsum("klab,ka->lb", h_pl, dc_pose)
        dl = torch.where(observed[:, None], (h_ll_inv @ rhs[..., None])[..., 0], zero)
        st_new = ba.retract_cam(st, dc)._replace(lm=st.lm + dl)
        cost_new = total_cost(st_new)
        lterms = mesh.all_reduce(torch.stack([
            2.0 * torch.einsum("ka,klab,lb->", dc_pose, h_pl, dl),
            torch.einsum("la,lab,lb->", dl, h_ll, dl), torch.sum(g_l * dl)]))
        pred = -(g_c @ dc + lterms[2]) - 0.5 * (dc @ (h_cc @ dc) + lterms[0] + lterms[1])
        st, lam, cost = ba._lm_update(cost_new < cost, st_new, st, lam, cost_new, cost, pred)
    lm_all = torch.zeros((l + pad, 3), dtype=f32, device=dev)
    lm_all[mine] = st.lm
    return st._replace(lm=mesh.all_reduce(lm_all)[:l], lm_valid=state.lm_valid), cost


def _same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.uint8),
                                              b.reshape(-1).view(torch.uint8))


def _ranks(mesh):
    """On each gloo CPU rank: the refactored solves and the bodies they
    replaced, with each one's log; whether the mesh (and a gloo mesh that
    names a card) would capture; and the log's record and replay."""
    out = {"world": mesh.size}
    nodes, edges = _graph_problem(mesh.size)
    mesh.take_log()
    new = parallel.shard_posegraph_solve(mesh, LM_ITERS, CG_ITERS)(nodes, edges)
    new_log = mesh.take_log()
    mine = mesh.block(edges.i.shape[0])
    old = topt.optimize_pose_graph(nodes, topt.PoseGraphEdges(*(x[mine] for x in edges)),
                                   lm_iters=LM_ITERS, cg_iters=CG_ITERS, reduce=mesh.all_reduce)
    out["solve"] = {"same": all(_same(a, b) for a, b in zip(new, old)),
                    "log": new_log, "old_log": mesh.take_log()}

    state, meas = _window_problem()
    new, new_cost = parallel.solve_window_schur_sharded(mesh, state, meas, iters=WINDOW_ITERS)
    new_log = mesh.take_log()
    old, old_cost = _replaced_window_solve(mesh, state, meas, WINDOW_ITERS)
    out["window"] = {"same": all(_same(a, b) for a, b in zip(new, old))
                     and _same(new_cost, old_cost),
                     "log": new_log, "old_log": mesh.take_log(), "cost": float(new_cost)}

    # one iteration of `_iteration` is the replaced loop's first
    pad = (-state.lm.shape[0]) % mesh.size
    sl = mesh.block(state.lm.shape[0] + pad)
    meas_loc = meas._replace(obs=ws._pad_rows(torch.nan_to_num(meas.obs), pad, 1)[:, sl],
                             vis=ws._pad_rows(meas.vis, pad, 1)[:, sl])
    st = state._replace(lm=ws._pad_rows(state.lm, pad, 0)[sl],
                        lm_valid=ws._pad_rows(state.lm_valid, pad, 0)[sl])
    cost0 = ws._total_cost(mesh.all_reduce, meas_loc, 1e3, st)
    st1, lam1, cost1 = ws._iteration(mesh.all_reduce, meas_loc, 1e3, st,
                                     torch.full((), 1e-3), cost0)
    old1, old_cost1 = _replaced_window_solve(mesh, state, meas, 1)
    lm1 = torch.zeros((state.lm.shape[0] + pad, 3))
    lm1[sl] = st1.lm
    lm1 = mesh.all_reduce(lm1)[:state.lm.shape[0]]
    out["iteration"] = {"same": _same(cost1, old_cost1) and _same(lm1, old1.lm)
                        and all(_same(getattr(st1, f), getattr(old1, f))
                                for f in ("p", "q", "v", "bg", "ba")),
                        "lam_finite": bool(torch.isfinite(lam1))}
    mesh.take_log()

    # no graph on a gloo or CPU mesh: `graphed` hands back the function
    card = pmesh.Mesh(mesh.rank, mesh.size, torch.device("cuda", 0), group=mesh.group)
    out["graphs"] = {"allowed": mesh.graphs_allowed(), "card_gloo": card.graphs_allowed(),
                     "same_fn": mesh.graphed(topt._lm_step) is topt._lm_step
                     and card.graphed(ws._iteration) is ws._iteration,
                     "kept": len(mesh.graphs) + len(card.graphs),
                     "backend": dist.get_backend(mesh.group)}

    # the log's record and replay, with real collectives
    x = torch.ones(5)
    with mesh.recording() as warm:
        mesh.all_reduce(x)
    with mesh.recording() as captured:
        mesh.all_reduce(x)
        with mesh.recording() as inner:
            mesh.all_reduce(torch.ones(2))
        mesh.all_reduce(torch.ones(3))
    during = list(mesh.log)
    mesh.replay(captured)
    mesh.replay(captured)
    out["record"] = {"warm": warm, "captured": captured, "inner": inner, "during": during,
                     "log": mesh.take_log(), "summed": x.tolist()}
    return out


@pytest.fixture(scope="module")
def ranks():
    """Rank 0's `_ranks` on 2 and on 3 gloo ranks on the CPU."""
    return {w: parallel.launch(_ranks, w, "gloo", "cpu") for w in (2, 3)}


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_solve_is_the_replaced_loop(ranks, world):
    """`shard_posegraph_solve` through `_lm_loop` and `Mesh.graphed` gives
    the bits and the calls of `optimize_pose_graph(reduce=...)` on the same
    block of edges."""
    r = ranks[world]["solve"]
    assert r["same"]
    assert r["log"] == r["old_log"]
    assert len(r["log"]) == 1 + LM_ITERS * (CG_ITERS + 2)


@pytest.mark.parametrize("world", [2, 3])
def test_window_iteration_is_the_replaced_body(ranks, world):
    """`solve_window_schur_sharded`, now `_iteration` replayed, gives the
    bits and the calls of the loop it replaced; one `_iteration` gives
    that loop's first iteration."""
    r = ranks[world]
    assert r["window"]["same"] and np.isfinite(r["window"]["cost"])
    assert r["window"]["log"] == r["window"]["old_log"]
    assert len(r["window"]["log"]) == 3 * WINDOW_ITERS + 2
    assert r["iteration"]["same"] and r["iteration"]["lam_finite"]


@pytest.mark.parametrize("world", [2, 3])
def test_no_graph_on_gloo_or_cpu(ranks, world):
    """A gloo mesh captures nothing, on the CPU or naming a card."""
    g = ranks[world]["graphs"]
    assert g["backend"] == "gloo"
    assert not g["allowed"] and not g["card_gloo"]
    assert g["same_fn"] and g["kept"] == 0


def test_no_graph_on_one_rank():
    mesh = parallel.make_mesh(device="cpu")
    assert not mesh.graphs_allowed()
    assert mesh.graphed(topt._lm_step) is topt._lm_step


def test_release_graphs_drops_every_graph(fake_card):
    """`Mesh.release_graphs` (what `launch` calls before leaving the
    group: NCCL waits on a communicator's graphs) clears each `GraphedCall`
    and forgets it."""
    mesh = pmesh.Mesh(0, 2, torch.device("cpu"))
    mesh.all_reduce = lambda t: t
    call = cuda_graph.GraphedCall(lambda x: x + 1, effects=mesh)
    mesh.graphs[topt._lm_step] = call
    call(torch.zeros(2))
    assert len(call.graphs) == 1
    mesh.release_graphs()
    assert call.graphs == {} and mesh.graphs == {}


def test_log_records_and_replays(ranks):
    """Within `recording()` the calls go to its list and not the log
    (nested: to the innermost); each `replay` appends the list once. The
    all-reduces still ran: ones summed over 2 ranks, twice."""
    r = ranks[2]["record"]
    assert r["warm"] == [("all-reduce", 20)]
    assert r["captured"] == [("all-reduce", 20), ("all-reduce", 12)]
    assert r["inner"] == [("all-reduce", 8)]
    assert r["during"] == []
    assert r["log"] == r["captured"] * 2
    assert r["summed"] == [4.0] * 5


class _Effects:
    """A mesh's side of `GraphedCall(effects=)`, counting what it is asked."""

    def __init__(self):
        self.log, self.record, self.recordings = [], None, 0

    @contextlib.contextmanager
    def recording(self):
        self.recordings += 1
        outer, self.record = self.record, []
        try:
            yield self.record
        finally:
            self.record = outer

    def replay(self, calls):
        self.log.extend(calls)

    def call(self, n):
        (self.log if self.record is None else self.record).append(("all-reduce", n))


class _FakeGraph:
    def capture_begin(self, pool=None, capture_error_mode=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _FakeStream:
    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


class _FakeEvent:
    def record(self, stream):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """`GraphedCall`'s capture path with the card's graph, stream and event
    calls stubbed: the function runs at the warm-up and at the capture, a
    replay runs nothing."""
    monkeypatch.setattr(cuda_graph, "_on_card", lambda tensors: True)
    for name, value in (("CUDAGraph", _FakeGraph), ("Stream", lambda dev: _FakeStream()),
                        ("current_stream", lambda dev=None: _FakeStream()),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("graph_pool_handle", lambda: object()), ("Event", _FakeEvent)):
        monkeypatch.setattr(torch.cuda, name, value)


def test_graphed_call_replays_the_captured_record(fake_card):
    """`GraphedCall(effects=)`: the warm-up's calls are dropped, the
    capture's kept with the graph, and each call (a replay) logs them once;
    a second signature has its own record; `disable_graphs()` runs the
    function, which logs as it goes."""
    fx = _Effects()
    runs = []

    def fn(x, n):
        runs.append(n)
        for _ in range(n):
            fx.call(x.numel() * 4)
        return x + 1

    call = cuda_graph.GraphedCall(fn, effects=fx)
    x = torch.zeros(3)
    for _ in range(4):
        call(x, 2)
    assert runs == [2, 2]                       # the warm-up and the capture
    assert fx.recordings == 2
    assert fx.log == [("all-reduce", 12)] * 8
    assert (call.captures, call.replays) == (1, 4)
    fx.log.clear()
    call(torch.zeros(5), 1)
    assert fx.log == [("all-reduce", 20)]
    assert call.captures == 2 and len(call.graphs) == 2
    fx.log.clear()
    with cuda_graph.disable_graphs():
        call(x, 3)
    assert runs[-1] == 3 and fx.log == [("all-reduce", 12)] * 3 and call.replays == 5

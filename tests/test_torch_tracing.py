"""The port's `Tracer` across threads, and the spans the pose graph records
on both of its threads: the ingest thread's `bow`, `loop_verify` and
`lock_wait`, the solver thread's `optimize`, and each blocking transfer as
`<outermost span>_sync` (CPU)."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from cvids_tpu_torch.io import multiagent
from cvids_tpu_torch.io.synthetic import Trajectory
from cvids_tpu_torch.server import posegraph, vocab
from cvids_tpu_torch.utils import tracing
from cvids_tpu_torch.utils.tracing import Tracer


@pytest.fixture
def fast_switching():
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(saved)


def test_new_names_on_another_thread_while_reading(fast_switching):
    """A thread opening new span names (and resetting) while this one reads
    `totals` and `counts` as the benchmark's closed loop does, 10^4 times."""
    tr, stop = Tracer(), threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            with tr.span(f"name{i}"):
                pass
            tr.count(f"counter{i}")
            i += 1
            if i % 500 == 0:
                tr.reset()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        for _ in range(10_000):
            {k: (tr.totals[k], tr.counts[k]) for k in tr.totals}
            sum(tr.counts.values())
    finally:
        stop.set()
        t.join(timeout=10.0)
    assert not t.is_alive()


def test_no_update_is_lost_across_threads(fast_switching):
    """More threads than cores recording the same names and new ones: every
    call is counted."""
    tr, n_threads, calls = Tracer(), 16, 300

    def worker(w):
        for i in range(calls):
            with tr.span("shared"):
                pass
            tr.add(f"own{w}", 1.0)
            tr.count("counter")

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    assert tr.counts["shared"] == len(tr.samples["shared"]) == n_threads * calls
    assert tr.counts["counter"] == n_threads * calls
    assert all(tr.counts[f"own{w}"] == calls and tr.totals[f"own{w}"] == calls
               for w in range(n_threads))


def test_sync_is_named_by_the_outermost_span_of_its_thread():
    """`tracing.sync()` records into the tracer of this thread's outermost
    open span, under its name, and records nothing where none is open (here
    or on another thread)."""
    tr, inner = Tracer(), Tracer()
    with tracing.sync():
        pass
    with tr.span("ingest"):
        with tr.span("loop_verify"):
            with tracing.sync():
                pass
        with inner.span("bow"), tracing.sync():
            pass
    def unspanned():
        with tracing.sync():
            pass

    other = threading.Thread(target=unspanned)
    with tr.span("depth"):
        other.start()
        other.join(timeout=10.0)
        with tr.span("fuse"), tracing.sync():
            pass
    assert not other.is_alive()
    assert dict(tr.counts) == {"loop_verify": 1, "ingest_sync": 2, "ingest": 1,
                               "depth_sync": 1, "fuse": 1, "depth": 1}
    assert dict(inner.counts) == {"bow": 1}
    assert tracing._open() == []


def test_add_records_one_call():
    tr = Tracer()
    tr.add("optimize_device", 0.25)
    tr.add("optimize_device", 0.5)
    assert tr.counts["optimize_device"] == 2 and tr.totals["optimize_device"] == 0.75
    assert list(tr.samples["optimize_device"]) == [0.25, 0.5]
    assert tr.mean_ms("optimize_device") == 375.0


def test_a_span_that_raises_is_not_counted():
    tr = Tracer()
    with pytest.raises(ValueError), tr.span("optimize"):
        raise ValueError
    assert "optimize" not in tr.totals and tracing._open() == []


@pytest.fixture(scope="module")
def stream():
    """Two agents on circles, seen by a trained vocabulary (the stream of
    `test_torch_server.py`, kept short)."""
    rng = np.random.default_rng(1)
    n_lm = 300
    landmarks = np.stack([rng.uniform(-14, 14, n_lm), rng.uniform(-14, 14, n_lm),
                          rng.uniform(0.2, 4.0, n_lm)], -1)
    descs = multiagent.landmark_descriptors(n_lm)
    agents = [
        multiagent.AgentSim(Trajectory.circle(radius=5.0, omega=0.45, center=(0.0, 0.0, 1.5))),
        multiagent.AgentSim(Trajectory.circle(radius=5.0, omega=0.45, phase=1.5,
                                              center=(2.0, 1.0, 1.5)),
                            yaw_offset=0.4, t_offset=np.array([2.0, -1.0, 0.3]),
                            drift_yaw_rate=0.0005, drift_t_rate=0.002)]
    packets, _ = multiagent.generate_packets(agents, landmarks, descs, duration=28.0,
                                             kf_rate=1.0, max_feats=60)
    voc = vocab.train_vocabulary(descs, k=8, levels=2, seed=0, device="cpu")
    return [p[-1] for p in packets], voc


def small_graph(voc, **kw):
    cfg = posegraph.ServerConfig(kf_capacity=256, max_win=64, max_ext=128, max_loops=256,
                                 optimize_every=15, lm_iters=8, cg_iters=40,
                                 min_loop_matches=12, pcm_min_edges=10, **kw)
    return posegraph.CollaborativePoseGraph(voc, cfg, device="cpu")


def test_lock_wait_only_when_another_thread_holds_the_lock(stream):
    packets, voc = stream
    g = small_graph(voc)
    for pkt in packets[:3]:
        g.add_keyframe(pkt)
    assert "lock_wait" not in g.tracer.totals
    held, release = threading.Event(), threading.Event()

    def hold():
        with g._lock:
            held.set()
            release.wait(10.0)

    t = threading.Thread(target=hold)
    t.start()
    held.wait(10.0)
    threading.Timer(0.05, release.set).start()
    g.add_keyframe(packets[3])
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert g.tracer.counts["lock_wait"] == 1 and g.tracer.totals["lock_wait"] >= 0.04
    assert g.tracer.counts["bow"] == 4 == g.tracer.counts["loop_verify"]


def test_worker_records_one_optimize_a_solve(stream):
    """With `async_optimize`, the worker's `optimize` calls equal the solves
    it ran, its transfers are `optimize_sync`, and the final synchronous
    solve of `flush` is not counted."""
    packets, voc = stream
    # ingest's wakes only (a periodic wake could start a solve as flush returns)
    g = small_graph(voc, async_optimize=True, optimize_period_s=600.0)
    try:
        for pkt in packets:
            g.add_keyframe(pkt)
        g.flush(final=False)
        solves = g.solve_count
        assert solves >= 2
        assert g.tracer.counts["optimize"] == solves
        assert g.tracer.counts["optimize_sync"] >= solves
        g.flush(final=True)
        assert g.solve_count == solves + 1 and g.tracer.counts["optimize"] == solves
    finally:
        g.close()
    assert "optimize_device" not in g.tracer.totals     # CUDA events on the card only


def test_profiler_export_holds_ingest_ranges(stream, tmp_path):
    """The main thread's `bow` and `loop_verify` as `record_function` ranges
    in a CPU profiler's exported trace."""
    packets, voc = stream
    g = small_graph(voc)
    g.add_keyframe(packets[0])
    g.tracer.use_profiler = True
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for pkt in packets[1:4]:
            g.add_keyframe(pkt)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("bow") == 3 and names.count("loop_verify") == 3
    assert "loop_verify_sync" in names


def test_a_new_reference_enters_sync_at_each_blocking_call():
    """`tracing.sync()` around a new reference's blocking calls on the
    card: the Sobel taps' one upload a device (none once cached), and a
    propagated reference's K⁻¹; none in a roll given its uploaded inputs
    and K⁻¹."""
    from cvids_tpu_torch.dense import estimator
    from cvids_tpu_torch.ops import image
    tr = Tracer()
    cfg = estimator.DenseConfig(height=16, width=24, num_depths=8)
    step = estimator.DenseStep(cfg)
    img = torch.rand((16, 24), generator=torch.Generator().manual_seed(0))
    k = torch.tensor([[20.0, 0.0, 12.0], [0.0, 20.0, 8.0], [0.0, 0.0, 1.0]])
    image._SOBEL_TAPS.pop(img.device, None)
    with tr.span("depth"):
        step.init_reference(img)
    assert tr.counts["depth_sync"] == 1
    with tr.span("depth"):
        step.init_reference(img)
    assert tr.counts["depth_sync"] == 1
    with tr.span("depth"):
        estimator.propagate_reference(cfg, step.state, img, torch.eye(3), torch.zeros(3), k)
    assert tr.counts["depth_sync"] == 2
    inputs = estimator.roll_inputs(np.eye(3), np.zeros(3), k.numpy(), None, img.device)
    with tr.span("depth"):
        step.roll(img, inputs, torch.linalg.inv(k))
    assert tr.counts["depth_sync"] == 2 and tr.counts["depth"] == 4

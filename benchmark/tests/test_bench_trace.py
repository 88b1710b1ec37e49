"""The trace reduction on a hand-built Chrome trace: busy time, device time
by the spans its launches lie in, idle gaps by the host's span, and the
per-layer readers on it."""

from types import SimpleNamespace

import pytest

from benchmark import trace
from benchmark.metrics import dense_device_ms, device_idle_share, ingest_ms


def X(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    X(trace.SLICE, "user_annotation", 0, 1000),
    X("depth", "user_annotation", 100, 200), X("fuse", "user_annotation", 200, 50),
    X("remap", "user_annotation", 120, 10), X("ingest", "user_annotation", 20, 60),
    X("cudaGraphLaunch", "cuda_runtime", 150, 5, 1), X("cudaLaunchKernel", "cuda_runtime", 210, 5, 2),
    X("cudaLaunchKernel", "cuda_runtime", 125, 2, 3), X("cudaLaunchKernel", "cuda_runtime", 500, 2, 4),
    X("sweep", "kernel", 160, 50, 1), X("tsdf_integrate_kernel", "kernel", 215, 20, 2),
    X("remap_gather", "kernel", 400, 30, 3), X("solve", "kernel", 600, 100, 4),
    X("outside", "kernel", 2000, 100, 5),
]


def test_reduce_by_hand():
    tr = trace.reduce(EVENTS)
    assert tr.window_s == pytest.approx(1e-3) and tr.busy_s == pytest.approx(200e-6)
    assert tr.device_s({"depth"}, {"fuse", "remap"}) == pytest.approx(50e-6)
    assert tr.device_s({"fuse"}, name="tsdf_integrate") == pytest.approx(20e-6)
    assert tr.device_s({"remap"}) == pytest.approx(30e-6)
    gaps = dict((w, 0.0) for _, w in tr.gaps)
    for secs, where in tr.gaps:
        gaps[where] += secs
    assert gaps["ingest"] == pytest.approx(160e-6)       # 0-160 with the host in `ingest`'s middle
    assert sum(gaps.values()) == pytest.approx(800e-6)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["solve", pytest.approx(100e-6)]
    assert len(b["device_ops"]) == 4 and len(b["idle_gaps"]) <= 10


def test_another_threads_launches_land_in_no_span():
    """A graph the solver thread launches while the main thread is inside
    `depth` counts in no span; the main thread's launch still does."""
    events = EVENTS + [X("cudaGraphLaunch", "cuda_runtime", 180, 5, 6, tid=2),
                       X("solver_step", "kernel", 220, 40, 6),
                       X("step", "user_annotation", 170, 100, tid=3)]
    tr = trace.reduce(events)
    assert tr.device_s({"depth"}, {"fuse", "remap"}) == pytest.approx(50e-6)
    assert tr.device_s(set(), name="solver_step") == pytest.approx(40e-6)
    assert [op.spans for op in tr.ops if op.name == "solver_step"] == [frozenset()]


def test_layer_readers_on_the_hand_trace():
    tr = trace.reduce(EVENTS)
    run = SimpleNamespace(trace=tr, window=SimpleNamespace(slice_counters={"dense_replays": 2}),
                          spans={"ingest": (0.5, 100)})
    assert dense_device_ms.read(run) == pytest.approx(0.025)
    assert device_idle_share.read(run) == pytest.approx(80.0)
    assert ingest_ms.read(run) == pytest.approx(5.0)
    assert dense_device_ms.read(SimpleNamespace(trace=None, window=run.window)) is None


def test_capture_guard_holds_the_capture_lock_and_gives_it_up():
    from cvids_tpu_torch.utils import cuda_graph
    lock = cuda_graph._CAPTURE_LOCK
    with trace.CaptureGuard():
        assert not lock.acquire(blocking=False)
    assert lock.acquire(blocking=False)
    lock.release()
    guard = trace.CaptureGuard(max_s=0.2).__enter__()
    with lock:          # a capture this thread would need does not hang
        pass
    guard.__exit__(None, None, None)

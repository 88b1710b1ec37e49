"""Reading the traced run: torch.profiler over a fixed slice of the window,
exported as a Chrome trace and reduced to what the per-layer metrics read.

Each device activity (kernel, copy, fill) is tied to the host call that
launched it by the profiler's correlation id, and through that call's
thread and time to the program's `Tracer` spans on the same thread, which
the traced run records as `record_function` ranges: so a kernel replayed
from a CUDA graph counts in the span whose host code launched the graph,
and work that another thread (the server's solver) launches while the main
thread is inside a span counts in none.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

SLICE = "benchmark_slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class DeviceOp:
    name: str
    start: float     # us, trace clock
    dur: float       # us
    spans: frozenset  # names of the program spans its launch lies in


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)
    gaps: list = field(default_factory=list)   # (seconds, host span at the gap)

    def device_s(self, inside: set, outside: set = frozenset(), name: str | None = None) -> float:
        """Seconds of device activity launched inside every span of `inside`
        and none of `outside` (optionally only activities named like `name`)."""
        return sum(op.dur for op in self.ops
                   if inside <= op.spans and not (outside & op.spans)
                   and (name is None or name in op.name)) * 1e-6


def _stream_done() -> None:
    """Wait for the current stream's queued work (an event, not a device
    synchronise: the server's solver thread may be capturing a CUDA graph,
    and a device-wide synchronise is not allowed while it does)."""
    import torch
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()


class CaptureGuard:
    """Holds the program's one-capture-at-a-time lock (`utils.cuda_graph`)
    on a helper thread while the profiler runs. The profiler synchronises
    the whole device when it stops, which is not allowed while the server's
    solver thread captures a CUDA graph, and device tracing beside a capture
    has crashed the process; so a capture the solver needs during the slice
    waits for its end (traced runs only). The helper gives the lock up after
    `max_s` whatever happens, so a capture the main thread itself would need
    cannot hang the run."""

    def __init__(self, max_s: float = 30.0):
        import threading
        from cvids_tpu_torch.utils import cuda_graph
        self._lock, self._max_s = cuda_graph._CAPTURE_LOCK, max_s
        self._held, self._done = threading.Event(), threading.Event()
        self._thread = threading.Thread(target=self._hold, name="capture-guard", daemon=True)

    def _hold(self) -> None:
        with self._lock:
            self._held.set()
            self._done.wait(self._max_s)

    def __enter__(self):
        self._thread.start()
        self._held.wait()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()


def quiet_solver(graph) -> None:
    """Let the server's solver thread finish its solve and keep it from
    starting another until the next keyframe is ingested (the wait that
    `CollaborativePoseGraph.flush` makes, without its final solve or its
    resolving of queued loop checks): the profiler starts and stops its
    device tracing while no other thread launches work."""
    import time
    graph._opt_paused = True
    for _ in range(2):          # twice: a solve may have passed its pause check just now
        while graph._opt_wake.is_set() or graph._opt_running.is_set():
            time.sleep(0.001)
        time.sleep(0.002)


def warm_up() -> None:
    """Start the profiler's device tracing once on a trivial call, so that
    its first start inside the window is not its initialisation."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with CaptureGuard(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device="cuda").sum()
        _stream_done()


class Profiler:
    """torch.profiler over a slice: `start()`, `stop()` at the slice's ends
    (inside the window, under a `CaptureGuard`, each with the server's
    solver quiet), `reduce()` after the window (the export and its reading
    cost the window nothing)."""

    def __init__(self, graph):
        self._graph = graph

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._guard = CaptureGuard().__enter__()
        quiet_solver(self._graph)
        _stream_done()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()

    def stop(self) -> None:
        try:
            self._range.__exit__(None, None, None)
            quiet_solver(self._graph)
            _stream_done()
            self._prof.__exit__(None, None, None)
        finally:
            self._guard.__exit__(None, None, None)

    def reduce(self) -> "Trace":
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        self._prof = None
        return reduce(events["traceEvents"] if isinstance(events, dict) else events)


def _intervals(evts):
    evts = sorted(evts)
    return [e[0] for e in evts], evts


def reduce(events: list) -> Trace:
    """The slice's busy time, device activities with their spans, and idle
    gaps labelled by the innermost span the host was in."""
    slc = [e for e in events if e.get("name") == SLICE and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not slc:
        raise RuntimeError("the profiled slice is missing from the trace")
    t0, t1 = float(slc[0]["ts"]), float(slc[0]["ts"]) + float(slc[0]["dur"])
    launch = {}                               # correlation -> (thread, time)
    spans = defaultdict(list)                 # (thread, name) -> intervals
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        thread = (e.get("pid"), e.get("tid"))
        if cat in HOST_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (thread, float(e["ts"]))
        elif cat == "user_annotation" and e.get("name") != SLICE:
            spans[thread, e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    index = {key: _intervals(v) for key, v in spans.items()}

    def spans_at(thread, t: float) -> frozenset:
        found = []
        for (th, name), (starts, iv) in index.items():
            if th != thread:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                found.append(name)
        return frozenset(found)

    def innermost(t: float) -> str:
        best, width = "outside the spans", float("inf")
        for (_, name), (starts, iv) in index.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1] and iv[i][1] - iv[i][0] < width:
                best, width = name, iv[i][1] - iv[i][0]
        return best

    ops, busy = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if s + d < t0 or s > t1:
            continue
        thread, host = launch.get(e.get("args", {}).get("correlation"), (None, s))
        ops.append(DeviceOp(e.get("name", "?"), s, d, spans_at(thread, host)))
        busy.append((max(s, t0), min(s + d, t1)))
    busy.sort()
    merged = []
    for s, e in busy:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, prev = [], t0
    for s, e in merged + [[t1, t1]]:
        if s > prev:
            gaps.append(((s - prev) * 1e-6, innermost(0.5 * (s + prev))))
        prev = max(prev, e)
    return Trace(window_s=(t1 - t0) * 1e-6, busy_s=sum(e - s for s, e in merged) * 1e-6,
                 ops=ops, gaps=gaps)


def short_name(name: str) -> str:
    """A device activity's function name without its return type, template
    and argument lists (`void at::native::foo<float>(...)` -> `at::native::foo`);
    copies and fills keep their names."""
    name = name.replace("(anonymous namespace)::", "")
    if "::" not in name and "<" not in name:
        return name.strip()
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).split("(")[0].strip().split(" ")[-1]


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time, by name, and the idle
    time by what the host was doing, the ten largest."""
    by_op, by_gap = defaultdict(float), defaultdict(float)
    for op in tr.ops:
        by_op[short_name(op.name)] += op.dur * 1e-6
    for secs, where in tr.gaps:
        by_gap[where] += secs
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}

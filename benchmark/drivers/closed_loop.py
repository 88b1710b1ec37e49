"""The closed-loop backlog: keyframes go to the server in the session's time
order, the next one once `submit` + `process` have returned and the device
work they queued on the current stream has finished. A keyframe's latency
runs from its submission to that completion. A run that uses up the session
before the window ends fails; it never wraps.

In a traced run the profiled slice is set apart: its keyframes run with the
server's spans as profiler ranges, and their time, their latencies and
their spans are left out of the window's, so that the host-clock numbers
of a traced run come from keyframes that ran as in an untraced one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from .. import trace as trace_mod


@dataclass
class Window:
    attempted: int = 0
    failed: int = 0
    elapsed_s: float = 0.0
    latencies_s: list = field(default_factory=list)    # outside the profiled slice
    publishing: list = field(default_factory=list)     # per latency: did it publish a map
    published: list = field(default_factory=list)     # depth records published in the window
    trace: object = None                               # trace.Trace of the profiled slice
    slice_counters: dict = field(default_factory=dict)
    slice_spans: dict = field(default_factory=dict)    # span -> (seconds, calls) in the slice
    slice_s: float = 0.0


def _completion(device):
    if device.type != "cuda":
        return lambda: None
    ev = torch.cuda.Event()

    def wait():
        ev.record()
        ev.synchronize()
    return wait


def finish_queued(device) -> None:
    _completion(device)()


def warm_up(server, packets, device) -> None:
    """The session's first keyframes, until every program the window meets
    has been built and captured."""
    done = _completion(device)
    for pkt in packets:
        server.submit(pkt)
        server.process()
        done()


def _span_totals(tracer) -> dict:
    return {k: (tracer.totals[k], tracer.counts[k]) for k in tracer.totals}


def window(server, packets, start: int, seconds: float, device, recorders,
           trace_slice=None) -> Window:
    """Submit packets[start:] closed loop for `seconds`, not counting the
    profiled slice. With `trace_slice` = (offset, count), window keyframes
    offset..offset+count-1 run under the profiler, with the server's spans
    recorded as profiler ranges."""
    done = _completion(device)
    win = Window()
    published = server.depth_maps_published
    prof = None
    t_open = time.perf_counter()
    i = start
    while True:
        now = time.perf_counter()
        if now - t_open - win.slice_s >= seconds and (prof is None or win.trace is not None):
            break
        if i >= len(packets):
            raise RuntimeError(f"the session's {len(packets)} keyframes ran out "
                               f"{now - t_open:.1f} s into the window")
        n = i - start
        if trace_slice is not None and n == trace_slice[0]:
            prof = trace_mod.Profiler(server.graph)
            spans0 = _span_totals(server.tracer)
            t_slice = time.perf_counter()
            prof.start()
            server.tracer.use_profiler = True
            replays0 = server._dense_graphs.replays
            maps0 = server.depth_maps_published
        in_slice = prof is not None and win.trace is None
        t = time.perf_counter()
        server.submit(packets[i])
        server.process()
        done()
        if not in_slice:
            win.latencies_s.append(time.perf_counter() - t)
            win.publishing.append(server.depth_maps_published > published)
        win.attempted += 1
        if server.depth_maps_published > published:
            new = server.depth_maps_published - published
            win.published.extend(server.depth_records[-new:])
            published = server.depth_maps_published
        for r in recorders:
            r.observe(server, i, n)
        if in_slice and n == trace_slice[0] + trace_slice[1] - 1:
            server.tracer.use_profiler = False
            prof.stop()
            win.slice_s = time.perf_counter() - t_slice
            spans1 = _span_totals(server.tracer)
            win.slice_spans = {k: (v[0] - spans0.get(k, (0.0, 0))[0], v[1] - spans0.get(k, (0.0, 0))[1])
                               for k, v in spans1.items()}
            win.trace = prof
            win.slice_counters = {
                "keyframes": trace_slice[1],
                "dense_replays": server._dense_graphs.replays - replays0,
                "maps": [r["ref_index"] for r in win.published[len(win.published)
                                                             - (server.depth_maps_published - maps0):]]
                if server.depth_maps_published > maps0 else []}
        i += 1
    win.elapsed_s = time.perf_counter() - t_open - win.slice_s
    if isinstance(win.trace, trace_mod.Profiler):
        win.trace = win.trace.reduce()
    return win

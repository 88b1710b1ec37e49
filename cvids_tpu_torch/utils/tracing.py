"""Structured stage tracing + counters (port of
``cvids_tpu/utils/tracing.py``).

Named host-clock spans with the reference's stage taxonomy (its printf
timers, `server_pose_graph.cpp:707-922,1808`). With `use_profiler`, each
span is also a `torch.profiler.record_function` range, so device traces
line up with host stages. Besides the totals, each span's most recent
per-call durations are kept (`samples`, the last `SAMPLES` of each) for
medians and percentiles.

Threads may record into one tracer: the collaborative server's ingest
thread and its solver thread both do. Each thread has its own stack of open
spans (of every tracer), which names its blocking transfers (`sync`). A new
name replaces the tables with grown copies instead of growing them, so a
thread that iterates `totals`, `counts` or `samples` while another records
never sees one change size; a name missing from a table reads as 0 (an
empty deque in `samples`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field

__all__ = ["Tracer", "STAGES", "global_tracer", "span", "sync"]

# the names the collaborative server records (`server/pipeline.py`,
# `server/posegraph.py`, `mapping/tsdf.py`): the stages, ingest's parts, the
# solver thread's solve and its time on the solver's stream, a reference
# roll and the rolls that replayed a graph captured before, and the
# blocking transfers, named by the outermost span open around them
STAGES = ("ingest", "lock_wait", "bow", "loop_verify", "optimize", "optimize_device",
          "depth", "remap", "fuse", "mesh", "roll", "roll_graph", "ingest_sync",
          "optimize_sync", "depth_sync")
SAMPLES = 10_000

_local = threading.local()      # `stack`: this thread's open spans, outermost first
_NO_SPAN = contextlib.nullcontext()


class _Table(dict):
    """A tracer's table: a missing name reads as `default()` and is not
    inserted, so a reader never grows a table that another thread iterates."""

    __slots__ = ("_default",)

    def __init__(self, default, *items):
        super().__init__(*items)
        self._default = default

    def __missing__(self, name):
        return self._default()


class _Span:
    """One open span (a class, not a generator: it is entered on every
    keyframe's hot path)."""

    __slots__ = ("_tracer", "_name", "_stack", "_range", "_t0")

    def __init__(self, tracer: Tracer, name: str):
        self._tracer, self._name, self._range = tracer, name, None

    def __enter__(self):
        self._stack = _open()
        self._stack.append(self)
        if self._tracer.use_profiler:
            import torch
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        self._stack.pop()
        if exc_type is None:      # a span that raised is not counted
            self._tracer._record(self._name, dt)
        return False


@dataclass
class Tracer:
    totals: dict = field(default_factory=lambda: _Table(float))
    counts: dict = field(default_factory=lambda: _Table(int))
    samples: dict = field(default_factory=lambda: _Table(deque))
    use_profiler: bool = False
    _lock: threading.Lock = field(default_factory=threading.Lock, init=False, repr=False,
                                  compare=False)

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add(self, name: str, seconds: float):
        """Record a duration measured elsewhere (a device interval) as one
        call of `name`."""
        self._record(name, seconds)

    def count(self, name: str, n: int = 1):
        with self._lock:
            if name in self.counts:
                self.counts[name] += n
            else:
                self.counts = _Table(int, {**self.counts, name: n})

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return 1000.0 * self.totals.get(name, 0.0) / c if c else 0.0

    def report(self) -> str:
        totals, lines = self.totals, []
        for name in sorted(totals, key=lambda n: -totals[n]):
            lines.append(f"{name:>12}: {totals[name]:8.3f}s total, "
                         f"{self.mean_ms(name):8.2f} ms/call x{self.counts[name]}")
        return "\n".join(lines)

    def reset(self):
        with self._lock:
            self.totals, self.counts, self.samples = _Table(float), _Table(int), _Table(deque)

    def _record(self, name: str, dt: float):
        with self._lock:
            if name in self.totals:
                self.totals[name] += dt
                self.counts[name] += 1
                self.samples[name].append(dt)
                return
            # counts before totals: a reader of `totals` finds each name in
            # `counts`
            self.counts = _Table(int, {**self.counts, name: self.counts[name] + 1})
            self.samples = _Table(deque, {**self.samples, name: deque([dt], maxlen=SAMPLES)})
            self.totals = _Table(float, {**self.totals, name: dt})


def _open() -> list:
    """This thread's open spans, outermost first."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = stack = []
        return stack


def sync():
    """A span around one blocking host<->device transfer (`.cpu()`,
    `.item()`, a `.to()` from pageable memory, `torch.unique`, a
    boolean-mask read), recorded as `<outermost open span of this
    thread>_sync` into that span's tracer; nothing where this thread has no
    span open."""
    stack = _open()
    if not stack:
        return _NO_SPAN
    outer = stack[0]
    return _Span(outer._tracer, outer._name + "_sync")


_GLOBAL = Tracer()


def global_tracer() -> Tracer:
    """The process-wide tracer that `span` records into."""
    return _GLOBAL


def span(name: str):
    """`global_tracer().span(name)`."""
    return _GLOBAL.span(name)

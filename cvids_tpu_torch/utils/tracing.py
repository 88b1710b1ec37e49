"""Structured stage tracing + counters (port of
``cvids_tpu/utils/tracing.py``).

Named host-clock spans with the reference's stage taxonomy (its printf
timers, `server_pose_graph.cpp:707-922,1808`): the collaborative server
traces `ingest`, `depth`, `fuse`, `mesh` and `optimize`. With
`use_profiler`, each span is also a `torch.profiler.record_function` range,
so device traces line up with host stages. Besides the totals, each span's
most recent per-call durations are kept (`samples`, the last `SAMPLES` of
each) for medians and percentiles.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field

__all__ = ["Tracer", "STAGES", "global_tracer", "span"]

STAGES = ("ingest", "loop", "align", "optimize", "depth", "fuse", "mesh",
          "publish")
SAMPLES = 10_000


@dataclass
class Tracer:
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    samples: dict = field(default_factory=lambda: defaultdict(lambda: deque(maxlen=SAMPLES)))
    use_profiler: bool = False

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.use_profiler:
            import torch
            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self.samples[name].append(dt)

    def count(self, name: str, n: int = 1):
        self.counts[name] += n

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return 1000.0 * self.totals.get(name, 0.0) / c if c else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(f"{name:>12}: {self.totals[name]:8.3f}s total, "
                         f"{self.mean_ms(name):8.2f} ms/call x{self.counts[name]}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.samples.clear()


_GLOBAL = Tracer()


def global_tracer() -> Tracer:
    """The process-wide tracer that `span` records into."""
    return _GLOBAL


def span(name: str):
    """`global_tracer().span(name)`."""
    return _GLOBAL.span(name)

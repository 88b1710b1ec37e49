"""Replay a fixed-shape tensor function as one CUDA graph: the port's form
of the reference's `jax.jit`.

Eager PyTorch on the card pays host time for every launch (~25 µs a small
op on the H100 machine, `PERF.md` §5). The front-end's KLT tracker and
window solve, the server's dense frame and its 4-DoF solve are hundreds to
thousands of launches with fixed shapes, a fixed iteration count and no read
back to the host. `GraphedCall(fn)` captures `fn` once per input signature
(the pytree structure, each tensor's shape, dtype and device, and the value
of every non-tensor leaf) into a `torch.cuda.CUDAGraph` over static copies
of its inputs, and afterwards copies the inputs in, replays the graph and
returns clones of the outputs: the same kernels in the same order as the
eager call, so the same bits.

- Bound arguments (`bound=` argument positions) are captured over the
  caller's own tensors, which are neither copied in nor out: the port's
  form of `donate_argnums`, for state that `fn` updates in place (the dense
  state's cost volumes). Their storage addresses are part of the signature,
  and the graph keeps them alive.
- Captures are thread-local (`capture_error_mode="thread_local"`) on the
  call's own side stream, with no device-wide synchronization, so a worker
  thread can capture while another thread keeps allocating and launching.
  Calls of one `GraphedCall` are serialized, on the host by a lock and on
  the device by an event, so two threads never replay one graph over each
  other's inputs. One limit is PyTorch's: while a capture is underway, no
  thread may draw from the card's default random generator (it raises
  "Offset increment outside graph capture"); the server draws none.
- `cuda_kernels.launches` keeps meaning "kernels run": a capture's wrapper
  calls are counted apart, and each replay adds that count.
- The graphs of one `GraphedCall` share one memory pool, captured on one
  side stream: their replays run one after another (above) and each call
  returns clones of the outputs, so no graph's transient tensors are live
  when another graph runs. A server's dense frames for all its clients are
  one `GraphedCall`, so one pool.
- One capture at a time in the process: a capture (with its warm-up call)
  holds a process-wide lock, so the pose graph's background solver and its
  ingest thread never capture at once. `fn` must not call a `GraphedCall`.
- `clear()` drops every graph with its static inputs and bound tensors:
  the caller's form of a recompile, when the state it binds has moved (a
  database's store growing into its next capacity tier).
- `effects=`: an object that keeps a host-side record of device work, a
  `parallel.Mesh` and its collective log. The warm-up call and the capture
  run inside `effects.recording()`, which yields the list its calls record
  into instead; the warm-up's list is dropped, the capture's is kept with
  the graph, and every replay hands it to `effects.replay`. So the record
  follows what the device runs: one capture's worth a replay, nothing for
  the warm-up.

Calls on CPU tensors run `fn` itself, and so does every call inside
`disable_graphs()` (the counterpart of `jax.disable_jit()`, for eager
comparisons). A capture that fails on the card raises.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils import _pytree as pytree

from ..ops import cuda_kernels

__all__ = ["GraphedCall", "disable_graphs", "graphs_disabled"]

_tls = threading.local()
_CAPTURE_LOCK = threading.Lock()     # one capture at a time in the process


@contextlib.contextmanager
def disable_graphs():
    """Within (on this thread), every `GraphedCall` runs its function
    eagerly. Nests; restores on exit."""
    _tls.disabled = getattr(_tls, "disabled", 0) + 1
    try:
        yield
    finally:
        _tls.disabled -= 1


def graphs_disabled() -> bool:
    return getattr(_tls, "disabled", 0) > 0


def _on_card(tensors) -> bool:
    return bool(tensors) and tensors[0].device.type == "cuda"


class _Entry:
    __slots__ = ("graph", "static", "out", "launches", "recorded")

    def __init__(self, graph, static, out, launches, recorded):
        self.graph, self.static, self.out, self.launches = graph, static, out, launches
        self.recorded = recorded


class GraphedCall:
    """`fn(*args)` through a CUDA graph per input signature (see the module
    docstring). `fn` must not read device values back to the host, nor
    copy host data to the device, nor branch on tensor values."""

    def __init__(self, fn, bound: tuple[int, ...] = (), effects=None):
        self.fn = fn
        self.bound = frozenset(bound)
        self.effects = effects
        self.graphs: dict = {}
        self.replays = 0
        self.captures = 0               # over the object's life, `clear()` included
        self._lock = threading.Lock()
        self._streams: dict = {}        # device -> capture stream
        self._pools: dict = {}          # device -> the graphs' pool handle
        self._done: torch.cuda.Event | None = None

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if not _on_card(tensors) or graphs_disabled():
            return self.fn(*args)
        is_bound = self._bound_mask(args)
        key = (spec, tuple(
            (tuple(x.shape), x.dtype, x.device, x.data_ptr() if b else None)
            if isinstance(x, torch.Tensor) else x for x, b in zip(leaves, is_bound)))
        with self._lock:
            stream = torch.cuda.current_stream(tensors[0].device)
            if self._done is not None:
                stream.wait_event(self._done)
            entry = self.graphs.get(key)
            if entry is None:
                with _CAPTURE_LOCK:
                    entry = self.graphs[key] = self._capture(leaves, spec, is_bound,
                                                             tensors[0].device)
                self.captures += 1
            for dst, src, b in zip(entry.static, leaves, is_bound):
                if isinstance(src, torch.Tensor) and not b:
                    dst.copy_(src)
            entry.graph.replay()
            out = pytree.tree_map(
                lambda x: x.clone() if isinstance(x, torch.Tensor) else x, entry.out)
            self._done = torch.cuda.Event()
            self._done.record(stream)
            self.replays += 1
            if self.effects is not None:
                self.effects.replay(entry.recorded)
        cuda_kernels.add_launches(entry.launches)
        return out

    def clear(self) -> None:
        """Drop every graph, its static inputs and its references to bound
        tensors; the next call captures anew, into a new memory pool (a pool
        whose graphs are all gone may not take another capture; its blocks
        return to the allocator when it next frees cached memory)."""
        with self._lock:
            self.graphs.clear()
            self._pools.clear()

    def _bound_mask(self, args) -> list[bool]:
        """Per pytree leaf of `args`: does it belong to a bound argument?"""
        mask = []
        for i, a in enumerate(args):
            mask += [i in self.bound] * len(pytree.tree_leaves(a))
        return mask

    def _capture(self, leaves, spec, is_bound, device) -> _Entry:
        # static inputs: copies of the free tensors, the caller's own bound ones
        static = [x.clone() if isinstance(x, torch.Tensor) and not b else x
                  for x, b in zip(leaves, is_bound)]
        # the warm-up call runs on copies of the bound tensors too, so that
        # it leaves the caller's state as it found it
        warm = [x.clone() if isinstance(x, torch.Tensor) and b else x
                for x, b in zip(static, is_bound)]
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        pool = self._pools.get(device)
        if pool is None:
            pool = self._pools[device] = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        with self._recording(), torch.cuda.stream(side):   # one warm-up call, as CUDA graphs ask
            self.fn(*pytree.tree_unflatten(warm, spec))
        del warm
        graph = torch.cuda.CUDAGraph()
        args = pytree.tree_unflatten(static, spec)
        with (self._recording() as recorded, cuda_kernels.counted_apart() as launched,
              torch.cuda.stream(side)):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = self.fn(*args)
            except BaseException:
                with contextlib.suppress(Exception):   # the first error is the one to see
                    graph.capture_end()
                raise
            graph.capture_end()
        current.wait_stream(side)
        return _Entry(graph, static, out, {k: v for k, v in launched.items() if v},
                      recorded)

    def _recording(self):
        return (self.effects.recording() if self.effects is not None
                else contextlib.nullcontext())

"""Replay a fixed-shape tensor function as one CUDA graph.

Eager PyTorch on the card pays host time for every launch (~25 µs a small
op on the H100 machine, `PERF.md` §5), and the front-end's KLT tracker and
window solve are thousands of small launches with fixed shapes, a fixed
iteration count and no read back to the host. `GraphedCall(fn)` captures
`fn` once per input signature (the pytree structure, each tensor's shape,
dtype and device, and the value of every non-tensor leaf) into a
`torch.cuda.CUDAGraph` over static copies of its inputs, and afterwards
copies the inputs in, replays the graph and returns clones of the outputs:
the same kernels in the same order as the eager call, so the same bits.
Calls on CPU tensors run `fn` itself; a capture that fails on the card
raises.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

__all__ = ["GraphedCall"]


class GraphedCall:
    """`fn(*args)` through a CUDA graph per input signature (see the module
    docstring). `fn` must not read device values back to the host, nor
    copy host data to the device, nor branch on tensor values."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs: dict = {}
        self.replays = 0

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if not tensors or tensors[0].device.type != "cuda":
            return self.fn(*args)
        key = (spec, tuple((tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
                           else x for x in leaves))
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(leaves, spec)
        graph, static, out = entry
        for dst, src in zip(static, leaves):
            if isinstance(src, torch.Tensor):
                dst.copy_(src)
        graph.replay()
        self.replays += 1
        return pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, out)

    def _capture(self, leaves, spec):
        static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        args = pytree.tree_unflatten(static, spec)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # one warm-up call, as CUDA graphs ask
            self.fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.fn(*args)
        return graph, static, out

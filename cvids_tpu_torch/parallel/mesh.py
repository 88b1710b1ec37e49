"""Process meshes and the sharded server paths on `torch.distributed`
(port of ``cvids_tpu/parallel/mesh.py``).

JAX puts N devices in one process and XLA inserts the collectives from
sharding annotations. Here each rank is a process of its own and every
collective is an explicit call through `Mesh.all_reduce`, which logs it for
the audit (``parallel/audit.py``). All-reduce is the only collective the
port issues: gloo, the backend of ranks that share one card, offers only
all-reduce and broadcast on CUDA tensors, and a gather is an all-reduce of
a zero-filled buffer.

- the **agent axis** shards per-agent work: `sharded_dense_fuse` fuses a
  rank's block of agents on its own card, with no collective (the
  reference's one process per agent stream);
- the **edge axis** of the 4-DoF solve: `shard_posegraph_solve` replicates
  the nodes and gives each rank a contiguous block of the edges; the LM
  loop's segment sums and costs are all-reduced.

On NCCL ranks on the card the sharded solves replay CUDA graphs of one LM
iteration, collectives included (`Mesh.graphed`): the reference's
`jax.jit` of the sharded program. Gloo collectives cannot be captured, so
on gloo, on the CPU, on a one-rank mesh and inside
`utils.cuda_graph.disable_graphs()` the same iteration runs eagerly.

`launch` starts the ranks: `nccl` with one card a rank, or `gloo` with every
rank on one device (the CPU, or one card that all ranks share).
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile

import torch
import torch.distributed as dist

from .. import resolve_device
from ..server import optimizer as opt

__all__ = ["Mesh", "make_mesh", "launch", "pad_edges_for_sharding",
           "shard_posegraph_solve", "sharded_dense_fuse"]


class Mesh:
    """The ranks of one process group along one named axis.

    `all_reduce` sums a tensor in place across the ranks and appends
    (op, payload bytes) to `log`, one entry a call; on a one-rank mesh it is
    the identity and issues and logs nothing. Under a CUDA graph of
    `graphed`, the log follows the device: a replay appends the calls that
    the capture made, and the warm-up call appends nothing."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 axis: str = "agents", group=None):
        self.rank, self.size, self.device = rank, size, device
        self.axis, self.group = axis, group
        self.log: list[tuple[str, int]] = []
        self._record: list[tuple[str, int]] | None = None
        self.graphs: dict = {}

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return t
        call = ("all-reduce", t.numel() * t.element_size())
        (self.log if self._record is None else self._record).append(call)
        dist.all_reduce(t, group=self.group)
        return t

    @contextlib.contextmanager
    def recording(self):
        """Within, the calls are appended to the yielded list instead of
        `log` (a graph's warm-up and capture, `GraphedCall(effects=)`)."""
        outer, self._record = self._record, []
        try:
            yield self._record
        finally:
            self._record = outer

    def replay(self, calls: list[tuple[str, int]]) -> None:
        """Log `calls` as issued: the collectives of one graph replay."""
        self.log.extend(calls)

    def graphs_allowed(self) -> bool:
        """Can this mesh's collectives be captured: NCCL ranks on the card,
        more than one of them."""
        return (self.size > 1 and self.device.type == "cuda"
                and dist.get_backend(self.group) == "nccl")

    def graphed(self, fn):
        """`fn` replayed as a CUDA graph per input signature on this mesh
        (`utils.cuda_graph.GraphedCall`, one per `fn`, its collectives
        logged at each replay) where `graphs_allowed()`, else `fn` itself.
        Every rank must call it with the same signatures in the same order,
        so that all capture the same collectives. A capture or replay that
        fails raises."""
        if not self.graphs_allowed():
            return fn
        call = self.graphs.get(fn)
        if call is None:
            from ..utils.cuda_graph import GraphedCall
            call = self.graphs[fn] = GraphedCall(fn, effects=self)
        return call

    def release_graphs(self) -> None:
        """Drop every graph of `graphed`. `dist.destroy_process_group` does
        not return while a graph that holds the group's NCCL collectives
        exists (NCCL 2.28 on H100s: the ranks never exit), so release them
        first; `launch` does."""
        for call in self.graphs.values():
            call.clear()
        self.graphs.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def block(self, n: int) -> slice:
        """This rank's contiguous block of an axis of `n`, a multiple of the
        mesh size (the shard of `PartitionSpec(axis)`)."""
        if n % self.size:
            raise ValueError(f"an axis of {n} does not split into {self.size} equal blocks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def take_log(self) -> list[tuple[str, int]]:
        """The calls logged since the last `take_log`, and a fresh log."""
        out, self.log = self.log, []
        return out


def make_mesh(n_devices: int | None = None, axis: str = "agents",
              device: torch.device | str | None = None) -> Mesh:
    """Inside an initialized process group of world W: a mesh over all W
    ranks (`n_devices`, when given, must equal W). With no process group: a
    one-rank mesh. `device=None` is `resolve_device(None)`: the current card,
    or the RuntimeError that names `device="cpu"`. JAX's `make_mesh(8)` is
    8 devices of one process; a mesh of N here needs N ranks (`launch`)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"a mesh of {n_devices} in a process group of {world} ranks")
        return Mesh(dist.get_rank(), world, dev, axis, dist.group.WORLD)
    if n_devices not in (None, 1):
        raise ValueError(f"a mesh of {n_devices} needs {n_devices} ranks: start them "
                         f"with parallel.launch")
    return Mesh(0, 1, dev, axis)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, backend, devices, port, tmp):
    """A spawned rank: join the group, run `fn(mesh, *args)` with the args
    saved in `tmp`, and on rank 0 save its result, moved to the host, there;
    then release the mesh's graphs and leave the group. An exception ends
    the process; `torch.multiprocessing.spawn` raises its traceback in the
    parent."""
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)    # the ranks share the host's cores
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    mesh = make_mesh(world, device=dev)
    try:
        result = fn(mesh, *args)
        if rank == 0:
            torch.save(_to_host(result), os.path.join(tmp, "rank0.pt"))
    finally:
        mesh.release_graphs()
    dist.destroy_process_group()


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def launch(fn, world: int, backend: str, device: torch.device | str | None = None, *args):
    """Run `fn(mesh, *args)` on `world` spawned ranks of one process group
    and return rank 0's result, its tensors moved to the host. `fn` and
    `args` are pickled (a function of a module, numpy and host values).

    - `backend="nccl"`: rank r on `cuda:r`; raises when there are fewer
      than `world` cards.
    - `backend="gloo"`: every rank on `device` (None: the card); the CPU
      ranks run one intra-op thread each.

    A rank that raises makes the call raise with that rank's traceback; the
    other ranks are stopped. The parent builds the CUDA kernel library
    before any rank loads it (the ranks' paths load no host library)."""
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise RuntimeError(
                f'launch(backend="nccl") puts one rank on each card and needs {world} CUDA '
                f'devices, and torch.cuda.device_count() is {have}; pass backend="gloo" to '
                f'share one device (device="cpu" to run on the CPU)')
        devices = [f"cuda:{r}" for r in range(world)]
    elif backend == "gloo":
        devices = [str(resolve_device(device))] * world
    else:
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if devices[0].startswith("cuda"):
        from .. import _build
        _build.build()
    with tempfile.TemporaryDirectory(prefix="cvids_launch_") as tmp:
        # through a file: a spawned process reads its pickled arguments
        # after it has started, and a write that fills the pipe would hold
        # the next rank's start until then
        torch.save(args, os.path.join(tmp, "args.pt"))
        torch.multiprocessing.spawn(_rank_main, nprocs=world, join=True,
                                    args=(fn, world, backend, devices, _free_port(), tmp))
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)


def pad_edges_for_sharding(edges: opt.PoseGraphEdges, n_shards: int) -> opt.PoseGraphEdges:
    """Pad the edge axis to a multiple of the mesh size with zeros: the
    padding is invalid and leaves every residual unchanged."""
    pad = (-edges.i.shape[0]) % n_shards
    if pad == 0:
        return edges
    return opt.PoseGraphEdges(*(
        torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype, device=x.device)])
        for x in edges))


def shard_posegraph_solve(mesh: Mesh, lm_iters: int = 10, cg_iters: int = 40):
    """The 4-DoF solve with the edges sharded over `mesh`: a callable
    `(nodes, edges) -> nodes`. Nodes are replicated (4 floats a keyframe);
    of the padded edge arrays (`pad_edges_for_sharding`) each rank keeps its
    contiguous block of E / W, so residuals and Jacobians are evaluated
    locally, and `optimize_pose_graph` all-reduces every segment sum and
    cost through the mesh: 1 + lm_iters * (cg_iters + 2) calls, of which
    lm_iters * cg_iters carry (N, 4) floats, lm_iters (N, 8) and the rest
    one float.

    On NCCL ranks on the card the first cost runs eagerly (its all-reduce
    also sets up the communicator before any capture) and one LM iteration,
    with its cg_iters + 2 all-reduces, is a CUDA graph (`Mesh.graphed`,
    keyed by the shapes and `cg_iters`) replayed `lm_iters` times; elsewhere
    the iterations run eagerly. The same kernels in the same order."""
    def solve(nodes: opt.PoseGraphNodes, edges: opt.PoseGraphEdges) -> opt.PoseGraphNodes:
        mine = mesh.block(edges.i.shape[0])
        return opt._lm_loop(mesh.graphed(opt._lm_step), nodes,
                            opt.PoseGraphEdges(*(x[mine] for x in edges)),
                            lm_iters, cg_iters, reduce=mesh.all_reduce)
    return solve


def sharded_dense_fuse(mesh: Mesh, cfg):
    """Dense fusion with the agent axis sharded over `mesh`: a callable
    `(states, imgs, a_mats, b_vecs, banded_warp=None) -> [DenseState]` over
    this rank's block of agents (sequences of `DenseState`s, (H, W) images,
    (3, 3) and (3,) tensors), running `dense.estimator.fuse_measurement`
    for each on the rank's device. `banded_warp` is the host gate's answer
    (`fuse_measurement`'s). Issues no collective, so on the card each
    frame is the server's replayed CUDA graph (`estimator.fuse_graphs`, one
    graph per state the callable is given, which it keeps alive); it
    updates each state in place and returns the states."""
    from ..dense import estimator

    graphs = estimator.fuse_graphs()

    def fuse(states, imgs, a_mats, b_vecs, banded_warp=None):
        for st, img, a, b in zip(states, imgs, a_mats, b_vecs, strict=True):
            graphs(cfg, st, img.to(torch.float32), a, b, banded_warp)
        return list(states)
    return fuse

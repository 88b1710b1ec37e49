"""Multi-GPU execution on `torch.distributed` (port of ``cvids_tpu/parallel``):
process meshes and `launch`, the edge-sharded 4-DoF solve, the agent-sharded
dense step, the landmark-sharded window Schur solve and the collective
audit. The chunk-sharded TSDF is `mapping.tsdf.sharded_integrate`."""

from .audit import collective_payloads, summarize_collectives  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    launch,
    make_mesh,
    pad_edges_for_sharding,
    shard_posegraph_solve,
    sharded_dense_fuse,
)
from .window_schur import solve_window_schur_sharded  # noqa: F401

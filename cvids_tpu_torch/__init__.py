"""cvids_tpu_torch — the PyTorch/CUDA port of ``cvids_tpu``.

A second package beside the JAX reference, with the same module layout
(``cvids_tpu_torch/ops/sgm.py`` ports ``cvids_tpu/ops/sgm.py``), the same
public names, argument order and array layouts. Plain tensor code is
PyTorch; every Pallas TPU kernel on the ported path is a CUDA C++ kernel for
Hopper (``csrc/``), built at first use by ``_build.py`` and bound in
``ops/cuda_kernels.py`` beside a plain PyTorch twin of each.

Ported so far:

- ``ops``:      image blur, gradients, pyramids and warps, plane-sweep cost,
                SGM + WTA,
                Gaussian×Beta depth filter, Hamming matching, PnP,
                fundamental-matrix and essential-matrix RANSAC, FAST, BRIEF
                and pyramidal KLT, and the six CUDA kernels of
                ``ops/cuda_kernels.py``: ``projective_warp_banded``,
                ``plane_sweep``, ``sgm_scan_bidir`` (both orientations),
                ``wta``, ``depth_filter_update``, ``hamming_matrix``
- ``dense``:    multi-view depth estimation (``fuse_measurement``)
- ``geometry``: rotations and quaternions, SE(3) poses, the 4-DoF (yaw +
                translation) algebra, float64 numpy helpers for the
                server's host-side bookkeeping
- ``camera``:   pinhole + radtan, equidistant (fisheye), Mei and Scaramuzza
                models with ``project``/``lift``, ``make_camera``, intrinsic
                calibration and the chessboard detector; the server's
                ``set_client_camera`` builds a client's remap grid from them
- ``server``:   the whole collaborative server (``pipeline``: packets
                with images -> pose graph -> per-client dense depth ->
                TSDF -> mesh), the pose graph (``posegraph``: ingestion,
                pipelined loop detection, submap alignment, background
                solves), its keyframe store, BoW vocabularies and databases
                (``vocab``), PCM outlier rejection (``pcm``), the 4-DoF
                pose-graph optimizer and the relaxation smoother
- ``mapping``:  the chunked TSDF volume on the device (``tsdf``, with the
                chunk-sharded ``shard_pool`` / ``sharded_integrate``) and
                its meshing by marching tetrahedra with PLY export
                (``mesh``, ``ops/marching_cubes.py``)
- ``vio``:      the agent: IMU preintegration, the visual-inertial
                bootstrap, the sliding-window BA and ``AgentFrontend``
                (pixels and IMU in, keyframe packets out)
- ``utils``:    stage tracing, server/TSDF checkpoints (the JAX package's
                npz layout, so either package loads the other's), the typed
                configs (``config``), trajectory metrics, the CUDA-graph
                replay of fixed-shape calls (``cuda_graph``), the WebGL
                viewer (``viewer``) and the plots (``visualization``)
- ``io``:       the keyframe packet and its wire codec, the socket
                transport between agent processes and the server, EuRoC
                datasets (reader and synthetic writer, with the port's own
                PNG codec and sensor.yaml reader), TUM files, the synthetic
                sequences and multi-agent streams, and the renderers (numpy,
                copied from ``cvids_tpu.io``)
- ``native``:   the C++ max clique for PCM and the inverted-index BoW
                database (``fmc.cpp``, ``bow.cpp``, built with the host's
                compiler at first use)
- ``parallel``: multi-GPU on ``torch.distributed``: process meshes and
                ``launch`` (nccl with a card a rank, or gloo ranks sharing
                one device), the edge-sharded 4-DoF solve, the
                agent-sharded dense step, the landmark-sharded window Schur
                solve and the audit of the collectives a run issues
- ``apps``:     the programs: ``run_synthetic``, ``run_euroc`` and
                ``agent_process`` (one agent of the deployment, streaming
                over a socket); ``entry``: the server's compute step with
                example inputs, and ``dryrun_multichip``, the sharded
                server step on N ranks
- ``interop``:  carry the JAX package's states, vocabularies, configs,
                TSDF volumes and cameras (as numpy) to the port and back

The package imports ``torch`` and never ``jax``, nor any module of
``cvids_tpu``: it runs without the JAX package.

Entry points that own device state (``CollaborativeServer``,
``CollaborativePoseGraph``, ``TsdfVolume``, ``SparseBowDatabase``,
``train_vocabulary``, ``generic_vocabulary``, ``AgentFrontend``), the
apps and the agent process, ``parallel.make_mesh`` outside a process
group, and the helpers that make tensors from nothing or
from host data (``ops.depth_filter.init_state``,
``ops.hamming.descriptors_to_torch``, ``ops.ransac.gumbel_noise``, the
cameras' ``create``, ``camera.make_camera`` and the chessboard tools) run on
the card unless the caller names a device: ``device=None`` means
`default_device()`, which raises where there is no card rather than falling
back to the CPU. Pass ``device="cpu"`` to run the
PyTorch twins on the host, as the CPU tests do.
"""

import torch

__version__ = "0.1.0"

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """The device the port's entry points use when none is given: the
    current CUDA card. Raises when there is none, so nothing runs on the CPU
    unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cvids_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    return default_device() if device is None else torch.device(device)

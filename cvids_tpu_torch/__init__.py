"""cvids_tpu_torch — the PyTorch/CUDA port of ``cvids_tpu``.

A second package beside the JAX reference, with the same module layout
(``cvids_tpu_torch/ops/sgm.py`` ports ``cvids_tpu/ops/sgm.py``), the same
public names, argument order and array layouts. Plain tensor code is
PyTorch; every Pallas TPU kernel on the ported path is a CUDA C++ kernel for
Hopper (``csrc/``), built at first use by ``_build.py`` and bound in
``ops/cuda_kernels.py`` beside a plain PyTorch twin of each.

Ported so far (the step ``__graft_entry__.entry()`` runs):

- ``ops``:     image gradients and warps, plane-sweep cost, SGM + WTA,
               Gaussian×Beta depth filter, the four CUDA kernels
- ``dense``:   multi-view depth estimation (``fuse_measurement``)
- ``geometry``: the yaw-pitch-roll helpers the 4-DoF solver uses
- ``server``:  the 4-DoF pose-graph optimizer
- ``interop``: carry the JAX package's states (as numpy) to tensors and back

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

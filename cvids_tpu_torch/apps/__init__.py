"""The port's programs, counterparts of the JAX package's examples:
`run_synthetic` and `run_euroc` (``examples/run_{synthetic,euroc}.py``) and
`agent_process`, one agent of the reference's deployment (a front-end on an
EuRoC-format sequence streaming packets over a socket). Run as
``python -m cvids_tpu_torch.apps.run_euroc --seq DIR ...``; they take the
card unless given ``--device cpu``."""

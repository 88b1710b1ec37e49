"""Host-only inputs and outputs of the system, numpy only: the keyframe
packet (`msgs`) and its wire codec (`codec`), the cross-process socket
transport (`transport`), the synthetic sequences and multi-agent streams
(`multiagent`, `synthetic`), the renderers (`render`), EuRoC datasets
(`euroc`, and `euroc_synth`, which writes one) with the port's own PNG
codec (`png`) and sensor.yaml reader (`sensor_yaml`), and TUM trajectory
files (`tum`)."""

from . import synthetic  # noqa: F401

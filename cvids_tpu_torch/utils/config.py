"""Typed configuration (port of the camera part of
``cvids_tpu/utils/config.py``; the agent and system configurations come with
the VIO front-end)."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CameraConfig"]


@dataclass
class CameraConfig:
    """Pinhole + radtan (the EuRoC rig; `euroc_config.yaml:10-22`)."""

    fx: float = 461.6
    fy: float = 460.3
    cx: float = 363.0
    cy: float = 248.1
    k1: float = -0.2917
    k2: float = 0.08228
    p1: float = 5.333e-05
    p2: float = -1.578e-04
    width: int = 752
    height: int = 480
    model: str = "pinhole"  # pinhole | equidistant | mei
    xi: float = 0.0         # Mei mirror offset (unused by other models)

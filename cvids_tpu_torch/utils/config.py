"""Unified typed configuration tree (port of ``cvids_tpu/utils/config.py``).

The reference splits configuration across roslaunch params, per-agent
OpenCV-YAML sensor files (`config/euroc/euroc_config.yaml`) and compile-time
CUDA constants (`dense_mapping_parameters.h`); here one dataclass tree covers
all of it, loadable from a dict with the reference's agent config keys and
overridable field by field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from ..dense.estimator import DenseConfig
from ..mapping.tsdf import TsdfConfig
from ..server.posegraph import ServerConfig
from ..vio.imu import ImuNoise

__all__ = ["CameraConfig", "AgentConfig", "SystemConfig", "load_agent_yaml"]


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


@dataclass
class AgentConfig:
    """Per-agent front-end + solver settings (VINS-format keys)."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    imu: ImuNoise = field(default_factory=ImuNoise)
    max_features: int = 150       # `max_cnt` (euroc_config.yaml:44)
    min_feature_dist: int = 30    # `min_dist` (:45)
    keyframe_freq: float = 10.0   # `freq` (:46): max keyframe publish rate
    # camera-rate keyframe selection (`AgentFrontend.process_frame`): median
    # rotation-compensated parallax (pixels at a 460 px focal) that promotes
    # a frame to keyframe, VINS `keyframe_parallax: 10`
    keyframe_parallax: float = 10.0
    # failsafe: force a keyframe after this many seconds without one
    max_kf_interval: float = 1.0
    # track-survival trigger: keyframe when fewer than this fraction of the
    # last keyframe's features are still tracked
    kf_min_survival: float = 0.55
    # full-image FAST+BRIEF features per packet for the server's loop
    # matcher, budgeted apart from the tracker (`server_keyframe.cpp:267-290`
    # extracts all corners at threshold 20)
    loop_features: int = 512
    # photometric normalization before tracking/description, the role of
    # `equalize: 1` (euroc_config.yaml:47)
    equalize: bool = False
    # `fisheye: 1` + fisheye_mask.jpg (euroc_config.yaml:41): a circular
    # mask centered on (cx, cy) of radius fisheye_mask_radius (pixels; 0 ->
    # min(cx, cy, w-cx, h-cy))
    fisheye: bool = False
    fisheye_mask_radius: float = 0.0
    window_size: int = 10
    max_solver_iterations: int = 8  # `max_num_iterations` (:55)
    fast_threshold: float = 20.0
    # weight of the between-keyframe bias random-walk factor in the window
    # solve
    bias_weight: float = 50.0
    # keyframes solved after the VI bootstrap before the first packet
    publish_warmup: int = 2
    # body->camera extrinsics
    r_cb: tuple = ((0.0, -1.0, 0.0), (0.0, 0.0, -1.0), (1.0, 0.0, 0.0))
    p_bc: tuple = (0.0, 0.0, 0.0)


@dataclass
class SystemConfig:
    """Whole-system tree: agents + server + dense + tsdf."""

    num_agents: int = 1
    agents: list = field(default_factory=list)  # list[AgentConfig]
    server: ServerConfig = field(default_factory=ServerConfig)
    dense: DenseConfig = field(default_factory=DenseConfig)
    tsdf: TsdfConfig = field(default_factory=TsdfConfig)

    def __post_init__(self):
        while len(self.agents) < self.num_agents:
            self.agents.append(AgentConfig())

    def override(self, **kv) -> "SystemConfig":
        return dataclasses.replace(self, **kv)


_VINS_KEYS = {
    # VINS/reference yaml key -> (section, field)
    "max_cnt": ("agent", "max_features"),
    "min_dist": ("agent", "min_feature_dist"),
    "freq": ("agent", "keyframe_freq"),
    "equalize": ("agent", "equalize"),
    "max_num_iterations": ("agent", "max_solver_iterations"),
    "acc_n": ("imu", "acc_n"),
    "gyr_n": ("imu", "gyr_n"),
    "acc_w": ("imu", "acc_w"),
    "gyr_w": ("imu", "gyr_w"),
    "image_width": ("camera", "width"),
    "image_height": ("camera", "height"),
}


def load_agent_yaml(d: dict[str, Any]) -> AgentConfig:
    """Build an AgentConfig from a dict with the reference's VINS-style keys
    (`collaborative_server_system.cpp:128-183` reads the same fields)."""
    cam = CameraConfig()
    imu = {}
    agent = {}
    dist = d.get("distortion_parameters", {})
    proj = d.get("projection_parameters", {})
    cam = dataclasses.replace(
        cam,
        fx=float(proj.get("fx", cam.fx)), fy=float(proj.get("fy", cam.fy)),
        cx=float(proj.get("cx", cam.cx)), cy=float(proj.get("cy", cam.cy)),
        k1=float(dist.get("k1", cam.k1)), k2=float(dist.get("k2", cam.k2)),
        p1=float(dist.get("p1", cam.p1)), p2=float(dist.get("p2", cam.p2)),
        model=str(d.get("model_type", cam.model)).lower())
    for key, (section, fname) in _VINS_KEYS.items():
        if key not in d:
            continue
        if section == "imu":
            imu[fname] = float(d[key])
        elif section == "camera":
            cam = dataclasses.replace(cam, **{fname: int(d[key])})
        else:
            agent[fname] = type(getattr(AgentConfig(), fname))(d[key])
    return AgentConfig(camera=cam, imu=ImuNoise(**imu), **agent)

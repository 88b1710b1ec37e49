"""EuRoC MAV dataset (ASL format) reader (port of ``cvids_tpu/io/euroc.py``).

Replaces the reference's rosbag replay path: reads the standard `mav0/`
layout — `cam0/data.csv` + image files, `imu0/data.csv`,
`state_groundtruth_estimate0/data.csv` — into plain arrays. Images are
decoded by the port's own PNG codec (`io/png.py`) and the calibration by its
own `sensor.yaml` reader (`io/sensor_yaml.py`): the port needs neither PIL,
imageio nor PyYAML. Host numpy only; everything is gated on the dataset
being on disk (none ships with this repo: `io/euroc_synth.py` writes one).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from . import png, sensor_yaml

__all__ = ["EurocSequence", "load_euroc", "available", "load_agent_config"]


def available(root: str) -> bool:
    return os.path.isfile(os.path.join(root, "mav0", "imu0", "data.csv"))


@dataclass
class EurocSequence:
    imu_t: np.ndarray       # (M,) seconds
    gyr: np.ndarray         # (M, 3)
    acc: np.ndarray         # (M, 3)
    cam_t: np.ndarray       # (K,) seconds
    cam_files: list         # (K,) absolute paths
    gt_t: np.ndarray | None
    gt_p: np.ndarray | None
    gt_q: np.ndarray | None  # (N, 4) wxyz

    def load_image(self, i: int) -> np.ndarray:
        """Frame `i` as float32 (H, W); a color file is averaged over its
        channels, as `cvids_tpu/io/euroc.py:45-46` does."""
        img = png.read_png(self.cam_files[i])
        if img.ndim == 3:
            img = img.mean(axis=-1)
        return img.astype(np.float32)


def _read_csv(path: str) -> list:
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append(row)
    return rows


def load_agent_config(root: str, cam: str = "cam0"):
    """Build an `AgentConfig` from the dataset's own `sensor.yaml` files
    (intrinsics/distortion/resolution from `mav0/cam0/sensor.yaml`, noise
    densities from `mav0/imu0/sensor.yaml`, camera extrinsics from `T_BS`) —
    the role the reference's per-agent VINS config yaml plays
    (`collaborative_server_system.cpp:110-189`). Returns None if the camera
    sensor.yaml is absent (caller falls back to defaults).

    The intrinsics and distortion coefficients are made floats: YAML 1.1
    reads an exponent without a dot (`5e-05`, as Python prints 0.00005) as
    a string, which the JAX package passes on into the camera config."""
    from ..utils.config import AgentConfig, CameraConfig
    from ..vio.imu import ImuNoise

    cam_path = os.path.join(root, "mav0", cam, "sensor.yaml")
    if not os.path.isfile(cam_path):
        return None
    c = sensor_yaml.load(cam_path)
    fx, fy, cx, cy = (float(v) for v in c["intrinsics"])
    w, h = c["resolution"]
    dist = [float(v) for v in c.get("distortion_coefficients", [0, 0, 0, 0])]
    t_bs = np.asarray(c["T_BS"]["data"], np.float64).reshape(4, 4)
    cam_cfg = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy,
                           k1=dist[0], k2=dist[1], p1=dist[2], p2=dist[3],
                           width=int(w), height=int(h),
                           model=str(c.get("camera_model", "pinhole")).lower(),
                           xi=float(c.get("mirror_parameter", 0.0)))
    kwargs = dict(camera=cam_cfg,
                  r_cb=tuple(map(tuple, t_bs[:3, :3].T)),
                  p_bc=tuple(t_bs[:3, 3]))
    # optional feature-tracker keys (VINS `max_cnt`/`min_dist`,
    # `config/euroc/euroc_config.yaml:44-45`) — synthetic datasets write
    # them scaled to their resolution; real EuRoC yamls lack them
    if "max_cnt" in c:
        kwargs["max_features"] = int(c["max_cnt"])
    if "min_dist" in c:
        kwargs["min_feature_dist"] = int(c["min_dist"])
    if "fast_threshold" in c:
        kwargs["fast_threshold"] = float(c["fast_threshold"])
    if "equalize" in c:
        kwargs["equalize"] = bool(int(c["equalize"]))
    if "freq" in c:
        kwargs["keyframe_freq"] = float(c["freq"])
    if "keyframe_parallax" in c:
        kwargs["keyframe_parallax"] = float(c["keyframe_parallax"])
    if "fisheye" in c:
        kwargs["fisheye"] = bool(int(c["fisheye"]))
    imu_path = os.path.join(root, "mav0", "imu0", "sensor.yaml")
    if os.path.isfile(imu_path):
        i = sensor_yaml.load(imu_path)
        kwargs["imu"] = ImuNoise(
            acc_n=float(i.get("accelerometer_noise_density", 0.08)),
            gyr_n=float(i.get("gyroscope_noise_density", 0.004)),
            acc_w=float(i.get("accelerometer_random_walk", 4e-4)),
            gyr_w=float(i.get("gyroscope_random_walk", 4e-6)))
    return AgentConfig(**kwargs)


def load_euroc(root: str, cam: str = "cam0") -> EurocSequence:
    mav = os.path.join(root, "mav0")
    imu_rows = _read_csv(os.path.join(mav, "imu0", "data.csv"))
    imu = np.asarray([[float(x) for x in r] for r in imu_rows])
    imu_t = imu[:, 0] * 1e-9
    gyr = imu[:, 1:4]
    acc = imu[:, 4:7]

    cam_rows = _read_csv(os.path.join(mav, cam, "data.csv"))
    cam_t = np.asarray([float(r[0]) for r in cam_rows]) * 1e-9
    cam_files = [os.path.join(mav, cam, "data", r[1].strip()) for r in cam_rows]

    gt_t = gt_p = gt_q = None
    gt_path = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if os.path.isfile(gt_path):
        gt_rows = _read_csv(gt_path)
        gt = np.asarray([[float(x) for x in r] for r in gt_rows])
        gt_t = gt[:, 0] * 1e-9
        gt_p = gt[:, 1:4]
        gt_q = gt[:, 4:8]  # EuRoC stores qw qx qy qz (wxyz already)
    return EurocSequence(imu_t, gyr, acc, cam_t, cam_files, gt_t, gt_p, gt_q)

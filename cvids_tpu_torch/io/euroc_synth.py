"""Synthetic EuRoC (ASL-format) dataset writer (port of
``cvids_tpu/io/euroc_synth.py``).

The reference is validated against recorded EuRoC rosbags, which do not ship
with the repo. This module renders a synthetic visual-inertial sequence
(closed-form trajectory, exact IMU, Gaussian-blob landmark imagery) into the
*on-disk ASL layout*:

    <root>/mav0/cam0/{sensor.yaml, data.csv, data/<ns>.png}
    <root>/mav0/imu0/{sensor.yaml, data.csv}
    <root>/mav0/state_groundtruth_estimate0/data.csv

so the real-dataset path — `io.euroc.load_euroc` + `apps/run_euroc.py` —
is exercised end to end, byte-format-compatible with the actual dataset
(nanosecond integer timestamps, EuRoC CSV column orders, sensor.yaml
calibration blocks). It renders on the CPU through the port's `io/render`
and `camera.make_camera`, builds each body rotation in numpy float32 (the
JAX package's `quat_to_matrix` in float32 through XLA), and writes PNGs
through `io/png.py`.

`write_sequence_files` is the file-writing half on its own: it takes frames
that are already rendered and quantized (`chip_smoke.py` phase 9 writes
phase 8's frames through it).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.config import AgentConfig, CameraConfig
from . import png, render, synthetic

__all__ = ["write_euroc_sequence"]


def _write_csv(path: str, header: str, rows) -> None:
    with open(path, "w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(",".join(r) + "\n")


def _cam_sensor_yaml(cfg: CameraConfig, r_cb: np.ndarray, p_bc: np.ndarray,
                     rate_hz: float, tracker: dict | None = None) -> str:
    # T_BS = body-from-sensor; the extrinsics store r_cb (cam<-body) and
    # p_bc (cam origin in body), so R_BS = r_cb^T, t_BS = p_bc.
    t_bs = np.eye(4)
    t_bs[:3, :3] = np.asarray(r_cb, np.float64).T
    t_bs[:3, 3] = np.asarray(p_bc, np.float64)
    data = ", ".join(f"{v:.9f}" for v in t_bs.ravel())
    return (
        "%YAML:1.0\n"
        "sensor_type: camera\n"
        "T_BS:\n"
        "  cols: 4\n"
        "  rows: 4\n"
        f"  data: [{data}]\n"
        f"rate_hz: {rate_hz}\n"
        f"resolution: [{cfg.width}, {cfg.height}]\n"
        f"camera_model: {cfg.model}\n"
        f"intrinsics: [{cfg.fx}, {cfg.fy}, {cfg.cx}, {cfg.cy}]\n"
        + (f"mirror_parameter: {cfg.xi}\n" if cfg.model == "mei" else "")
        + ("distortion_model: equidistant\n"
           if cfg.model in ("equidistant", "kannala_brandt")
           else "distortion_model: radial-tangential\n")
        + f"distortion_coefficients: [{cfg.k1}, {cfg.k2}, {cfg.p1}, {cfg.p2}]\n"
        # feature-tracker keys (the reference carries these in the same
        # per-agent config: `config/euroc/euroc_config.yaml:44-45`); the
        # EuRoC loader treats them as optional extensions
        + ("".join(f"{k}: {v}\n" for k, v in (tracker or {}).items()))
    )


def _imu_sensor_yaml(rate_hz: float, gyr_noise: float, acc_noise: float) -> str:
    return (
        "%YAML:1.0\n"
        "sensor_type: imu\n"
        f"rate_hz: {rate_hz}\n"
        f"gyroscope_noise_density: {gyr_noise}\n"
        "gyroscope_random_walk: 4.0e-06\n"
        f"accelerometer_noise_density: {acc_noise}\n"
        "accelerometer_random_walk: 4.0e-04\n"
    )


def _ns(t: float) -> str:
    return str(int(round(t * 1e9)))


def write_sequence_files(root: str, cfg: AgentConfig, frames, cam_t: np.ndarray,
                         imu_t: np.ndarray, gyr: np.ndarray, acc: np.ndarray, gt: dict,
                         cam_rate: float, imu_rate: float, gyr_noise: float,
                         acc_noise: float, exact: bool = False) -> str:
    """Write one agent's sequence, already rendered, to `<root>/mav0/...`;
    returns `root`. `frames`: one (H, W) uint8 image per time of `cam_t`;
    `gt`: the ground truth at `cam_t` as arrays p (K, 3), q (K, 4, wxyz),
    v (K, 3) and the biases bg, ba (3,). The IMU and ground-truth values are
    written with 9 decimals, as the JAX package's writer writes them, or,
    with `exact`, with 17 significant digits, as EuRoC's own CSVs carry
    them: they then read back bit-equal (the times stay integer
    nanoseconds)."""
    num = "{:.17g}".format if exact else "{:.9f}".format
    cam_cfg = cfg.camera
    mav = os.path.join(root, "mav0")
    cam_dir = os.path.join(mav, "cam0")
    img_dir = os.path.join(cam_dir, "data")
    imu_dir = os.path.join(mav, "imu0")
    gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
    for d in (img_dir, imu_dir, gt_dir):
        os.makedirs(d, exist_ok=True)

    cam_rows = []
    for t, img in zip(cam_t, frames):
        name = f"{_ns(t)}.png"
        png.write_png(os.path.join(img_dir, name), img)
        cam_rows.append([_ns(t), name])
    _write_csv(os.path.join(cam_dir, "data.csv"), "#timestamp [ns],filename", cam_rows)
    with open(os.path.join(cam_dir, "sensor.yaml"), "w") as f:
        f.write(_cam_sensor_yaml(
            cam_cfg, cfg.r_cb, cfg.p_bc, cam_rate,
            tracker={"max_cnt": cfg.max_features,
                     "min_dist": cfg.min_feature_dist,
                     "fast_threshold": cfg.fast_threshold,
                     # the reference's equalize flag rides in the same
                     # per-agent config (euroc_config.yaml:47)
                     "equalize": int(cfg.equalize),
                     # keyframe-selection keys (`freq` + `keyframe_parallax`,
                     # euroc_config.yaml:46 + VINS estimator config)
                     "freq": cfg.keyframe_freq,
                     "keyframe_parallax": cfg.keyframe_parallax,
                     # `fisheye: 1` image-circle mask (euroc_config.yaml:41)
                     "fisheye": int(cfg.fisheye)}))

    # imu (EuRoC column order: t, w_xyz, a_xyz)
    imu_rows = [[_ns(t)] + [num(v) for v in gyr[i]] + [num(v) for v in acc[i]]
                for i, t in enumerate(imu_t)]
    _write_csv(os.path.join(imu_dir, "data.csv"),
               "#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
               "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
               "a_RS_S_z [m s^-2]", imu_rows)
    with open(os.path.join(imu_dir, "sensor.yaml"), "w") as f:
        f.write(_imu_sensor_yaml(imu_rate, gyr_noise, acc_noise))

    # ground truth (t, p, q_wxyz, v, bw, ba — 17 columns like EuRoC)
    gt_rows = [[_ns(t)] + [num(v) for v in np.concatenate(
        [gt["p"][i], gt["q"][i], gt["v"][i], gt["bg"], gt["ba"]])]
               for i, t in enumerate(cam_t)]
    _write_csv(os.path.join(gt_dir, "data.csv"),
               "#timestamp,p_RS_R_x [m],p_RS_R_y [m],p_RS_R_z [m],"
               "q_RS_w [],q_RS_x [],q_RS_y [],q_RS_z [],v_RS_R_x [m s^-1],"
               "v_RS_R_y [m s^-1],v_RS_R_z [m s^-1],b_w_RS_S_x [rad s^-1],"
               "b_w_RS_S_y [rad s^-1],b_w_RS_S_z [rad s^-1],"
               "b_a_RS_S_x [m s^-2],b_a_RS_S_y [m s^-2],b_a_RS_S_z [m s^-2]",
               gt_rows)
    return root


def write_euroc_sequence(
    root: str,
    cfg: AgentConfig | None = None,
    trajectory: synthetic.Trajectory | None = None,
    duration: float = 8.0,
    cam_rate: float = 2.0,
    imu_rate: float = 200.0,
    num_landmarks: int = 400,
    landmark_box: float = 12.0,
    seed: int = 0,
    world_seed: int | None = None,
    gyr_noise: float = 5e-4,
    acc_noise: float = 0.01,
    bg: tuple = (0.001, -0.001, 0.0005),
    ba: tuple = (0.005, -0.01, 0.02),
    scene: dict | None = None,
    photometric: dict | None = None,
) -> str:
    """Render one agent's sequence to `<root>/mav0/...`; returns `root`.

    `cam_rate` is the written camera rate (frames double as keyframes — for
    a full-rate dataset use 20.0 and a keyframe stride downstream).

    `scene`: optional `render.default_scene`-style dict. When given, frames
    are the ray-traced textured scene (through the camera's full distortion
    model) with feature blobs splatted at landmarks sampled ON the scene
    surfaces — one world consistent for both the sparse front-end and the
    dense mapper.

    `photometric`: optional realism nuisances. Keys (all optional):
      flicker (float, ±fractional auto-exposure swing, sinusoid + walk),
      vignette (float, corner falloff strength),
      noise_std / shot_noise (floats, sensor noise),
      exposure_time (float s; motion blur extent = angular rate x
      exposure_time x focal, direction from the gyro — rotational blur).
    """
    from ..camera import make_camera
    from ..geometry.hostmath import quat_to_matrix_np

    if cfg is None:
        cfg = AgentConfig()
    cam_cfg = cfg.camera
    if trajectory is None:
        trajectory = synthetic.Trajectory.circle(radius=4.0, omega=0.35, height_amp=0.2)
    seq = synthetic.generate_sequence(
        trajectory, duration=duration, kf_rate=cam_rate, imu_rate=imu_rate,
        num_landmarks=0, seed=seed, gyr_noise=gyr_noise, acc_noise=acc_noise,
        bg=bg, ba=ba)

    # the landmark cloud is the *world*: agents that should co-localize must
    # share it (same world_seed) while keeping per-agent sensor noise (seed)
    rng = np.random.default_rng((seed if world_seed is None else world_seed) + 77)
    if scene is not None:
        landmarks = render.sample_scene_landmarks(num_landmarks, rng, scene)
    else:
        landmarks = np.stack([
            rng.uniform(-landmark_box, landmark_box, num_landmarks),
            rng.uniform(-landmark_box, landmark_box, num_landmarks),
            rng.uniform(0.0, 3.5, num_landmarks)], -1)
    intens = rng.uniform(80, 200, num_landmarks)

    cam = make_camera(cam_cfg, device="cpu")
    r_cb = np.asarray(cfg.r_cb, np.float64)
    p_bc = np.asarray(cfg.p_bc, np.float64)

    pm = photometric or {}
    pm_rng = np.random.default_rng(seed + 3301)
    exp_walk = 0.0
    frames = []
    for i, t in enumerate(seq.times_kf):
        r_wb = quat_to_matrix_np(seq.q_gt[i].astype(np.float32)).astype(np.float32)
        base = None
        if scene is not None:
            r_wc = r_wb @ r_cb.T
            t_wc = seq.p_gt[i] + r_wb @ p_bc
            base, _ = render.render_textured_scene(cam, r_wc, t_wc, scene)
        img = render.render_blobs(cam, landmarks, intens, r_wb, seq.p_gt[i],
                                  r_cb, p_bc, base=base)
        if pm:
            flick = float(pm.get("flicker", 0.0))
            exp_walk = 0.9 * exp_walk + pm_rng.normal(0.0, 0.3 * flick)
            exposure = 1.0 + flick * np.sin(2.6 * t + 0.7) + exp_walk
            # rotational motion blur from the angular rate at t
            gi = int(np.argmin(np.abs(seq.imu_t - t)))
            w_c = r_cb @ seq.gyr[gi]             # body -> camera axes
            et = float(pm.get("exposure_time", 0.0))
            blur = float(np.hypot(w_c[0], w_c[1]) * et * cam_cfg.fx)
            img = render.apply_photometric(
                img, pm_rng, exposure=float(np.clip(exposure, 0.3, 3.0)),
                vignette=float(pm.get("vignette", 0.0)),
                noise_std=float(pm.get("noise_std", 0.0)),
                shot_noise=float(pm.get("shot_noise", 0.0)),
                blur_px=blur, blur_dir=(-w_c[1], w_c[0]))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return write_sequence_files(
        root, cfg, frames, seq.times_kf, seq.imu_t, seq.gyr, seq.acc,
        dict(p=seq.p_gt, q=seq.q_gt, v=seq.v_gt, bg=seq.bg_true, ba=seq.ba_true),
        cam_rate, imu_rate, gyr_noise, acc_noise)

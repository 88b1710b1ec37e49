"""The agent's visual-inertial front-end (port of ``cvids_tpu/vio``): IMU
preintegration (`imu`), the visual-inertial bootstrap (`initializer`), the
sliding-window bundle adjustment (`window_ba`) and `frontend.AgentFrontend`,
which turns pixels and IMU samples into keyframe packets."""

"""Camera models (port of ``cvids_tpu/camera``): pinhole + radtan,
equidistant (Kannala-Brandt), Mei (unified) and Scaramuzza (OCamCalib)
projections, their calibrators, the chessboard detector, and the factory
that builds a model from a `CameraConfig`. The class names matter: the
renderer and the server's remap grid pick a model's code path by
``type(cam).__name__``."""

from .pinhole import PinholeCamera, distort, undistort_iterative  # noqa: F401
from .models import (  # noqa: F401
    EquidistantCamera,
    MeiCamera,
    ScaramuzzaCamera,
    calibrate_pinhole,
)
from .chessboard import (  # noqa: F401
    calibrate_chessboards,
    chessboard_response,
    find_chessboard,
    render_chessboard,
)


def make_camera(cfg, device=None):
    """Camera factory — the camodocal `CameraFactory::generateCamera` role:
    build the right projection model from a `CameraConfig` (any object with
    its fields), on `device` (None: the card).

    `cfg.model`: "pinhole" (radtan), "equidistant"/"kannala_brandt"
    (fisheye; the 4 distortion fields carry k2..k5), or "mei" (unified,
    `cfg.xi` mirror offset + radtan).
    """
    model = str(getattr(cfg, "model", "pinhole") or "pinhole").lower()
    if model in ("pinhole", "radtan", "radial-tangential"):
        return PinholeCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                    (cfg.k1, cfg.k2, cfg.p1, cfg.p2),
                                    cfg.width, cfg.height, device=device)
    if model in ("equidistant", "kannala_brandt", "kannala-brandt",
                 "fisheye"):
        return EquidistantCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                        (cfg.k1, cfg.k2, cfg.p1, cfg.p2),
                                        cfg.width, cfg.height, device=device)
    if model in ("mei", "cata", "unified"):
        return MeiCamera.create(getattr(cfg, "xi", 0.0), cfg.fx, cfg.fy,
                                cfg.cx, cfg.cy,
                                (cfg.k1, cfg.k2, cfg.p1, cfg.p2),
                                cfg.width, cfg.height, device=device)
    raise ValueError(f"unknown camera model {model!r}")

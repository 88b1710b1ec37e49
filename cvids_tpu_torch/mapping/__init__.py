from . import mesh, tsdf  # noqa: F401

from . import checkpoint, config, metrics, tracing, viewer  # noqa: F401

from . import checkpoint, config, metrics, tracing  # noqa: F401

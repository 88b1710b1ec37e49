from . import checkpoint, config, tracing  # noqa: F401

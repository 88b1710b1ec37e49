from . import checkpoint, tracing  # noqa: F401

from . import estimator  # noqa: F401

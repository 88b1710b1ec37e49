from .rotations import *  # noqa: F401,F403

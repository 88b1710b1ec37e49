from .rotations import *  # noqa: F401,F403
from .se3 import *  # noqa: F401,F403

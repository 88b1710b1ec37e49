from .rotations import *  # noqa: F401,F403
from .se3 import *  # noqa: F401,F403
from . import fourdof  # noqa: F401
from . import hostmath  # noqa: F401

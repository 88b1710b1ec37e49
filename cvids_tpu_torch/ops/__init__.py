from . import brief, fast, hamming, image, klt, ransac  # noqa: F401

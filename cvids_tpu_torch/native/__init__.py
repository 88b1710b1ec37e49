"""Native C++ max clique for PCM, via ctypes (port of the max-clique part of
``cvids_tpu/native``).

The graphs are tiny and irregular (one node per inter-agent loop edge of a
client pair), so the search stays on the host, as in the reference. The
source, ``fmc.cpp``, is built at first use by `_build.build_host` into
``build/host/``; without a C++ compiler `available()` is False and
`server.pcm.max_clique` runs its Python search.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from .. import _build

__all__ = ["available", "max_clique_native"]

_SRC = Path(__file__).resolve().parent / "fmc.cpp"
_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(_build.build_host(_SRC)))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.cvids_max_clique_exact.restype = ctypes.c_int
    lib.cvids_max_clique_heu.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def max_clique_native(adj: np.ndarray, exact_threshold: int = 40) -> np.ndarray | None:
    """Native max clique; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(np.asarray(adj, np.uint8))
    np.fill_diagonal(a, 0)
    n = a.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    out = np.zeros(n, np.int32)
    pa = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    po = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if n <= exact_threshold:
        k = lib.cvids_max_clique_exact(pa, n, po)
    else:
        k = lib.cvids_max_clique_heu(pa, n, po, 30)
    return np.sort(out[:k]).astype(np.int64)

"""Native C++ host helpers via ctypes (port of ``cvids_tpu/native``): the
max clique for PCM and the inverted-index BoW database.

Both are tiny and irregular (one node per inter-agent loop edge of a client
pair; word -> posting lists), so they stay on the host, as in the reference.
The sources, ``fmc.cpp`` and ``bow.cpp`` (copies of the JAX package's), are
each built at first use by `_build.build_host` into ``build/host/``. Without
a C++ compiler `available()` is False and `server.pcm.max_clique` runs its
Python search; `NativeBowIndex` raises, naming why its library is missing.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from .. import _build

__all__ = ["available", "max_clique_native", "NativeBowIndex"]

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "fmc.cpp"
_BOW_SRC = _DIR / "bow.cpp"
_LIB = None
_TRIED = False
_BOW_LIB = None


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


def _load_bow():
    """The BoW library, built on first call; raises RuntimeError when it
    cannot be built or loaded."""
    global _BOW_LIB
    if _BOW_LIB is None:
        try:
            lib = ctypes.CDLL(str(_build.build_host(_BOW_SRC)))
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native BoW library unavailable: {e}") from e
        lib.cvids_bow_create.restype = ctypes.c_void_p
        lib.cvids_bow_create.argtypes = [ctypes.c_int]
        lib.cvids_bow_destroy.argtypes = [ctypes.c_void_p]
        lib.cvids_bow_add.restype = ctypes.c_int
        lib.cvids_bow_count.restype = ctypes.c_int
        lib.cvids_bow_count.argtypes = [ctypes.c_void_p]
        _BOW_LIB = lib
    return _BOW_LIB


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


class NativeBowIndex:
    """Inverted-index BoW database: the L1 score of DBoW2 as the sum over
    shared words of min(q_w, d_w) (unit-norm vectors), touching only the
    entries that share a word with the query (`bow.cpp`). The dense scorer
    of the same function is `server.vocab`'s."""

    def __init__(self, num_words: int):
        self._lib = _load_bow()
        self._h = ctypes.c_void_p(self._lib.cvids_bow_create(num_words))
        self.num_words = num_words

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cvids_bow_destroy(self._h)
            self._h = None

    @staticmethod
    def _sparse(vec: np.ndarray):
        nz = np.nonzero(vec)[0].astype(np.int32)
        return nz, np.ascontiguousarray(np.asarray(vec)[nz], np.float32)

    def add(self, vec: np.ndarray, client_id: int = 0) -> int:
        nz, wts = self._sparse(vec)
        return self._lib.cvids_bow_add(
            self._h, nz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            wts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(nz), client_id)

    @property
    def count(self) -> int:
        return self._lib.cvids_bow_count(self._h)

    def query(self, vec: np.ndarray, exclude_from: int = -1) -> np.ndarray:
        n = self.count
        scores = np.zeros(max(n, 1), np.float32)
        nz, wts = self._sparse(vec)
        self._lib.cvids_bow_query(
            self._h, nz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            wts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(nz), exclude_from,
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return scores[:n]

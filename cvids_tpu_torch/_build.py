"""Build and load the CUDA kernel library (``csrc/*.cu``) at first use.

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` — seconds to build, where an extension that
includes PyTorch's headers takes minutes. The library lands in
``build/cuda/`` beside the package, named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads as is.

Every C entry point returns ``cudaGetLastError()`` after its launches; the
wrappers in ``ops/cuda_kernels.py`` raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cuda"

# -fmad=false: no fused multiply-adds, so each kernel rounds at the same
# points as its PyTorch twin and the two agree bit for bit where their
# operation order matches (the kernels are memory- or latency-bound; the
# lost FMAs cost nothing measurable)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, ints as c_int;
# each returns a cudaError_t as int
SIGNATURES = {
    "cvids_warp_banded": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cvids_plane_sweep": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cvids_sgm_scan_bidir": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P],
    "cvids_wta": [_P, _P, _P, _P, _I, _P, _P, ctypes.c_long, _I, _I,
                  ctypes.c_float, _P],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcvids_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if its hash is not built yet.

    Returns (path, compiler log). The log holds ``-Xptxas -v``'s registers,
    shared memory and spills per kernel, and is kept beside the library."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cus = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *cus]
    res = subprocess.run(cmd, capture_output=True, text=True)
    text = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{text}")
    log.write_text(text)
    os.replace(tmp, out)
    return out, text


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; declares every signature."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.cvids_error_string.argtypes = [ctypes.c_int]
        lib.cvids_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib

"""Build and load the CUDA kernel library (``csrc/*.cu``) at first use.

Each source compiles with its own ``nvcc`` (all started together), and the
objects link into one shared library with a plain C interface, loaded with
``ctypes`` — seconds to build, where an extension that includes PyTorch's
headers takes minutes. The library lands in
``build/cuda/`` beside the package, named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads as is.

Every C entry point returns ``cudaGetLastError()`` after its launches; the
wrappers in ``ops/cuda_kernels.py`` raise when it is not 0.

`build_host` does the same for a host-only C++ source (the native max
clique ``native/fmc.cpp`` and BoW index ``native/bow.cpp``, one library
each) with the host's C++ compiler, into ``build/host/``.
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
HOST_BUILD_DIR = _PKG.parent / "build" / "host"
HOST_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

# -fmad=false: no fused multiply-adds, so each kernel rounds at the same
# points as its PyTorch twin and the two agree bit for bit where their
# operation order matches (the kernels are memory- or latency-bound; the
# lost FMAs cost nothing measurable)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v", "-lineinfo"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p, ints as c_int,
# floats as c_float; each returns a cudaError_t as int
SIGNATURES = {
    "cvids_warp_banded": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cvids_plane_sweep": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cvids_plane_sweep_plan": [_I, _I, _I, ctypes.POINTER(_I)],
    "cvids_sgm_scan_bidir": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "cvids_sgm_scan_plan": [_I, _I, _I, ctypes.POINTER(_I)],
    "cvids_wta": [_P, _P, _P, _P, _I, _P, _P, ctypes.c_long, _I, _I, _F, _P],
    "cvids_wta_plan": [ctypes.c_long, _I, _I, ctypes.POINTER(_I)],
    "cvids_hamming": [_P, _P, _P, _P, _P, _I, _I, _P],
    "cvids_hamming_plan": [_I, _I, ctypes.POINTER(_I)],
    "cvids_depth_filter": [_P, _P, _P, _P, _P, _P, _F, _P, _F, _F, _F,
                           _P, _P, _P, _P, ctypes.c_long, _P],
    "cvids_small_eig": [_P, _P, _P, _I, _I, _I, _I, _P],
    "cvids_empty": [_P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcvids_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if its hash is not built yet: one ``nvcc -c`` per
    source, all running at once, then one link.

    Returns (path, compiler log). The log holds ``-Xptxas -v``'s registers,
    shared memory and spills per kernel, and is kept beside the library."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    texts, failed = [], []
    for src, _, proc in jobs:
        texts.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    text = "".join(texts)
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{text}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    log.write_text(text)
    os.replace(tmp, out)
    return out, text


def build_host(src: Path) -> Path:
    """Compile one host-only C++ source into a shared library under
    ``build/host/``, named by a hash of the source and flags, unless it is
    built already. Raises RuntimeError when no compiler is found or it
    fails."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(src.read_bytes())
    out = HOST_BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError(f"no C++ compiler for {src.name}")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {src.name} ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


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

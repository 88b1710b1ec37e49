"""Build a window_lm.cu into a shared library that runs on the CPU, with
every CUDA thread an OS thread (``emu.h``), for bit-for-bit comparisons of
two kernel sources without a card.

    python3 dev/wlm_emulator/build.py SOURCE OUT.so [extra g++ flags]

The source's inline PTX (the cluster rank, ``mapa``, the cluster barrier's
two halves, ``cp.async``) is replaced by the emulator's calls, its dynamic
shared memory by the emulated block's array and its launch by
`emu_launch`. Needs g++ with C++20 (``std::barrier``). See ``compare.py``.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE.parents[1] / "cvids_tpu_torch" / "csrc"


def _asm(stmt: str) -> str:
    if "cluster_ctarank" in stmt:
        return "r = blockIdx.x;"
    if "mapa" in stmt:
        return "out = emu_remote(reinterpret_cast<uint64_t>(p), rank);"
    if "barrier.cluster.arrive" in stmt:
        return "emu_cluster_arrive();"
    if "barrier.cluster.wait" in stmt:
        return "emu_cluster_wait();"
    if "cp.async.cg" in stmt:
        return "std::memcpy(dst, src, 16); (void)d;"
    if "cp.async" in stmt:
        return ";"
    raise SystemExit(f"no emulation for: {stmt}")


def translate(text: str) -> str:
    """The source with its CUDA-only constructs replaced."""
    text = text.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    text = re.sub(r"extern __shared__ (__align__\(16\) )?float sm\[\];",
                  "float* sm = emu_smem();", text)
    text = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),.*?>>>\((\w+)\);",
                  r"emu_launch(\1, \2, \3, \4, \5);", text)
    out, i = [], 0
    while True:
        j = text.find("asm volatile(", i)
        if j < 0:
            out.append(text[i:])
            return "".join(out)
        out.append(text[i:j])
        depth, k = 0, j + len("asm volatile")
        while True:
            if text[k] == "(":
                depth += 1
            elif text[k] == ")":
                depth -= 1
                if depth == 0:
                    break
            k += 1
        out.append(_asm(text[j:k + 2]))
        i = k + 2


def build(source: Path, out: Path, flags=()) -> Path:
    cpp = out.with_suffix(".cpp")
    cpp.write_text(translate(source.read_text()))
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", "-w", "-I", str(HERE), "-I", str(CSRC), *flags, "-o", str(out),
                    str(cpp)], check=True)
    return out


if __name__ == "__main__":
    build(Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3:])

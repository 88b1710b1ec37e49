"""Where the window kernel's cycles go, phase by phase.

    python3 dev/torch_probe_window_lm_phases.py [--package DIR] [--runs 20] [--k 10]

Builds a copy of the package's ``csrc/`` with ``-DCVIDS_WLM_CLOCKS`` into
``build/wlm_clocks/`` (outside the main build; the package's own library
is not touched), runs `cuda_kernels.window_lm` at `chip_smoke.py` phase 3's
window (K = 10, 600 slots, a 150-row prior, 8 iterations; `--k` another
K with the same slots) and prints one JSON line: the cycles of each phase
a call (``clock64`` of thread 0 of block 0, summed over the iterations; a
phase that ends in a cluster barrier counts the wait for the slowest
block; the cluster kernel also splits the landmark sums, the Cholesky and
the back substitution into their parts), their sum, and the call's
CUDA-event ms in this build. Needs a
card and nvcc. `--package DIR` takes the package under DIR (the parent
tree for an A/B, run one process a tree, in turns). A source without the
clock hooks (the single-block kernel of the tree before the cluster) gets
them inserted at its phase comments; a source that has neither the hooks
nor those comments is refused.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("init", "blocks_duals", "prior_rows", "landmark_list", "landmark_sums", "system",
          "cholesky", "back_substitution", "step", "cost", "accept",
          # the cluster kernel's parts of some of them (the rest of a phase,
          # mostly its closing cluster barrier, stays under its own name);
          # the step's cost is its camera rows
          "landmark_sums.units", "cholesky.wait", "cholesky.factor_block",
          "cholesky.next_panel", "cholesky.factor_rows", "cholesky.rest", "back_substitution.solve",
          "back_substitution.barrier", "back_substitution.update", "blocks_duals.own_items",
          "step.hd", "step.landmarks", "system.own_entries",
          # the first IMU column's item, in its own thread
          "dual_item.seeds", "dual_item.imu_rows", "dual_item.stores")

# the clock hooks, as ``csrc/window_lm.cu`` of the cluster kernel states them
HOOKS = r'''
#ifdef CVIDS_WLM_CLOCKS
__device__ unsigned long long cvids_wlm_clocks[32];
__shared__ long long cvids_wlm_t;
#define WLM_CLOCK_START                                                 \
  do {                                                                  \
    if (threadIdx.x == 0) cvids_wlm_t = clock64();                      \
  } while (0)
#define WLM_CLOCK(ph)                                                   \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                          \
      const long long t_ = clock64();                                   \
      cvids_wlm_clocks[ph] += static_cast<unsigned long long>(t_ - cvids_wlm_t); \
      cvids_wlm_t = t_;                                                 \
    }                                                                   \
  } while (0)
#endif
enum { C_INIT, C_BLOCKS, C_PRIOR, C_LIST, C_SUMS, C_SYSTEM, C_CHOL, C_BACK, C_STEP, C_COST,
       C_ACCEPT, C_N };
'''
READER = r'''
extern "C" int cvids_wlm_clocks_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, cvids_wlm_clocks, sizeof(unsigned long long) * 32);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[32] = {};
  return static_cast<int>(cudaMemcpyToSymbol(cvids_wlm_clocks, zero, sizeof(zero)));
}
'''
# (anchor, text inserted before it) in the single-block kernel's source
SINGLE_BLOCK = (
    ("  const int k = a.k, l = a.l, n = 15 * k, tid = threadIdx.x, f_n = k - 1;\n"
     "  const int pose = 6 * k, n_low", "  WLM_CLOCK_START;\n"),
    ("  for (int it = 0; it < a.iters; ++it) {", "  WLM_CLOCK(C_INIT);\n"),
    ("    // --- the prior's rows at retract(st, 0)", "    WLM_CLOCK(C_BLOCKS);\n"),
    ("    // --- the sums over landmarks, in landmark order", "    WLM_CLOCK(C_PRIOR);\n"),
    ("    {\n      const int n_tasks = n_low + pose;", "    WLM_CLOCK(C_LIST);\n"),
    ("    // --- the reduced camera system's lower triangle", "    WLM_CLOCK(C_SUMS);\n"),
    ("    // --- Cholesky, the right-hand side as row n", "    WLM_CLOCK(C_SYSTEM);\n"),
    ("    // --- the back substitution by one warp", "    WLM_CLOCK(C_CHOL);\n"),
    ("    // --- the step: camera states, landmarks", "    WLM_CLOCK(C_BACK);\n"),
    ("    // --- the cost at the step, and the Levenberg", "    WLM_CLOCK(C_STEP);\n"),
    ("    if (tid == 0) {\n      const float cost = misc[M_COST]", "    WLM_CLOCK(C_COST);\n"),
    ("  if (tid < k) {\n    const float* s = cur + SLOT * tid;\n    for (int i = 0; i < 3; ++i) {\n"
     "      a.out_p", "    WLM_CLOCK(C_ACCEPT);\n"),
)


def hooked_source(text: str) -> tuple[str, bool]:
    """The source with the clock hooks: as it is when it has them, else with
    them inserted at the single-block kernel's phase comments."""
    if "CVIDS_WLM_CLOCKS" in text:
        return text, False
    include = '#include "common.cuh"\n'
    if include not in text:
        raise SystemExit("window_lm.cu: no include to put the clock hooks after")
    text = text.replace(include, include + HOOKS, 1)
    for anchor, before in SINGLE_BLOCK:
        if text.count(anchor) != 1:
            raise SystemExit(f"window_lm.cu: phase anchor not found once: {anchor[:60]!r}")
        text = text.replace(anchor, before + anchor)
    # the last hook closes the iteration loop: it goes inside it
    text = text.replace("    WLM_CLOCK(C_ACCEPT);\n  if (tid < k) {", "  if (tid < k) {")
    marker = "      for (int i = tid; i < 3 * l; i += THREADS) a.out_lm[i] = g_lm[i];\n    }\n" \
             "    __syncthreads();\n  }\n"
    if text.count(marker) != 1:
        raise SystemExit("window_lm.cu: the iteration's end not found once")
    text = text.replace(marker, marker[:-4] + "    WLM_CLOCK(C_ACCEPT);\n  }\n")
    return text + READER, True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=str(ROOT))
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args()
    pkg_root = Path(args.package).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pkg_root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the clocks run on a card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cvids_tpu_torch import _build
    from cvids_tpu_torch.ops import cuda_kernels as ck

    src = Path(_build.CSRC)
    text, inserted = hooked_source((src / "window_lm.cu").read_text())
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    work = ROOT / "build" / "wlm_clocks" / tag
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src, work / "csrc")
    (work / "csrc" / "window_lm.cu").write_text(text)
    _build.CSRC = work / "csrc"
    _build.BUILD_DIR = work / "lib"
    _build.NVCC_FLAGS = [*_build.NVCC_FLAGS, "-DCVIDS_WLM_CLOCKS"]
    _build._lib = None
    lib = _build.load()
    read = lib.cvids_wlm_clocks_read
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 32)()

    dev = torch.device("cuda")
    st, m = cs.window_lm_inputs(dev, k=args.k)
    ck.window_lm(st, m, cs.WLM_ITERS)          # the build and a warm call
    torch.cuda.synchronize()
    assert read(buf) == 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.runs):
        ck.window_lm(st, m, cs.WLM_ITERS)
    end.record()
    torch.cuda.synchronize()
    assert read(buf) == 0
    cycles = {name: buf[i] / args.runs for i, name in enumerate(PHASES)}
    total = sum(cycles.values())
    print(json.dumps({"wlm_phases": {
        "package": str(pkg_root), "hooks_inserted": inserted, "k": args.k, "l": cs.WLM_L,
        "iters": cs.WLM_ITERS, "runs": args.runs,
        "ms_instrumented": start.elapsed_time(end) / args.runs,
        "cycles": cycles, "cycles_total": total,
        "share": {n: c / total for n, c in cycles.items()} if total else None,
        "device": torch.cuda.get_device_name(0)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Two window_lm sources against each other, bit for bit, on the CPU.

    python3 dev/wlm_emulator/compare.py OLD.cu NEW.cu [--all] [--work DIR]

Builds both with ``build.py`` (into DIR, by default build/wlm_emulator/)
and runs them on `chip_smoke.window_lm_inputs` windows built on the CPU: a
K = 10 window of 120 slots, 2 iterations; with ``--all`` phase 3's window
(K = 10, 600 slots, 8 iterations) and every `window_lm_edge_cases` window.
Prints a line a window: the seconds each took, the costs, and whether
every output of NEW equals OLD's bit for bit (NaN equal to NaN). A window
past OLD's keyframes runs NEW alone. Emulated, a window of 600 slots takes
~10 s; the edges ~3 minutes.

Use it to change the kernel's structure (threads, barriers, where a sum
runs) while keeping its order: two sources that order every operation
alike agree here as they do on the card. It says nothing of speed.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.cvids_window_lm.argtypes = [ctypes.POINTER(P), ctypes.POINTER(I), ctypes.POINTER(F), P]
    lib.cvids_window_lm.restype = I
    return lib


def run(lib, state, meas, iters, lam=1e-3, anchor_weight=1e3, scratch=4_000_000):
    """One solve through the library's C entry, as `cuda_kernels.window_lm`
    lays its pointers out; None when the library refuses the window."""
    prior = meas.prior
    pre = meas.pre
    ins = [state.p, state.q, state.v, state.bg, state.ba, state.lm, state.kf_valid,
           state.lm_valid, meas.obs, meas.vis, pre.dp, pre.dv, pre.dq, pre.dt, pre.j_p_bg,
           pre.j_p_ba, pre.j_v_bg, pre.j_v_ba, pre.j_q_bg, pre.sqrt_info, pre.bg, pre.ba,
           meas.pre_valid, meas.r_cb, meas.p_bc, meas.anchor_p, meas.anchor_yaw]
    ins = [t.contiguous() for t in ins]
    ins += ([None] * 7 if prior is None else
            [t.contiguous() for t in (prior.j, prior.r0, prior.p, prior.q, prior.v, prior.bg,
                                      prior.ba)])
    outs = [torch.empty_like(ins[i]) for i in range(6)]
    cost = torch.empty((), dtype=torch.float32)
    work = torch.full((scratch,), float("nan"))
    ptrs = (P * 42)(*(0 if t is None else t.data_ptr() for t in ins + outs + [cost, work]))
    ints = (I * 5)(state.p.shape[0], state.lm.shape[0], 0 if prior is None else prior.j.shape[0],
                   int(iters), scratch)
    floats = (F * 7)(lam, anchor_weight, meas.pix_weight, meas.huber_delta, meas.bias_weight,
                     meas.ba_prior_weight, meas.bg_prior_weight)
    if lib.cvids_window_lm(ptrs, ints, floats, None) != 0:
        return None
    return outs + [cost]


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def main() -> int:
    import build
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--work", default=str(ROOT / "build" / "wlm_emulator"))
    args = ap.parse_args()
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    old = load(build.build(Path(args.old), work / "old.so"))
    new = load(build.build(Path(args.new), work / "new.so"))
    cases = [("K = 10, L = 120", *cs.window_lm_inputs("cpu", n_lm=120), 2, 1e-3)]
    if args.all:
        cases = [("path window", *cs.window_lm_inputs("cpu"), cs.WLM_ITERS, 1e-3)]
        cases += cs.window_lm_edge_cases("cpu")
    ok = True
    for what, st, m, iters, lam in cases:
        t0 = time.time()
        b = run(new, st, m, iters, lam)
        t1 = time.time()
        a = run(old, st, m, iters, lam)
        t2 = time.time()
        if b is None:
            print(f"{what}: NEW refused the window", flush=True)
            ok = False
            continue
        line = f"{what}: NEW {t1 - t0:.1f} s, cost {float(b[-1]):.6f}"
        if a is None:
            line += "; OLD refused it"
        else:
            eq = all(same(x, y) for x, y in zip(a, b))
            ok = ok and eq
            line += f"; OLD {t2 - t1:.1f} s, cost {float(a[-1]):.6f}; bit for bit: {eq}"
        print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

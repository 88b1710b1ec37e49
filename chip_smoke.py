"""GPU smoke run of the PyTorch/CUDA port: builds the four CUDA kernels,
holds each against its PyTorch twin on the card at the main path's shapes,
then drives the server step of `__graft_entry__.entry()` through the port at
full width (dense fusion at 640x480x128 in bf16, then the 4-DoF solve on a
256-keyframe graph) and checks that every kernel of the path ran.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (PATH or /usr/local/cuda/bin). Exits non-zero on
any failed phase. The line before the last is the kernel table as JSON; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

H, W, D = 480, 640, 128
FOCAL, BASELINE, DEPTH = 461.0, 0.11, 3.0
N_FRAMES = 8
N_NODES = 256
SOURCES = {
    "warp_banded": ("cvids_tpu_torch/csrc/warp_banded.cu",
                    "cvids_tpu/ops/pallas_kernels.py:426"),
    "plane_sweep": ("cvids_tpu_torch/csrc/plane_sweep.cu",
                    "cvids_tpu/ops/pallas_kernels.py:548"),
    "sgm_scan": ("cvids_tpu_torch/csrc/sgm_scan.cu",
                 "cvids_tpu/ops/pallas_kernels.py:237"),
    "wta": ("cvids_tpu_torch/csrc/wta.cu",
            "cvids_tpu/ops/pallas_kernels.py:652"),
}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, runs: int) -> float:
    """Median of `runs` CUDA-event timings of fn() (after one warm-up).

    The stream is kept busy (torch.cuda._sleep) while fn() is enqueued, so
    the events bracket the device's execution of fn's work rather than the
    host's launch loop; a call whose enqueue outlasts the fill (a twin that
    launches thousands of small ops) still shows its host gaps."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def print_ptxas_summary(log: str) -> None:
    """One line per kernel from nvcc's -Xptxas -v output: registers over the
    template instances, and the spill bytes."""
    import re
    names = ("warp_rows_kernel", "warp_cols_kernel", "plane_sweep_kernel",
             "sgm_scan_kernel", "wta_kernel")
    regs = {n: [] for n in names}
    spills = {n: 0 for n in names}
    current = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = next((n for n in names if n in line), None)
        elif current and "Used" in line and "registers" in line:
            regs[current].append(int(re.search(r"Used (\d+) registers", line).group(1)))
        elif current and "spill" in line:
            spills[current] += sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
    for n in names:
        if regs[n]:
            print(f"  ptxas {n}: {len(regs[n])} instance(s), registers "
                  f"{min(regs[n])}-{max(regs[n])}, spill bytes {spills[n]}")


def _self_device_us(evt) -> float:
    # the attribute's name changed across torch versions
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else evt.self_cuda_time_total)


def profile_frame(fn) -> tuple[float, list[tuple[str, float, int]]]:
    """Run fn() once under torch.profiler; returns (wall ms, [(name, device
    ms, calls)] of the device activities, largest first)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, _self_device_us(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _self_device_us(e) > 0]
    return wall, sorted(rows, key=lambda r: -r[1])


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def textured_plane(rng, h=H, w=W, focal=FOCAL, baseline=BASELINE, depth=DEPTH):
    """A textured plane at `depth` seen by a reference camera and one moved
    by `baseline` along x (the benchmark scene of bench.py)."""
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    pad = 80
    tex = rng.uniform(0, 255, (h, w + 2 * pad)).astype(np.float32)
    disp = int(round(focal * baseline / depth))
    ref = tex[:, pad:pad + w]
    meas = tex[:, pad + disp:pad + disp + w]
    a_mat = (k @ np.linalg.inv(k)).astype(np.float32)
    b_vec = (k @ np.array([-baseline, 0, 0], np.float32)).astype(np.float32)
    return ref, meas, a_mat, b_vec, k


def rotation_homography(k: np.ndarray, yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return (k @ r @ np.linalg.inv(k)).astype(np.float32)


def banded_gate(a_mat: np.ndarray, h: int, w: int) -> bool:
    """The host's per-frame choice of the banded warp (96/48 bands with an
    8 px margin, as the pipeline gates it)."""
    from cvids_tpu_torch.ops.costvolume import warp_shift_bounds_np
    dx, dy = warp_shift_bounds_np(a_mat, h, w, step=4)
    return bool(dx < 88.0 and dy < 40.0)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its twin
# ---------------------------------------------------------------------------


def kernel_checks(device, rng, h=H, w=W, d=D, runs=10, twin_runs=3):
    """Run each kernel and its twin on the same inputs at the main path's
    shapes; returns {name: (max_abs_err, ms, plain_ms)}."""
    from cvids_tpu_torch.ops import costvolume, cuda_kernels as ck
    from cvids_tpu_torch.ops.image import projective_warp_mxu

    dev = torch.device(device)
    timed = dev.type == "cuda"
    out = {}
    ref, meas, a_mat, b_vec, k = textured_plane(rng, h, w)
    ref_t = torch.from_numpy(ref).to(dev)
    meas_t = torch.from_numpy(meas).to(dev)

    # --- banded warp, identity and a small rotation, bands 96/48
    err = 0.0
    m_rot = None
    for name, m in (("identity", a_mat), ("rotation", rotation_homography(k, 0.05))):
        m_t = torch.from_numpy(m).to(dev)
        a1, c1 = ck.projective_warp_banded(meas_t, m_t, 96, 48)
        a2, c2 = ck.projective_warp_banded_twin(meas_t, m_t, 96, 48)
        e_val = (a1 - a2).abs().max().item()
        e_cov = (c1 - c2).abs().max().item()
        # same fp32 operations in the same order (no FMA contraction)
        check(e_val <= 1e-3 and e_cov <= 1e-6,
              f"warp_banded {name}: value err {e_val}, coverage err {e_cov}")
        print(f"  warp_banded {name}: max|err| value {e_val:.3g} coverage {e_cov:.3g}"
              f" (tolerance 1e-3 / 1e-6); covered {(c1 > 0.999).float().mean().item():.3f}")
        err = max(err, e_val)
        m_rot = m_t
    ms = time_ms(lambda: ck.projective_warp_banded(meas_t, m_rot, 96, 48), runs) if timed else 0.0
    pms = time_ms(lambda: ck.projective_warp_banded_twin(meas_t, m_rot, 96, 48),
                  twin_runs) if timed else 0.0
    out["warp_banded"] = (err, ms, pms)

    # --- plane sweep at the slice's geometry, bf16 volume
    a_t = torch.from_numpy(a_mat).to(dev)
    b_t = torch.from_numpy(b_vec).to(dev)
    inv = (torch.arange(d, dtype=torch.float32, device=dev) + 1.0) / (BASELINE * FOCAL)
    mc, cov = projective_warp_mxu(meas_t, a_t)
    meas_al = (mc / cov.clamp(min=1e-3)).contiguous()
    pos = [p.contiguous() for p in costvolume._sweep_positions(a_t, b_t, inv, h, w)]
    c1 = ck.plane_sweep(ref_t, meas_al, *pos, out_dtype=torch.bfloat16).float()
    c2 = ck.plane_sweep_twin(ref_t, meas_al, *pos, out_dtype=torch.bfloat16).float()
    check(torch.equal(c1 >= 0, c2 >= 0), "plane_sweep: valid masks differ")
    both = (c1 >= 0) & (c2 >= 0)
    e = (c1 - c2).abs()[both]
    e_max, e_mean = e.max().item(), e.mean().item()
    # tests/test_pallas.py's sweep tolerances
    check(e_max < 1.5 and e_mean < 0.2, f"plane_sweep: max {e_max} mean {e_mean}")
    print(f"  plane_sweep bf16: max|err| {e_max:.3g} mean {e_mean:.3g} "
          f"(tolerance 1.5 / 0.2), valid masks identical, valid {both.float().mean().item():.3f}")
    ms = time_ms(lambda: ck.plane_sweep(ref_t, meas_al, *pos), runs) if timed else 0.0
    pms = time_ms(lambda: ck.plane_sweep_twin(ref_t, meas_al, *pos), twin_runs) if timed else 0.0
    out["plane_sweep"] = (e_max, ms, pms)

    # --- SGM scan, both orientations, bf16 and fp32
    cost = torch.from_numpy(rng.uniform(0, 50, (h, w, d)).astype(np.float32)).to(dev)
    p2 = torch.from_numpy(rng.uniform(0.8, 2.3, (h, w)).astype(np.float32) * 64.0).to(dev)
    err = 0.0
    for dt, tol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-6)):
        c_dt, p2_dt = cost.to(dt), p2.to(dt)
        p1 = torch.tensor(16.0, device=dev).to(dt)
        for axis in (0, 1):
            o1 = ck.sgm_scan_bidir(c_dt, p2_dt, p1, axis=axis).float()
            o2 = ck.sgm_scan_bidir_twin(c_dt, p2_dt, p1, axis=axis).float()
            e = (o1 - o2).abs().max().item()
            rel = ((o1 - o2).abs() / o2.abs().clamp(min=1.0)).max().item()
            # the same fp32 recurrence and rounding points: exact expected;
            # tolerance one ulp of the cost dtype, relative
            check(rel <= tol, f"sgm_scan {dt} axis {axis}: rel err {rel}")
            print(f"  sgm_scan {str(dt)[6:]} axis {axis}: max|err| {e:.3g} "
                  f"max rel {rel:.3g} (tolerance {tol:.3g} relative)")
            err = max(err, e)
    c_bf, p2_bf = cost.to(torch.bfloat16), p2.to(torch.bfloat16)
    p1_bf = torch.tensor(16.0, device=dev).to(torch.bfloat16)

    def sgm_pair(fn):
        return lambda: (fn(c_bf, p2_bf, p1_bf, axis=1), fn(c_bf, p2_bf, p1_bf, axis=0))

    ms = time_ms(sgm_pair(ck.sgm_scan_bidir), runs) if timed else 0.0
    pms = time_ms(sgm_pair(ck.sgm_scan_bidir_twin), twin_runs) if timed else 0.0
    out["sgm_scan"] = (err, ms, pms)

    # --- WTA on two bf16 parts
    pa = torch.from_numpy(rng.uniform(0, 50, (h, w, d)).astype(np.float32)).to(dev).to(torch.bfloat16)
    pb = torch.from_numpy(rng.uniform(0, 50, (h, w, d)).astype(np.float32)).to(dev).to(torch.bfloat16)
    i1, f1 = ck.wta(pa, pb)
    i2, f2 = ck.wta_twin(pa, pb)
    e = (i1 - i2).abs().max().item()
    x = pa.float() + pb.float()
    c0 = x.amin(-1)
    idx = torch.argmin(x, dim=-1)                     # first minimum
    lane = torch.arange(d, device=dev)
    c2 = torch.where((lane - idx[..., None]).abs() <= 1, torch.full((), 3e38, device=dev),
                     x).amin(-1)
    tie = (c0 - 0.98 * c2).abs() <= 1e-6 * c0.abs().clamp(min=1.0)
    n_conf_diff = int(((f1 != f2) & ~tie).sum().item())
    check(e <= 1e-5, f"wta: idx err {e}")
    check(n_conf_diff == 0, f"wta: conf differs at {n_conf_diff} non-tie pixels")
    print(f"  wta 2 x bf16: max|idx err| {e:.3g} (tolerance 1e-5); conf differs at "
          f"{int((f1 != f2).sum().item())} pixels, {n_conf_diff} away from a c0 = 0.98 c2 tie")
    ms = time_ms(lambda: ck.wta(pa, pb), runs) if timed else 0.0
    pms = time_ms(lambda: ck.wta_twin(pa, pb), twin_runs) if timed else 0.0
    out["wta"] = (e, ms, pms)
    for name, (_, ms, pms) in out.items():
        print(f"  time {name}: kernel {ms:.4f} ms, twin {pms:.4f} ms")
    return out


def edge_checks(device, rng) -> None:
    """Kernel == twin off the main path's shapes: ragged tiles, odd scan
    lengths, the extreme depth counts, 1 to 4 WTA parts."""
    from cvids_tpu_torch.ops import costvolume, cuda_kernels as ck

    dev = torch.device(device)

    def same(a, b, what):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            check(torch.equal(x, y), f"{what}: kernel != twin "
                  f"(max diff {(x.float() - y.float()).abs().max().item()})")

    for h, w, d in ((37, 53, 32), (16, 128, 256), (1, 33, 64)):
        img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
        k = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)
        m = torch.from_numpy(rotation_homography(k, 0.03)).to(dev)
        same(ck.projective_warp_banded(img, m, 8, 4),
             ck.projective_warp_banded_twin(img, m, 8, 4), f"warp {h}x{w}")
        b = torch.from_numpy(k @ np.array([-0.1, 0.02, 0.01], np.float32)).to(dev)
        inv = (torch.arange(d, dtype=torch.float32, device=dev) + 1.0) * 0.02
        pos = [p.contiguous() for p in costvolume._sweep_positions(m, b, inv, h, w)]
        for dt in (torch.float32, torch.bfloat16):
            same(ck.plane_sweep(img, img.flip(1).contiguous(), *pos, out_dtype=dt),
                 ck.plane_sweep_twin(img, img.flip(1).contiguous(), *pos, out_dtype=dt),
                 f"sweep {h}x{w}x{d} {dt}")
            cost = torch.from_numpy(rng.uniform(0, 50, (h, w, d)).astype(np.float32)).to(dev).to(dt)
            p2 = torch.from_numpy(rng.uniform(30, 90, (h, w)).astype(np.float32)).to(dev).to(dt)
            for axis in (0, 1):
                same(ck.sgm_scan_bidir(cost, p2, 7.0, axis=axis),
                     ck.sgm_scan_bidir_twin(cost, p2, 7.0, axis=axis),
                     f"sgm {h}x{w}x{d} {dt} axis {axis}")
            parts = [cost, cost.flip(2).contiguous(), cost.roll(1, 2), cost.roll(3, 2)]
            for n in (1, 3, 4):
                same(ck.wta(*parts[:n]), ck.wta_twin(*parts[:n]), f"wta {n} x {h}x{w}x{d} {dt}")
    print("  edge shapes (37x53x32, 16x128x256, 1x33x64; fp32 and bf16; "
          "1/3/4 WTA parts): every kernel equals its twin")


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------


def dense_chain(device, rng_seed, h=H, w=W, d=D, n_frames=N_FRAMES):
    """init_reference, n_frames of fuse_measurement with the host's banded
    gate, finalize, then one frame whose rotation fails the gate. Returns
    (median depth, converged share, final filt.mu, per-frame ms, gates)."""
    from cvids_tpu_torch.dense import estimator

    dev = torch.device(device)
    rng = np.random.default_rng(rng_seed)
    cfg = estimator.DenseConfig(height=h, width=w, num_depths=d,
                                dep_sample=1.0 / (BASELINE * FOCAL))
    ref, meas, a_mat, b_vec, k = textured_plane(rng, h, w)
    meas_t = torch.from_numpy(meas).to(dev)
    a_t = torch.from_numpy(a_mat).to(dev)
    b_t = torch.from_numpy(b_vec).to(dev)
    gate = banded_gate(a_mat, h, w)
    state = estimator.init_reference(cfg, torch.from_numpy(ref).to(dev))
    frame_ms = []
    for _ in range(n_frames):
        _sync(dev)
        t0 = time.perf_counter()
        state = estimator.fuse_measurement(cfg, state, meas_t, a_t, b_t,
                                           banded_warp=gate)
        _sync(dev)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    inv_d, ok = estimator.finalize(cfg, state)
    crop = (slice(40, -40), slice(40, -40))
    okc = ok[crop]
    med = float(torch.median(1.0 / inv_d[crop][okc].clamp(min=1e-6)).item()) \
        if bool(okc.any()) else float("nan")
    share = float(okc.float().mean().item())
    # one frame that fails the gate: the exact warp runs
    a_rot = rotation_homography(k, 0.25)
    gate_rot = banded_gate(a_rot, h, w)
    state = estimator.fuse_measurement(cfg, state, meas_t, torch.from_numpy(a_rot).to(dev),
                                       b_t, banded_warp=gate_rot)
    _sync(dev)
    return med, share, state.filt.mu, frame_ms, (gate, gate_rot)


def pose_graph(device, n=N_NODES):
    """The 256-keyframe 4-DoF solve of __graft_entry__.entry() (2 LM
    iterations of 10 CG steps). Returns (residual norm before, after, ms)."""
    from cvids_tpu_torch.server import optimizer as opt

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    # entry() draws the two dense images first, from the same generator
    rng.uniform(0, 255, (H, W))
    rng.uniform(0, 255, (H, W))
    yaw = torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    nodes = opt.PoseGraphNodes(yaw=yaw, pr=torch.zeros((n, 2), device=dev), t=t,
                               valid=torch.ones(n, dtype=torch.bool, device=dev),
                               fixed=torch.arange(n, device=dev) == 0)
    edges = opt.make_sequential_edges(nodes.yaw, nodes.pr, nodes.t,
                                      torch.zeros(n, dtype=torch.int64, device=dev),
                                      nodes.valid)
    # perturb the poses so the solve has work to do
    nodes = nodes._replace(
        yaw=nodes.yaw + torch.from_numpy(rng.normal(0, 0.01, n).astype(np.float32)).to(dev),
        t=nodes.t + torch.from_numpy(rng.normal(0, 0.05, (n, 3)).astype(np.float32)).to(dev))
    before = float(torch.linalg.vector_norm(opt.edge_residuals(nodes, edges)).item())
    ms = []
    for _ in range(2):      # the first solve also initializes cuBLAS
        _sync(dev)
        t0 = time.perf_counter()
        out = opt.optimize_pose_graph(nodes, edges, lm_iters=2, cg_iters=10)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    check(all(bool(torch.isfinite(x.float()).all()) for x in out), "pose graph: non-finite output")
    after = float(torch.linalg.vector_norm(opt.edge_residuals(out, edges)).item())
    return before, after, ms


def profile_slice(device):
    """Profile one steady-state fuse_measurement (third frame of a fresh
    chain); prints the device time by activity and the device-busy share."""
    from cvids_tpu_torch.dense import estimator

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    cfg = estimator.DenseConfig(dep_sample=1.0 / (BASELINE * FOCAL))
    ref, meas, a_mat, b_vec, _ = textured_plane(rng)
    args = (torch.from_numpy(meas).to(dev), torch.from_numpy(a_mat).to(dev),
            torch.from_numpy(b_vec).to(dev))
    gate = banded_gate(a_mat, H, W)
    box = [estimator.init_reference(cfg, torch.from_numpy(ref).to(dev))]
    for _ in range(2):
        box[0] = estimator.fuse_measurement(cfg, box[0], *args, banded_warp=gate)

    def frame():
        box[0] = estimator.fuse_measurement(cfg, box[0], *args, banded_warp=gate)

    wall, rows = profile_frame(frame)
    total = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if any(k in r[0] for k in (
        "warp_rows_kernel", "warp_cols_kernel", "plane_sweep_kernel",
        "sgm_scan_kernel", "wta_kernel")))
    print(f"  profiled frame: wall {wall:.3f} ms (profiler on), device busy "
          f"{total:.3f} ms ({total / wall:.1%} of wall), the four kernels "
          f"{ours:.3f} ms, {len(rows)} distinct device activities")
    for name, ms, calls in rows[:14]:
        print(f"    {ms:8.4f} ms  x{calls:<3d} {name[:110]}")


def twin_patches():
    """Context that routes the slice's kernel calls to the twins (used only
    for the comparison chain)."""
    from cvids_tpu_torch.ops import cuda_kernels as ck
    return [mock.patch.object(ck, "projective_warp_banded", ck.projective_warp_banded_twin),
            mock.patch.object(ck, "plane_sweep", ck.plane_sweep_twin),
            mock.patch.object(ck, "sgm_scan_bidir", ck.sgm_scan_bidir_twin),
            mock.patch.object(ck, "wta", ck.wta_twin)]


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from cvids_tpu_torch import _build
    from cvids_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")

    # phase 2: build
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load()
    print(f"phase 2 build: {path.name} in {time.perf_counter() - t0:.1f} s")
    print_ptxas_summary(log)
    torch.cuda.synchronize()

    # phase 3: each kernel against its twin at the main path's shapes
    checks = kernel_checks(dev, np.random.default_rng(1))
    edge_checks(dev, np.random.default_rng(2))
    torch.cuda.synchronize()
    print("phase 3 kernels vs twins: all within tolerance")

    # phase 4: the slice, counted
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    med, share, mu, frame_ms, gates = dense_chain(dev, 0)
    before, after, pg_ms = pose_graph(dev)
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 4 slice: median depth {med:.3f} m (true {DEPTH}), converged "
          f"{share:.3f} on the [40:-40] crop; banded gate {gates[0]}, rotated frame "
          f"gate {gates[1]}; frame ms {[round(x, 3) for x in frame_ms]}; peak "
          f"device memory {peak:.2f} GiB")
    print(f"  pose graph {N_NODES} KF (2 LM x 10 CG): residual norm {before:.4f} -> "
          f"{after:.4f}; solve ms {[round(x, 1) for x in pg_ms]} (first, second)")
    print(f"  launches on the main path: {counts}")
    check(abs(med - DEPTH) < 0.4, f"median depth {med} not within 0.4 m of {DEPTH}")
    check(gates == (True, False), f"gates {gates}: expected banded then exact")
    check(after <= before, f"pose graph residual grew: {before} -> {after}")
    check(all(v > 0 for v in counts.values()), f"a kernel did not run: {counts}")

    # the same chain through the twins on the card
    patches = twin_patches()
    for p in patches:
        p.start()
    try:
        _, _, mu_twin, _, _ = dense_chain(dev, 0)
    finally:
        for p in patches:
            p.stop()
    torch.cuda.synchronize()
    diff = (mu - mu_twin).abs()
    frac = float((diff > 1e-5).float().mean().item())
    # each kernel rounds at its twin's points: the chains agree except where
    # an argmin tie could break differently; allow 0.1 % of pixels
    check(frac <= 1e-3, f"filt.mu differs from the twin chain at {frac:.4%} of pixels")
    print(f"  filt.mu vs the twin chain: max|diff| {diff.max().item():.3g}, "
          f"{frac:.4%} of pixels beyond 1e-5 (tolerance 0.1 %)")
    profile_slice(dev)
    print("phase 4 slice: ok")

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": counts[name],
                "max_abs_err": checks[name][0], "ms": checks[name][1],
                "plain_ms": checks[name][2]} for name in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

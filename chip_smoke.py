"""GPU smoke run of the PyTorch/CUDA port: builds the ten CUDA kernels
(warp_banded, plane_sweep, sgm_scan, wta, depth_filter_update,
hamming_matrix for the Pallas kernels; small_eig, the eigensolver of the
8-point F and of the PnP's DLT, klt_track, the agents' pyramidal LK
tracker, tsdf_integrate, a published map's TSDF integrate, and window_lm,
the agents' whole window solve, which have no Pallas counterpart), holds
each against its
PyTorch twin on the card at its path's shapes (beside the launch floor: an
empty kernel through the same launch path, timed the same way), then drives
the port's paths at full width and checks that every kernel of each path
ran:

- phase 4, the server step of `__graft_entry__.entry()`: dense fusion at
  640x480x128 in bf16 (warp, sweep, SGM, WTA, filter kernels), then the
  4-DoF solve on a 256-keyframe graph, both as the server runs them
  (replayed CUDA graphs); then the graphed dense frame against the eager one
  bit for bit over 40 frames (both warps, reference rolls), the two side by
  side (wall per frame, device busy, device activities, host launch calls),
  and the 1024-keyframe / 6400-edge solve (12 LM x 60 CG) eager against
  graphed, seconds and bit equality;
- phase 5, the collaborative pose-graph server: each BoW database's
  query-and-insert program through three store growths (one capture a
  capacity tier, replays equal to an eager database's, superseded tiers
  released); 4 agents streaming ~500
  keyframes (160 window / 512 extra features each) through
  `CollaborativePoseGraph` with a 10^6-word tree vocabulary and the
  background solver (the Hamming kernel and small_eig in every loop
  verification, the cascade one graph, the BoW step one graph; the
  graphed solve on the worker's stream), every replay of the two ingest
  programs rerun eagerly and equal bit for bit, then the same stream's loop
  edges through the kernels (graphs) and through their twins (eager) with
  inline solves, the ingest medians, and host launch calls, device
  activities and host syncs a keyframe;
- phase 6, the whole collaborative server: 4 agents' keyframe packets
  with 640x480 images rendered in `default_scene()`'s room through
  `CollaborativeServer` (pose graph, per-client dense depth at 640x480x128
  bf16, TSDF fusion at 0.1 m with carving, the mesh), scored against the
  rendered depth and the analytic scene, with the dense graphs' shared
  pool; each map's chunk walk (one graph replay and one read) held to its
  CPU run, one tsdf_integrate launch a map, the mesh's replays (one a
  256-chunk batch) held to the eager path; then a short stream through the
  kernels and through the twins;
- phase 7, distorted clients: the remap grids that `set_client_camera`
  builds for a radtan pinhole, an equidistant fisheye and a Mei camera (equal
  to the CPU's; an image rendered through the distorted camera and remapped
  equals the undistorted pinhole's rendering), then a radtan and a fisheye
  agent, images rendered through their cameras and features lifted by the
  port's `lift`, through the same whole server to phase 6's bounds;
- phase 3 also holds klt_track to its twin bit for bit at the front-end's
  call (752x480 pyramids, 150 points, 4 levels x 15, the forward-backward
  gate) and at edge shapes, and its tracks to the true motion, and
  tsdf_integrate at a published map's 640x480 frame into its chunks of a
  4096-chunk pool (a stride-0 colour) and at edge shapes, and window_lm at
  the front-end's window (K = 10, 600 slots, a 150-row prior, 8
  iterations) and at edge windows up to K = 21, and against the CPU
  solve, with its cluster, registers and local memory a thread;
- phase 8, the agents: two `AgentFrontend`s (FAST/BRIEF/KLT, IMU
  preintegration, the VI bootstrap, the sliding-window BA) on every 20 Hz
  frame of ~10 s of 752x480 radtan imagery with 200 Hz IMU, rendered in
  test_full_system.py's room with its photometric nuisances, their packets
  through `CollaborativeServer` with the held-out `generic_vocabulary(10,
  4)`, held to test_full_system.py's bounds (VI-initialized, >= 8 packets an
  agent, aligned, a loop, ATE < 10 cm, depth RMS < 0.12, mesh < 0.15 m),
  with the front-end's times per frame and keyframe, its host syncs and its
  device activities per frame; the front-end's CUDA graphs (the track step
  with its F-RANSAC, the re-detection, the packet's image program, the
  preintegration, the window solve, the marginalization's Schur
  complement) each captured, replayed and equal to its eager call, which
  reads nothing back, the eager call's klt_track and window_lm held to
  their twins; the tracker launched once a tracked frame and window_lm
  once a solve (phases 8, 9 and 12); four
  loop-verification cascades (their Hamming
  and small_eig calls) and two graphed dense
  frames of that server run (480x752x128 volumes) are kept, each rerun
  eagerly through the kernels (equal to the graph's, each kernel call held
  against its twin), the frames also through the twins;
- phase 9, the reference's deployment topology (test_full_topology.py):
  phase 8's frames written as two EuRoC-format sequences (PNG, CSV with the
  IMU at 17 significant digits, sensor.yaml) and read back bit-equal, two
  spawned agent processes
  (`apps.agent_process`) streaming AgentMsg and image frames over TCP into
  `CollaborativeSocketServer` -> `CollaborativeServer` with background
  solves; every packet received equal to what was sent, the topology
  test's bounds, four cascades and two graphed dense frames held
  against the twins as in phase 8;
- phase 10, the apps and the viewers: `apps.run_synthetic` at its
  defaults, `apps.run_euroc` on phase 9's sequences, one call of
  `entry()`'s step, and phase 9's server's `export_viewer`,
  `save_loop_overlay` and `live_viewer`;
- phase 11, multi-GPU: `entry.dryrun_multichip(4)`, the JAX dry run's toy
  and production phases (the 1024-keyframe / 6400-edge solve, one agent a
  rank at 480x640x128 bf16, the K=21 / L=600 window, the 2048-chunk TSDF)
  on four ranks, NCCL with a card a rank where the machine has four cards,
  else gloo with the four sharing this card; each rank's dense step and TSDF
  block bit-equal to one process's on the card, the sharded solve and window
  within their bounds of one card's, the collectives by their formulas; on
  NCCL the solve and window replay a CUDA graph of one LM iteration, and are
  rerun replayed and eagerly (`disable_graphs()`): bits and calls compared,
  both times and the solve's t1 / (4 t4) printed;
- phase 12, the fisheye rig (test_fisheye_e2e.py): two agents with an
  equidistant camera, EuRoC-format sequences written and read back, through
  `AgentFrontend` and `CollaborativePoseGraph`, to that test's bounds, the
  front-end's graphs held to the eager calls;
- phase 13, a checkpoint resumed in a fresh process (test_checkpoint_e2e.py):
  the pose graph on the card saved mid-mission, restored in a spawned
  process on the card and in one on the CPU, both ending with the
  uninterrupted card run's map;
- phase 14, the once-an-agent and offline programs: the pre-init
  essential pose and the VI bootstrap's two solves on the inputs of agent
  0's last call of each in phase 8, then `calibrate_chessboards` for the
  pinhole, equidistant, Mei and Scaramuzza models on test_extras.py's
  boards rendered at 752x480, to test_extras.py's bounds against the true
  cameras; each program (those three, the chessboard response, each
  calibrator's residuals and Jacobian) replayed as a CUDA graph and held
  to its eager call bit for bit, with its capture seconds, replayed and
  eager ms and host launch calls.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only    # phases 1-3, one timed call each
    python3 chip_smoke.py --dense-probe [--package DIR]   # the dense frame's times only
    python3 chip_smoke.py --server-probe [--package DIR]  # ingest and whole-server times only
    python3 chip_smoke.py --kernels-probe [--package DIR] # small_eig's and klt_track's times only
    python3 chip_smoke.py --multichip       # phases 1, 2 and 11 only

The banded warp is one kernel that computes its own sample positions from
the 3x3 map on the device; phase 3 also checks that a call is that one launch
and no other device work.

`--dense-probe` builds, times 35 dense frames after 5 of warm-up, eager and
graphed in turn (a package without graphs: eager only), profiles one of
each (device busy, device activities, host launch calls) and three graphed
frames for each kernel's time in the frame. With `--package DIR` it
imports `cvids_tpu_torch` from DIR (an unpacked `git archive` of another
commit) instead of this script's directory: the run to make in turns on two
trees (parent, change, change, parent) inside one call when a change to the
dense path is measured, e.g.

    git archive HEAD~1 cvids_tpu_torch | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 chip_smoke.py --dense-probe --package $t; done

`--server-probe` (~1.5 min) prints one JSON line for the package on sys.path
(`--package DIR` as above): phase 5's ingest host ms a keyframe with
background solves and host syncs a keyframe, the 100-keyframe stream's
inline ingest ms with host launch calls and device activities a keyframe
(30 keyframes profiled one by one), and phase 6's whole-server host ms a
keyframe, with each stream's keyframes a second, and its published maps:
the `fuse` and `mesh` spans, each map's chunk walk, `_alloc` and device
integrate ms, chunks a map, `extract_mesh` graphed and eager in turns
with the memory its graphs keep, and one profiled `extract_mesh` and
`integrate`; run it on parent, change, change, parent inside one call.

`--kernels-probe` (seconds) prints one JSON line for the package on sys.path
(`--package DIR` as above): the port's own hand kernels, `small_eig`,
`klt_track` and (where the package has it) `window_lm`, at phase 3's
inputs (one F-RANSAC's 128 9x9 and 3x3 fp64 systems, one PnP DLT's 128
12x12 and 3x3, the front-end's tracker call, the front-end's window; and
where the package takes it, the K = 21 window of phase 11 and the
kernel's registers and local memory), and
the window solve as the front-end calls it (a `GraphedCall` of
`frontend._solve_window_fast`, in any package): each call's median
CUDA-event ms over 50 runs, each single kernel's device ms under the
profiler, the launch floor, whether each kernel equals its twin bit for
bit, and torch.linalg.eigh's ms on the same batches; run it on parent,
change, change, parent inside one call.

`--kernels-only` is the run to put under compute-sanitizer (memcheck,
initcheck, racecheck). Needs one CUDA card and nvcc (PATH or
/usr/local/cuda/bin). Imports neither JAX nor any module of `cvids_tpu`,
and checks so at the end. Exits non-zero on any failed phase. The line before
the last is the kernel table as JSON (per kernel: launches on the whole
server's run, on the distorted clients' run, on the agents' server run and
on the topology's,
launches per graphed dense frame and the host's launch calls per graphed
and eager frame or, for the Hamming kernel, launches per keyframe, max abs err against the twin, kernel
and twin ms, the roofline bound of the same call from
`cuda_kernels.kernel_work` and the H100's published peaks, the launch floor,
the share of the bound reached and the reach, max(bound, floor) / time); the
last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
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
    "depth_filter_update": ("cvids_tpu_torch/csrc/depth_filter.cu",
                            "cvids_tpu/ops/pallas_kernels.py:146"),
    "hamming_matrix": ("cvids_tpu_torch/csrc/hamming.cu",
                       "cvids_tpu/ops/pallas_kernels.py:65"),
    # no Pallas counterpart: the 8-point F's eigh and svd, which the JAX
    # package leaves to XLA (and the port's torch.linalg waited for the card)
    "small_eig": ("cvids_tpu_torch/csrc/small_eig.cu", "cvids_tpu/ops/ransac.py:181"),
    # no Pallas counterpart: the JAX package compiles track_points into one
    # program; the port ran it as ~40 small launches an LK iteration
    "klt_track": ("cvids_tpu_torch/csrc/klt_track.cu", "cvids_tpu/ops/klt.py:35"),
    # no Pallas counterpart: the JAX package compiles _integrate_kernel into
    # one program; the port ran it as ~40 eager launches and 3 index_copy_
    "tsdf_integrate": ("cvids_tpu_torch/csrc/tsdf_integrate.cu",
                       "cvids_tpu/mapping/tsdf.py:70"),
    # no Pallas counterpart: the JAX package compiles _solve_window_fast_jit
    # into one program; the port replayed it as a graph of ~18,000 kernels
    "window_lm": ("cvids_tpu_torch/csrc/window_lm.cu", "cvids_tpu/vio/window_ba.py:689"),
}
# each kernel's wrapper in cuda_kernels (its twin: the same name + "_twin")
WRAPPERS = {"warp_banded": "projective_warp_banded", "plane_sweep": "plane_sweep",
            "sgm_scan": "sgm_scan_bidir", "wta": "wta",
            "depth_filter_update": "depth_filter_update", "hamming_matrix": "hamming_matrix",
            "small_eig": "small_eigh", "klt_track": "klt_track",
            "tsdf_integrate": "tsdf_integrate", "window_lm": "window_lm"}
DENSE_KERNELS = ("warp_banded", "plane_sweep", "sgm_scan", "wta", "depth_filter_update")
SERVER_KERNELS = ("hamming_matrix",)
RANSAC_KERNELS = ("small_eig",)     # every F-RANSAC: the agents' track step, the servers' cascade
FRONTEND_KERNELS = ("klt_track", "window_lm")   # the agents' track step, their window solve
MAP_KERNELS = ("tsdf_integrate",)   # a published map's integrate (the servers)
# phase 3's tracker inputs: the front-end's call at the EuRoC rig
KLT_H, KLT_W, KLT_N = 480, 752, 150
KLT_ARGS = dict(radius=10, iters=15, max_residual=35.0, min_eig=1e-3, fb_thresh=1.5)
KLT_LEVELS = 4
KLT_MOTION = (2.3, -1.7, 0.01)      # the second frame's shift (px) and turn (rad)
# the server slice: run_synthetic.py's circles for 4 agents, 1 Hz keyframes
SERVER_AGENTS = 4
SERVER_DURATION = 125.0     # s per agent: 126 keyframes each, 504 in all
SERVER_LANDMARKS = 3000     # >= 711 visible per keyframe: windows fill to 160, extras to 512
SERVER_TREE = (10, 6)       # k, levels: 10^6 words, the brief_k10L6.bin scale
COMPARE_AGENTS = 2          # the kernel-vs-twin edge comparison's stream
COMPARE_DURATION = 49.0     # s per agent: 100 keyframes in all
# the whole server with images: 4 agents in default_scene()'s room
PIPE_AGENTS = 4
PIPE_KF = 36                # keyframes per agent
PIPE_LANDMARKS = 1500       # on the scene's surfaces
SHORT_KF = 12               # the kernel-vs-twin stream: agent 0's first keyframes
# the filter kernel against its twin, per field: the same fp32 operations in
# the same order with no FMA contraction, so at most 2 ulp apart
FILTER_MAX_ULP = 2
# phase 6's whole-server host ms a keyframe (median) of the tree before the
# pose graph's ingest programs ran as CUDA graphs, in two `--server-probe`
# runs on an H100 at 700 W (PERF.md section 6): printed beside this run's
PARENT_WHOLE_SERVER_MS = "27.1-33.0"
# published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and fp32 and fp64 rates outside the tensor cores; the roofline bounds are
# held against these whatever the card's power limit, which is printed
# beside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_FP64_PER_S = 34e12


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


# the kernels' entry points as the compiler log and the profiler name them;
# warp_rows_kernel and warp_cols_kernel are the two kernels of package
# revisions before the fused warp, which `--package` may point at
KERNEL_ENTRIES = ("warp_banded_kernel", "warp_rows_kernel", "warp_cols_kernel",
                  "plane_sweep_kernel", "sgm_scan_kernel", "wta_kernel",
                  "depth_filter_kernel", "hamming_kernel", "small_eig_kernel", "klt_track_kernel",
                  "tsdf_integrate_kernel", "window_lm_kernel", "empty_kernel")


def ptxas_summary(log: str) -> tuple[dict, dict]:
    """From nvcc's -Xptxas -v output: each kernel's registers over its
    template instances, and its spill bytes (stores and loads)."""
    import re
    regs = {n: [] for n in KERNEL_ENTRIES}
    spills = {n: 0 for n in KERNEL_ENTRIES}
    current = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = next((n for n in KERNEL_ENTRIES if n in line), None)
        elif current and "Used" in line and "registers" in line:
            regs[current].append(int(re.search(r"Used (\d+) registers", line).group(1)))
        elif current and "spill" in line:
            spills[current] += sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
    return regs, spills


def print_ptxas_summary(log: str) -> None:
    """One line per kernel: registers over the template instances, and the
    spill bytes."""
    regs, spills = ptxas_summary(log)
    for n in KERNEL_ENTRIES:
        if regs[n]:
            print(f"  ptxas {n}: {len(regs[n])} instance(s), registers "
                  f"{min(regs[n])}-{max(regs[n])}, spill bytes {spills[n]}")


def _self_device_us(evt) -> float:
    # the attribute's name changed across torch versions
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else evt.self_cuda_time_total)


# the runtime calls that put work on a stream: what a frame costs the host
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync", "cudaLaunchCooperativeKernel")


def profile_frame(fn, host_launches: bool = False):
    """Run fn() once under torch.profiler; returns (wall ms, [(name, device
    ms, calls)] of the device activities, largest first) and, with
    `host_launches`, the number of HOST_LAUNCH_CALLS the host made."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = [(e.key, _self_device_us(e) / 1e3, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and _self_device_us(e) > 0]
    rows = sorted(rows, key=lambda r: -r[1])
    if not host_launches:
        return wall, rows
    return wall, rows, sum(e.count for e in events if e.key in HOST_LAUNCH_CALLS
                           and e.device_type == torch.autograd.DeviceType.CPU)


def profiled_kernel_ms(fn, entry: str) -> float:
    """Device ms of the one device activity, named after `entry`, of one
    profiled call of fn() (the kernel's own time, without the launch latency
    that a pair of CUDA events around one small kernel includes). fn() has
    run once before, so its kernel is loaded; the first profile of a process
    may start late and come back empty, so the second one that shows device
    work is read. A call that shows other device work, the kernel twice, or
    nothing in eight profiles fails."""
    fn()
    acts = []
    for attempt in range(8):
        _, acts = profile_frame(fn)
        if acts and attempt >= 1:
            break
    check(len(acts) == 1 and acts[0][2] == 1 and entry in acts[0][0],
          f"{entry}: a call's device activities are {[(a[0], a[2]) for a in acts]}, "
          f"not one {entry}")
    return acts[0][1]


def host_us_per_launch(fn, n: int = 20_000) -> float:
    """Host microseconds that one fn() takes to enqueue, over `n` calls on an
    idle stream (the device keeps up with an empty kernel, so this is the
    launch path's host cost and not a full queue's back-pressure)."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def roofline(name: str, calls: int = 1, peak_ops: float = PEAK_FP32_PER_S,
             **shape) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations"): the least time an H100 could
    take for `calls` calls of kernel `name` at `shape`, from the bytes and
    operations `cuda_kernels.kernel_work` counts and the published peaks
    (`peak_ops`: the rate of the operations' type)."""
    from cvids_tpu_torch.ops.cuda_kernels import kernel_work
    nbytes, ops = kernel_work(name, **shape)
    t_bytes = calls * nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = calls * ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def rotation_homography(k: np.ndarray, yaw: float, pitch: float = 0.0) -> np.ndarray:
    """K R K^-1 for a camera turned by `yaw` about y, then `pitch` about x
    (a pitch makes m21 nonzero, so the warp's row pass depends on the row)."""
    c, s = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    r_yaw = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    r_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return (k @ r_pitch @ r_yaw @ np.linalg.inv(k)).astype(np.float32)


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
    shapes; returns ({name: (max_abs_err, ms, plain_ms, bound_ms, bound_by)},
    extras), the bound being the roofline of the timed call (the SGM row:
    one frame's two launches). extras holds `floor_ms`, the launch floor (the
    library's empty kernel timed as the others are), `launch_host_us` (the
    host's cost of one launch through the wrappers' launch function),
    `profiler_ms` (the device time of the small kernels under the profiler)
    and `hamming_2048` (the Hamming kernel where its store is the bound)."""
    from cvids_tpu_torch.ops import costvolume, cuda_kernels as ck
    from cvids_tpu_torch.ops.image import projective_warp_mxu

    dev = torch.device(device)
    timed = dev.type == "cuda"
    out = {}
    extras = {"floor_ms": 0.0, "launch_host_us": float("nan"), "profiler_ms": {}}
    if timed:
        # the yardstick first: an empty kernel through the same launch path,
        # the same events, the same median
        extras["floor_ms"] = time_ms(lambda: ck.empty_launch(dev), runs)
        extras["launch_host_us"] = host_us_per_launch(lambda: ck.empty_launch(dev),
                                                      20_000 if runs > 1 else 500)
    ref, meas, a_mat, b_vec, k = textured_plane(rng, h, w)
    ref_t = torch.from_numpy(ref).to(dev)
    meas_t = torch.from_numpy(meas).to(dev)
    m_rot = torch.from_numpy(rotation_homography(k, 0.05)).to(dev)
    st, x, valid = filter_inputs(rng, dev, h, w)
    ha, hb, hav, hbv = hamming_inputs(rng, dev, 160, 512)
    ha2, hb2, _, _ = hamming_inputs(rng, dev, 2048, 2048)
    ata, ftf, f3 = eight_point_systems(rng, dev)
    klt_in = klt_inputs(rng, dev)
    dlt_ata, dlt_mtm, dlt_m = dlt_systems(rng, dev)
    tsdf_rng = np.random.default_rng(7)
    tsdf_in = tsdf_inputs(tsdf_rng, dev)
    tsdf_prof = (tsdf_in[0], _pool_copy(tsdf_in[1]), *tsdf_in[2:])
    wlm_in = window_lm_inputs(dev)
    if timed:
        # the kernels of microseconds under the profiler, before the volume
        # kernels and the twins run: each call must be one kernel launch and
        # nothing else (no position math, no cast of the fp32 map, no memset)
        extras["profiler_ms"] = {
            key: profiled_kernel_ms(fn, entry) for key, entry, fn in (
                ("empty", "empty_kernel", lambda: ck.empty_launch(dev)),
                ("warp_banded", "warp_banded_kernel",
                 lambda: ck.projective_warp_banded(meas_t, m_rot, 96, 48)),
                ("depth_filter_update", "depth_filter_kernel",
                 lambda: ck.depth_filter_update(st, x, 0.013, valid)),
                ("hamming_matrix", "hamming_kernel", lambda: ck.hamming_matrix(ha, hb, hav, hbv)),
                ("hamming_2048", "hamming_kernel", lambda: ck.hamming_matrix(ha2, hb2)),
                ("small_eig", "small_eig_kernel", lambda: ck.small_eigh(ata)),
                ("small_eig_dlt", "small_eig_kernel", lambda: ck.small_eigh(dlt_ata)),
                ("klt_track", "klt_track_kernel", lambda: ck.klt_track(*klt_in, **KLT_ARGS)),
                ("tsdf_integrate", "tsdf_integrate_kernel",
                 lambda: ck.tsdf_integrate(*tsdf_prof)),
                ("window_lm", "window_lm_kernel", lambda: ck.window_lm(*wlm_in, WLM_ITERS)))}
        print(f"  launch floor: an empty kernel through cuda_kernels._launch {extras['floor_ms']:.4f} "
              f"ms between CUDA events (median of {runs}), "
              f"{extras['profiler_ms']['empty']:.4f} ms under the profiler; the host "
              f"spends {extras['launch_host_us']:.2f} us a launch; one device activity a call "
              f"of the warp, the filter, the Hamming kernel, small_eig, klt_track, "
              f"tsdf_integrate and window_lm")

    # --- banded warp at phase 4's map and a small rotation, bands 96/48
    err = 0.0
    for name, m_t in (("phase 4's map", torch.from_numpy(a_mat).to(dev)), ("rotation", m_rot)):
        a1, c1 = ck.projective_warp_banded(meas_t, m_t, 96, 48)
        a2, c2 = ck.projective_warp_banded_twin(meas_t, m_t, 96, 48)
        e_val = (a1 - a2).abs().max().item()
        e_cov = (c1 - c2).abs().max().item()
        # the twin's fp32 operations in the twin's order, positions included
        # (no FMA contraction, IEEE divisions): exact
        check(e_val == 0.0 and e_cov == 0.0,
              f"warp_banded {name}: value err {e_val}, coverage err {e_cov}")
        print(f"  warp_banded {name}: max|err| value {e_val:.3g} coverage {e_cov:.3g}"
              f" (tolerance: exact); covered {(c1 > 0.999).float().mean().item():.3f}")
        err = max(err, e_val, e_cov)
    ms = time_ms(lambda: ck.projective_warp_banded(meas_t, m_rot, 96, 48), runs) if timed else 0.0
    pms = time_ms(lambda: ck.projective_warp_banded_twin(meas_t, m_rot, 96, 48),
                  twin_runs) if timed else 0.0
    out["warp_banded"] = (err, ms, pms, *roofline("warp_banded", h=h, w=w))

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
    # the same fp32 operations in the same order, no FMA contraction: exact
    check(e_max == 0.0, f"plane_sweep: max {e_max} mean {e_mean}")
    print(f"  plane_sweep bf16: max|err| {e_max:.3g} mean {e_mean:.3g} "
          f"(tolerance: exact), valid masks identical, valid {both.float().mean().item():.3f}")
    ms = time_ms(lambda: ck.plane_sweep(ref_t, meas_al, *pos), runs) if timed else 0.0
    pms = time_ms(lambda: ck.plane_sweep_twin(ref_t, meas_al, *pos), twin_runs) if timed else 0.0
    out["plane_sweep"] = (e_max, ms, pms, *roofline("plane_sweep", h=h, w=w, d=d, itemsize=2))

    # --- SGM scan, both orientations, bf16 and fp32
    cost = torch.from_numpy(rng.uniform(0, 50, (h, w, d)).astype(np.float32)).to(dev)
    p2 = torch.from_numpy(rng.uniform(0.8, 2.3, (h, w)).astype(np.float32) * 64.0).to(dev)
    err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        c_dt, p2_dt = cost.to(dt), p2.to(dt)
        p1 = torch.tensor(16.0, device=dev).to(dt)
        for axis in (0, 1):
            o1 = ck.sgm_scan_bidir(c_dt, p2_dt, p1, axis=axis).float()
            o2 = ck.sgm_scan_bidir_twin(c_dt, p2_dt, p1, axis=axis).float()
            e = (o1 - o2).abs().max().item()
            # the same fp32 recurrence and rounding points: exact
            check(e == 0.0, f"sgm_scan {dt} axis {axis}: max abs err {e}")
            print(f"  sgm_scan {str(dt)[6:]} axis {axis}: max|err| {e:.3g} (tolerance: exact)")
            err = max(err, e)
    c_bf, p2_bf = cost.to(torch.bfloat16), p2.to(torch.bfloat16)
    p1_bf = torch.tensor(16.0, device=dev).to(torch.bfloat16)

    def sgm_pair(fn):
        return lambda: (fn(c_bf, p2_bf, p1_bf, axis=1), fn(c_bf, p2_bf, p1_bf, axis=0))

    ms = time_ms(sgm_pair(ck.sgm_scan_bidir), runs) if timed else 0.0
    pms = time_ms(sgm_pair(ck.sgm_scan_bidir_twin), twin_runs) if timed else 0.0
    out["sgm_scan"] = (err, ms, pms, *roofline("sgm_scan", calls=2, s=h, x=w, d=d, itemsize=2))

    # --- WTA on two bf16 parts
    pa = torch.from_numpy(rng.uniform(0, 50, (h, w, d)).astype(np.float32)).to(dev).to(torch.bfloat16)
    pb = torch.from_numpy(rng.uniform(0, 50, (h, w, d)).astype(np.float32)).to(dev).to(torch.bfloat16)
    i1, f1 = ck.wta(pa, pb)
    i2, f2 = ck.wta_twin(pa, pb)
    e = (i1 - i2).abs().max().item()
    n_conf_diff = int((f1 != f2).sum().item())
    # the twin's fp32 sums, comparisons and parabola in the twin's order: exact
    check(torch.equal(i1, i2), f"wta: idx_f differs from the twin's, max abs err {e}")
    check(n_conf_diff == 0, f"wta: conf differs at {n_conf_diff} pixels")
    print(f"  wta 2 x bf16: max|idx err| {e:.3g}, conf differs at {n_conf_diff} pixels "
          f"(tolerance: exact); confident {f1.float().mean().item():.3f}")
    ms = time_ms(lambda: ck.wta(pa, pb), runs) if timed else 0.0
    pms = time_ms(lambda: ck.wta_twin(pa, pb), twin_runs) if timed else 0.0
    out["wta"] = (e, ms, pms, *roofline("wta", h=h, w=w, d=d, itemsize=2, parts=2))

    # --- depth filter at the dense path's (H, W), scalar tau2 as the estimator passes it
    err = 0.0
    for tau2 in (0.013, torch.from_numpy(rng.uniform(1e-3, 0.05, (h, w)).astype(np.float32)).to(dev)):
        err = max(err, filter_agree(ck.depth_filter_update(st, x, tau2, valid),
                                    ck.depth_filter_update_twin(st, x, tau2, valid),
                                    f"depth_filter {h}x{w} tau2 {'map' if torch.is_tensor(tau2) else 'scalar'}"))
    ms = time_ms(lambda: ck.depth_filter_update(st, x, 0.013, valid), runs) if timed else 0.0
    pms = time_ms(lambda: ck.depth_filter_update_twin(st, x, 0.013, valid), runs) if timed else 0.0
    out["depth_filter_update"] = (err, ms, pms, *roofline("depth_filter_update", h=h, w=w))

    # --- Hamming at the loop verification's shape (160 window x 512 extra), masked
    d1, d2 = ck.hamming_matrix(ha, hb, hav, hbv), ck.hamming_matrix_twin(ha, hb, hav, hbv)
    e1 = (d1 - d2).abs().max().item()
    check(torch.equal(d1, d2), f"hamming_matrix 160x512: kernel != twin (max |err| {e1})")
    ms = time_ms(lambda: ck.hamming_matrix(ha, hb, hav, hbv), runs) if timed else 0.0
    pms = time_ms(lambda: ck.hamming_matrix_twin(ha, hb, hav, hbv), runs) if timed else 0.0
    d1, d2 = ck.hamming_matrix(ha2, hb2), ck.hamming_matrix_twin(ha2, hb2)
    e2 = (d1 - d2).abs().max().item()
    check(torch.equal(d1, d2), f"hamming_matrix 2048x2048: kernel != twin (max |err| {e2})")
    out["hamming_matrix"] = (max(e1, e2), ms, pms, *roofline("hamming_matrix", n=160, m=512))
    ms2 = time_ms(lambda: ck.hamming_matrix(ha2, hb2), runs) if timed else 0.0
    pms2 = time_ms(lambda: ck.hamming_matrix_twin(ha2, hb2), twin_runs) if timed else 0.0
    bound2, by2 = roofline("hamming_matrix", n=2048, m=2048, a_mask=False, b_mask=False)
    extras["hamming_2048"] = {"max_abs_err": e2, "ms": ms2, "plain_ms": pms2,
                              "bound_ms": bound2, "bound_by": by2}
    print(f"  hamming_matrix 160x512 masked and 2048x2048: max |err| {e1}, {e2} "
          f"(tolerance: exact)")

    # --- small_eig at the F-RANSAC's shapes: 128 8-point systems AᵀA (9x9)
    # and their FᵀF (3x3) in fp64, one fundamental_ransac's eigen work; the
    # edges
    e_small = small_eig_edges(rng, dev)
    pair = (lambda: (ck.small_eigh(ata), ck.small_eigh(ftf)))
    ms = time_ms(pair, runs) if timed else 0.0
    pms = time_ms(lambda: (ck.small_eigh_twin(ata), ck.small_eigh_twin(ftf)),
                  twin_runs) if timed else 0.0
    # the library's yardstick: the one call that computes the same function,
    # torch.linalg.eigh of the same 9x9 and 3x3 batches (it checks its errors
    # on the host); beside it, labelled, the calls the kernel replaced on the
    # path, eigh of the 9x9 systems and svd of the 3x3 F
    extras["library_ms"] = {"small_eig": time_ms(lambda: (torch.linalg.eigh(ata),
                                                          torch.linalg.eigh(ftf)), runs)
                            if timed else float("nan")}
    extras["replaced_ms"] = {"small_eig": time_ms(lambda: (torch.linalg.eigh(ata),
                                                           torch.linalg.svd(f3)), runs)
                             if timed else float("nan")}
    extras["small_eig_accuracy"] = small_eig_accuracy(
        {"8-point F (9x9, 3x3)": (ata, ftf), "PnP DLT (12x12, 3x3)": (dlt_ata, dlt_mtm),
         "degenerate 8-point (9x9, null space 2 and 3)": tuple(
             degenerate_eight_point_systems(np.random.default_rng(3), dev, kind)[1]
             for kind in ("duplicate", "planar"))})
    (b9, by9), (b3, _) = (roofline("small_eig", batch=128, n=9, itemsize=8,
                                   peak_ops=PEAK_FP64_PER_S),
                          roofline("small_eig", batch=128, n=3, itemsize=8,
                                   peak_ops=PEAK_FP64_PER_S))
    out["small_eig"] = (e_small, ms, pms, b9 + b3, by9)
    print(f"  small_eig, one F-RANSAC's eigen work (128 x 9x9 and 128 x 3x3, fp64, bound "
          f"at {PEAK_FP64_PER_S / 1e12:.0f} TFLOP/s fp64): library torch.linalg.eigh of both "
          f"{extras['library_ms']['small_eig']:.4f} ms (the calls it replaced, eigh + svd of "
          f"F: {extras['replaced_ms']['small_eig']:.4f} ms)")
    # --- and at the PnP DLT's: 128 6-point systems AᵀA (12x12) and the
    # MᵀM (3x3) of their P[:, :3], fp64, one pnp_ransac's eigen work
    got = (ck.small_eigh(dlt_ata), ck.small_eigh(dlt_mtm))
    ref = (ck.small_eigh_twin(dlt_ata), ck.small_eigh_twin(dlt_mtm))
    check(all(_same_bits(x, y) for a, b in zip(got, ref) for x, y in zip(a, b)),
          "small_eig at the DLT's shapes: the kernel's eigenpairs differ from the twin's")
    (b12, by12), (b3, _) = (roofline("small_eig", batch=128, n=12, itemsize=8,
                                     peak_ops=PEAK_FP64_PER_S),
                            roofline("small_eig", batch=128, n=3, itemsize=8,
                                     peak_ops=PEAK_FP64_PER_S))
    dlt = {"max_abs_err": 0.0,
           "ms": time_ms(lambda: (ck.small_eigh(dlt_ata), ck.small_eigh(dlt_mtm)), runs)
           if timed else 0.0,
           "plain_ms": time_ms(lambda: (ck.small_eigh_twin(dlt_ata), ck.small_eigh_twin(dlt_mtm)),
                               twin_runs) if timed else 0.0,
           # the library's yardstick: eigh of the same 12x12 and 3x3 batches;
           # and the calls the DLT made before: eigh of the 12x12 systems,
           # svd of P[:, :3] (each checks its errors on the host)
           "library_ms": time_ms(lambda: (torch.linalg.eigh(dlt_ata), torch.linalg.eigh(dlt_mtm)),
                                 runs) if timed else float("nan"),
           "replaced_ms": time_ms(lambda: (torch.linalg.eigh(dlt_ata), torch.linalg.svd(dlt_m)),
                                  runs) if timed else float("nan"),
           "profiler_ms": extras["profiler_ms"].get("small_eig_dlt"),
           "bound_ms": b12 + b3, "bound_by": by12}
    extras["small_eig_dlt"] = dlt

    # --- the pyramidal LK tracker at the front-end's call (and edge shapes)
    out["klt_track"] = klt_checks(dev, rng, klt_in, timed, runs, twin_runs)
    # --- the TSDF integrate at a published map's frame (and edge shapes)
    out["tsdf_integrate"] = tsdf_checks(dev, tsdf_rng, tsdf_in, timed, runs, twin_runs)
    # --- the window solve at the front-end's window (and edge windows)
    out["window_lm"], extras["window_lm"] = window_lm_checks(dev, wlm_in, timed, runs, twin_runs)
    print(f"  small_eig, one PnP DLT's eigen work (128 x 12x12 and 128 x 3x3, fp64): kernel == "
          f"twin bit for bit; kernel {dlt['ms']:.4f} ms (the 12x12 alone under the profiler "
          f"{dlt['profiler_ms'] or float('nan'):.4f} ms), twin {dlt['plain_ms']:.4f} ms, library "
          f"torch.linalg.eigh of both {dlt['library_ms']:.4f} ms (the calls it replaced, eigh + "
          f"svd of P[:, :3]: {dlt['replaced_ms']:.4f} ms); bound {dlt['bound_ms']:.6f} ms "
          f"({by12}), share {dlt['bound_ms'] / dlt['ms'] if dlt['ms'] else float('nan'):.2%}")

    floor = extras["floor_ms"]
    rows = list(out.items()) + [("hamming_matrix at 2048x2048",
                                 (e2, ms2, pms2, bound2, by2))]
    for name, (_, ms, pms, bound, by) in rows:
        share = f"{bound / ms:.1%}" if ms > 0 else "not measured"
        reach = f"{max(bound, floor) / ms:.1%}" if ms > 0 else "not measured"
        key = "hamming_2048" if "2048" in name else name
        prof = extras["profiler_ms"].get(key)
        prof_txt = "" if prof is None else f", {prof:.4f} ms under the profiler"
        peak = (f"{PEAK_FP64_PER_S / 1e12:.0f} TFLOP/s fp64" if name == "small_eig"
                else f"{PEAK_FP32_PER_S / 1e12:.0f} TFLOP/s fp32")
        print(f"  time {name}: kernel {ms:.4f} ms{prof_txt}, twin {pms:.4f} ms; bound {bound:.4f} "
              f"ms ({by}; {PEAK_BYTES_PER_S / 1e12:.2f} TB/s, {peak}), launch floor "
              f"{floor:.4f} ms; share of bound {share}, of max(bound, floor) {reach}")
    return out, extras


def eight_point_systems(rng, dev, k=128):
    """One fundamental_ransac's eigenproblems on `dev`, in fp64 as
    `ransac._eight_point` poses them on the card: the 8-point systems AᵀA
    (k, 9, 9) of noisy two-view samples, their least eigenvectors' FᵀF
    (k, 3, 3), and F itself (k, 3, 3, for the library's svd)."""
    from cvids_tpu_torch.ops import cuda_kernels as ck

    pts = rng.uniform(-2, 2, (k, 8, 3)).astype(np.float32)
    pts[..., 2] += 6.0
    pc2 = pts + np.array([0.4, 0.1, 0.05], np.float32)
    x1 = pts[..., :2] / pts[..., 2:3] + rng.normal(size=(k, 8, 2)) * 1e-3
    x2 = pc2[..., :2] / pc2[..., 2:3] + rng.normal(size=(k, 8, 2)) * 1e-3
    x1, x2 = (torch.from_numpy(x.astype(np.float32)).to(dev).double() for x in (x1, x2))
    a = torch.stack([x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
                     x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
                     x1[..., 0], x1[..., 1], torch.ones_like(x1[..., 0])], -1)
    ata = (a.transpose(-1, -2) @ a).contiguous()
    f = ck.small_eigh_twin(ata)[1][..., :, 0].reshape(k, 3, 3).contiguous()
    return ata, (f.transpose(-1, -2) @ f).contiguous(), f


def degenerate_eight_point_systems(rng, dev, kind, k=64):
    """Degenerate 8-point samples in fp64 on `dev`: the systems A (k, 8, 9),
    their AᵀA and its nullity. "duplicate": the 8th correspondence a copy
    of the 1st (7 distinct ones, a two-dimensional null space); "planar":
    all 8 points on one plane (the monomials span 6 dimensions, three)."""
    pts = rng.uniform(-2, 2, (k, 8, 3))
    pts[..., 2] += 6.0
    if kind == "planar":
        pts[..., 2] = 6.0 + 0.3 * pts[..., 0] - 0.2 * pts[..., 1]
    else:
        pts[:, 7] = pts[:, 0]
    r = np.asarray([[0.995, -0.0998, 0.0], [0.0998, 0.995, 0.0], [0.0, 0.0, 1.0]])
    pc2 = pts @ r.T + np.array([0.4, 0.1, 0.05])
    x1, x2 = (torch.from_numpy(p[..., :2] / p[..., 2:3]).to(dev) for p in (pts, pc2))
    a = torch.stack([x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
                     x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
                     x1[..., 0], x1[..., 1], torch.ones_like(x1[..., 0])], -1)
    return a, (a.transpose(-1, -2) @ a).contiguous(), {"duplicate": 2, "planar": 3}[kind]


def dlt_systems(rng, dev, k=128):
    """One pnp_ransac's eigenproblems on `dev`, in fp64 as `ransac._dlt_pose`
    poses them on the card: the 6-point systems AᵀA (k, 12, 12) of noisy
    samples of a posed camera, the MᵀM (k, 3, 3) of their least
    eigenvectors' P[:, :3] = M, and M itself (for the library's svd)."""
    from cvids_tpu_torch.ops import cuda_kernels as ck

    pts = rng.uniform(-2, 2, (k, 6, 3))
    pts[..., 2] += 6.0
    yaw = 0.2
    r = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
    pc = pts @ r.T + np.array([0.3, -0.2, 0.1])
    obs = pc[..., :2] / pc[..., 2:3] + rng.normal(size=(k, 6, 2)) * 1e-3
    p3, ob = (torch.from_numpy(x).to(dev) for x in (pts, obs))
    xh = torch.cat([p3, torch.ones_like(p3[..., :1])], -1)
    z = torch.zeros_like(xh)
    a = torch.cat([torch.cat([xh, z, -ob[..., :1] * xh], -1),
                   torch.cat([z, xh, -ob[..., 1:] * xh], -1)], 1)
    ata = (a.transpose(-1, -2) @ a).contiguous()
    m = ck.small_eigh_twin(ata)[1][..., :, 0].reshape(k, 3, 4)[..., :3].contiguous()
    return ata, (m.transpose(-1, -2) @ m).contiguous(), m


# small_eig against float64 torch.linalg.eigh on the path's systems: the
# eigenvalues' error relative to the largest, |VᵀV - I| and the residual |A V
# - V Λ| relative to max |A| (measured on the CPU twin: <= 6e-15 at 8 sweeps,
# dev/torch_probe_small_eig.py); 1e-12 leaves room for the card's libm-free
# arithmetic, which is the twin's
SMALL_EIG_ACCURACY_TOL = 1e-12


def small_eig_accuracy(systems: dict) -> dict:
    """The kernel's eigenpairs of each named pair of fp64 batches against
    torch.linalg.eigh's in float64; fails beyond SMALL_EIG_ACCURACY_TOL.
    Returns {name: {eig_rel, orth, resid}} (the larger of the pair's)."""
    from cvids_tpu_torch.ops import cuda_kernels as ck

    out = {}
    for name, mats in systems.items():
        row = {"eig_rel": 0.0, "orth": 0.0, "resid": 0.0}
        for a in mats:
            w, v = ck.small_eigh(a)
            wr = torch.linalg.eigh(a.double())[0]
            eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
            row["eig_rel"] = max(row["eig_rel"], float(((w - wr).abs().amax(-1)
                                                        / wr.abs().amax(-1)).max()))
            row["orth"] = max(row["orth"], float((v.mT @ v - eye).abs().max()))
            row["resid"] = max(row["resid"], float(((a @ v - v * w[:, None, :]).abs()
                                                    .amax((-1, -2)) / a.abs().amax((-1, -2)))
                                                   .max()))
        check(max(row.values()) < SMALL_EIG_ACCURACY_TOL,
              f"small_eig at the {name} systems against float64 torch.linalg.eigh: {row}, "
              f"tolerance {SMALL_EIG_ACCURACY_TOL}")
        out[name] = row
    print("  small_eig against float64 torch.linalg.eigh (eigenvalues relative to the largest, "
          "|VᵀV - I|, |AV - VΛ| / max|A|; tolerance "
          f"{SMALL_EIG_ACCURACY_TOL}): " + "; ".join(
              f"{k} {v['eig_rel']:.2e}, {v['orth']:.2e}, {v['resid']:.2e}" for k, v in out.items()))
    return out


def small_eig_edges(rng, dev) -> float:
    """small_eig against its twin, bit for bit, at the edge shapes n = 1, 3,
    9 and 12 (random symmetric positive semi-definite batches of 128, odd
    batch sizes) in fp32 and fp64, a diagonal matrix with tied eigenvalues
    and a zero matrix. Returns the largest |difference| (0)."""
    from cvids_tpu_torch.ops import cuda_kernels as ck

    cases = []
    for n, b in ((1, 5), (3, 128), (9, 128), (9, 3), (12, 128), (12, 7)):
        x = torch.from_numpy(rng.normal(size=(b, n, n))).to(dev)
        for dtype in (torch.float32, torch.float64):
            cases.append((f"{b} x {n}x{n} {str(dtype)[6:]}",
                          (x @ x.transpose(-1, -2)).to(dtype).contiguous()))
    cases.append(("ties", torch.diag(torch.tensor([3.0, 1.0, 1.0, 2.0], device=dev))[None]
                  .contiguous()))
    cases.append(("zero", torch.zeros((4, 9, 9), device=dev)))
    for what, a in cases:
        got, ref = ck.small_eigh(a), ck.small_eigh_twin(a)
        check(all(_same_bits(x, y) for x, y in zip(got, ref)),
              f"small_eig {what}: the kernel's eigenpairs differ from the twin's")
    print(f"  small_eig at {', '.join(c[0] for c in cases)}: kernel == twin bit for bit")
    return 0.0


def klt_texture(rng, h, w, dx=0.0, dy=0.0, angle=0.0, bias=0.0, black=None) -> np.ndarray:
    """A band-limited texture (12 random sinusoids around 125), moved by (dx,
    dy) px and turned by `angle` about the centre, plus `bias`; `black` (x0,
    y0, x1, y1) is a box of the unmoved frame set to 0 (a flat patch)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    c, s = np.cos(angle), np.sin(angle)
    xc, yc = xx - w / 2 - dx, yy - h / 2 - dy
    u, v = c * xc + s * yc + w / 2, -s * xc + c * yc + h / 2
    img = np.full((h, w), 125.0)
    for _ in range(12):
        k, th, ph = rng.uniform(0.05, 0.35), rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi)
        img += 7.0 * np.sin(k * (np.cos(th) * u + np.sin(th) * v) + ph)
    if black is not None:
        x0, y0, x1, y1 = black
        img[(u >= x0) & (u <= x1) & (v >= y0) & (v <= y1)] = 0.0
    return (img + bias).astype(np.float32)


def klt_inputs(rng, dev, h=KLT_H, w=KLT_W, n=KLT_N, levels=KLT_LEVELS, margin=12.0):
    """The tracker's call as the front-end makes it: the pyramids of two
    frames (the second moved by KLT_MOTION's shift and turn, 8 levels
    brighter, a black box in both), n points seeded ~0.5 px off their
    prediction, the last ones a point at the border, one given as invalid,
    one in the black box and one seeded 80 px off. Returns (pyr0, pyr1, xy0,
    valid0, init_xy) on `dev`."""
    from cvids_tpu_torch.ops.image import build_pyramid

    seed = int(rng.integers(1 << 30))
    box = (0.55 * w, 0.6 * h, 0.55 * w + 40, 0.6 * h + 40)
    img0 = klt_texture(np.random.default_rng(seed), h, w, black=box)
    img1 = klt_texture(np.random.default_rng(seed), h, w, *KLT_MOTION, 8.0, black=box)
    xy = np.stack([rng.uniform(margin, w - margin, n), rng.uniform(margin, h - margin, n)],
                  -1).astype(np.float32)
    valid = np.ones(n, bool)
    init = xy + rng.normal(0, 0.5, xy.shape).astype(np.float32)
    if n >= 4:
        xy[-1] = [2.0, 2.0]                                     # at the border
        valid[-2] = False                                       # given as invalid
        xy[-3] = [box[0] + 20, box[1] + 20]                     # in the black box
        init[-4] += [80.0, -60.0]                               # seeded far off
    pyr = [[lv.contiguous() for lv in build_pyramid(torch.from_numpy(im).to(dev), levels)]
           for im in (img0, img1)]
    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    return pyr[0], pyr[1], t(xy), t(valid), t(init)


def klt_truth(xy: torch.Tensor, h=KLT_H, w=KLT_W) -> torch.Tensor:
    """Where the points xy of `klt_inputs`' first frame lie in its second:
    the inverse of `klt_texture`'s turn about the centre, then the shift."""
    dx, dy, angle = KLT_MOTION
    c, s = np.cos(angle), np.sin(angle)
    u, v = xy[:, 0].double() - w / 2, xy[:, 1].double() - h / 2
    return torch.stack([c * u - s * v + w / 2 + dx, s * u + c * v + h / 2 + dy], -1)


def klt_edge_cases(rng, dev) -> list:
    """(what, inputs, keyword arguments) of the tracker at edge shapes: one
    point, 33 points (a ragged last 32), every point invalid, no
    forward-backward gate (3 levels x 10), radius 3 at 1-4 levels on an odd
    97x131 pair, radius 0 and the largest radius, points leaving the image
    (seeds moved by up to 300 px)."""
    cases = []
    full = klt_inputs(rng, dev, 120, 160, 40, 4)
    cases.append(("1 point", tuple(x[:1] if i > 1 else x for i, x in enumerate(full)),
                  KLT_ARGS))
    cases.append(("33 points", klt_inputs(rng, dev, 120, 160, 33, 4), KLT_ARGS))
    none = list(full)
    none[3] = torch.zeros_like(full[3])
    cases.append(("all invalid", tuple(none), KLT_ARGS))
    cases.append(("no gate, 3 levels x 10", klt_inputs(rng, dev, 120, 160, 40, 3),
                  dict(radius=10, iters=10, max_residual=25.0, min_eig=1e-3, fb_thresh=None)))
    for levels in (1, 2, 3, 4):
        cases.append((f"radius 3, {levels} levels, 97x131", klt_inputs(rng, dev, 97, 131, 24,
                                                                       levels, 6.0),
                      dict(radius=3, iters=8, max_residual=40.0, min_eig=1e-3, fb_thresh=1.0)))
    cases.append(("radius 0", klt_inputs(rng, dev, 97, 131, 24, 2, 4.0),
                  dict(KLT_ARGS, radius=0)))
    cases.append(("radius 24", klt_inputs(rng, dev, 120, 160, 12, 2, 30.0),
                  dict(KLT_ARGS, radius=24, iters=4)))
    off = list(klt_inputs(rng, dev, 120, 160, 40, 4))
    off[4] = off[4] + torch.from_numpy(rng.uniform(-300, 300, (40, 2)).astype(np.float32)).to(dev)
    cases.append(("seeds off the image", tuple(off), KLT_ARGS))
    return cases


def klt_checks(dev, rng, inputs, timed, runs, twin_runs):
    """klt_track against its twin, bit for bit, at the path's shape (the
    752x480 pyramids, 150 points, 4 levels x 15, the gate) and at
    `klt_edge_cases`; then the path's call timed. Returns (max |err|, ms,
    twin ms, bound ms, bound by)."""
    from cvids_tpu_torch.ops import cuda_kernels as ck

    def same(what, args, kw):
        got, ref = ck.klt_track(*args, **kw), ck.klt_track_twin(*args, **kw)
        check(all(_same_bits(a, b) for a, b in zip(got, ref)),
              f"klt_track {what}: the kernel's output differs from the twin's")
        return got

    xy, valid, _ = same("at the path's shape", inputs, KLT_ARGS)
    cases = klt_edge_cases(rng, dev)
    for what, args, kw in cases:
        same(what, args, kw)
    ms = time_ms(lambda: ck.klt_track(*inputs, **KLT_ARGS), runs) if timed else 0.0
    pms = time_ms(lambda: ck.klt_track_twin(*inputs, **KLT_ARGS), twin_runs) if timed else 0.0
    bound, by = roofline("klt_track", n=KLT_N, p=(2 * KLT_ARGS["radius"] + 1) ** 2,
                         levels=KLT_LEVELS, iters=KLT_ARGS["iters"], fb=True, h=KLT_H, w=KLT_W)
    err = (xy.double() - klt_truth(inputs[2])).norm(dim=-1)[valid]
    check(int(valid.sum()) >= KLT_N * 0.8 and float(err.median()) < 0.1,
          f"klt_track at the path's shape: {int(valid.sum())} of {KLT_N} tracked, median "
          f"error {float(err.median())} px against the true motion")
    print(f"  klt_track at {KLT_W}x{KLT_H}, {KLT_N} points, {KLT_LEVELS} levels x "
          f"{KLT_ARGS['iters']}, the gate: kernel == twin bit for bit (tolerance: exact); "
          f"{int(valid.sum())} tracked, error against the true motion median "
          f"{float(err.median()):.4f} px, largest {float(err.max()):.4f} px (tolerance: median "
          f"< 0.1 px, >= 80 % tracked); and at {', '.join(c[0] for c in cases)}")
    return 0.0, ms, pms, bound, by


# phase 3's window-solve inputs: the front-end's window (K = 10 keyframes,
# 4 x 150 landmark slots, 8 iterations, a camera-only prior of 15K rows)
WLM_K, WLM_L, WLM_ITERS = 10, 600, 8


def window_lm_inputs(dev, k=WLM_K, n_lm=WLM_L, seed=0, prior=True, huber=5.0, fill=0.6,
                     kf_invalid=(), pre_invalid=(), no_landmarks=False):
    """(state, meas) of one `solve_window_fast` call on `dev`, built on the
    CPU by the port alone: `io.synthetic`'s circle (keyframes at 2 Hz, a
    landmark box around it), the port's preintegration, positions and
    landmarks perturbed by 5 cm, a `fill` share of the slots that two
    keyframes see valid, the front-end's weights (460 px, bias 50); with
    `prior`, the camera-only prior that `marginalize_prior_cam` makes of
    this window, linearized 2 cm away. `kf_invalid` / `pre_invalid` clear
    those slots' and intervals' flags."""
    from cvids_tpu_torch.geometry import yaw_of
    from cvids_tpu_torch.io import synthetic
    from cvids_tpu_torch.vio import imu, window_ba as ba

    seq = synthetic.generate_sequence(synthetic.Trajectory.circle(radius=5.0, omega=0.5),
                                      duration=(k - 1) / 2.0, kf_rate=2.0,
                                      num_landmarks=n_lm, seed=seed)
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))     # noqa: E731
    g, a, dt, v = synthetic.imu_slices(seq)
    zero = torch.zeros(3)
    pre = imu.preintegrate(f(g), f(a), f(dt), zero, zero, sample_valid=torch.as_tensor(v))
    lm_valid = (seq.vis.sum(0) >= 2) & (rng.random(n_lm) < fill) & (not no_landmarks)
    kf_valid = np.ones(k, bool)
    kf_valid[list(kf_invalid)] = False
    pre_valid = np.ones(k - 1, bool)
    pre_valid[list(pre_invalid)] = False
    st = ba.WindowState(
        p=f(seq.p_gt + rng.normal(0, 0.05, (k, 3))), q=f(seq.q_gt), v=f(seq.v_gt),
        bg=torch.zeros((k, 3)), ba=torch.zeros((k, 3)),
        lm=f(np.where(lm_valid[:, None], seq.landmarks + rng.normal(0, 0.05, (n_lm, 3)), 0.0)),
        kf_valid=torch.as_tensor(kf_valid), lm_valid=torch.as_tensor(lm_valid))
    meas = ba.WindowMeasurements(
        obs=f(np.nan_to_num(seq.obs)), vis=torch.as_tensor(seq.vis), pre=pre,
        pre_valid=torch.as_tensor(pre_valid), r_cb=f([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0],
                                                       [1.0, 0.0, 0.0]]),
        p_bc=zero, pix_weight=460.0, huber_delta=huber, bias_weight=50.0, prior=None,
        anchor_p=f(seq.p_gt[0]), anchor_yaw=yaw_of(f(seq.q_gt[0])))
    if prior:
        dying = meas.vis[0] & ~meas.vis[1:].any(0)
        j, r0 = ba.marginalize_prior_cam(st, meas, dying)
        meas = meas._replace(prior=ba.CamPriorFactor(j=j, r0=r0, p=st.p + 0.02, q=st.q,
                                                     v=st.v, bg=st.bg, ba=st.ba))
    # contiguous, as the front-end's stacked window is
    to = lambda t: t.to(dev).contiguous()      # noqa: E731
    return (ba.WindowState(*(to(x) for x in st)),
            meas._replace(obs=to(meas.obs), vis=to(meas.vis),
                          pre=type(pre)(*(to(x) for x in pre)), pre_valid=to(meas.pre_valid),
                          r_cb=to(meas.r_cb), p_bc=to(meas.p_bc), anchor_p=to(meas.anchor_p),
                          anchor_yaw=to(meas.anchor_yaw),
                          prior=None if meas.prior is None else
                          type(meas.prior)(*(to(x) for x in meas.prior))))


def window_lm_edge_cases(dev) -> list:
    """(what, state, meas, iters, init_lambda) of the window kernel's edges:
    no prior, the Huber branch on most observations, invalid keyframe slots
    and intervals, no valid landmark, one and 25 iterations, rejected steps
    (the yaw anchor 3 rad off and λ = 1e-10: the first step is taken, the
    next ones rejected while λ grows), K = 12, 13 and 21 (the kernel's
    limit, its system over the cluster's shared memory) with 1100 slots (two
    a logical thread, a ragged tile), K = 2 with 37 slots."""
    st, m = window_lm_inputs(dev, seed=4)
    return [
        ("no prior", *window_lm_inputs(dev, prior=False), WLM_ITERS, 1e-3),
        ("huber_delta 1.0", *window_lm_inputs(dev, huber=1.0, seed=1), WLM_ITERS, 1e-3),
        ("slots 8-9 and interval 3 invalid",
         *window_lm_inputs(dev, seed=2, kf_invalid=(8, 9), pre_invalid=(3,)), WLM_ITERS, 1e-3),
        ("no valid landmark", *window_lm_inputs(dev, seed=3, no_landmarks=True), WLM_ITERS,
         1e-3),
        ("1 iteration", st, m, 1, 1e-3),
        ("25 iterations", *window_lm_inputs(dev, seed=5), 25, 1e-3),
        ("rejected steps", st, m._replace(anchor_yaw=m.anchor_yaw + 3.0), WLM_ITERS, 1e-10),
        ("K = 12, L = 1100", *window_lm_inputs(dev, k=12, n_lm=1100, seed=6), WLM_ITERS, 1e-3),
        ("K = 13, L = 1100", *window_lm_inputs(dev, k=13, n_lm=1100, seed=8), WLM_ITERS, 1e-3),
        ("K = 21, L = 1100", *window_lm_inputs(dev, k=21, n_lm=1100, seed=10), WLM_ITERS, 1e-3),
        ("K = 2, L = 37", *window_lm_inputs(dev, k=2, n_lm=37, seed=7, prior=False), WLM_ITERS,
         1e-3),
    ]


def window_to(state, meas, dev):
    """A window problem's tensors moved to `dev` (a prior included)."""
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda x: x.to(dev) if torch.is_tensor(x) else x, (state, meas))


def window_work(state, meas) -> dict:
    """The data's counts for `kernel_work("window_lm", ...)`: valid
    observations (visible from a valid keyframe of a valid landmark) and
    co-observations (a landmark with a pair of its keyframes, m <= k)."""
    valid = meas.vis & state.kf_valid[:, None] & state.lm_valid[None, :]
    per_lm = valid.sum(0)
    return {"obs": int(valid.sum()), "pairs": int((per_lm * (per_lm + 1) // 2).sum())}


def window_lm_checks(dev, inputs, timed, runs, twin_runs):
    """window_lm against its twin, bit for bit, at the front-end's window
    (K = 10, 600 slots, a 150-row prior, 8 iterations) and at
    `window_lm_edge_cases`; the path's result and the K = 13 and K = 21
    windows' against the port's CPU solve (`solve_window_fast`'s body,
    test_solvers_match's tolerances); the compiled kernel's cluster,
    registers and local memory; then the path's call timed. Returns ((max
    |err|, ms, twin ms, bound ms, bound by), the data's counts)."""
    from cvids_tpu_torch import _build
    from cvids_tpu_torch.ops import cuda_kernels as ck
    from cvids_tpu_torch.vio import window_ba as ba

    def same(what, st, m, iters, lam=1e-3):
        got, ref = ck.window_lm(st, m, iters, lam), ck.window_lm_twin(st, m, iters, lam)
        check(all(_same_bits(a, b) for a, b in zip(tuple(got[0]) + (got[1],),
                                                   tuple(ref[0]) + (ref[1],))),
              f"window_lm {what}: the kernel's state or cost differs from the twin's")
        return got

    def against_cpu(what, st, m, got, iters=WLM_ITERS):
        cpu, cpu_cost = ba.solve_window_fast(*window_to(st, m, "cpu"), iters=iters)
        p_err = float((got[0].p.cpu() - cpu.p).abs().max())
        lm_err = float((got[0].lm.cpu() - cpu.lm).abs().max())
        cost_rel = abs(float(got[1]) - float(cpu_cost)) / float(cpu_cost)
        check(p_err < 1e-3 and lm_err < 1e-2 and cost_rel < 1e-3,
              f"window_lm {what} against the CPU solve: |p| {p_err}, |lm| {lm_err}, "
              f"cost {float(got[1])} against {float(cpu_cost)}")
        return p_err, lm_err, cost_rel

    st, m = inputs
    got = same("at the path's window", st, m, WLM_ITERS)
    cases = window_lm_edge_cases(dev)
    for what, st2, m2, iters, lam in cases:
        got2 = same(what, st2, m2, iters, lam)
        if st2.p.shape[0] > 12:
            errs = against_cpu(what, st2, m2, got2, iters)
            print(f"  window_lm {what}: kernel == twin bit for bit; against the CPU solve |p| "
                  f"{errs[0]:.3g} m, |lm| {errs[1]:.3g} m, cost {errs[2]:.3g} relative "
                  f"(tolerances 1e-3, 1e-2, 1e-3)")
    p_err, lm_err, cost_rel = against_cpu("at the path's window", st, m, got)
    attrs = ck.window_lm_attrs()
    spills = ptxas_summary(_build.build()[1])[1]["window_lm_kernel"]
    print(f"  window_lm compiled: a cluster of {attrs['cluster']} blocks of {attrs['threads']} "
          f"threads, {attrs['registers']} registers and {attrs['local_bytes']} local bytes a "
          f"thread (cudaFuncGetAttributes: the stack frame of sinf's and cosf's argument "
          f"reduction); ptxas: {spills} spill bytes")
    check(spills == 0, f"window_lm spills {spills} bytes")
    ms = time_ms(lambda: ck.window_lm(st, m, WLM_ITERS), runs) if timed else 0.0
    pms = time_ms(lambda: ck.window_lm_twin(st, m, WLM_ITERS), twin_runs) if timed else 0.0
    work = window_work(st, m)
    bound, by = roofline("window_lm", k=WLM_K, l=WLM_L, iters=WLM_ITERS,
                         prior=m.prior.j.shape[0], **work)
    print(f"  window_lm at K = {WLM_K}, L = {WLM_L} ({int(st.lm_valid.sum())} valid, "
          f"{work['obs']} observations, {work['pairs']} co-observations), a "
          f"{m.prior.j.shape[0]}-row prior, {WLM_ITERS} iterations: kernel == twin bit for bit "
          f"(tolerance: exact), cost {float(got[1]):.4f}; against the CPU solve |p| "
          f"{p_err:.3g} m, |lm| {lm_err:.3g} m, cost {cost_rel:.3g} relative (tolerances 1e-3, "
          f"1e-2, 1e-3); and at {', '.join(c[0] for c in cases)}")
    return (0.0, ms, pms, bound, by), work


# phase 3's TSDF inputs: a published map's frame at phase 6's shapes and
# TsdfConfig() (0.1 m voxels, 8^3 chunks, carving) into a mid-run pool
TSDF_CAPACITY = 4096


def tsdf_inputs(rng, dev, h=H, w=W, focal=FOCAL, cfg_kw=None, m=None, stride0=True,
                slot0=False, off_image=False, capacity=TSDF_CAPACITY):
    """(cfg, pool, slots, coords, depth, color, k, r_cw, t_cw) of one
    `cuda_kernels.tsdf_integrate` call on `dev`: a rippled, tilted wall at
    2-6 m (10 % holes, 1 % past max_depth) seen from a turned camera, the
    chunks its walk touches (the first `m`; with `off_image` three behind
    the camera and three far away too), distinct slots of a pool mid-run
    (a third of the voxels unseen, weights up to the cap, slot 0 among them
    with `slot0`), the colour the server's grey image on three channels (a
    stride-0 view) or, without `stride0`, a contiguous colour image."""
    from cvids_tpu_torch.mapping.tsdf import ChunkPool, TsdfConfig, TsdfVolume

    cfg = TsdfConfig(**(cfg_kw or {}))
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = 2.0 + 4.0 * uu / w + 0.4 * np.sin(vv / (h / 12)) + rng.normal(0, 0.01, (h, w))
    depth[rng.random((h, w)) < 0.1] = 0.0
    depth[rng.random((h, w)) < 0.01] = 25.0
    depth = depth.astype(np.float32)
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    r_wc = rotation_homography(np.eye(3, dtype=np.float32), 0.3, 0.1)
    t_wc = np.array([0.4, -0.2, 0.1], np.float32)
    coords = TsdfVolume(cfg, device="cpu")._touched_chunks(depth, k, r_wc, t_wc)[:m]
    if off_image:
        chunk = cfg.voxel_size * cfg.chunk_size
        behind = np.floor((t_wc - 2.0 * r_wc[:, 2]) / chunk).astype(np.int32)
        far = np.array([[400, -300, 250]], np.int32) + np.arange(3)[:, None]
        coords = np.concatenate([coords, behind + np.arange(3)[:, None] * [1, 0, 0], far])
    n = len(coords)
    slots = rng.permutation(capacity)[:n].astype(np.int64)
    if slot0:           # slot 0 and the pool's last slot among the chunks
        for i, want in ((n // 2, 0), (n - 1, capacity - 1)):
            if want not in slots:
                slots[i] = want
    s = cfg.chunk_size
    shape = (capacity, s, s, s)
    wgt = rng.uniform(0.5, 100.0, shape).astype(np.float32)
    wgt[rng.random(shape) < 0.33] = 0.0
    wgt[rng.random(shape) < 0.05] = 100.0
    pool = ChunkPool(*(torch.from_numpy(a).to(dev) for a in (
        rng.uniform(-0.2, 0.2, shape).astype(np.float32), wgt,
        rng.uniform(0, 255, shape + (3,)).astype(np.float32))))
    gray = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
    color = (gray[..., None].expand(-1, -1, 3) if stride0 else
             torch.from_numpy(rng.uniform(0, 255, (h, w, 3)).astype(np.float32)).to(dev))
    to = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)  # noqa: E731
    return (cfg, pool, to(slots, torch.int64), to(coords, torch.int32), to(depth), color, to(k),
            to(r_wc.T), to(-r_wc.T @ t_wc))


def tsdf_edge_cases(rng, dev) -> list:
    """(what, inputs) of the TSDF kernel's edges: one chunk, chunks of 7³
    and 9³ voxels (the voxel loop's ragged last pass), chunks whose voxels
    all fall off the image, a contiguous colour, slot 0 and the pool's last
    slot, carving off with a quadratic truncation, a ragged 37x53 image."""
    return [
        ("one chunk", tsdf_inputs(rng, dev, m=1)),
        ("chunks of 7^3", tsdf_inputs(rng, dev, cfg_kw=dict(chunk_size=7), m=200,
                                      capacity=512)),
        ("chunks of 9^3", tsdf_inputs(rng, dev, cfg_kw=dict(chunk_size=9), m=200,
                                      capacity=512)),
        ("off-image chunks", tsdf_inputs(rng, dev, m=20, off_image=True)),
        ("a contiguous colour", tsdf_inputs(rng, dev, m=300, stride0=False)),
        ("slot 0 and the last slot", tsdf_inputs(rng, dev, m=300, slot0=True)),
        ("no carving, quadratic truncation",
         tsdf_inputs(rng, dev, cfg_kw=dict(carving=False, trunc_quad=0.02), m=300)),
        ("a 37x53 image", tsdf_inputs(rng, dev, 37, 53, 30.0, m=50, capacity=256)),
    ]


def _pool_copy(pool):
    return type(pool)(*(x.clone() for x in pool))


def tsdf_checks(dev, rng, inputs, timed, runs, twin_runs):
    """tsdf_integrate against its twin, bit for bit, at the path's shape (a
    published map's frame at 640x480 into its chunks of a 4096-chunk pool)
    and at `tsdf_edge_cases`, each from copies of one pool; then the path's
    call timed (in place: every run integrates the frame again). Returns
    (max |err|, ms, twin ms, bound ms, bound by)."""
    from cvids_tpu_torch.ops import cuda_kernels as ck

    def same(what, inp):
        cfg, pool, *rest = inp
        got, ref = _pool_copy(pool), _pool_copy(pool)
        ck.tsdf_integrate(cfg, got, *rest)
        ck.tsdf_integrate_twin(cfg, ref, *rest)
        check(all(_same_bits(a, b) for a, b in zip(got, ref)),
              f"tsdf_integrate {what}: the kernel's pool differs from the twin's")
        return pool, got

    before, after = same("at the path's shape", inputs)
    # the data's counts: voxels whose weight changed, voxels in the band
    # (their colour changed) and pool words whose bits changed, for the bound
    moved = [(a.view(torch.int32) != b.view(torch.int32)) for a, b in zip(after, before)]
    changed = int(moved[1].sum())
    updated = int(moved[2].any(-1).sum())
    written = int(sum(x.sum() for x in moved))
    cases = tsdf_edge_cases(rng, dev)
    for what, inp in cases:
        same(what, inp)
    cfg, pool, slots, coords, *rest = inputs
    if dev.type == "cuda":
        # a slot outside the pool (past its end, negative) is skipped by the
        # kernel, which writes nothing else: the twin on the other chunks
        # (the twin itself raises on such a slot)
        bad = slots.clone()
        bad[:2] = torch.tensor([pool.sdf.shape[0], -1], device=dev)
        got, ref = _pool_copy(pool), _pool_copy(pool)
        ck.tsdf_integrate(cfg, got, bad, coords, *rest)
        ck.tsdf_integrate_twin(cfg, ref, slots[2:], coords[2:], *rest)
        check(all(_same_bits(a, b) for a, b in zip(got, ref)),
              "tsdf_integrate with two slots outside the pool: the pool differs from the "
              "twin's on the other chunks")
        cases.append(("two slots outside the pool",))
    m = slots.shape[0]
    work = _pool_copy(pool)
    ms = time_ms(lambda: ck.tsdf_integrate(cfg, work, slots, coords, *rest),
                 runs) if timed else 0.0
    pms = time_ms(lambda: ck.tsdf_integrate_twin(cfg, work, slots, coords, *rest),
                  twin_runs) if timed else 0.0
    depth, color = rest[0], rest[1]
    color_px = 4 * (1 if color.stride(-1) == 0 else 3)
    bound, by = roofline("tsdf_integrate", m=m, s=cfg.chunk_size, h=depth.shape[0],
                         w=depth.shape[1], updated=updated, written=written, color_px=color_px)
    check(changed > m * 8, f"tsdf_integrate at the path's shape: {changed} voxels of {m} "
                           f"chunks changed")
    print(f"  tsdf_integrate, a {W}x{H} frame into {m} chunks of {cfg.chunk_size}^3 (pool "
          f"{pool.sdf.shape[0]}, stride-0 colour): kernel == twin bit for bit (tolerance: "
          f"exact), {changed} voxels changed ({updated} in the band, {written} pool words "
          f"written); and at {', '.join(c[0] for c in cases)}")
    return 0.0, ms, pms, bound, by


def plan_checks() -> None:
    """The scan's, the sweep's, the WTA's, the Hamming kernel's, the
    tracker's, the TSDF kernel's and the window solve's launch plans as
    Python restates them (and the CPU tests hold
    to the card's limits) against what the built library reports for the
    same shapes: every D and dtype, ragged line counts and tiles."""
    from cvids_tpu_torch.ops import cuda_kernels as ck

    n = 0
    for d in range(32, 257, 32):
        for dt in (torch.bfloat16, torch.float32):
            for lines in (1, 3, H, W + 1):
                want, got = ck.sgm_scan_plan(lines, d, dt), ck.compiled_sgm_scan_plan(lines, d, dt)
                check(want == got, f"sgm_scan plan at {lines} lines, D {d}, {dt}: Python "
                                   f"{want}, library {got}")
                n += 1
        for h, w in ((H, W), (37, 53), (1, 33), (9, 31)):
            want, got = ck.plane_sweep_plan(h, w, d), ck.compiled_plane_sweep_plan(h, w, d)
            check(want == got, f"plane_sweep plan at {h}x{w}x{d}: Python {want}, library {got}")
            n += 1
            for dt in (torch.bfloat16, torch.float32):
                want, got = ck.wta_plan(h * w, d, dt), ck.compiled_wta_plan(h * w, d, dt)
                check(want == got, f"wta plan at {h * w} pixels, D {d}, {dt}: Python {want}, "
                                   f"library {got}")
                n += 1
    for hn, hm in ((160, 512), (2048, 2048), (1, 1), (37, 129), (160, 1), (33, 4097),
                   (1, 4097), (7, 100_000), (131, 128)):
        want, got = ck.hamming_plan(hn, hm), ck.compiled_hamming_plan(hn, hm)
        check(want == got, f"hamming plan at {hn}x{hm}: Python {want}, library {got}")
        n += 1
    for kn in (1, 33, KLT_N, 1000):
        for radius in (0, 3, 10, 15, 16, 24):
            want, got = ck.klt_plan(kn, radius), ck.compiled_klt_plan(kn, radius)
            check(want == got, f"klt plan at {kn} points, radius {radius}: Python {want}, "
                               f"library {got}")
            n += 1
    for tm in (1, 33, 1000, 131_072):
        for ts in (1, 5, 7, 8, 9, 16):
            want, got = ck.tsdf_plan(tm, ts), ck.compiled_tsdf_plan(tm, ts)
            check(want == got, f"tsdf plan at {tm} chunks of {ts}^3: Python {want}, "
                               f"library {got}")
            n += 1
    for wk in (1, 2, 5, 10, 11, 12, 13, 20, 21):
        for wl in (0, 37, WLM_L, 1100):
            for wp in (0, 15 * wk, 15 * wk + 1):
                want, got = ck.window_lm_plan(wk, wl, wp), ck.compiled_window_lm_plan(wk, wl, wp)
                check(want == got, f"window_lm plan at K {wk}, L {wl}, prior {wp}: Python "
                                   f"{want}, library {got}")
                n += 1
    print(f"  launch plans: Python's equal the library's at {n} shapes")


def filter_inputs(rng, dev, h, w):
    """A mid-run filter state and a measurement with out-of-range and
    invalid pixels."""
    from cvids_tpu_torch.ops.depth_filter import FilterState

    def u(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (h, w)).astype(np.float32)).to(dev)

    st = FilterState(u(0.1, 1.5), u(1e-4, 0.5), u(5.0, 40.0), u(5.0, 40.0))
    x = u(0.05, 2.0)
    x[0, :2] = torch.tensor([0.001, 500.0], device=dev)[:w]
    valid = torch.from_numpy(rng.random((h, w)) > 0.2).to(dev)
    return st, x, valid


def ulp_distance(x: torch.Tensor, y: torch.Tensor) -> int:
    """Largest distance in fp32 ulps between two float32 tensors (the bit
    patterns mapped onto one ordered integer line, so -0 and +0 are 0 apart)."""
    def ordered(t):
        i = t.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(x) - ordered(y)).abs().max().item()) if x.numel() else 0


def filter_agree(out, ref, what) -> float:
    """Checks the kernel's FilterState against the twin's, field by field,
    within FILTER_MAX_ULP; returns the max |err| over the four fields."""
    parts, err = [], 0.0
    for name, o, r in zip(("mu", "sigma2", "a", "b"), out, ref):
        ulp = ulp_distance(o, r)
        check(ulp <= FILTER_MAX_ULP, f"{what} {name}: kernel vs twin {ulp} ulp apart "
              f"(max |err| {(o - r).abs().max().item()}), tolerance {FILTER_MAX_ULP} ulp")
        parts.append(f"{name} {ulp} ulp")
        err = max(err, (o - r).abs().max().item())
    print(f"  {what}: kernel vs twin max distance " + ", ".join(parts)
          + f" (tolerance {FILTER_MAX_ULP} ulp)")
    return err


def hamming_inputs(rng, dev, n, m):
    """Random descriptors (int32 words), a third of b copies of a with a
    few flipped bits, and validity masks."""
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    k = min(n, m) // 3
    b[:k] = a[:k] ^ (rng.random((k, 8)) < 0.03).astype(np.uint32)
    to = lambda x: torch.from_numpy(x.view(np.int32)).to(dev)  # noqa: E731
    return (to(a), to(b), torch.from_numpy(rng.random(n) > 0.1).to(dev),
            torch.from_numpy(rng.random(m) > 0.1).to(dev))


def warp_edge_maps(h: int, w: int, band_x: int, band_y: int) -> dict[str, np.ndarray]:
    """3x3 maps that decide what the fused warp must get right at (h, w):
    shifts just inside, on and just beyond each band, a perspective map (m20
    and m21 nonzero), a pitch that puts the degenerate row of the pass-1
    inversion (|m11 - r m21| < 1e-3) inside the image, a map with that row at
    h // 2 whose neighbouring rows keep coverage, one that sends every
    output row to it (y_in = h // 2 everywhere: only g = -1e9 on that row
    keeps the coverage at 0), and maps with non-finite positions
    (`nonfinite_warp_maps`)."""
    maps = {}
    for axis, band in ((0, band_x), (1, band_y)):
        for shift in (band - 0.5, band, band + 0.5, band + 1.5, -band + 0.25, -band, -band - 1.0):
            m = np.eye(3, dtype=np.float32)
            m[axis, 2] = shift
            maps[f"shift {'xy'[axis]} {shift:+.2f}"] = m
    focal = 0.72 * w
    k = np.array([[focal, 0, w / 2], [0, focal, h // 2], [0, 0, 1]])
    maps["perspective"] = rotation_homography(k, 0.03, -0.02)
    if h >= 8:
        # den(r) = cos a - (r - h // 2) sin a / focal = 0 at r = h // 2 + h // 4
        maps["pitch, degenerate row"] = rotation_homography(k, 0.01, np.arctan(focal / (h // 4)))
        r0 = h // 2
        maps["degenerate row, neighbours covered"] = np.array(
            [[1, 0, 0.25], [0, 1, 1], [0, 1.0 / r0, 0]], np.float32)
        maps["degenerate row, sampled by every row"] = np.array(
            [[1, 0, 0.25], [0, 1, r0], [0, 1.0 / r0, 1]], np.float32)
    maps.update(nonfinite_warp_maps())
    return maps


def nonfinite_warp_maps() -> dict[str, np.ndarray]:
    """3x3 maps whose sample positions are not finite: the column-pass
    position of row 0 is inf * 0 = NaN and that of every other row inf
    (m11 = inf); the row-pass position of column 0 is NaN and that of every
    other column inf (m00 = inf); every position NaN (m12 = NaN). A
    non-finite position is inside no band: value 0 and coverage 0, from the
    kernel and from the twin, and no index is made from it."""
    maps = {}
    for name, (i, j), value in (("non-finite: row 0 NaN, the others inf", (1, 1), np.inf),
                                ("non-finite: column 0 NaN, the others inf", (0, 0), np.inf),
                                ("non-finite: every position NaN", (1, 2), np.nan)):
        m = np.eye(3, dtype=np.float32)
        m[i, j] = value
        maps[name] = m
    return maps


def degenerate_rows(m: np.ndarray, h: int) -> int:
    """Rows of an h-row image where the warp's pass-1 inversion degenerates,
    in the kernel's fp32 arithmetic."""
    den = m[1, 1] - np.arange(h, dtype=np.float32) * m[2, 1]
    return int((np.abs(den) < np.float32(1e-3)).sum())


def wta_built_rows(d: int, n_vec_elems: int, rng) -> np.ndarray:
    """(R, d) fp32 rows for the first part of a WTA call, built around what
    the kernel's lane groups decide: ties across the depths where two lanes'
    vectors meet and far apart, plateaus (whole row, and a run that spans
    lanes), the minimum at index 0 and at d - 1, negative values, +-0."""
    n = n_vec_elems
    base = rng.uniform(10.0, 40.0, d).astype(np.float32)
    rows = []
    ties = [(n - 1, n), (2 * n - 1, 2 * n), (d // 2 - 1, d // 2), (d - 5, 3), (d - 1, 0),
            (d - n - 1, d - n)]
    for at in ties + [(0,), (d - 1,), (1,), (d - 2,)]:
        r = base.copy()
        r[list(at)] = -80.0
        rows.append(r)
    rows.append(np.full(d, 3.0, np.float32))
    r = -base
    r[d // 4: 3 * d // 4] = -90.0
    rows.append(r)
    r = np.zeros(d, np.float32)
    r[[5, d - 3]] = -0.0
    rows.append(r)
    r = np.full(d, -0.0, np.float32)
    r[n] = 0.0
    rows.append(r)
    return np.stack(rows)


def edge_checks(device, rng) -> None:
    """Kernel == twin off the main path's shapes: ragged tiles, odd scan
    lengths, the extreme depth counts, 1 to 4 WTA parts, the warp's bands and
    degenerate rows, the WTA's lane groups on built rows."""
    from cvids_tpu_torch.ops import costvolume, cuda_kernels as ck

    dev = torch.device(device)

    def same(a, b, what):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            check(torch.equal(x, y), f"{what}: kernel != twin "
                  f"(max diff {(x.float() - y.float()).abs().max().item()})")

    # the fused warp: the path's shape with its bands, ragged shapes (W not a
    # multiple of the block's 128 columns, bands larger than the image), H = 1
    n_maps, n_deg = 0, 0
    for h, w, bands in ((H, W, (96, 48)), (37, 53, (8, 4)), (16, 130, (8, 4)),
                        (1, 33, (8, 4)), (9, 7, (96, 48))):
        img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
        for name, m in warp_edge_maps(h, w, *bands).items():
            if "degenerate" in name:
                check(degenerate_rows(m, h) >= 1, f"warp {h}x{w} {name}: no degenerate row")
                n_deg += 1
            m_t = torch.from_numpy(m).to(dev)
            same(ck.projective_warp_banded(img, m_t, *bands),
                 ck.projective_warp_banded_twin(img, m_t, *bands), f"warp {h}x{w} {name}")
            n_maps += 1
        m64 = torch.eye(3, dtype=torch.float64, device=dev)     # cast as the twin casts it
        same(ck.projective_warp_banded(img, m64, *bands),
             ck.projective_warp_banded_twin(img, m64, *bands), f"warp {h}x{w} float64 map")
    # the WTA: every D/32 in both dtypes with 1 to 4 parts, on 77 pixels (no
    # multiple of a block's 8 to 64 pixels), random values of both signs and
    # the built rows
    n_wta = 0
    for d in range(32, 257, 32):
        for dt in (torch.float32, torch.bfloat16):
            vol = rng.uniform(-20, 50, (7, 11, d)).astype(np.float32)
            built = wta_built_rows(d, 8 if dt == torch.bfloat16 else 4, rng)
            vol.reshape(-1, d)[:len(built)] = built
            first = torch.from_numpy(vol).to(dev).to(dt)
            const = [torch.full_like(first, c) for c in (1.5, -0.25, 2.0)]
            noisy = [first.roll(1, 2), first.flip(2).contiguous(), first.roll(3, 2)]
            for n in (1, 2, 3, 4):
                for others in (const, noisy):
                    parts = [first, *others[:n - 1]]
                    same(ck.wta(*parts), ck.wta_twin(*parts), f"wta {n} x 7x11x{d} {dt}")
                    n_wta += 1

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
    # the scan's lane groupings (every D/32 in both dtypes), scan lengths of
    # one, two, odd, below and above the 8-row ring, and line counts
    # that leave a block's last groups spare; sweep tiles (8 x 30 x 64) one
    # over, one under and exactly full, and depth blocks half empty
    for s_len, x, d in ((1, 3, 32), (2, 5, 64), (3, 2, 96), (7, 9, 128), (15, 1, 160),
                        (17, 4, 192), (33, 3, 224), (5, 7, 256), (16, 33, 128)):
        cost = torch.from_numpy(rng.uniform(0, 50, (s_len, x, d)).astype(np.float32)).to(dev)
        p2 = torch.from_numpy(rng.uniform(30, 90, (s_len, x)).astype(np.float32)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            for axis in (0, 1):
                same(ck.sgm_scan_bidir(cost.to(dt), p2.to(dt), 7.0, axis=axis),
                     ck.sgm_scan_bidir_twin(cost.to(dt), p2.to(dt), 7.0, axis=axis),
                     f"sgm {s_len}x{x}x{d} {dt} axis {axis}")
    for h, w, d in ((9, 31, 96), (8, 30, 64), (7, 29, 160), (17, 61, 224), (25, 91, 32)):
        img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
        k = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)
        m = torch.from_numpy(rotation_homography(k, 0.03)).to(dev)
        b = torch.from_numpy(k @ np.array([-0.1, 0.02, 0.01], np.float32)).to(dev)
        inv = (torch.arange(d, dtype=torch.float32, device=dev) + 1.0) * 0.02
        pos = [p.contiguous() for p in costvolume._sweep_positions(m, b, inv, h, w)]
        for dt in (torch.float32, torch.bfloat16):
            same(ck.plane_sweep(img, img.flip(1).contiguous(), *pos, out_dtype=dt),
                 ck.plane_sweep_twin(img, img.flip(1).contiguous(), *pos, out_dtype=dt),
                 f"sweep {h}x{w}x{d} {dt}")
    # the Hamming kernel: N and M off the tile (4 rows, 128 columns), one row,
    # one column
    for n, m in ((1, 1), (37, 129), (160, 1), (33, 4097), (131, 257), (3, 100),
                 (267, 1000), (1057, 130)):
        a, b, av, bv = hamming_inputs(rng, dev, n, m)
        for masks in ((None, None), (av, None), (None, bv), (av, bv)):
            same(ck.hamming_matrix(a, b, *masks), ck.hamming_matrix_twin(a, b, *masks),
                 f"hamming {n}x{m}")
        if n > 1 and m > 1:
            # slices of whole descriptors start at a 32-byte offset
            same(ck.hamming_matrix(a[1:], b[1:], av[1:], bv[1:]),
                 ck.hamming_matrix_twin(a[1:], b[1:], av[1:], bv[1:]), f"hamming {n}x{m} sliced")
    empty = torch.zeros((0, 8), dtype=torch.int32, device=dev)
    check(ck.hamming_matrix(empty, b).shape == (0, b.shape[0]), "hamming with N == 0")
    try:
        ck.hamming_matrix(a.reshape(-1)[1:-7].view(-1, 8), b)
        check(False, "hamming: descriptors off a 16-byte boundary were taken")
    except ValueError:
        pass
    # the filter: pixel counts off the block's 256, one row, one pixel
    for h, w in ((37, 53), (1, 33), (481, 641), (1, 1)):
        st, x, valid = filter_inputs(rng, dev, h, w)
        tau2_map = torch.from_numpy(rng.uniform(1e-3, 0.05, (h, w)).astype(np.float32)).to(dev)
        for tau2 in (0.02, tau2_map):
            filter_agree(ck.depth_filter_update(st, x, tau2, valid),
                         ck.depth_filter_update_twin(st, x, tau2, valid),
                         f"depth_filter {h}x{w} tau2 {'map' if torch.is_tensor(tau2) else 'scalar'}")
    print(f"  fused warp: {n_maps} maps (shifts inside, on and beyond each band, a perspective "
          f"map, {n_deg} with a degenerate row inside the image, a float64 map) at 480x640, "
          f"37x53, 16x130, 1x33 and 9x7; WTA: {n_wta} calls at every D from 32 to 256, fp32 and "
          f"bf16, 1 to 4 parts, 77 pixels with built rows (ties across lanes, plateaus, the "
          f"ends, negative values, +-0): every one equal to its twin")
    print("  edge shapes (37x53x32, 16x128x256, 1x33x64; fp32 and bf16; scans of 1, 2, 3, "
          "7, 15, 17 and 33 rows (the ring holds 8) at every D from 32 to 256; sweeps of 9x31, 8x30, 7x29, "
          "17x61 and 25x91 pixels at D 96, 64, 160, 224 and 32; "
          "1/3/4 WTA parts; Hamming 1x1, 37x129, 160x1, 33x4097, 131x257, 3x100, 267x1000 and "
          "1057x130 with and without masks and as slices; filter 37x53, 1x33, 481x641 and "
          "1x1): every kernel agrees with its twin")


RED_ZONE = 1 << 16     # bytes of 0xFF on each side of a guarded tensor


class GuardedTorch:
    """Stands in for the `torch` module inside `cuda_kernels`: its `empty`
    and `empty_like` return tensors placed between two red zones of 0xFF
    bytes (NaN in every float dtype) in a larger buffer, themselves filled
    with 0xFF, so that a read before a write is NaN and a write past either
    end shows in a red zone. Everything else is torch's."""

    def __init__(self):
        self.buffers = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def guarded(self, shape, dtype, device, fill=None) -> torch.Tensor:
        nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        buf = torch.full((2 * RED_ZONE + nbytes,), 0xFF, dtype=torch.uint8, device=device)
        self.buffers.append(buf)
        t = buf[RED_ZONE:RED_ZONE + nbytes].view(dtype).view(tuple(shape))
        return t if fill is None else t.copy_(fill)

    def empty(self, *size, dtype=None, device=None, **_):
        shape = size[0] if len(size) == 1 and not isinstance(size[0], int) else size
        return self.guarded(shape, dtype or torch.get_default_dtype(), device)

    def empty_like(self, t, **_):
        return self.guarded(t.shape, t.dtype, t.device)

    def red_zones_intact(self) -> bool:
        return all(bool((b[:RED_ZONE] == 0xFF).all()) and bool((b[-RED_ZONE:] == 0xFF).all())
                   for b in self.buffers)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns, so NaNs compare as values."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def memory_checks(device, rng, repeats=3) -> int:
    """An audit of the ten kernels' memory accesses that needs no sanitizer:
    each kernel runs at the path's shapes and at ragged ones with its inputs
    and outputs guarded (`GuardedTorch`), and must give the bits of its
    unguarded run every time, with every red zone intact. An out-of-bounds
    read that reaches a result reads NaN; an out-of-bounds write lands in a
    red zone; a read of unwritten output reads NaN; a race shows as runs
    that differ. Returns the number of guarded launches."""
    from torch.utils import _pytree as pytree

    from cvids_tpu_torch.ops import costvolume, cuda_kernels as ck

    dev = torch.device(device)
    cases = []
    for h, w, d in ((H, W, D), (37, 53, 32), (1, 33, 64), (9, 31, 96), (17, 3, 224)):
        img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
        k = np.array([[FOCAL, 0, w / 2], [0, FOCAL, h / 2], [0, 0, 1]], np.float32)
        m = torch.from_numpy(rotation_homography(k, 0.03)).to(dev)
        bands = (96, 48) if h == H else (8, 4)
        cases.append(("warp_banded", ck.projective_warp_banded, (img, m, *bands)))
        b = torch.from_numpy(k @ np.array([-0.1, 0.02, 0.01], np.float32)).to(dev)
        inv = (torch.arange(d, dtype=torch.float32, device=dev) + 1.0) / (BASELINE * FOCAL)
        pos = [p.contiguous() for p in costvolume._sweep_positions(m, b, inv, h, w)]
        meas = img.flip(1).contiguous()
        cost = torch.from_numpy(rng.uniform(0, 50, (h, w, d)).astype(np.float32)).to(dev)
        p2 = torch.from_numpy(rng.uniform(30, 90, (h, w)).astype(np.float32)).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            cases.append(("plane_sweep", lambda *a, dt=dt: ck.plane_sweep(*a, out_dtype=dt),
                          (img, meas, *pos)))
            c, p = cost.to(dt), p2.to(dt)
            for axis in (0, 1):
                cases.append(("sgm_scan", lambda *a, axis=axis: ck.sgm_scan_bidir(*a, axis=axis),
                              (c, p, 7.0)))
            cases.append(("wta", ck.wta, (c, c.flip(2).contiguous())))
            cases.append(("wta", ck.wta, (c, c.roll(1, 2), c.roll(3, 2), c.flip(2).contiguous())))
        st, x, valid = filter_inputs(rng, dev, h, w)
        tau2 = torch.from_numpy(rng.uniform(1e-3, 0.05, (h, w)).astype(np.float32)).to(dev)
        cases.append(("depth_filter_update", ck.depth_filter_update, (st, x, 0.013, valid)))
        cases.append(("depth_filter_update", ck.depth_filter_update, (st, x, tau2, valid)))
    for n, m_ in ((160, 512), (37, 129), (1, 4097), (131, 257), (267, 1000), (1057, 130)):
        a, b, av, bv = hamming_inputs(rng, dev, n, m_)
        cases.append(("hamming_matrix", ck.hamming_matrix, (a, b, av, bv)))
        cases.append(("hamming_matrix", ck.hamming_matrix, (a, b)))
    for b, n in ((128, 9), (128, 3), (5, 12), (3, 1)):
        x = torch.from_numpy(rng.normal(size=(b, n, n))).to(dev)
        for dtype in (torch.float32, torch.float64):
            cases.append(("small_eig", ck.small_eigh,
                          ((x @ x.transpose(-1, -2)).to(dtype).contiguous(),)))
    for args, kw in ((klt_inputs(rng, dev), KLT_ARGS),
                     (klt_inputs(rng, dev, 97, 131, 33, 3, 6.0),
                      dict(radius=3, iters=8, max_residual=40.0, min_eig=1e-3, fb_thresh=1.0))):
        cases.append(("klt_track", lambda *a, kw=kw: ck.klt_track(*a, **kw), args))
    # the TSDF kernel writes the pool in place: the case returns the pool;
    # the grey image is expanded to three channels inside, as the server's is
    for inp in (tsdf_inputs(rng, dev, m=400),
                tsdf_inputs(rng, dev, 37, 53, 30.0, cfg_kw=dict(chunk_size=7), m=9,
                            capacity=64)):
        cfg, pool, slots, coords, depth, color, *geom = inp

        def integrated(pool, slots, coords, depth, gray, *geom, cfg=cfg):
            ck.tsdf_integrate(cfg, pool, slots, coords, depth, gray[..., None].expand(-1, -1, 3),
                              *geom)
            return tuple(pool)
        cases.append(("tsdf_integrate", integrated,
                      (pool, slots, coords, depth, color[..., 0].contiguous(), *geom)))
    # the window solve: its outputs and scratch guarded, the path's window
    # and the edges of its tiles and threads
    for (wst, wm), iters in ((window_lm_inputs(dev), 2),
                             (window_lm_inputs(dev, k=12, n_lm=1100, seed=6), 1),
                             (window_lm_inputs(dev, k=21, n_lm=1100, seed=10), 1),
                             (window_lm_inputs(dev, k=2, n_lm=37, seed=7, prior=False), 3)):
        cases.append(("window_lm", lambda st, m, iters=iters: ck.window_lm(st, m, iters),
                      (wst, wm)))

    def flat(out):
        return [t for o in (out if isinstance(out, tuple) else (out,))
                for t in (o if isinstance(o, tuple) else (o,))]

    n_launches = 0
    for name, fn, args in cases:
        ref = flat(fn(*_clone_state(args)))     # a copy: the TSDF kernel writes its pool
        for _ in range(repeats):
            g = GuardedTorch()

            def guard(a, g=g):
                # FilterState, ChunkPool, a window's state and measurements
                if isinstance(a, tuple) and hasattr(a, "_fields"):
                    return type(a)(*(guard(t) for t in a))
                if isinstance(a, list):             # the tracker's pyramids
                    return [guard(t) for t in a]
                if isinstance(a, torch.Tensor):
                    return g.guarded(a.shape, a.dtype, a.device, fill=a)
                return a

            with mock.patch.object(ck, "torch", g):
                out = flat(fn(*(guard(a) for a in args)))
            torch.cuda.synchronize()
            n_launches += 1
            shape = next(tuple(a.shape) for a in pytree.tree_leaves(args) if torch.is_tensor(a))
            check(all(torch.equal(_bits(o), _bits(r)) for o, r in zip(out, ref)),
                  f"{name} {shape}: a guarded run differs from the unguarded one")
            check(g.red_zones_intact(), f"{name} {shape}: a red zone was written")
    print(f"  memory audit: {n_launches} guarded launches of the ten kernels (path and ragged "
          f"shapes, {RED_ZONE} B red zones, {repeats} runs each): every run bit-identical "
          f"to the unguarded one, every red zone intact")
    return n_launches


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------


def _dense_api():
    """(estimator, DenseStep or None, disable_graphs or None): a package of
    a revision before the graphed frame (`--package`) has neither."""
    from cvids_tpu_torch.dense import estimator
    try:
        from cvids_tpu_torch.utils.cuda_graph import disable_graphs
    except ImportError:
        disable_graphs = None
    return estimator, getattr(estimator, "DenseStep", None), disable_graphs


class _Chain:
    """One dense state driven as the server drives it: a `DenseStep`, its
    frames replayed as CUDA graphs or, with `graphed=False`, run eagerly
    (inside `disable_graphs()`); `fuse_measurement` itself where the
    package has no `DenseStep`."""

    def __init__(self, cfg, ref_t, graphed=True):
        estimator, step_cls, self._disable = _dense_api()
        self.graphed = graphed and step_cls is not None
        self.cfg, self._est = cfg, estimator
        self.step = step_cls(cfg) if step_cls is not None else None
        if self.step is not None:
            self.step.init_reference(ref_t)
        else:
            self._state = estimator.init_reference(cfg, ref_t)

    @property
    def state(self):
        return self.step.state if self.step is not None else self._state

    def _mode(self):
        return (contextlib.nullcontext() if self.graphed or self._disable is None
                else self._disable())

    def fuse(self, meas_t, a_t, b_t, banded):
        with self._mode():
            if self.step is None:
                self._state = self._est.fuse_measurement(self.cfg, self._state, meas_t, a_t,
                                                         b_t, banded_warp=banded)
            else:
                self.step.fuse(meas_t, a_t, b_t, banded)

    def roll(self, ref_t, k_t, bias):
        dev = ref_t.device
        with self._mode():
            self.step.propagate_reference(ref_t, torch.eye(3, device=dev),
                                          torch.zeros(3, device=dev), k_t, sparse_bias=bias)


def dense_chain(device, rng_seed, h=H, w=W, d=D, n_frames=N_FRAMES, graphed=True):
    """init_reference, n_frames with the host's banded gate, finalize, then
    one frame whose rotation fails the gate, all through a `DenseStep` as
    the server runs it (replayed CUDA graphs; eagerly with `graphed=False`).
    Returns (median depth, converged share, final filt.mu, per-frame ms,
    gates)."""
    dev = torch.device(device)
    rng = np.random.default_rng(rng_seed)
    estimator = _dense_api()[0]
    cfg = estimator.DenseConfig(height=h, width=w, num_depths=d,
                                dep_sample=1.0 / (BASELINE * FOCAL))
    ref, meas, a_mat, b_vec, k = textured_plane(rng, h, w)
    meas_t = torch.from_numpy(meas).to(dev)
    a_t = torch.from_numpy(a_mat).to(dev)
    b_t = torch.from_numpy(b_vec).to(dev)
    gate = banded_gate(a_mat, h, w)
    chain = _Chain(cfg, torch.from_numpy(ref).to(dev), graphed)
    frame_ms = []
    for _ in range(n_frames):
        _sync(dev)
        t0 = time.perf_counter()
        chain.fuse(meas_t, a_t, b_t, gate)
        _sync(dev)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    inv_d, ok = estimator.finalize(cfg, chain.state)
    crop = (slice(40, -40), slice(40, -40))
    okc = ok[crop]
    med = float(torch.median(1.0 / inv_d[crop][okc].clamp(min=1e-6)).item()) \
        if bool(okc.any()) else float("nan")
    share = float(okc.float().mean().item())
    # one frame that fails the gate: the exact warp runs
    a_rot = rotation_homography(k, 0.25)
    gate_rot = banded_gate(a_rot, h, w)
    chain.fuse(meas_t, torch.from_numpy(a_rot).to(dev), b_t, gate_rot)
    _sync(dev)
    return med, share, chain.state.filt.mu.clone(), frame_ms, (gate, gate_rot)


GRAPH_FRAMES = 40           # graphed against eager frames, bit for bit
TIMED_FRAMES = (5, 35)      # warm-up, then timed frames per mode


def _stats(ms) -> dict:
    return {"median": statistics.median(ms), "p90": sorted(ms)[int(0.9 * len(ms))],
            "min": min(ms)}


def frame_times(device, pair=None) -> dict:
    """The dense frame at 640x480x128, eager against graphed: wall ms per
    frame (median, p90, min) over TIMED_FRAMES[1] frames after
    TIMED_FRAMES[0] of warm-up, each mode in turn, the device synced
    around each frame; then one profiled frame of each: device busy ms,
    device activities, wall ms with the profiler on, and the host's launch
    calls (HOST_LAUNCH_CALLS). `pair` continues two chains (eager, graph);
    a package without graphs gives the eager figures only."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    estimator = _dense_api()[0]
    cfg = estimator.DenseConfig(dep_sample=1.0 / (BASELINE * FOCAL))
    ref, meas, a_mat, b_vec, _ = textured_plane(rng)
    args = (torch.from_numpy(meas).to(dev), torch.from_numpy(a_mat).to(dev),
            torch.from_numpy(b_vec).to(dev), banded_gate(a_mat, H, W))
    if pair is None:
        ref_t = torch.from_numpy(ref).to(dev)
        pair = (_Chain(cfg, ref_t, graphed=False), _Chain(cfg, ref_t, graphed=True))
    chains = {"eager": pair[0]}
    if pair[1].graphed:
        chains["graph"] = pair[1]
    from cvids_tpu_torch.ops import cuda_kernels as ck
    ms = {m: [] for m in chains}
    launched = {m: dict.fromkeys(ck.launches, 0) for m in chains}
    for i in range(sum(TIMED_FRAMES)):
        for m, ch in chains.items():
            before = dict(ck.launches)
            _sync(dev)
            t0 = time.perf_counter()
            ch.fuse(*args)
            _sync(dev)
            if i >= TIMED_FRAMES[0]:
                ms[m].append((time.perf_counter() - t0) * 1e3)
                for n in launched[m]:
                    launched[m][n] += ck.launches[n] - before[n]
    out = {}
    for m, ch in chains.items():
        wall, rows, host = profile_frame(lambda: ch.fuse(*args), host_launches=True)
        out[m] = {"wall_ms": _stats(ms[m]), "device_busy_ms": sum(r[1] for r in rows),
                  "kernel_launches": {n: v / TIMED_FRAMES[1] for n, v in launched[m].items()
                                      if v},
                  "device_activities": sum(r[2] for r in rows), "profiled_wall_ms": wall,
                  "host_launches": host,
                  "kernels_ms": {name: round(t, 4) for name, t, _ in rows
                                 if any(k in name for k in KERNEL_ENTRIES)}}
    for m, v in out.items():
        print(f"  dense frame {m:5s}: wall ms median {v['wall_ms']['median']:.3f} p90 "
              f"{v['wall_ms']['p90']:.3f} min {v['wall_ms']['min']:.3f} over "
              f"{TIMED_FRAMES[1]} frames; profiled: device busy {v['device_busy_ms']:.3f} ms, "
              f"{v['device_activities']} device activities, {v['host_launches']} host launch "
              f"calls, wall {v['profiled_wall_ms']:.3f} ms (profiler on)")
    return out


def graph_frame_checks(device, n_frames=GRAPH_FRAMES) -> dict:
    """The graphed dense frame against the eager one at 640x480x128, bit
    for bit (the two volumes, the four filter fields, the frame count)
    after each of `n_frames` frames: banded and exact warps, and reference
    rolls with and without a sparse bias between, so every graph variant
    runs and the graphs outlive the rolls. Then `frame_times` on the same
    two chains. Returns the frame figures."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    estimator = _dense_api()[0]
    cfg = estimator.DenseConfig(dep_sample=1.0 / (BASELINE * FOCAL))
    ref, meas, a_mat, b_vec, k = textured_plane(rng)
    ref_t, meas_t = torch.from_numpy(ref).to(dev), torch.from_numpy(meas).to(dev)
    a_t, b_t, k_t = (torch.from_numpy(x).to(dev) for x in (a_mat, b_vec, k))
    a_rot = rotation_homography(k, 0.25)
    a_rot_t = torch.from_numpy(a_rot).to(dev)
    gates = (banded_gate(a_mat, H, W), banded_gate(a_rot, H, W))
    uv = np.stack(np.meshgrid(np.arange(20, W - 20, 24), np.arange(20, H - 20, 24)),
                  -1).reshape(-1, 2).astype(np.float32)
    bias = estimator.splat_sparse(cfg, torch.from_numpy(uv).to(dev),
                                  torch.full((len(uv),), 1.0 / DEPTH, device=dev),
                                  torch.ones(len(uv), dtype=torch.bool, device=dev))
    pair = (_Chain(cfg, ref_t, graphed=False), _Chain(cfg, ref_t, graphed=True))
    rolls = {n_frames // 2: bias, 3 * n_frames // 4: None}
    exact = {n_frames // 4, n_frames // 2 + 3, 3 * n_frames // 4 + 2}
    equal = 0
    for i in range(n_frames):
        if i in rolls:
            for ch in pair:
                ch.roll(ref_t, k_t, rolls[i])
        a, g = (a_rot_t, gates[1]) if i in exact else (a_t, gates[0])
        for ch in pair:
            ch.fuse(meas_t, a, b_t, g)
        check(_dense_bits_equal(pair[0].state, pair[1].state),
              f"graphed dense frame {i} differs from the eager frame")
        equal += 1
    graphs = pair[1].step.graphs
    check(len(graphs.graphs) == 4, f"{len(graphs.graphs)} dense graphs captured, not 4")
    print(f"  graphed dense frames: {equal} of {n_frames} equal to the eager frames bit for "
          f"bit (mean_cost, count, mu, sigma2, a, b, num_frames): gates {gates}, exact-warp "
          f"frames {sorted(exact)}, reference rolls at {sorted(rolls)} (the first with a sparse "
          f"bias); {len(graphs.graphs)} graphs captured (warp x bias), {graphs.replays} replays")
    return frame_times(dev, pair)


def solve_checks(device) -> dict:
    """The dry run's 1024-keyframe / 6400-edge problem (`entry.
    dryrun_problems`), 12 LM x 60 CG, on one card: the eager solve against
    the graphed one (an LM iteration's graph replayed 12 times), seconds
    and bit equality. The first graphed call captures (after one eager
    warm-up iteration), the second only replays."""
    from cvids_tpu_torch.entry import dryrun_problems
    from cvids_tpu_torch.server import optimizer as opt

    dev = torch.device(device)
    nodes, edges = dryrun_problems(1, dev, production=True)["graph"]
    times, outs = {}, {}
    for name, fn in (("eager", opt.optimize_pose_graph),
                     ("graph_capture", opt.optimize_pose_graph_graphed),
                     ("graph", opt.optimize_pose_graph_graphed)):
        _sync(dev)
        t0 = time.perf_counter()
        outs[name] = fn(nodes, edges, 12, 60)
        _sync(dev)
        times[name] = time.perf_counter() - t0
    same = all(_same_bits(x, y) for m in ("graph_capture", "graph")
               for x, y in zip(outs[m], outs["eager"]))
    _, rows = profile_frame(lambda: opt.optimize_pose_graph_graphed(nodes, edges, 12, 60))
    busy = sum(r[1] for r in rows)
    print(f"  4-DoF solve {len(nodes.yaw)} KF / {len(edges.i)} edges, 12 LM x 60 CG: eager "
          f"{times['eager']:.4f} s, graphed {times['graph']:.4f} s (the capturing call "
          f"{times['graph_capture']:.4f} s); graphed equal to eager bit for bit: {same}; "
          f"a replay's device busy {busy / 1e3:.4f} s over {sum(r[2] for r in rows)} device "
          f"activities")
    check(same, "the graphed 4-DoF solve differs from the eager solve")
    return {"nodes": len(nodes.yaw), "edges": len(edges.i), "eager_s": times["eager"],
            "graph_s": times["graph"], "capture_s": times["graph_capture"],
            "device_busy_s": busy / 1e3, "bit_equal": same}


def pose_graph(device, n=N_NODES):
    """The 256-keyframe 4-DoF solve of __graft_entry__.entry() (2 LM
    iterations of 10 CG steps), graphed as `entry()` runs it. Returns
    (residual norm before, after, ms of the capturing call and a replay)."""
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
        out = opt.optimize_pose_graph_graphed(nodes, edges, lm_iters=2, cg_iters=10)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    check(all(bool(torch.isfinite(x.float()).all()) for x in out), "pose graph: non-finite output")
    after = float(torch.linalg.vector_norm(opt.edge_residuals(out, edges)).item())
    return before, after, ms


def profile_slice(device):
    """Profile one steady-state graphed dense frame (the third of a fresh
    chain); prints the device time by activity and the device-busy share."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    estimator = _dense_api()[0]
    cfg = estimator.DenseConfig(dep_sample=1.0 / (BASELINE * FOCAL))
    ref, meas, a_mat, b_vec, _ = textured_plane(rng)
    args = (torch.from_numpy(meas).to(dev), torch.from_numpy(a_mat).to(dev),
            torch.from_numpy(b_vec).to(dev), banded_gate(a_mat, H, W))
    chain = _Chain(cfg, torch.from_numpy(ref).to(dev))
    for _ in range(2):
        chain.fuse(*args)
    wall, rows = profile_frame(lambda: chain.fuse(*args))
    total = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if any(k in r[0] for k in KERNEL_ENTRIES))
    print(f"  profiled {'graphed' if chain.graphed else 'eager'} frame: wall {wall:.3f} ms "
          f"(profiler on), device busy {total:.3f} ms ({total / wall:.1%} of wall), the five "
          f"kernels {ours:.3f} ms, {sum(r[2] for r in rows)} device activities "
          f"({len(rows)} distinct)")
    # the 14 largest, and the port's own kernels wherever they rank
    for k, (name, ms, calls) in enumerate(rows):
        if k < 14 or any(entry in name for entry in KERNEL_ENTRIES):
            print(f"    {ms:8.4f} ms  x{calls:<3d} {name[:110]}")


def dense_probe(device) -> None:
    """The dense frame's times: eager against graphed (`frame_times`; the
    eager frame only for a package without graphs), then three profiled
    graphed frames with each kernel's device time."""
    import cvids_tpu_torch
    print(f"dense probe of {cvids_tpu_torch.__path__[0]}")
    print(json.dumps({"dense_frame": frame_times(device)}))
    for _ in range(3):
        profile_slice(device)


def server_probe(device) -> None:
    """The ingest's and the whole server's host times, for the package on
    sys.path (`--package`): phase 5's stream with background solves (host
    ms a keyframe, host syncs a keyframe), its 100-keyframe stream with
    inline solves (host ms, and keyframes 40-69 under the profiler one by
    one: host launch calls and device activities a keyframe), then phase
    6's whole server on its 4 x 36 rendered keyframes (`whole_server_probe`:
    host ms a keyframe and its published maps); keyframes a second of each
    stream, its final solve or sync included. Uses only what the parent's
    package also has."""
    import cvids_tpu_torch
    from cvids_tpu_torch.server import vocab

    dev = torch.device(device)
    print(f"server probe of {cvids_tpu_torch.__path__[0]}")
    tree = vocab.synthesize_tree_vocabulary(*SERVER_TREE, seed=0)
    packets, _ = server_stream(SERVER_AGENTS, SERVER_DURATION)
    server, stats = server_run(dev, packets, tree)
    ingest = np.asarray(stats["ingest_ms"])
    cmp_packets, _ = server_stream(COMPARE_AGENTS, COMPARE_DURATION)
    edges, inline_ms, prof = server_edges(dev, cmp_packets, tree, profile=(40, 70))
    out = {"package": cvids_tpu_torch.__path__[0],
           "ingest_ms": {"median": float(np.median(ingest)),
                         "p90": float(np.percentile(ingest, 90)), "keyframes": len(ingest)},
           "ingest_kf_per_s": len(ingest) / stats["stream_s"],
           "loops": int(server.loop_count), "syncs_per_kf": stats["syncs_per_kf"],
           "inline_ms": {"median": float(np.median(inline_ms)),
                         "p90": float(np.percentile(inline_ms, 90))},
           "inline_loops": len(edges),
           "launch_calls_per_kf": float(np.median(prof["launch_calls"])),
           "activities_per_kf": float(np.median(prof["activities"])),
           "profiled_kf": len(prof["launch_calls"]), **whole_server_probe(dev, tree)}
    print(json.dumps({"server_probe": out}))


def whole_server_probe(dev, tree, mesh_runs: int = 10) -> dict:
    """Phase 6's whole server on its 4 x 36 rendered keyframes: host ms a
    keyframe (median, p90) and keyframes a second over the stream; its
    published maps: the `fuse` and `mesh` spans' host ms, each map's chunk
    walk, `_alloc` and device integrate ms (`IntegrateTimer`; median,
    p90), chunks a map; then `extract_mesh` of the final map, `mesh_runs`
    times graphed and eager (`disable_graphs()`) in turns after one of
    each (host ms, median and spread), with the device memory that its
    first graphed call leaves reserved (the mesh graphs' pool; the
    allocator's free cache emptied before and after); then one profiled
    graphed `extract_mesh` and one profiled `integrate` of the last
    published map again (wall ms with the profiler on, device busy ms,
    device activities, host launch calls, the four largest activities).
    Uses only what the parent's package also has."""
    from cvids_tpu_torch.dense.estimator import DenseConfig
    from cvids_tpu_torch.mapping.mesh import extract_mesh
    from cvids_tpu_torch.mapping.tsdf import TsdfConfig
    from cvids_tpu_torch.server.pipeline import PipelineConfig
    from cvids_tpu_torch.server.posegraph import ServerConfig
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs

    scene, _, k = scene_stream(PIPE_AGENTS, PIPE_KF)
    cfg = PipelineConfig(server=ServerConfig(), dense=DenseConfig(), tsdf=TsdfConfig())
    t0 = time.perf_counter()
    server, kf_ms, timer = pipeline_run(dev, scene, tree, k, cfg)
    stream_s = time.perf_counter() - t0
    vol = server.volume

    def stats(v):
        return {"median": float(np.median(v)), "p90": float(np.percentile(v, 90))}

    def timed_mesh():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        extract_mesh(vol)
        return (time.perf_counter() - t1) * 1e3

    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    timed_mesh()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev) - reserved
    with disable_graphs():
        timed_mesh()
    graphed, eager = [], []
    for _ in range(mesh_runs):
        graphed.append(timed_mesh())
        with disable_graphs():
            eager.append(timed_mesh())
    rec = server.depth_records[-1]
    depth = torch.from_numpy(rec["depth"]).to(dev)
    color = (depth * 40.0)[..., None].expand(-1, -1, 3)
    profiles = {}
    for name, fn in (("extract_mesh", lambda: extract_mesh(vol)),
                     ("integrate", lambda: vol.integrate(depth, color, rec["k"], rec["r_wc"],
                                                         rec["t_wc"]))):
        fn()
        wall, rows, calls = profile_frame(fn, host_launches=True)
        profiles[name] = {"wall_ms": wall, "device_busy_ms": sum(r[1] for r in rows),
                          "activities": sum(r[2] for r in rows), "host_launch_calls": calls,
                          "largest": [(n[:60], round(ms, 4), c) for n, ms, c in rows[:4]]}
    spans = {n: np.asarray(v) * 1e3 for n, v in server.tracer.samples.items()}
    return {"whole_server_ms": {**stats(kf_ms), "keyframes": len(kf_ms)},
            "whole_server_kf_per_s": len(kf_ms) / stream_s,
            "spans_ms": {n: stats(spans[n]) for n in ("fuse", "mesh") if n in spans},
            "walk_ms": stats(timer.walk_ms), "alloc_ms": stats(timer.alloc_ms),
            "integrate_ms": stats(timer.device_ms()), "maps": timer.maps(),
            "chunks_per_map": stats(timer.chunks), "chunks": len(vol.slot_of),
            "extract_mesh_ms": {"graphed": [float(np.median(graphed)), min(graphed),
                                            max(graphed)],
                                "eager": [float(np.median(eager)), min(eager), max(eager)],
                                "runs": mesh_runs},
            "mesh_graph_reserved_mib": reserved / 2 ** 20, "profiles": profiles}


def kernels_probe(device, runs: int = 50) -> None:
    """The port's own hand kernels timed at phase 3's inputs, for the package
    on sys.path (`--package`); uses only what the parent's package also
    has."""
    import cvids_tpu_torch
    from cvids_tpu_torch.ops import cuda_kernels as ck

    from cvids_tpu_torch.utils.cuda_graph import GraphedCall
    from cvids_tpu_torch.vio import frontend

    dev = torch.device(device)
    rng = np.random.default_rng(1)
    ata, ftf, _ = eight_point_systems(rng, dev)
    klt_in = klt_inputs(rng, dev)
    dlt_ata, dlt_mtm, _ = dlt_systems(rng, dev)
    wst, wm = window_lm_inputs(dev)
    solve = GraphedCall(frontend._solve_window_fast)
    calls = {"f_pair": lambda: (ck.small_eigh(ata), ck.small_eigh(ftf)),
             "dlt_pair": lambda: (ck.small_eigh(dlt_ata), ck.small_eigh(dlt_mtm)),
             "eig_9x9": lambda: ck.small_eigh(ata),
             "eig_12x12": lambda: ck.small_eigh(dlt_ata),
             "eig_3x3": lambda: ck.small_eigh(ftf),
             "klt_track": lambda: ck.klt_track(*klt_in, **KLT_ARGS),
             "solve_graph": lambda: solve(wst, wm, WLM_ITERS)}
    singles = {"eig_9x9": "small_eig_kernel", "eig_12x12": "small_eig_kernel",
               "eig_3x3": "small_eig_kernel", "klt_track": "klt_track_kernel"}
    has_wlm = hasattr(ck, "window_lm")
    if has_wlm:
        calls["window_lm"] = lambda: ck.window_lm(wst, wm, WLM_ITERS)
        singles["window_lm"] = "window_lm_kernel"
    if getattr(ck, "WINDOW_LM_MAX_K", 0) >= 21:
        # bench.py's and phase 11's window: K = 21, 600 slots, a 315-row prior
        w21 = window_lm_inputs(dev, k=21)
        calls["window_lm_k21"] = lambda: ck.window_lm(*w21, WLM_ITERS)
    profiled = {k: profiled_kernel_ms(calls[k], e) for k, e in singles.items()}
    same = {"small_eig": all(_same_bits(x, y) for a in (ata, ftf, dlt_ata, dlt_mtm)
                             for x, y in zip(ck.small_eigh(a), ck.small_eigh_twin(a))),
            "klt_track": all(_same_bits(x, y) for x, y in
                             zip(ck.klt_track(*klt_in, **KLT_ARGS),
                                 ck.klt_track_twin(*klt_in, **KLT_ARGS)))}
    if has_wlm:
        got, ref = ck.window_lm(wst, wm, WLM_ITERS), ck.window_lm_twin(wst, wm, WLM_ITERS)
        same["window_lm"] = all(_same_bits(x, y) for x, y in zip(tuple(got[0]) + (got[1],),
                                                                  tuple(ref[0]) + (ref[1],)))
    check(all(same.values()), f"kernels probe: a kernel differs from its twin: {same}")
    print(json.dumps({"kernels_probe": {
        "package": cvids_tpu_torch.__path__[0], "runs": runs,
        "ms": {k: time_ms(fn, runs) for k, fn in calls.items()},
        "profiler_ms": profiled, "floor_ms": time_ms(lambda: ck.empty_launch(dev), runs),
        "equal_to_twin": same,
        "window_lm_attrs": ck.window_lm_attrs() if hasattr(ck, "window_lm_attrs") else None,
        "library_eigh_ms": {
            "f_pair": time_ms(lambda: (torch.linalg.eigh(ata), torch.linalg.eigh(ftf)), runs),
            "dlt_pair": time_ms(lambda: (torch.linalg.eigh(dlt_ata),
                                         torch.linalg.eigh(dlt_mtm)), runs)}}}))


def twin_patches():
    """Context that routes the slice's kernel calls to the twins (used only
    for the comparison chain)."""
    from cvids_tpu_torch.ops import cuda_kernels as ck
    return [mock.patch.object(ck, fn, getattr(ck, fn + "_twin")) for fn in WRAPPERS.values()]


def _same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN equal to NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() else a == b).all())


class KernelRecorder:
    """Keeps the inputs and outputs of the calls numbered `calls` (None:
    every call) of the wrappers of kernels `names` during a run (device
    clones), then holds each kept output against the twin on the same
    inputs: the run's own data at the run's shapes. The recording launches
    none of the kernels; the comparison runs only the twins. A CUDA-graph
    replay calls no wrapper, and a capture's calls are not kept (they run
    nothing): a graphed dense frame is held to the twins by `FrameRecorder`.
    A context manager around the run."""

    CALLS = (0, 1, 30, 31)   # for the SGM (two calls a frame): frames 1 and 16

    def __init__(self, names=tuple(WRAPPERS), calls=CALLS):
        from cvids_tpu_torch.ops import cuda_kernels as ck

        self.calls = {name: 0 for name in names}
        self.keep = calls
        self.kept = []
        self._patches = [mock.patch.object(ck, WRAPPERS[name],
                                           self._recording(name, getattr(ck, WRAPPERS[name])))
                         for name in names]

    def _recording(self, name, fn):
        from torch.utils import _pytree as pytree

        def clone(tree):
            return pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, tree)

        def call(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():   # a capture runs nothing
                return fn(*args, **kwargs)
            i = self.calls[name]
            self.calls[name] += 1
            keep = self.keep is None or i in self.keep
            inputs = clone((args, kwargs)) if keep else None
            out = fn(*args, **kwargs)
            if keep:
                self.kept.append((name, i, inputs, clone(out)))
            return out
        return call

    def __enter__(self):
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()

    def compare(self) -> dict:
        """Each kept call against the twin: exact (NaN equal to NaN), the
        filter within FILTER_MAX_ULP per field. Returns the number of calls
        compared per kernel."""
        from torch.utils import _pytree as pytree

        from cvids_tpu_torch.ops import cuda_kernels as ck

        seen = {}
        for name, i, (args, kwargs), out in self.kept:
            ref = getattr(ck, WRAPPERS[name] + "_twin")(*args, **kwargs)
            shape = tuple(args[0].shape) if torch.is_tensor(args[0]) else tuple(args[0][0].shape)
            what = f"{name} call {i} at {shape}"
            if name == "depth_filter_update":
                filter_agree(out, ref, what)
            else:
                outs, refs = pytree.tree_leaves(out), pytree.tree_leaves(ref)
                check(len(outs) == len(refs) and all(_same_values(o, r) for o, r in zip(outs, refs)),
                      f"{what}: the kernel's output differs from the twin's")
            seen.setdefault(name, []).append(f"#{i} {shape}")
        print("  the run's own kernel calls against the twins on the same inputs (tolerance: "
              f"exact, the filter {FILTER_MAX_ULP} ulp): "
              + "; ".join(f"{n} {', '.join(v)}" for n, v in seen.items()))
        return {n: len(v) for n, v in seen.items()}


class CascadeRecorder:
    """Keeps the pose graphs' loop-verification calls numbered `calls`
    during a run (their arguments and the graph's outputs, no copy), then
    reruns each eagerly under `disable_graphs()` through the kernels (equal
    to the graph's outputs bit for bit) with every kernel call of the rerun
    held against its twin (`KernelRecorder`): a replay calls no wrapper, so
    the kept cascades stand in for the run's Hamming and small_eig calls. A
    context manager around the run (it patches
    `CollaborativePoseGraph._dispatch_verify`, so every server of the run is
    seen)."""

    def __init__(self, calls=KernelRecorder.CALLS):
        from cvids_tpu_torch.server import posegraph

        self.n, self.keep, self.kept = 0, calls, []
        real, rec = posegraph.CollaborativePoseGraph._dispatch_verify, self

        def dispatch(server, j, cands):
            program = server._verify

            def verify(*args):
                out = program(*args)
                if rec.n in rec.keep:
                    rec.kept.append((args, out))
                rec.n += 1
                return out

            server._verify = verify
            try:
                return real(server, j, cands)
            finally:
                server._verify = program

        self._patch = mock.patch.object(posegraph.CollaborativePoseGraph, "_dispatch_verify",
                                        dispatch)

    def __enter__(self):
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()

    def compare(self) -> dict:
        from cvids_tpu_torch.server.posegraph import _match_and_pnp
        from cvids_tpu_torch.utils.cuda_graph import disable_graphs

        leaves = torch.utils._pytree.tree_leaves
        with disable_graphs(), KernelRecorder(SERVER_KERNELS + RANSAC_KERNELS,
                                              calls=None) as kernels:
            for i, (args, out) in enumerate(self.kept):
                want = _match_and_pnp(*args)
                check(all(_same_bits(x, y) for x, y in zip(leaves(out), leaves(want))),
                      f"cascade call {self.keep[i]}: the graph's outputs differ from the eager "
                      f"call's")
        print(f"  {len(self.kept)} of {self.n} loop-verification cascades rerun eagerly with the "
              f"kernels: equal to the graph's bit for bit")
        return kernels.compare()


def _clone_state(st):
    """A DenseState with every tensor cloned (a bias of None stays None)."""
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, st)


def _same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    return (x.dtype == y.dtype and x.shape == y.shape
            and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)))


def _dense_bits_equal(a, b) -> bool:
    """The two volumes, the four filter fields and the frame count, bit for bit."""
    return all(_same_bits(x, y) for x, y in zip(
        (a.mean_cost, a.count, *a.filt, a.num_frames), (b.mean_cost, b.count, *b.filt,
                                                        b.num_frames)))


class FrameRecorder:
    """Keeps the graphed dense frames numbered FRAMES of a run (calls of
    `DenseStep.fuse`, all clients counted together): the state before the
    frame, its measurement, `a_mat`, `b_vec` and warp choice, and the state
    after it (device clones). `compare` reruns each kept frame on a copy of
    the state before, twice and eagerly: with the kernels, each kernel call
    held against its twin on its own inputs (`KernelRecorder`, every call),
    and with the twins. The kernel frame must equal the graph's frame bit
    for bit; the twin frame must equal it exactly in the volumes and within
    FILTER_MAX_ULP in the filter. A context manager around the run."""

    FRAMES = (1, 16)

    def __init__(self):
        from cvids_tpu_torch.dense import estimator

        self.n = 0
        self.kept = []
        real = estimator.DenseStep.fuse

        def fuse(step, meas_img, a_mat, b_vec, banded_warp=None):
            i = self.n
            self.n += 1
            if i not in self.FRAMES:
                return real(step, meas_img, a_mat, b_vec, banded_warp)
            before = _clone_state(step.state)
            inputs = (meas_img.to(torch.float32).clone(), a_mat.clone(), b_vec.clone(),
                      banded_warp)
            out = real(step, meas_img, a_mat, b_vec, banded_warp)
            self.kept.append((i, step.cfg, before, inputs, _clone_state(out)))
            return out

        self._patch = mock.patch.object(estimator.DenseStep, "fuse", fuse)

    def __enter__(self):
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()

    def compare(self) -> dict:
        """Returns the number of kernel calls held against the twins per
        kernel."""
        from cvids_tpu_torch.dense import estimator
        from cvids_tpu_torch.utils.cuda_graph import disable_graphs

        counts = {}
        for i, cfg, before, (meas, a, b, banded), graphed in self.kept:
            what = f"graphed dense frame {i} ({'banded' if banded else 'exact'} warp, " \
                   f"{'a' if before.sparse_bias is not None else 'no'} sparse bias) at " \
                   f"{tuple(before.mean_cost.shape)}"
            rec = KernelRecorder(names=DENSE_KERNELS, calls=None)
            st_k, st_t = _clone_state(before), _clone_state(before)
            with disable_graphs():
                with rec:
                    estimator._fuse_into(cfg, st_k, meas, a, b, banded)
                with contextlib.ExitStack() as stack:
                    for p in twin_patches():
                        stack.enter_context(p)
                    estimator._fuse_into(cfg, st_t, meas, a, b, banded)
            check(_dense_bits_equal(st_k, graphed),
                  f"{what}: the eager frame differs from the graph's")
            check(all(_same_values(x, y) for x, y in zip(
                (st_t.mean_cost, st_t.count, st_t.num_frames),
                (graphed.mean_cost, graphed.count, graphed.num_frames))),
                f"{what}: the twins' volumes differ from the graph's")
            filter_agree(graphed.filt, st_t.filt, f"{what}, the twins' filter")
            for n, c in rec.compare().items():
                counts[n] = counts.get(n, 0) + c
        print(f"  {len(self.kept)} graphed dense frames rerun eagerly with the kernels (equal bit "
              f"for bit) and with the twins (volumes exact, filter {FILTER_MAX_ULP} ulp): kernel "
              f"calls held against the twins {counts}")
        return counts


def cascade_checks(recorder: CascadeRecorder, counts: dict) -> None:
    """The kept cascades rerun eagerly and their kernel calls held against
    the twins: every kept call (those of `recorder.keep` that the run
    reached) one Hamming call and four small_eig calls (the 8-point F's
    pair, the DLT's pair)."""
    compared = recorder.compare()
    kept = len(recorder.kept)
    check(kept == sum(c < recorder.n for c in recorder.keep)
          and compared.get("hamming_matrix", 0) == kept
          and compared.get("small_eig", 0) == 4 * kept,
          f"{kept} of {recorder.n} cascades kept, kernel calls held against the twins "
          f"{compared}, launches {counts}")


def recorded_checks(recorder: CascadeRecorder, frames: FrameRecorder, counts: dict) -> None:
    """A server run's recorded calls against the twins: the Hamming
    kernel's calls in the kept cascades, and every dense kernel that the
    kept graphed frames ran (the banded warp where its gate passed in
    them)."""
    cascade_checks(recorder, counts)
    dense = frames.compare()
    banded = any(k[3][3] for k in frames.kept)
    check(len(frames.kept) == len(FrameRecorder.FRAMES)
          and all(dense.get(n, 0) > 0 for n in DENSE_KERNELS if n != "warp_banded" or banded),
          f"graphed frames kept {len(frames.kept)}, dense kernel calls held against the "
          f"twins {dense}")


# ---------------------------------------------------------------------------
# Phase 5: the collaborative pose-graph server
# ---------------------------------------------------------------------------


def server_stream(n_agents, duration, n_landmarks=SERVER_LANDMARKS, seed=1):
    """The world and agents of examples/run_synthetic.py (circles with
    yaw/translation offsets and odometric drift), dense enough that every
    keyframe carries 512 features. Returns (packets, ground truth)."""
    from cvids_tpu_torch.io import multiagent
    from cvids_tpu_torch.io.synthetic import Trajectory

    rng = np.random.default_rng(seed)
    landmarks = np.stack([rng.uniform(-14, 14, n_landmarks), rng.uniform(-14, 14, n_landmarks),
                          rng.uniform(0.2, 4.0, n_landmarks)], -1)
    descs = multiagent.landmark_descriptors(n_landmarks)
    agents = [multiagent.AgentSim(
        Trajectory.circle(radius=5.0 - 0.3 * a, omega=0.45, phase=2.0 * a,
                          center=(1.0 * a, 0.5 * a, 1.5)),
        yaw_offset=0.4 * a, t_offset=np.array([2.0 * a, -1.0 * a, 0.1 * a]),
        drift_yaw_rate=0.0005, drift_t_rate=0.002) for a in range(n_agents)]
    return multiagent.generate_packets(agents, landmarks, descs, duration=duration,
                                       kf_rate=1.0, max_feats=512)


def gumbel_check(device, n_draws=40, n=160) -> None:
    """The server's RANSAC noise drawn for the card and for the CPU from one
    seed (the uniforms come from the CPU generator, the logs run where the
    noise is used) must pick the same hypotheses: the same top-6 (PnP) and
    top-8 (F) index sets for every row, at the verification's (128, max_win)
    shape and valid-match densities from 5 % to all."""
    from cvids_tpu_torch.ops import ransac

    g_cpu, g_dev = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    rng = np.random.default_rng(3)
    err, diff_rows = 0.0, 0
    for k in range(n_draws):
        a = ransac.gumbel_noise(128, n, g_cpu, device="cpu")
        b = ransac.gumbel_noise(128, n, g_dev, device=device)
        err = max(err, (b.cpu() - a).abs().max().item())
        valid = torch.from_numpy(rng.random(n) < (k + 1) / n_draws)
        for size in (6, 8):
            ia = ransac._sample_indices(a, valid, size).sort(dim=1).values
            ib = ransac._sample_indices(b, valid.to(device), size).cpu().sort(dim=1).values
            diff_rows += int((ia != ib).any(dim=1).sum())
    check(diff_rows == 0, f"RANSAC noise: {diff_rows} hypotheses differ between CPU and card")
    print(f"  RANSAC noise, {n_draws} draws of (128, {n}) from one seed: card vs CPU max "
          f"|diff| {err:.3g}; the same top-6 and top-8 index sets in every row")


class SyncCounter:
    """Counts the main thread's host syncs while active: torch's sync debug
    mode warns at each synchronizing CUDA call (a worker thread's are not
    counted)."""

    def __enter__(self):
        self.count = 0
        self._saved = warnings.catch_warnings()
        self._saved.__enter__()
        warnings.simplefilter("always")
        main, show = threading.main_thread(), warnings.showwarning

        def count(message, category, *args, **kwargs):
            if "synchroniz" not in str(message):
                show(message, category, *args, **kwargs)
            elif threading.current_thread() is main:
                self.count += 1

        warnings.showwarning = count
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._saved.__exit__(*exc)


def ate(server, gt, cid) -> float:
    st = server.store
    sel = np.nonzero(st.client[:st.count] == cid)[0]
    errs = [np.linalg.norm(st.world_p[k] - gt[(cid, int(st.local_index[k]))][0]) for k in sel]
    return float(np.sqrt(np.mean(np.square(errs))))


class IngestRecorder:
    """Keeps every call of a pose graph's two ingest programs during a run:
    the verification cascade's arguments and outputs (`server._verify`,
    `posegraph._match_and_pnp`), and each BoW `query_and_add`'s inputs, the
    database's row count and capacity at the call and its outputs (device
    handles, no copy: the inputs are the server's immutable feature
    uploads). `compare()` reruns every call eagerly under `disable_graphs()`
    and holds each replay's outputs, and the row it inserted, to the eager
    call's bits. A BoW call's store before it is rebuilt from the final
    store: rows below its count are never written again, rows from it on
    hold their initial fill."""

    def __init__(self, server):
        self.server, self.db = server, server.db
        self.verify_program = server._verify
        self.bow_program = server.db._query_insert
        self.verify, self.bow = [], []
        self._query_and_add = server.db.query_and_add
        server._verify = self._record_verify
        server.db.query_and_add = self._record_bow

    def _record_verify(self, *args):
        out = self.verify_program(*args)
        self.verify.append((args, out))
        return out

    def _record_bow(self, descriptors, client_id, exclude_recent=10, top_k=4, valid=None):
        count = self.db.count
        out = self._query_and_add(descriptors, client_id, exclude_recent, top_k, valid)
        self.bow.append((descriptors, valid, client_id, count, max(count - exclude_recent, 0),
                         top_k, len(self.db.client), out))
        return out

    def compare(self) -> dict:
        from cvids_tpu_torch.server import posegraph, vocab
        from cvids_tpu_torch.utils.cuda_graph import disable_graphs

        db = self.db
        bad_verify = bad_bow = 0
        with disable_graphs():
            for args, out in self.verify:
                want = posegraph._match_and_pnp(*args)
                got_l, want_l = (torch.utils._pytree.tree_leaves(x) for x in (out, want))
                bad_verify += not all(_same_bits(x, y) for x, y in zip(got_l, want_l))
            for desc, valid, cid, count, cut, top_k, cap, out in self.bow:
                ids, vals, cl = (x[:cap].clone() for x in (db.ids, db.vals, db.client_dev))
                ids[count:], vals[count:], cl[count:] = -1, 0.0, -1
                sc = torch.tensor([count, cid, cut], device=ids.device)
                want = vocab._sparse_query_insert(db._dev, desc, valid, ids, vals, cl, sc[0],
                                                  sc[1], sc[2], db.tree.levels, db.f,
                                                  db.tree.num_words, top_k)
                rows = ((ids, db.ids), (vals, db.vals), (cl, db.client_dev))
                bad_bow += not (all(_same_bits(x, y) for x, y in zip(out, want))
                                and all(_same_bits(a[count], b[count]) for a, b in rows))
        return {"cascade_calls": len(self.verify), "cascade_differ": bad_verify,
                "bow_calls": len(self.bow), "bow_differ": bad_bow,
                "cascade_captures": self.verify_program.captures,
                "cascade_replays": self.verify_program.replays,
                "bow_captures": self.bow_program.captures,
                "bow_replays": self.bow_program.replays,
                "bow_graphs_held": len(self.bow_program.graphs),
                "bow_tiers": int(np.log2(len(db.client) / self.bow[0][6])) + 1 if self.bow else 0,
                "cascade_launches": next(iter(self.verify_program.graphs.values())).launches
                if self.verify_program.graphs else {}}


def server_run(device, packets, tree, sync_window=(200, 240), record=False):
    """Streams the packets through CollaborativePoseGraph (ServerConfig's
    reference defaults, background solves) and flushes with a final solve.
    Returns (server, stats): per-keyframe host ms of add_keyframe, solve ms,
    the PCM edge counts per run, host syncs per keyframe over `sync_window`
    (on a card), and with `record` the run's `IngestRecorder`."""
    from cvids_tpu_torch.server import pcm, posegraph

    pcm_sizes, solve_ms = [], []
    real_filter = pcm.pcm_filter

    def counted_filter(edge_T, pose_i, pose_j, valid, *args, **kwargs):
        pcm_sizes.append(int(np.sum(valid)))
        return real_filter(edge_T, pose_i, pose_j, valid, *args, **kwargs)

    server = posegraph.CollaborativePoseGraph(
        tree, posegraph.ServerConfig(async_optimize=True), device=device)
    real_optimize = server.optimize

    def timed_optimize():
        # the worker solves on its own stream: sync that one, never the
        # device (a capture may be underway on another thread)
        t0 = time.perf_counter()
        out = real_optimize()
        if torch.device(device).type == "cuda":
            torch.cuda.current_stream().synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    server.optimize = timed_optimize
    recorder = IngestRecorder(server) if record else None
    from cvids_tpu_torch.server import optimizer as opt
    ingest_ms, captured, syncs = [], [], float("nan")
    lo, hi = sync_window
    counter = None
    try:
        with mock.patch.object(pcm, "pcm_filter", counted_filter):
            t_stream = time.perf_counter()
            for k, (_, _, _, pkt) in enumerate(packets):
                if k == lo and torch.device(device).type == "cuda":
                    counter = SyncCounter().__enter__()
                t0 = time.perf_counter()
                server.add_keyframe(pkt)
                ingest_ms.append((time.perf_counter() - t0) * 1e3)
                captured.append(len(opt._GRAPHED.graphs) if opt._GRAPHED is not None else 0)
                if k == hi - 1 and counter is not None:
                    counter.__exit__(None, None, None)
                    syncs, counter = counter.count / (hi - lo), None
            server.flush(final=True)
            _sync(device)
            stream_s = time.perf_counter() - t_stream
    finally:
        if counter is not None:
            counter.__exit__(None, None, None)
        server.close()
    return server, {"ingest_ms": ingest_ms, "solve_ms": solve_ms, "pcm_sizes": pcm_sizes,
                    "syncs_per_kf": syncs, "stream_s": stream_s, "captured": captured,
                    "recorder": recorder}


def server_edges(device, packets, tree, profile=None, config=None):
    """The accepted loop edges of a stream with inline solves (a background
    solve lands when the scheduler lets it, which moves the gates), and the
    host ms of each add_keyframe that ran no solve. With `profile` = (lo,
    hi) on a card, keyframes lo..hi-1 run one each under the profiler, and
    the third value is, over those that ran no solve, the host's launch
    calls (HOST_LAUNCH_CALLS) and device activities of each (else None)."""
    from cvids_tpu_torch.server import posegraph

    server = posegraph.CollaborativePoseGraph(tree, config or posegraph.ServerConfig(),
                                              device=device)
    ingest_ms, prof = [], {"launch_calls": [], "activities": []}
    for k, (_, _, _, pkt) in enumerate(packets):
        solves = server.solve_count
        t0 = time.perf_counter()
        if profile is not None and profile[0] <= k < profile[1]:
            _, rows, calls = profile_frame(lambda: server.add_keyframe(pkt), host_launches=True)
            if server.solve_count == solves:
                prof["launch_calls"].append(calls)
                prof["activities"].append(sum(r[2] for r in rows))
            continue
        server.add_keyframe(pkt)
        if server.solve_count == solves:
            ingest_ms.append((time.perf_counter() - t0) * 1e3)
    server.flush(final=False)
    server.close()
    edges = {(int(i), int(j)) for i, j in zip(server.loop_i[:server.loop_count],
                                              server.loop_j[:server.loop_count])}
    return edges, ingest_ms, (prof if profile is not None else None)


def server_phase(device, n_agents=SERVER_AGENTS, duration=SERVER_DURATION,
                 tree_shape=SERVER_TREE, compare=(COMPARE_AGENTS, COMPARE_DURATION)):
    """Phase 5: the server slice, its launches counted, its outputs checked;
    then the kernel route's loop edges against the twin route's. Returns the
    tree vocabulary and {"launches": the main run's kernel launches,
    "programs": its ingest programs' counts (on a card)}."""
    from cvids_tpu_torch.ops import cuda_kernels as ck
    from cvids_tpu_torch.server import pcm, vocab

    dev = torch.device(device)
    t0 = time.perf_counter()
    tree = vocab.synthesize_tree_vocabulary(*tree_shape, seed=0)
    packets, gt = server_stream(n_agents, duration)
    print(f"phase 5 server: {len(packets)} keyframes from {n_agents} agents, "
          f"{tree.num_words} words, world and vocabulary made in "
          f"{time.perf_counter() - t0:.1f} s; native max clique: "
          f"{pcm.native_max_clique_available()}")
    gumbel_check(dev)
    if dev.type == "cuda":
        bow_tier_checks(dev, tree)
        torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    server, stats = server_run(dev, packets, tree, record=True)
    _sync(dev)
    counts = dict(ck.launches)
    ates = [ate(server, gt, c) for c in range(n_agents)]
    ingest = np.asarray(stats["ingest_ms"])
    solves = stats["solve_ms"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else float("nan")
    print(f"  stream {stats['stream_s']:.2f} s; ingest ms per keyframe median "
          f"{np.median(ingest):.3f} p90 {np.percentile(ingest, 90):.3f} max {ingest.max():.3f}; "
          f"{len(solves)} solves, ms median {np.median(solves) if solves else float('nan'):.1f} "
          f"max {max(solves) if solves else float('nan'):.1f} (the last with the final flush); "
          f"host syncs per keyframe {stats['syncs_per_kf']:.2f}; peak device memory {peak:.2f} GiB")
    print(f"  aligned {[c.aligned for c in server.clients[:n_agents]]}; loops {server.loop_count} "
          f"(PCM kept {int(server.loop_pcm_ok[:server.loop_count].sum())}); PCM runs on "
          f"{len(stats['pcm_sizes'])} client pairs, edges max {max(stats['pcm_sizes'], default=0)}; "
          f"ATE m {[round(a, 4) for a in ates]}; launches {counts}")
    check(all(c.aligned for c in server.clients[:n_agents]), "a client never aligned")
    check(server.loop_count > 0, "no loop accepted")
    check(max(stats["pcm_sizes"], default=0) >= server.cfg.pcm_min_edges,
          f"PCM never ran on a pair with >= {server.cfg.pcm_min_edges} edges")
    check(ates[0] < 0.05, f"world client ATE {ates[0]} >= 0.05 m")
    check(all(a < 0.25 for a in ates[1:]), f"client ATE {ates} >= 0.25 m")
    check(all(counts[k] > 0 for k in SERVER_KERNELS + RANSAC_KERNELS),
          f"a server kernel did not run: {counts}")
    if dev.type == "cuda":
        rec = stats["recorder"].compare()
        print(f"  ingest programs: the cascade {rec['cascade_calls']} calls, "
              f"{rec['cascade_captures']} capture(s), {rec['cascade_replays']} replays, kernel "
              f"launches a replay {rec['cascade_launches']}; BoW query-and-insert "
              f"{rec['bow_calls']} calls, {rec['bow_captures']} capture(s) over "
              f"{rec['bow_tiers']} capacity tier(s), {rec['bow_graphs_held']} graph held, "
              f"{rec['bow_replays']} replays; every replay rerun eagerly under "
              f"disable_graphs(): {rec['cascade_differ']} cascades and {rec['bow_differ']} BoW "
              f"steps differ in a bit (tolerance: none)")
        check(rec["cascade_calls"] > 0 and rec["cascade_captures"] == 1
              and rec["cascade_replays"] == rec["cascade_calls"],
              f"the cascade was not one graph replayed at every call: {rec}")
        check(rec["bow_calls"] == len(packets) and rec["bow_captures"] == rec["bow_tiers"]
              and rec["bow_graphs_held"] == 1 and rec["bow_replays"] == rec["bow_calls"],
              f"the BoW step was not one graph a tier replayed at every keyframe: {rec}")
        check(rec["cascade_differ"] == 0 and rec["bow_differ"] == 0,
              f"a replay differs from its eager call: {rec}")
        check(rec["cascade_launches"].get("small_eig", 0) == 4
              and rec["cascade_launches"].get("hamming_matrix", 0) == 1,
              f"a cascade replay's kernels {rec['cascade_launches']}: not one Hamming call and "
              f"four small_eig calls (the 8-point F's pair, the DLT's pair)")
        stats["programs"] = rec

    cmp_packets, _ = server_stream(*compare)
    window = (40, 70) if dev.type == "cuda" else None
    edges_kernel, inline_ms, prof = server_edges(dev, cmp_packets, tree, profile=window)
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs
    with contextlib.ExitStack() as stack:
        stack.enter_context(disable_graphs())   # a graph would replay the kernels
        for p in twin_patches():
            stack.enter_context(p)
        edges_twin, _, _ = server_edges(dev, cmp_packets, tree)
    check(edges_kernel == edges_twin,
          f"loop edges differ: kernel {len(edges_kernel)}, twin {len(edges_twin)}, "
          f"common {len(edges_kernel & edges_twin)}")
    check(len(edges_kernel) > 0, "the comparison stream accepted no loop")
    print(f"  {len(cmp_packets)}-keyframe stream, inline solves: the kernel route (graphs) "
          f"and the twin route (eager) accept the same {len(edges_kernel)} loop edges; ingest "
          f"ms per keyframe without a solve (kernel route) median {np.median(inline_ms):.3f} "
          f"p90 {np.percentile(inline_ms, 90):.3f}")
    if prof is not None and prof["launch_calls"]:
        stats["launch_calls_per_kf"] = float(np.median(prof["launch_calls"]))
        print(f"  ingest per keyframe (keyframes {window[0]}-{window[1] - 1} of that stream "
              f"that ran no solve, {len(prof['launch_calls'])} profiled one by one): host "
              f"launch calls median {np.median(prof['launch_calls']):.0f} (min "
              f"{min(prof['launch_calls'])}, max {max(prof['launch_calls'])}), device "
              f"activities median {np.median(prof['activities']):.0f}; host syncs per "
              f"keyframe (background run) {stats['syncs_per_kf']:.2f}")
    from cvids_tpu_torch.server import optimizer as opt
    graphed = opt._GRAPHED
    if dev.type == "cuda":
        check(graphed is not None and graphed.replays > 0, "no 4-DoF solve was a graph replay")
        # the keyframes ingested after the background run's last capture
        cap = stats["captured"]
        steady = ingest[[k for k in range(len(cap)) if cap[k] == cap[-1]][1:]]
        print(f"  graphed 4-DoF solves: ingest ms per keyframe median, background "
              f"{np.median(ingest):.3f} ({len(packets)} keyframes; {np.median(steady):.3f} over "
              f"the {len(steady)} after the last of its {cap[-1]} captures), inline "
              f"{np.median(inline_ms):.3f} (the {len(cmp_packets)}-keyframe stream, keyframes "
              f"that ran no solve); {len(graphed.graphs)} LM-iteration graphs captured in the "
              f"process (tiers), {graphed.replays} replays")
    print("phase 5 server: ok")
    return tree, {"launches": counts, "programs": stats.get("programs", {})}


def bow_tier_checks(device, tree, capacity=16, n_frames=70) -> None:
    """Each database's query-and-insert program through three growths of its
    store (capacity 16 to 128): one capture per capacity tier and none per
    keyframe, every replay's outputs and the final store equal to an eager
    database's fed the same keyframes under `disable_graphs()`, and each
    superseded tier's store and graph released (nothing holds the old
    store: its weak reference dies). The sparse database on `tree`; the
    dense one on a 4096-word trained vocabulary."""
    import weakref

    from cvids_tpu_torch.io import multiagent
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs

    dev = torch.device(device)
    rng = np.random.default_rng(11)
    pool = multiagent.landmark_descriptors(3000)
    frames = [(torch.from_numpy(pool[rng.integers(0, 3000, 512)].view(np.int32).copy()).to(dev),
               torch.from_numpy(rng.random(512) > 0.1).to(dev), int(rng.integers(0, 4)))
              for _ in range(n_frames)]
    voc = vocab.train_vocabulary(pool[:2000], k=8, levels=4, seed=0, device=dev)
    kinds = {"sparse": (lambda: vocab.SparseBowDatabase(tree, capacity, device=dev),
                        lambda db, d, v, c: db.query_and_add(d, c, 10, valid=v),
                        "_query_insert", ("ids", "vals", "client_dev")),
             "dense": (lambda: vocab.BowDatabase(voc, capacity),
                       lambda db, d, v, c: db.query_and_add_descriptors(d, c, 10, valid=v),
                       "_bow_query_insert", ("vectors", "client_dev"))}
    for kind, (make, step, program, stores) in kinds.items():
        graphed, eager = make(), make()
        old, differ = [], 0
        for d, v, c in frames:
            if graphed.count == len(graphed.client):
                old.append(weakref.ref(getattr(graphed, stores[0])))
            got = step(graphed, d, v, c)
            with disable_graphs():
                want = step(eager, d, v, c)
            differ += not all(_same_bits(x, y) for x, y in zip(got, want))
        prog = getattr(graphed, program)
        _sync(dev)
        same_store = all(_same_bits(getattr(graphed, n), getattr(eager, n)) for n in stores)
        tiers = int(np.log2(len(graphed.client) // capacity)) + 1
        alive = sum(r() is not None for r in old)
        print(f"  {kind} BoW database, {n_frames} keyframes from capacity {capacity}: "
              f"{prog.captures} captures over {tiers} tiers, {prog.replays} replays, "
              f"{len(prog.graphs)} graph held; {differ} replays differ from the eager "
              f"database's calls, final stores {'equal' if same_store else 'DIFFER'} bit for "
              f"bit; superseded stores still alive {alive} of {len(old)}")
        check(prog.captures == tiers and prog.replays == n_frames and len(prog.graphs) == 1,
              f"{kind} BoW program: {prog.captures} captures, {prog.replays} replays, "
              f"{len(prog.graphs)} graphs for {tiers} tiers and {n_frames} keyframes")
        check(differ == 0 and same_store, f"{kind} BoW program: replays differ from eager calls")
        check(alive == 0, f"{kind} BoW program: {alive} superseded stores still held")


# ---------------------------------------------------------------------------
# Phase 6: the whole collaborative server, packets with images -> mesh
# ---------------------------------------------------------------------------


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera axes in world (z toward the target, x level, y down)."""
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], 1)


def scene_distance(pts: np.ndarray, sc: dict | None = None) -> np.ndarray:
    """Unsigned distance of (N, 3) points to the surfaces (floor, wall, box)
    of a room (`default_scene()` unless `sc` is given)."""
    from cvids_tpu_torch.io.render import default_scene
    sc = sc or default_scene()
    q = np.maximum(sc["box_lo"][None] - pts, pts - sc["box_hi"][None])
    d_box = np.abs(np.linalg.norm(np.maximum(q, 0.0), axis=1) + np.minimum(q.max(1), 0.0))
    return np.minimum(np.minimum(np.abs(pts[:, 2] - sc["floor_z"]),
                                 np.abs(pts[:, 1] - sc["wall_y"])), d_box)


def scene_stream(n_agents, n_kf, h=H, w=W, focal=FOCAL, n_landmarks=PIPE_LANDMARKS, seed=5,
                 cams=None):
    """Agents on arcs in front of `default_scene()`'s room, each camera
    looking at the box, keyframes at 1 Hz in time order. Each packet's image
    is rendered from the keyframe's ground-truth camera pose; its window and
    extra features are the landmarks (sampled on the scene's surfaces) that
    the camera sees unoccluded, up to 512, in normalized coordinates. Agent
    a's odometry frame is offset by yaw 0.4a and t (2a, -a, 0.1a); agent 0's
    is the ground-truth frame.

    Without `cams` every agent carries the undistorted pinhole of (focal,
    w / 2, h / 2). With `cams`, one of the port's cameras an agent (on any
    device), the image is rendered through the agent's camera, distortion
    and all, and the features are projected through it and lifted back by its
    `lift`, as an agent would send them; the true depth is still the
    undistorted pinhole's, which is what the server estimates after its
    remap. Returns (packets, {(agent, kf): true depth}, K)."""
    from cvids_tpu_torch import camera, interop
    from cvids_tpu_torch.io import multiagent, render
    from cvids_tpu_torch.io.msgs import KeyframePacket
    from cvids_tpu_torch.io.synthetic import quat_from_matrix_np

    rng = np.random.default_rng(seed)
    pinhole = camera.PinholeCamera.create(focal, focal, w / 2, h / 2, width=w, height=h,
                                          device="cpu")
    k32 = pinhole.k_matrix.numpy()
    k = k32.astype(np.float64)
    # the renderer reads a camera's fields on the host, once a call
    host_cams = [interop.camera_to_numpy(c) for c in cams] if cams else None
    landmarks = render.sample_scene_landmarks(n_landmarks, rng)
    descs = multiagent.landmark_descriptors(n_landmarks)
    views = []
    for i in range(n_kf):
        for a in range(n_agents):
            s = i / n_kf if a % 2 == 0 else 1.0 - i / n_kf
            ang = -0.6 + 1.2 * s
            radius = 1.5 + 0.2 * a
            eye = np.array([1.5 + radius * np.sin(ang), -2.2 - 0.25 * a, 1.2 + 0.12 * a])
            target = np.array([1.5 + 0.1 * a, 1.0, 0.5])
            views.append((a, i, look_at(eye, target), eye))
    with ThreadPoolExecutor(8) as ex:
        ideal = list(ex.map(lambda v: render.render_textured_scene(pinhole, v[2], v[3]), views))
        images = ideal if cams is None else list(ex.map(
            lambda v: render.render_textured_scene(host_cams[v[0]], v[2], v[3]), views))
    packets, truth = [], {}
    for (a, i, r_wc, eye), (img, depth), (_, true_depth) in zip(views, images, ideal):
        truth[(a, i)] = true_depth
        pts_c = (landmarks - eye) @ r_wc
        z = pts_c[:, 2]
        if cams is None:
            px = pts_c @ k.T
            px = px[:, :2] / np.maximum(z, 1e-9)[:, None]
        else:       # through the agent's camera, where the camera lives
            dev = cams[a].cx.device
            px_t = cams[a].project(torch.as_tensor(pts_c, dtype=torch.float32, device=dev))
            # a point behind or beside the camera projects to no pixel (NaN,
            # or a value beyond any image): outside, whatever its size
            px = np.clip(np.nan_to_num(px_t.cpu().numpy().astype(np.float64), nan=-1.0),
                         -1.0, 1e6)
        u = np.round(px[:, 0]).astype(np.int64)
        v = np.round(px[:, 1]).astype(np.int64)
        inside = (z > 0.5) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        seen = np.zeros_like(inside)
        seen[inside] = np.abs(depth[v[inside], u[inside]] - z[inside]) < 0.05 * z[inside]
        idx = np.nonzero(seen)[0][:512]
        if cams is None:
            uv = (pts_c[idx, :2] / z[idx, None]).astype(np.float32)
        else:
            uv = cams[a].lift(px_t[torch.as_tensor(idx, device=dev)]).cpu().numpy()
        yaw_off, t_off = 0.4 * a, np.array([2.0 * a, -1.0 * a, 0.1 * a])
        c, s = np.cos(-yaw_off), np.sin(-yaw_off)
        r_lw = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])   # world -> odometry
        ones = np.ones(len(idx), bool)
        r_cb = multiagent.R_CB_DEFAULT.astype(np.float64)
        packets.append(KeyframePacket(
            client_id=a, timestamp=float(i), p_wb=(r_lw @ (eye - t_off)).astype(np.float32),
            q_wb=quat_from_matrix_np(r_lw @ r_wc @ r_cb).astype(np.float32),
            r_cb=multiagent.R_CB_DEFAULT, p_bc=np.zeros(3, np.float32),
            win_pts3d=((landmarks[idx] - t_off) @ r_lw.T).astype(np.float32), win_uv=uv,
            win_ids=idx.astype(np.int64), win_desc=descs[idx], win_valid=ones,
            ext_uv=uv, ext_desc=descs[idx], ext_valid=ones.copy(), image=img))
    return packets, truth, k32


class IntegrateTimer:
    """Times each `TsdfVolume.integrate` of a volume by part, without adding
    a sync to the path: the chunk walk (host clock around `_touched_chunks`,
    which ends in its read of the keys), the allocation (host clock around
    `_alloc`) and the device integrate (CUDA events around
    `integrate_chunks` on a card, summed over a map's calls: one launch, or
    batches of 1024 chunks before the TSDF kernel). With `cpu_walk`, each
    map's depth is kept (a device copy) with the walk's inputs and chunks,
    and `walk_check` runs each walk again on the CPU after the run."""

    def __init__(self, volume, cpu_walk=False):
        from cvids_tpu_torch.mapping import tsdf
        self.walk_ms, self.alloc_ms, self.events, self.chunks = [], [], [], []
        self.walks = []
        real_touched, real_alloc = volume._touched_chunks, volume._alloc
        real_chunks = tsdf.integrate_chunks
        self._restore = lambda: setattr(tsdf, "integrate_chunks", real_chunks)
        timed = volume.device.type == "cuda"
        self._cpu = tsdf.TsdfVolume(volume.cfg, device="cpu") if cpu_walk else None

        def touched(depth, *args):
            t0 = time.perf_counter()
            out = real_touched(depth, *args)
            self.walk_ms.append((time.perf_counter() - t0) * 1e3)
            self.events.append([])
            if cpu_walk:
                self.walks.append((depth.clone() if torch.is_tensor(depth) else depth, args, out))
            return out

        def alloc(coords):
            t0 = time.perf_counter()
            slots = real_alloc(coords)
            self.alloc_ms.append((time.perf_counter() - t0) * 1e3)
            self.chunks.append(len(slots))
            return slots

        def chunks(*args, **kwargs):
            if not timed:
                return real_chunks(*args, **kwargs)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            real_chunks(*args, **kwargs)
            end.record()
            self.events[-1].append((start, end))

        volume._touched_chunks, volume._alloc = touched, alloc
        tsdf.integrate_chunks = chunks

    def device_ms(self) -> list[float]:
        """Device ms of each map's integrate (syncs once, at the end)."""
        if any(self.events):
            torch.cuda.synchronize()
        return [sum(s.elapsed_time(e) for s, e in ev) for ev in self.events if ev]

    def maps(self) -> int:
        """Maps that integrated chunks."""
        return sum(1 for c in self.chunks if c)

    def walk_check(self) -> list[int]:
        """Each kept map's walk run again on a CPU copy of its depth: the
        chunks that differ from the run's, a map (a map whose chunks are
        the same but in another order counts 1)."""
        diffs = []
        for depth, args, out in self.walks:
            ref = self._cpu._touched_chunks(depth.cpu() if torch.is_tensor(depth) else depth,
                                            *args)
            diffs.append(0 if np.array_equal(out, ref) else max(
                len(set(map(tuple, out)) ^ set(map(tuple, ref))), 1))
        return diffs

    def close(self):
        self._restore()


def pipeline_run(device, packets, vocabulary, k, cfg, cams=None, cpu_walk=False):
    """Streams the packets through CollaborativeServer; returns the server
    (its worker stopped), per-keyframe host ms, and the integrate timer
    (`IntegrateTimer`, with `cpu_walk` holding each map's walk to its CPU
    run). Every client gets the intrinsics `k`, or, with `cams` (a camera a
    client), its camera through `set_client_camera`."""
    from cvids_tpu_torch.server.pipeline import CollaborativeServer

    server = CollaborativeServer(vocabulary, cfg, device=device)
    for cid in sorted({int(p.client_id) for p in packets}):
        if cams is None:
            server.set_client_intrinsics(cid, k)
        else:
            server.set_client_camera(cid, cams[cid])
    timer = IntegrateTimer(server.volume, cpu_walk)
    kf_ms = []
    try:
        for pkt in packets:
            t0 = time.perf_counter()
            server.submit(pkt)
            server.process()
            kf_ms.append((time.perf_counter() - t0) * 1e3)
        _sync(device)
    finally:
        timer.close()
        server.close()
    return server, kf_ms, timer


def depth_rms(server, truth) -> list[float]:
    """Inverse-depth RMS of each published map against the rendered truth
    over pixels with 0.2-6 m true depth (test_full_system.py's scoring);
    maps that share < 2 % of such pixels are skipped."""
    st, out = server.graph.store, []
    for rec in server.depth_records:
        gt = truth[(rec["client"], int(st.local_index[rec["ref_index"]]))]
        est = rec["depth"]
        both = (est > 0) & (gt > 0.2) & (gt < 6.0)
        if both.mean() >= 0.02:
            out.append(float(np.sqrt(np.mean((1.0 / est[both] - 1.0 / gt[both]) ** 2))))
    return out


def default_device_check(vocabulary) -> None:
    """A server built with no `device` argument lives on the card: the
    port's entry points take the card unless the caller asks for the CPU."""
    import cvids_tpu_torch
    from cvids_tpu_torch.server.pipeline import CollaborativeServer

    server = CollaborativeServer(vocabulary)
    try:
        want = cvids_tpu_torch.default_device()
        devices = {"server": server.device, "graph": server.graph.device,
                   "bow database": server.graph.db.ids.device,
                   "TSDF pool": server.volume.pool.sdf.device}
        check(want.type == "cuda" and all(d == want for d in devices.values()),
              f"a server built without a device is not on the card: {devices}")
    finally:
        server.close()
    print(f"  a CollaborativeServer built with no device argument: server, pose graph, BoW "
          f"database and TSDF pool on {want}")


def pipeline_score(server, kf_ms, timer, truth, n_agents, counts, dev, stream_s, peak) -> dict:
    """Prints a whole-server run's times and scores and holds it to the
    bounds of phases 6 and 7: every client aligned, >= 4 depth maps an
    agent, median inverse-depth RMS < 0.12 against the rendered truth, a mesh
    of > 1000 triangles with median scene distance < 0.15 m, the TSDF pool on
    the device, all seven kernels of the server launched, `tsdf_integrate`
    once a map, the walk's chunks equal to its CPU run's on every map (where
    the timer ran it), and `extract_mesh` one replay a 256-chunk batch with
    the eager path's triangles bit for bit. Returns the tracer's spans (host
    ms per sample)."""
    import tempfile

    from cvids_tpu_torch.mapping.mesh import MESH_BATCH, extract_mesh, read_ply
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs

    vol = server.volume
    # the device memory that the mesh's first (capturing) call leaves
    # reserved: its graphs' pool, the allocator's free cache emptied around it
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ply = f"{tmp}/scene.ply"
        t1 = time.perf_counter()
        n_tri = server.save_mesh(ply)
        save_ms = (time.perf_counter() - t1) * 1e3
        verts, faces, _ = read_ply(ply)
    _sync(dev)
    if cuda:
        torch.cuda.empty_cache()
        reserved = (torch.cuda.memory_reserved(dev) - reserved) / 2 ** 20
    replays = vol.mesh_graph.replays
    t1 = time.perf_counter()
    graphed = extract_mesh(vol)
    mesh_ms = (time.perf_counter() - t1) * 1e3
    replays = vol.mesh_graph.replays - replays
    with disable_graphs():
        t1 = time.perf_counter()
        eager = extract_mesh(vol)
        eager_ms = (time.perf_counter() - t1) * 1e3
    batches = -(-len(vol.slot_of) // MESH_BATCH)
    per_client = [sum(r["client"] == c for r in server.depth_records) for c in range(n_agents)]
    rms = depth_rms(server, truth)
    med_rms = float(np.median(rms)) if rms else float("inf")
    dist = float(np.median(scene_distance(verts.astype(np.float64)))) if len(verts) else float("inf")
    dev_ms = timer.device_ms()
    walk_diffs = timer.walk_check()
    spans = {name: np.asarray(v) * 1e3 for name, v in server.tracer.samples.items()}
    print(f"  stream {stream_s:.2f} s; host ms per keyframe median {np.median(kf_ms):.3f} "
          f"p90 {np.percentile(kf_ms, 90):.3f}; peak device memory {peak:.2f} GiB")
    print("  tracer host ms per span: " + "; ".join(
        f"{n} x{len(v)} median {np.median(v):.3f} p90 {np.percentile(v, 90):.3f}"
        for n, v in spans.items()))
    print(f"  TsdfVolume.integrate per depth map, host ms: chunk walk median "
          f"{np.median(timer.walk_ms):.3f} p90 {np.percentile(timer.walk_ms, 90):.3f}, _alloc "
          f"median {np.median(timer.alloc_ms):.3f} p90 {np.percentile(timer.alloc_ms, 90):.3f}; "
          f"device integrate ms median {np.median(dev_ms) if dev_ms else float('nan'):.4f} max "
          f"{max(dev_ms, default=float('nan')):.4f}; chunks per map median "
          f"{np.median(timer.chunks):.0f} max {max(timer.chunks)}; tsdf_integrate launches "
          f"{counts['tsdf_integrate']} for {timer.maps()} maps"
          + (f"; the walk against its CPU run on a copy of each map's depth: "
             f"{sum(walk_diffs)} chunks differ over {len(walk_diffs)} maps"
             if walk_diffs else ""))
    print(f"  extract_mesh graphed {mesh_ms:.3f} ms ({replays} replays for {batches} batches "
          f"of {MESH_BATCH}), eager {eager_ms:.3f} ms, the same triangles bit for bit; "
          f"save_mesh {save_ms:.3f} ms"
          + (f" (its graphs keep {reserved:.1f} MiB reserved)" if cuda else "")
          + f"; chunks allocated {len(vol.slot_of)} (pool "
          f"{vol.capacity}, dropped {vol.dropped_chunks}); triangles {n_tri}")
    print(f"  aligned {[c.aligned for c in server.graph.clients[:n_agents]]}; loops "
          f"{server.graph.loop_count}; depth maps {server.depth_maps_published}, per agent "
          f"{per_client}; inverse-depth RMS median {med_rms:.4f} over {len(rms)} maps "
          f"{[round(r, 4) for r in rms]}; mesh median scene distance {dist:.4f} m; "
          f"launches {counts}")
    check(all(c.aligned for c in server.graph.clients[:n_agents]), "a client never aligned")
    check(min(per_client) >= 4, f"depth maps per agent {per_client}: fewer than 4")
    check(med_rms < 0.12, f"median inverse-depth RMS {med_rms} >= 0.12")
    check(n_tri > 1000 and faces == n_tri, f"mesh has {n_tri} triangles, not > 1000")
    check(dist < 0.15, f"mesh median scene distance {dist} m >= 0.15")
    check(vol.pool.sdf.device == dev and vol.pool.weight.device == dev,
          f"TSDF pool on {vol.pool.sdf.device}, not {dev}")
    check(all(counts[n] > 0 for n in DENSE_KERNELS + SERVER_KERNELS + MAP_KERNELS),
          f"a kernel did not run in the pipeline: {counts}")
    check(dev.type != "cuda" or counts["tsdf_integrate"] == timer.maps(),
          f"{counts['tsdf_integrate']} tsdf_integrate launches for {timer.maps()} maps")
    check(sum(walk_diffs) == 0,
          f"the walk on the device differs from its CPU run by {walk_diffs} chunks")
    check(all(a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))
              for a, b in zip(graphed, eager)), "extract_mesh's replays differ from the eager path")
    check(dev.type != "cuda" or replays == batches,
          f"extract_mesh replayed {replays} graphs for {batches} batches")
    return spans


def dense_graph_memory(server, dev) -> None:
    """Prints what the server's dense CUDA graphs hold: the graphs, one per
    client and warp and bias variant, and the device memory that the
    caching allocator keeps in the one pool that they share."""
    graphs = server._dense_graphs
    pool = graphs._pools.get(dev)
    dense = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if pool is not None and tuple(seg.get("segment_pool_id", (0, 0))) == tuple(pool))
    clients = len(server.dense_state)
    print(f"  dense CUDA graphs: {len(graphs.graphs)} for {clients} clients (warp x bias "
          f"variants), {graphs.replays} replays, sharing one pool of {dense / 2 ** 30:.3f} GiB; "
          f"device memory reserved {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")
    check(pool is not None and len(graphs.graphs) >= clients and dense > 0,
          "the server's dense frames were not replayed from one shared graph pool")


def pipeline_phase(device, vocabulary, n_agents=PIPE_AGENTS, n_kf=PIPE_KF, h=H, w=W,
                   focal=FOCAL, dense=None, short_kf=SHORT_KF):
    """Phase 6: the whole server at DenseConfig() and TsdfConfig() defaults
    (640x480x128 bf16, 0.1 m voxels, carving), inline solves; then a short
    stream through the kernels and through the twins. `dense` replaces
    DenseConfig() for a smaller rehearsal on the CPU. Returns the main
    run's launch counts and its maps' medians (maps, walk, alloc, device
    integrate and `mesh` span ms)."""
    from cvids_tpu_torch.dense.estimator import DenseConfig
    from cvids_tpu_torch.mapping.tsdf import TsdfConfig
    from cvids_tpu_torch.ops import cuda_kernels as ck
    from cvids_tpu_torch.server.pipeline import PipelineConfig
    from cvids_tpu_torch.server.posegraph import ServerConfig

    dev = torch.device(device)
    t0 = time.perf_counter()
    packets, truth, k = scene_stream(n_agents, n_kf, h, w, focal)
    cfg = PipelineConfig(server=ServerConfig(), dense=dense or DenseConfig(), tsdf=TsdfConfig())
    print(f"phase 6 pipeline: {len(packets)} keyframes with {h}x{w} images from {n_agents} "
          f"agents ({np.median([len(p.win_ids) for p in packets]):.0f} features median), "
          f"rendered in {time.perf_counter() - t0:.1f} s; dense {cfg.dense.height}x"
          f"{cfg.dense.width}x{cfg.dense.num_depths} {cfg.dense.dtype}")
    if dev.type == "cuda":
        default_device_check(vocabulary)
        torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    t0 = time.perf_counter()
    server, kf_ms, timer = pipeline_run(dev, packets, vocabulary, k, cfg, cpu_walk=True)
    stream_s = time.perf_counter() - t0
    counts = dict(ck.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else float("nan")
    spans = pipeline_score(server, kf_ms, timer, truth, n_agents, counts, dev, stream_s, peak)
    dev_ms = timer.device_ms()
    maps = {"maps": timer.maps(), "walk_ms": float(np.median(timer.walk_ms)),
            "alloc_ms": float(np.median(timer.alloc_ms)),
            "integrate_ms": float(np.median(dev_ms)) if dev_ms else None,
            "mesh_span_ms": float(np.median(spans["mesh"])) if "mesh" in spans else None}
    print(f"  whole-server host ms per keyframe median {np.median(kf_ms):.3f}, beside "
          f"{PARENT_WHOLE_SERVER_MS} before the ingest programs were graphs (PERF.md section 6; "
          f"`--server-probe --package` measures two trees in one call)")
    if dev.type == "cuda":
        dense_graph_memory(server, dev)

    # the short stream, kernels against twins: the same maps and chunks
    short = [p for p in packets if p.client_id == 0][:short_kf]
    runs = []
    from cvids_tpu_torch.utils.cuda_graph import disable_graphs
    for patched in (False, True):
        with contextlib.ExitStack() as stack:
            if patched:         # the twins run eagerly: a graph would replay the kernels
                stack.enter_context(disable_graphs())
            for p in twin_patches() if patched else ():
                stack.enter_context(p)
            s, _, _ = pipeline_run(dev, short, vocabulary, k, cfg)
        runs.append(s)
    (sk, st) = runs
    check(sk.depth_maps_published == st.depth_maps_published >= 1,
          f"short stream: {sk.depth_maps_published} maps via kernels, "
          f"{st.depth_maps_published} via twins")
    agree = min(float(np.isclose(a["depth"], b["depth"], rtol=1e-4, atol=0.0).mean())
                for a, b in zip(sk.depth_records, st.depth_records))
    check(agree >= 0.999, f"short stream: maps agree at {agree:.5f} of pixels, < 0.999")
    check(set(sk.volume.slot_of) == set(st.volume.slot_of),
          f"short stream: chunk sets differ ({len(sk.volume.slot_of)} vs "
          f"{len(st.volume.slot_of)})")
    print(f"  {len(short)}-keyframe stream through the kernels and the twins: "
          f"{sk.depth_maps_published} maps agreeing within 1e-4 relative at >= {agree:.5f} of "
          f"pixels (tolerance 0.999), the same {len(sk.volume.slot_of)} chunks")
    print("phase 6 pipeline: ok")
    return counts, maps


def distorted_cameras(device, h=H, w=W, focal=FOCAL) -> dict:
    """The port's three distorted models at one image size, on `device`: an
    EuRoC-like radtan pinhole, an equidistant fisheye (`test_fisheye_e2e`'s
    coefficients) and a Mei camera (xi 0.9, its focal scaled by 1 + xi so
    that it sees about the same field)."""
    from cvids_tpu_torch import camera

    size = dict(width=w, height=h, device=device)
    return {
        "radtan": camera.PinholeCamera.create(focal, focal, w / 2, h / 2,
                                              (-0.28, 0.07, 0.0, 0.0), **size),
        "equidistant": camera.EquidistantCamera.create(
            focal, focal, w / 2, h / 2, (-0.01, 0.02, -0.005, 0.001), **size),
        "mei": camera.MeiCamera.create(0.9, 1.9 * focal, 1.9 * focal, w / 2, h / 2,
                                       (-0.1, 0.05, 0.0, 0.0), **size),
    }


# check (b) of phase 7, in intensity levels of 255 over the image less a
# border of a twelfth of its height: a remapped image is within REMAP_MAX_ERR
# (mean absolute) of the undistorted pinhole's rendering, and the image as it
# came is at least REMAP_MIN_GAIN times further from it
REMAP_MAX_ERR = 2.0
REMAP_MIN_GAIN = 4.0


def remap_checks(device, cams: dict, dense, runs=10) -> dict:
    """Phase 7's two direct checks on every camera of `cams`, through a
    small server on `device` and one on the CPU: (a) the remap grid built on
    the device equals the CPU's to 1e-3 px and lives on the device; (b) an
    image rendered through the distorted camera and remapped by the server
    equals the rendering through the undistorted pinhole of the same K
    within REMAP_MAX_ERR away from the border, and is REMAP_MIN_GAIN times
    further from it without the remap. Returns {name: ms of one
    `bilinear_sample` of a resident image through the grid}."""
    from cvids_tpu_torch import camera, interop
    from cvids_tpu_torch.io import render
    from cvids_tpu_torch.mapping.tsdf import TsdfConfig
    from cvids_tpu_torch.ops.image import bilinear_sample
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.server.pipeline import CollaborativeServer, PipelineConfig
    from cvids_tpu_torch.server.posegraph import ServerConfig

    dev = torch.device(device)
    cfg = PipelineConfig(server=ServerConfig(kf_capacity=16, max_win=8, max_ext=8), dense=dense,
                         tsdf=TsdfConfig(capacity=8))
    tree = vocab.synthesize_tree_vocabulary(4, 2)
    on_dev = CollaborativeServer(tree, cfg, device=dev)
    on_cpu = CollaborativeServer(tree, cfg, device="cpu")
    h, w = dense.height, dense.width
    eye = np.array([1.6, -2.2, 1.2])
    r_wc = look_at(eye, np.array([1.5, 1.0, 0.5]))
    border = (slice(h // 12, -(h // 12)), slice(h // 12, -(h // 12)))
    times = {}
    try:
        for cid, (name, cam) in enumerate(cams.items()):
            t0 = time.perf_counter()
            on_dev.set_client_camera(cid, cam)
            _sync(dev)
            build_ms = (time.perf_counter() - t0) * 1e3
            on_cpu.set_client_camera(cid, cam)
            grid = on_dev._undistort_grid[cid]
            check(grid.device == dev and grid.shape == (h, w, 2),
                  f"{name}: remap grid {tuple(grid.shape)} on {grid.device}")
            gap = float((grid.cpu() - on_cpu._undistort_grid[cid]).abs().max())
            check(gap <= 1e-3, f"{name}: remap grid differs from the CPU's by {gap} px > 1e-3")
            host_cam = interop.camera_to_numpy(cam)
            pin = camera.PinholeCamera.create(float(cam.fx), float(cam.fy), float(cam.cx),
                                              float(cam.cy), width=w, height=h, device="cpu")
            raw, _ = render.render_textured_scene(host_cam, r_wc, eye)
            ideal, _ = render.render_textured_scene(pin, r_wc, eye)
            out = on_dev._undistort(cid, raw)
            check(out.device == dev and out.shape == (h, w), f"{name}: remapped image on {out.device}")
            err = float(np.abs(out.cpu().numpy() - ideal)[border].mean())
            err_raw = float(np.abs(raw - ideal)[border].mean())
            check(err < REMAP_MAX_ERR, f"{name}: remapped image {err} levels from the pinhole's")
            check(err_raw > REMAP_MIN_GAIN * err,
                  f"{name}: without the remap {err_raw} levels, with it {err}: no gain")
            timed = dev.type == "cuda"
            ms = time_ms(lambda: on_dev._undistort(cid, raw), runs) if timed else 0.0
            raw_dev = torch.from_numpy(raw).to(dev)
            ms_dev = time_ms(lambda: bilinear_sample(raw_dev, grid, fill=0.0), runs) if timed else 0.0
            times[name] = ms_dev
            print(f"  {name}: remap grid built in {build_ms:.1f} ms on {dev}, max |card - CPU| "
                  f"{gap:.2e} px (tolerance 1e-3); remapped image {err:.3f} levels from the "
                  f"undistorted pinhole's (bound {REMAP_MAX_ERR}), {err_raw:.3f} without the "
                  f"remap; one _undistort (copy in from pageable memory + bilinear_sample) "
                  f"{ms:.4f} ms between events, bilinear_sample alone on a resident image "
                  f"{ms_dev:.4f} ms")
    finally:
        on_dev.close()
        on_cpu.close()
    return times


DIST_KF = 36                # keyframes per agent of phase 7


def distorted_phase(device, vocabulary, n_kf=DIST_KF, h=H, w=W, focal=FOCAL, dense=None):
    """Phase 7: distorted clients through the whole server. The remap
    checks on a radtan, an equidistant and a Mei camera; then two agents,
    one carrying the radtan pinhole and one the fisheye, whose images are
    rendered through their cameras and whose features are lifted by the
    port's `lift`, stream through `CollaborativeServer` at DenseConfig() and
    TsdfConfig() defaults after `set_client_camera`, and are held to phase
    6's bounds against the undistorted truth. Returns the run's launch
    counts."""
    from cvids_tpu_torch.dense.estimator import DenseConfig
    from cvids_tpu_torch.mapping.tsdf import TsdfConfig
    from cvids_tpu_torch.ops import cuda_kernels as ck
    from cvids_tpu_torch.server.pipeline import PipelineConfig
    from cvids_tpu_torch.server.posegraph import ServerConfig

    dev = torch.device(device)
    cfg = PipelineConfig(server=ServerConfig(), dense=dense or DenseConfig(), tsdf=TsdfConfig())
    cams = distorted_cameras(dev, h, w, focal)
    print(f"phase 7 distorted clients: {', '.join(cams)} cameras at {h}x{w}")
    remap_checks(dev, cams, cfg.dense)
    agents = [cams["radtan"], cams["equidistant"]]
    t0 = time.perf_counter()
    packets, truth, k = scene_stream(len(agents), n_kf, h, w, focal, cams=agents)
    print(f"  {len(packets)} keyframes from {len(agents)} agents (radtan, equidistant), "
          f"{np.median([len(p.win_ids) for p in packets]):.0f} features median, images "
          f"rendered through the distorted cameras in {time.perf_counter() - t0:.1f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    t0 = time.perf_counter()
    server, kf_ms, timer = pipeline_run(dev, packets, vocabulary, k, cfg, cams=agents)
    stream_s = time.perf_counter() - t0
    counts = dict(ck.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else float("nan")
    check(sorted(server._undistort_grid) == [0, 1]
          and all(g.device == dev for g in server._undistort_grid.values()),
          f"remap grids {sorted(server._undistort_grid)} not on {dev}")
    np.testing.assert_array_equal(server._client_k[0], k)
    spans = pipeline_score(server, kf_ms, timer, truth, len(agents), counts, dev, stream_s, peak)
    check(len(spans.get("remap", ())) >= len(packets) - 2 * len(agents),
          f"{len(spans.get('remap', ()))} remaps for {len(packets)} keyframes")
    print("phase 7 distorted clients: ok")
    return counts


def splat_check(device, repeats=10) -> None:
    """`splat_sparse` at the dense path's size with landmarks that share
    pixels (512 on a 16 x 12 lattice) and rejected ones (invalid or outside
    the image): the same bits on every one of `repeats` runs, and the CPU's
    result."""
    from cvids_tpu_torch.dense import estimator

    dev = torch.device(device)
    rng = np.random.default_rng(11)
    cfg = estimator.DenseConfig()
    n = 512
    uv = np.stack([rng.integers(-1, 18, n) * (cfg.width / 16.0) + rng.uniform(-0.4, 0.4, n),
                   rng.integers(-1, 14, n) * (cfg.height / 12.0) + rng.uniform(-0.4, 0.4, n)],
                  -1).astype(np.float32)
    inv = rng.uniform(0.1, 1.2, n).astype(np.float32)
    valid = rng.random(n) > 0.25
    pix = np.round(uv).astype(np.int64)
    ok = valid & (pix[:, 0] >= 0) & (pix[:, 0] < cfg.width) & (pix[:, 1] >= 0) & (pix[:, 1] < cfg.height)
    shared = ok.sum() - len({tuple(p) for p in pix[ok]})
    check(shared >= 50 and (~ok).sum() >= 50,
          f"splat check: {shared} landmarks share a pixel, {(~ok).sum()} are rejected")

    def run(d):
        return estimator.splat_sparse(cfg, *(torch.from_numpy(a).to(d) for a in (uv, inv, valid)))

    first = run(dev)
    for i in range(1, repeats):
        check(torch.equal(run(dev), first), f"splat_sparse: run {i} differs from run 0 on {dev}")
    ref = run("cpu")
    gap = float((first.cpu().float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    check(gap <= 1e-5 * scale, f"splat_sparse on {dev} differs from the CPU's by {gap} (max {scale})")
    print(f"  splat_sparse with {shared} landmarks on shared pixels and {(~ok).sum()} rejected: "
          f"{repeats} runs bit-identical on {dev}, max |card - CPU| {gap:.3g} of {scale:.3g} "
          f"(tolerance 1e-5 relative)")


# ---------------------------------------------------------------------------
# Phase 8: the agents' VIO front-ends on rendered pixels and IMU -> the server
# ---------------------------------------------------------------------------

AGENTS = 2
AGENT_DURATION = 10.0       # s per agent
CAM_RATE, IMU_RATE = 20.0, 200.0
AGENT_LANDMARKS = 1400      # on the room's surfaces
AGENT_WORLD_SEED = 7
# test_full_system.py's room (its box is not default_scene()'s)
AGENT_SCENE = dict(floor_z=0.0, wall_y=3.0, box_lo=np.array([1.9, 0.6, 0.0]),
                   box_hi=np.array([2.9, 1.6, 0.9]))
AGENT_PHOTOMETRIC = dict(flicker=0.15, vignette=0.3, noise_std=1.5, shot_noise=0.3,
                         exposure_time=0.008)
AGENT_SYNC_WINDOW = (40, 80)     # agent 0's frames whose host syncs are counted
AGENT_PROFILE_WINDOW = (80, 90)  # agent 0's frames whose device activities are counted


def agent_config(camera=None, defaults=False):
    """The front-end's `AgentConfig()` defaults (150 features, min_dist 30,
    window 10, 8 solver iterations, 512 loop features) with `equalize` on,
    test_full_system.py's tuning for this rendered world (FAST threshold 12,
    keyframes at up to 2.5 Hz; `defaults` keeps AgentConfig()'s 20 and 10
    Hz) and its IMU noise densities; the EuRoC rig's radtan camera
    `CameraConfig()` unless `camera` is given. With the defaults' threshold
    and keyframe rate the depth maps miss test_full_system.py's RMS bound at
    752x480 (0.28 against 0.12), in the JAX package on the CPU as in the
    port on the card (`PERF.md` §6)."""
    from cvids_tpu_torch.utils.config import AgentConfig, CameraConfig
    from cvids_tpu_torch.vio.imu import ImuNoise

    tuning = {} if defaults else dict(fast_threshold=12.0, keyframe_freq=2.5)
    return AgentConfig(camera=camera or CameraConfig(), equalize=True,
                       imu=ImuNoise(acc_n=0.005, gyr_n=2e-4, acc_w=4e-4, gyr_w=4e-6), **tuning)


def agent_dense(camera) -> "DenseConfig":
    """The dense step at the camera's size with test_full_system.py's
    tuning carried from its 200 px focal to the camera's: the same angular
    step a depth (0.015 x 200 / fx in inverse depth), 128 depths (down to
    ~1.2 m at 461.6 px), measurement variance 0.5 step². With
    `AgentConfig()`'s tuning and `DenseConfig()`'s step (1 / (0.11 x 461))
    the median depth RMS was 0.28, in
    the port on the card and in the JAX package on the CPU on the same
    frames: VIO poses are noisier than phase 6's."""
    from cvids_tpu_torch.dense.estimator import DenseConfig

    return DenseConfig(height=camera.height, width=camera.width, num_depths=128,
                       dep_sample=0.015 * 200.0 / camera.fx, tau2_scale=0.5)


def agent_pipeline_config(camera, dense, async_optimize=False) -> "PipelineConfig":
    """test_full_system.py's server behind the agents: a 256-keyframe
    store, a solve every 20 keyframes, the PnP gate at 10 px, 0.1 m voxels
    without carving, a map from 2 fused frames, the reference advancing
    every 3; `dense` the dense step; with `async_optimize` the solves run
    in the background (test_full_topology.py's server)."""
    from cvids_tpu_torch.mapping.tsdf import TsdfConfig
    from cvids_tpu_torch.server.pipeline import PipelineConfig
    from cvids_tpu_torch.server.posegraph import ServerConfig

    return PipelineConfig(server=ServerConfig(kf_capacity=256, optimize_every=20,
                                              pnp_thresh=10.0 / float(camera.fx),
                                              async_optimize=async_optimize),
                          dense=dense, tsdf=TsdfConfig(voxel_size=0.1, capacity=2048,
                                                       carving=False),
                          min_fused_frames=2, ref_advance=3)


_RENDER = {}     # a render worker's world: camera, landmarks, intensities, extrinsics


def _render_init(camera, landmarks, intens, r_cb, p_bc) -> None:
    from cvids_tpu_torch.camera import make_camera

    torch.set_num_threads(1)
    _RENDER.update(cam=make_camera(camera, device="cpu"), landmarks=landmarks,
                   intens=intens, r_cb=r_cb, p_bc=p_bc)


def _render_frame(pose) -> np.ndarray:
    """One agent frame before its photometric nuisances: the room ray-traced
    through the camera with each landmark's texture splatted on."""
    from cvids_tpu_torch.io import render

    r_wb, p_wb = pose
    w = _RENDER
    base, _ = render.render_textured_scene(w["cam"], r_wb @ w["r_cb"].T, p_wb + r_wb @ w["p_bc"],
                                           AGENT_SCENE)
    return render.render_blobs(w["cam"], w["landmarks"], w["intens"], r_wb, p_wb, w["r_cb"],
                               w["p_bc"], base=base)


def _agent_nuisances(raw, seq, seed, r_cb, fx) -> list[np.ndarray]:
    """One agent's photometric nuisances, frame after frame from one
    generator (auto-exposure flicker with a random walk, vignette, shot and
    read noise, rotational motion blur from the gyro), then the 8-bit
    quantization of a PNG."""
    from cvids_tpu_torch.io import render

    pm, pm_rng, walk, images = AGENT_PHOTOMETRIC, np.random.default_rng(seed + 3301), 0.0, []
    for i, t in enumerate(seq.times_kf):
        walk = 0.9 * walk + pm_rng.normal(0.0, 0.3 * pm["flicker"])
        exposure = 1.0 + pm["flicker"] * np.sin(2.6 * t + 0.7) + walk
        w_c = r_cb @ seq.gyr[int(np.argmin(np.abs(seq.imu_t - t)))]
        img = render.apply_photometric(
            raw[i], pm_rng, exposure=float(np.clip(exposure, 0.3, 3.0)),
            vignette=pm["vignette"], noise_std=pm["noise_std"], shot_noise=pm["shot_noise"],
            blur_px=float(np.hypot(w_c[0], w_c[1]) * pm["exposure_time"] * fx),
            blur_dir=(-w_c[1], w_c[0]))
        images.append(np.clip(img, 0, 255).astype(np.uint8).astype(np.float32))
    return images


_ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def agent_sequences(cfg, n_agents=AGENTS, duration=AGENT_DURATION, n_landmarks=AGENT_LANDMARKS,
                    seed=0, workers=8):
    """Each agent's sequence as `io/euroc_synth.write_euroc_sequence` renders
    it for test_full_system.py, in memory: a speed-modulated circle (radius
    1.5 m, phases 0 and 0.45), exact IMU at IMU_RATE with noise and bias,
    frames at CAM_RATE ray-traced in the room through the agent's camera
    (distortion and all) with each landmark's texture splatted on, the
    photometric nuisances (flicker, vignette, noise, rotational blur), and
    the 8-bit quantization of a PNG. `seed` moves every draw (the world,
    the IMU noise and biases' walk, the nuisances; 0 is phase 8's), and
    `workers` render processes share the frames. Returns per agent a dict
    of cam_t, images, imu_t, gyr, acc and the ground truth gt_t, gt_p,
    gt_q, gt_v and the true biases bg, ba."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from cvids_tpu_torch.geometry.hostmath import quat_to_matrix_np
    from cvids_tpu_torch.io import render, synthetic

    r_cb = np.asarray(cfg.r_cb, np.float64)
    p_bc = np.asarray(cfg.p_bc, np.float64)
    rng = np.random.default_rng(AGENT_WORLD_SEED + 77 + 1000 * seed)
    landmarks = render.sample_scene_landmarks(n_landmarks, rng, AGENT_SCENE)
    intens = rng.uniform(80, 200, n_landmarks)
    seqs, poses = [], []
    for cid in range(n_agents):
        traj = synthetic.Trajectory.circle(radius=1.5, omega=0.5, height_amp=0.15,
                                           phase=(0.0, 0.45)[cid % 2] + 0.9 * (cid // 2),
                                           center=(0.0, 0.0, 1.3), speed_mod=0.3,
                                           speed_mod_freq=0.9)
        seq = synthetic.generate_sequence(traj, duration=duration, kf_rate=CAM_RATE,
                                          imu_rate=IMU_RATE, num_landmarks=0, seed=21 + cid + 1000 * seed,
                                          gyr_noise=2e-4, acc_noise=0.005,
                                          bg=(0.001, -0.001, 0.0005), ba=(0.005, -0.01, 0.02))
        seqs.append(seq)
        poses += [(quat_to_matrix_np(q.astype(np.float32)).astype(np.float32), p)
                  for q, p in zip(seq.q_gt, seq.p_gt)]
    # the frames in worker processes (spawned: this process holds a CUDA
    # context; one BLAS thread each), then each agent's photometric
    # nuisances in order, one worker an agent
    saved = {k: os.environ.get(k) for k in _ONE_THREAD}
    os.environ.update(_ONE_THREAD)
    try:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                 initializer=_render_init,
                                 initargs=(cfg.camera, landmarks, intens, r_cb, p_bc)) as ex:
            raw = list(ex.map(_render_frame, poses, chunksize=8))
            starts = np.cumsum([0] + [len(s.times_kf) for s in seqs])
            jobs = [ex.submit(_agent_nuisances, raw[starts[c]:starts[c + 1]], seqs[c],
                              21 + c + 1000 * seed,
                              r_cb, float(cfg.camera.fx)) for c in range(n_agents)]
            images = [j.result() for j in jobs]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return [dict(cam_t=s.times_kf, images=im, imu_t=s.imu_t, gyr=s.gyr, acc=s.acc,
                 gt_t=s.times_kf, gt_p=s.p_gt, gt_q=s.q_gt, gt_v=s.v_gt, bg=s.bg_true,
                 ba=s.ba_true) for s, im in zip(seqs, images)]


def agents_run(device, seqs, cfg, setup=None):
    """Every frame of every agent through its own `AgentFrontend` on
    `device`, agent after agent, as test_full_system.py feeds them (the IMU
    since the previous frame; the first frame the accelerometer of the 0.1 s
    before it). Returns (front-ends, packets per agent, per-frame rows
    (agent, frame, keyframe?, host ms with the device synced), the tracer,
    host syncs per frame over AGENT_SYNC_WINDOW, and agent 0's profiled
    frames: (device activities, device ms, wall ms) each). `setup`, if
    given, gets the list of front-ends before the first frame."""
    from cvids_tpu_torch.utils.tracing import Tracer
    from cvids_tpu_torch.vio.frontend import AgentFrontend

    dev = torch.device(device)
    tracer = Tracer()
    fes = [AgentFrontend(cfg, cid, device=dev, tracer=tracer) for cid in range(len(seqs))]
    if setup is not None:
        setup(fes)
    packets, rows, syncs, profiled = [[] for _ in seqs], [], float("nan"), []
    on_card = dev.type == "cuda"
    for cid, (seq, fe) in enumerate(zip(seqs, fes)):
        prev_t, counter = None, None
        for fi, t in enumerate(seq["cam_t"]):
            if prev_t is None:
                sel = (seq["imu_t"] >= t - 0.1) & (seq["imu_t"] < t)
                args = (np.zeros((0, 3)), seq["acc"][sel], np.zeros(0))
            else:
                sel = (seq["imu_t"] >= prev_t) & (seq["imu_t"] < t)
                ts = seq["imu_t"][sel]
                args = (seq["gyr"][sel], seq["acc"][sel], np.diff(np.append(ts, t)))
            prev_t = t
            if on_card and cid == 0 and fi == AGENT_SYNC_WINDOW[0]:
                counter = SyncCounter().__enter__()
            kf0 = fe.kf_count
            call = lambda: fe.process_frame(t, seq["images"][fi], *args)   # noqa: E731
            if on_card and cid == 0 and AGENT_PROFILE_WINDOW[0] <= fi < AGENT_PROFILE_WINDOW[1]:
                out = []
                wall, acts = profile_frame(lambda: out.append(call()))
                pkt = out[0]
                profiled.append((sum(a[2] for a in acts), sum(a[1] for a in acts), wall))
                ms = wall
            else:
                t0 = time.perf_counter()
                pkt = call()
                _sync(dev)
                ms = (time.perf_counter() - t0) * 1e3
            if counter is not None and fi == AGENT_SYNC_WINDOW[1] - 1:
                counter.__exit__(None, None, None)
                syncs, counter = counter.count / (AGENT_SYNC_WINDOW[1] - AGENT_SYNC_WINDOW[0]), None
            rows.append((cid, fi, fe.kf_count > kf0, ms))
            if pkt is not None:
                packets[cid].append(pkt)
        if counter is not None:
            counter.__exit__(None, None, None)
    return fes, packets, rows, tracer, syncs, profiled


def frame_imu(seq, fi):
    """(gyro, accelerometer, dts) that frame `fi` of an agent sequence
    (`agent_sequences`) brings, as `agents_run` feeds it."""
    t0, t1 = seq["cam_t"][fi - 1], seq["cam_t"][fi]
    sel = (seq["imu_t"] >= t0) & (seq["imu_t"] < t1)
    return seq["gyr"][sel], seq["acc"][sel], np.diff(np.append(seq["imu_t"][sel], t1))


def track_launch_checks(fes, counts, what) -> None:
    """The tracker ran once a tracked frame: its launches equal the track
    graphs' replays (one a tracked frame) plus their captures' warm-up
    calls, summed over the front-ends `fes`."""
    calls = sum(fe._track.replays for fe in fes)
    warm = sum(fe._track.captures for fe in fes)
    check(calls > 0 and counts["klt_track"] == calls + warm,
          f"{what}: {counts['klt_track']} klt_track launches for {calls} tracked frames and "
          f"{warm} captures")
    print(f"  {what}: klt_track launched {counts['klt_track']} times: once in each of the "
          f"{calls} tracked frames' track graphs and once in each of {warm} captures' warm-up")


def solve_launch_checks(fes, counts, what) -> None:
    """The window kernel ran once a solve: its launches equal the solve
    graphs' replays plus their captures' warm-up calls, summed over the
    front-ends `fes`."""
    calls = sum(fe._solve_fast.replays for fe in fes)
    warm = sum(fe._solve_fast.captures for fe in fes)
    check(calls > 0 and counts["window_lm"] == calls + warm,
          f"{what}: {counts['window_lm']} window_lm launches for {calls} solves and {warm} "
          f"captures")
    print(f"  {what}: window_lm launched {counts['window_lm']} times: once in each of the "
          f"{calls} solve graphs' replays and once in each of {warm} captures' warm-up")


def graph_checks(fe, img0, img1, imu) -> None:
    """The front-end's CUDA graphs, each of which must have been captured and
    replayed in the run, against the eager calls on the same inputs: the
    track step (KLT, lifts, F-RANSAC, its gate) on the frames img0 -> img1,
    the re-detection and the packet's image program on img1, one
    preintegration of `imu` (gyro, accelerometer, dts), the window solve and
    the marginalization's Schur complement on the final window. The same
    kernels in the same order: the same bits (checked to 1e-6 relative,
    integers exactly, and the largest difference printed). Each eager call
    runs under torch's sync debug mode "error": none reads a value back to
    the host (fundamental_ransac, FAST, BRIEF and the blur included). The
    eager track step's small_eig and klt_track calls and the eager solve's
    window_lm call are held to the twins."""
    from torch.utils import _pytree as pytree

    from cvids_tpu_torch.vio import frontend, window_ba

    calls = {"track": fe._track, "detect": fe._redetect_call, "describe": fe._describe,
             "preintegrate": fe._preint, "solve": fe._solve_fast, "marginalize": fe._marg}
    ran = {n: (len(c.graphs), c.replays) for n, c in calls.items()}
    check(all(g and r for g, r in ran.values()),
          f"a front-end program was not captured and replayed as a CUDA graph: {ran}")
    cfg, mf, thr = fe.cfg, fe.MAX_FEAT, float(fe.cfg.fast_threshold)
    a0, a1 = (fe._t(fe._preprocess(i)) for i in (img0, img1))
    buf = np.zeros((fe.MAX_IMU, 8), np.float32)
    n = min(len(imu[0]), fe.MAX_IMU)
    buf[:n, 0:3], buf[:n, 3:6], buf[:n, 6], buf[:n, 7] = imu[0][:n], imu[1][:n], imu[2][:n], 1.0
    meas = fe._build_meas()
    dying = fe._t(fe.vis[0] & ~fe.vis[1:].any(axis=0), torch.bool)
    progs = {
        "track": (frontend._track_step, (
            a0, a1, fe._stage("track", fe._feats(fe.feat_xy)), fe._stage("noise", fe._gumbel(mf)),
            fe.cam, 1.5, (3.0 / fe._fx) ** 2)),
        "detect": (frontend._redetect_step, (a1, fe._stage("detect", fe._feats()), thr, mf,
                                             cfg.min_feature_dist, float(cfg.min_feature_dist))),
        "describe": (frontend._describe_step, (a1, fe._stage("describe", fe.feat_xy), fe.cam, thr,
                                               fe._max_ext, fe._cell)),
        "preintegrate": (frontend._preintegrate_step, (fe._stage("imu", buf), fe.state.bg[0],
                                                       fe.state.ba[0], cfg.imu)),
        "solve": (frontend._solve_window_fast, (fe.state, meas, cfg.max_solver_iterations)),
        "marginalize": (window_ba.marg_schur_cam, (fe.state, meas, dying)),
    }
    rec = KernelRecorder(RANSAC_KERNELS + FRONTEND_KERNELS, calls=None)
    diffs = {}
    for name, (fn, args) in progs.items():
        graphed = calls[name](*args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with rec if name in ("track", "solve") else contextlib.nullcontext():
                eager = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for i, (a, b) in enumerate(zip(pytree.tree_leaves(graphed), pytree.tree_leaves(eager))):
            if a.is_floating_point():
                a, b = a.float(), b.float()
                d = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) if a.numel() else 0.0
            else:
                d = 0.0 if torch.equal(a, b) else float("inf")
            diffs[f"{name} output {i}"] = d
    worst = max(diffs, key=diffs.get)
    check(diffs[worst] <= 1e-6, f"graph replay differs from the eager call: {diffs}")
    compared = rec.compare()
    check(compared.get("small_eig", 0) >= 2 and compared.get("klt_track", 0) == 1
          and compared.get("window_lm", 0) == 1,
          f"the track step's small_eig and klt_track calls and the solve's window_lm {compared}")
    print(f"  CUDA graphs (captured, replays) in the run: {ran}; each replayed against its "
          f"eager call: largest relative difference {diffs[worst]:.3g} ({worst}; tolerance "
          f"1e-6); every eager call, fundamental_ransac, FAST, BRIEF and the blur included, "
          f"ran under sync debug mode \"error\": no host sync")


def agents_score(server, seqs, cfg, dense_h, dense_w, n_agents):
    """Scores the server fed by the agents as test_full_system.py does:
    (ATE sim3 per agent in m, inverse-depth RMS per scored map, overlaps,
    mesh median scene distance in m, triangles)."""
    import tempfile

    from cvids_tpu_torch.camera import PinholeCamera
    from cvids_tpu_torch.geometry.hostmath import quat_to_matrix_np
    from cvids_tpu_torch.io import render
    from cvids_tpu_torch.mapping.mesh import read_ply
    from cvids_tpu_torch.utils.metrics import ate_rmse, umeyama

    ates = []
    for cid in range(n_agents):
        tr = server.trajectory(cid)
        gt_p = np.stack([np.interp(tr[:, 0], seqs[cid]["gt_t"], seqs[cid]["gt_p"][:, k])
                         for k in range(3)], -1)
        ates.append(ate_rmse(tr[:, 1:4], gt_p, "sim3"))
    c = cfg.camera
    pin = PinholeCamera.create(c.fx, c.fy, c.cx, c.cy, (0, 0, 0, 0), dense_w, dense_h,
                               device="cpu")
    r_cb = np.asarray(cfg.r_cb, np.float64)
    p_bc = np.asarray(cfg.p_bc, np.float64)
    st = server.graph.store
    rmses, overlaps = [], []
    for rec in server.depth_records:
        seq = seqs[rec["client"]]
        gi = int(np.argmin(np.abs(seq["gt_t"] - float(st.timestamp[rec["ref_index"]]))))
        r_wb = quat_to_matrix_np(seq["gt_q"][gi])
        _, depth_gt = render.render_textured_scene(pin, r_wb @ r_cb.T, seq["gt_p"][gi] + r_wb @ p_bc,
                                                   AGENT_SCENE)
        est = rec["depth"]
        both = (est > 0) & (depth_gt > 0.2) & (depth_gt < 6.0)
        overlaps.append(float(both.mean()))
        if both.mean() >= 0.02:
            rmses.append(float(np.sqrt(np.mean((1.0 / est[both] - 1.0 / depth_gt[both]) ** 2))))
    with tempfile.TemporaryDirectory() as tmp:
        n_tri = server.save_mesh(f"{tmp}/scene.ply")
        verts, _, _ = read_ply(f"{tmp}/scene.ply")
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    tr0 = server.trajectory(0)
    gt0 = np.stack([np.interp(tr0[:, 0], seqs[0]["gt_t"], seqs[0]["gt_p"][:, k])
                    for k in range(3)], -1)
    _, r_al, t_al = umeyama(tr0[:, 1:4], gt0)
    dist = (float(np.median(scene_distance(verts @ r_al.T + t_al, AGENT_SCENE)))
            if len(verts) else float("inf"))
    return ates, rmses, overlaps, dist, n_tri


def vio_ate_cm(times, positions, seq) -> float:
    """ATE sim3 (cm) of an agent's own keyframe poses as its packets carry
    them (the front-end's VIO, before the server's loops and solves)
    against the sequence's ground truth: what the server's ATE starts
    from (ROADMAP F8)."""
    from cvids_tpu_torch.utils.metrics import ate_rmse

    t = np.asarray(times, np.float64)
    gt_p = np.stack([np.interp(t, seq["gt_t"], seq["gt_p"][:, k]) for k in range(3)], -1)
    return ate_rmse(np.asarray(positions, np.float64), gt_p, "sim3") * 100


def _ms_stats(v) -> str:
    v = np.asarray(v, np.float64)
    return (f"median {np.median(v):.3f} p90 {np.percentile(v, 90):.3f} (n {len(v)})"
            if len(v) else "none")


def agents_phase(device, n_agents=AGENTS, duration=AGENT_DURATION, camera=None,
                 dense=None, vocab_shape=(10, 4)):
    """Phase 8: two agents' front-ends on rendered pixels and IMU into the
    whole server. Each agent (EuRoC rig: 752x480 radtan, `agent_config()`)
    tracks every 20 Hz frame of its ~10 s sequence on `device` (KLT and the
    window solve replayed as CUDA graphs on the card, held to the eager
    calls by `graph_checks`); the packets,
    in time order, go through `CollaborativeServer` with the held-out
    `generic_vocabulary(10, 4)`, each client's radtan camera through
    `set_client_camera`, dense depth at the image size (`agent_dense`) and
    test_full_system.py's TSDF settings. Checks test_full_system.py's bounds:
    both agents VI-initialized with >= 8 packets, both clients aligned, >= 1
    loop, ATE sim3 < 10 cm, median inverse-depth RMS < 0.12, mesh median
    scene distance < 0.15 m; every kernel launched but the banded warp,
    whose host gate these keyframes' rotations exceed; on the card four loop-verification
    cascades rerun eagerly through the kernels, equal to their graph's
    outputs, each kernel call equal to the twin's on its inputs
    (`CascadeRecorder`), and two graphed dense frames rerun eagerly through
    the kernels and the twins (`FrameRecorder`); an `AgentFrontend`
    built with no device on the card. `camera` and `dense` replace the
    EuRoC camera and the dense size for a rehearsal on the CPU. Returns the
    server run's launch counts, the sequences and the scores (ATE cm per
    agent, median inverse-depth RMS, mesh distance m)."""
    from cvids_tpu_torch.ops import cuda_kernels as ck
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.server.pipeline import CollaborativeServer
    from cvids_tpu_torch.vio.frontend import AgentFrontend

    dev = torch.device(device)
    cfg = agent_config(camera)
    c = cfg.camera
    t0 = time.perf_counter()
    seqs = agent_sequences(cfg, n_agents, duration)
    print(f"phase 8 agents: {n_agents} agents x {len(seqs[0]['cam_t'])} frames of "
          f"{c.width}x{c.height} ({c.model}, k1 {c.k1}) at {CAM_RATE:.0f} Hz, IMU at "
          f"{IMU_RATE:.0f} Hz, rendered in {time.perf_counter() - t0:.1f} s")
    if dev.type == "cuda":
        fe = AgentFrontend(cfg)
        check(fe.device == dev and fe.state.lm.device == dev and fe.cam.fx.device == dev,
              f"an AgentFrontend built with no device is on {fe.device}, not {dev}")
        print(f"  an AgentFrontend built with no device argument: state and camera on {fe.device}")
        torch.cuda.reset_peak_memory_stats()

    ck.reset_launches()
    t0 = time.perf_counter()
    once = {}
    fes, packets, rows, tracer, syncs, profiled = agents_run(
        dev, seqs, cfg, setup=lambda f: once.update(record_once_programs(f[0])))
    fe_s = time.perf_counter() - t0
    fe_counts = dict(ck.launches)
    peak_fe = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else float("nan")
    frame_ms = [r[3] for r in rows if not r[2]]
    kf_ms = [r[3] for r in rows if r[2]]
    n_pk = [len(p) for p in packets]
    print(f"  front-ends: {len(rows)} frames in {fe_s:.1f} s ({sum(frame_ms) / 1e3:.1f} s in "
          f"plain frames, {sum(kf_ms) / 1e3:.1f} s in keyframes); host ms per frame (device "
          f"synced after each) {_ms_stats(frame_ms)}; per keyframe {_ms_stats(kf_ms)}; "
          f"keyframes {[f.kf_count for f in fes]}, packets {n_pk}; peak device memory "
          f"{peak_fe:.2f} GiB")
    print("  front-end spans, host ms: " + "; ".join(
        f"{name} {_ms_stats(np.asarray(v) * 1e3)}" for name, v in tracer.samples.items()))
    if profiled:
        acts = [p[0] for p in profiled]
        busy = [p[1] for p in profiled]
        wall = [p[2] for p in profiled]
        print(f"  agent 0 frames {AGENT_PROFILE_WINDOW[0]}-{AGENT_PROFILE_WINDOW[1] - 1} "
              f"profiled: device activities per frame {acts}; device busy ms "
              f"{[round(b, 3) for b in busy]}; wall ms {[round(w, 1) for w in wall]}; busy "
              f"share {sum(busy) / sum(wall):.3f}")
    print(f"  host syncs per frame (agent 0 frames {AGENT_SYNC_WINDOW[0]}-"
          f"{AGENT_SYNC_WINDOW[1] - 1}): {syncs:.1f}; track stats {fes[0].track_stats}")
    print(f"  front-ends' kernel launches (graph replays count their kernels): {fe_counts}")
    tracked = sum(fe._track.replays for fe in fes)      # before graph_checks' replay
    solves = sum(fe._solve_fast.replays + fe._solve_fast.captures for fe in fes)
    if dev.type == "cuda":
        check(all(fe_counts[n] > 0 for n in RANSAC_KERNELS + FRONTEND_KERNELS),
              f"a kernel of the front-ends did not run: {fe_counts}")
        track_launch_checks(fes, fe_counts, "phase 8")
        solve_launch_checks(fes, fe_counts, "phase 8")
        graph_checks(fes[0], seqs[0]["images"][-2], seqs[0]["images"][-1],
                     frame_imu(seqs[0], len(seqs[0]["cam_t"]) - 1))
    check(all(f.vi_initialized for f in fes), "an agent never VI-initialized")
    check(min(n_pk) >= 8, f"packets per agent {n_pk}: fewer than 8")

    dense = dense or agent_dense(c)
    pcfg = agent_pipeline_config(c, dense)
    t0 = time.perf_counter()
    tree = vocab.generic_vocabulary(*vocab_shape, device=dev)
    voc_s = time.perf_counter() - t0
    server = CollaborativeServer(tree, pcfg, device=dev)
    for cid, fe in enumerate(fes):
        server.set_client_camera(cid, fe.cam)
    merged = sorted([p for pk in packets for p in pk], key=lambda p: p.timestamp)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    kf_ms_srv = []
    on_card = dev.type == "cuda"
    recorder = CascadeRecorder() if on_card else contextlib.nullcontext()
    frames = FrameRecorder() if on_card else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with recorder, frames:
            for p in merged:
                t1 = time.perf_counter()
                server.submit(p)
                server.process()
                kf_ms_srv.append((time.perf_counter() - t1) * 1e3)
            server.optimize()
            _sync(dev)
    finally:
        server.close()
    srv_s = time.perf_counter() - t0
    counts = dict(ck.launches)
    if on_card:
        recorded_checks(recorder, frames, counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else float("nan")
    ates, rmses, overlaps, dist, n_tri = agents_score(server, seqs, cfg, dense.height,
                                                      dense.width, n_agents)
    med_rms = float(np.median(rmses)) if rmses else float("inf")
    g = server.graph
    spans = {name: np.asarray(v) * 1e3 for name, v in server.tracer.samples.items()}
    print(f"  server: generic_vocabulary{vocab_shape} in {voc_s:.1f} s; {len(merged)} "
          f"packets in {srv_s:.2f} s, host ms per keyframe {_ms_stats(kf_ms_srv)}; peak "
          f"device memory {peak:.2f} GiB")
    print("  server spans, host ms: " + "; ".join(f"{n} {_ms_stats(v)}" for n, v in spans.items()))
    print(f"  aligned {[cl.aligned for cl in g.clients[:n_agents]]}; loops {g.loop_count}; "
          f"ATE sim3 cm {[round(a * 100, 2) for a in ates]}; depth maps "
          f"{server.depth_maps_published}, inverse-depth RMS median {med_rms:.4f} over "
          f"{len(rmses)} maps (overlap max {max(overlaps, default=0):.3f}); mesh {n_tri} "
          f"triangles, median scene distance {dist:.4f} m; launches {counts}")
    vio = [round(vio_ate_cm([p.timestamp for p in pk], [p.p_wb for p in pk], seq), 2)
           for pk, seq in zip(packets, seqs)]
    print(f"  scores against test_full_system.py's bounds: packets {n_pk} (>= 8 each), loops "
          f"{g.loop_count} (>= 1), aligned {[cl.aligned for cl in g.clients[:n_agents]]}, ATE "
          f"sim3 cm {[round(a * 100, 2) for a in ates]} (< 10; the agents' own VIO poses "
          f"{vio}), inverse-depth RMS median {med_rms:.4f} (< 0.12), mesh median scene "
          f"distance {dist:.4f} m (< 0.15)")
    check(g.loop_count >= 1, "no loop closure between the agents")
    check(all(cl.aligned for cl in g.clients[:n_agents]), "a client never aligned")
    check(all(a < 0.10 for a in ates), f"ATE sim3 {ates} m: not all < 0.10 (the agents' own "
                                       f"VIO poses {vio} cm; ROADMAP F8)")
    check(len(rmses) >= 2 and med_rms < 0.12, f"median inverse-depth RMS {med_rms} ({rmses})")
    check(dist < 0.15, f"mesh median scene distance {dist} m >= 0.15")
    if dev.type == "cuda":
        # the banded warp runs only where the host gate passes: keyframes
        # 0.4 s apart on this circle rotate by ~11 degrees, ~90 px at 461.6
        # px, beyond the band (88 px), so the exact warp takes every frame
        gated = ("warp_banded",)
        check(all(counts[n] > 0 for n in DENSE_KERNELS + SERVER_KERNELS if n not in gated),
              f"a kernel did not run in phase 8: {counts}")
        print(f"  launches: every kernel of the path ran; the banded warp {counts['warp_banded']} "
              f"times (its host gate)")
    print("phase 8 agents: ok")
    return counts, seqs, {"ate_cm": [a * 100 for a in ates], "rms": med_rms, "mesh_m": dist,
                          "frontend_launches": fe_counts, "frames": len(rows),
                          "tracked_frames": tracked, "solves": solves,
                          "keyframes": sum(f.kf_count for f in fes), "once": once}


# ---------------------------------------------------------------------------
# Phase 9: the deployment topology: agent processes -> sockets -> the server
# ---------------------------------------------------------------------------

TOPOLOGY_DRAIN_S = 600.0    # the longest wait for the agents' streams to drain


def write_sequences(seqs, cfg, root, exact=True) -> list[str]:
    """Phase 8's sequences as EuRoC-format directories through the port's
    writer (8-bit PNG frames, nanosecond CSVs, sensor.yaml with `cfg`'s
    calibration and tuning), each read back through `load_euroc` and
    `load_image`: the frames equal phase 8's bit for bit, and with `exact`
    (IMU values with 17 significant digits, as EuRoC's own files carry
    them) the IMU too. Returns the roots."""
    from cvids_tpu_torch.io import euroc, euroc_synth

    roots = []
    for cid, seq in enumerate(seqs):
        r = euroc_synth.write_sequence_files(
            os.path.join(root, f"agent{cid}"), cfg, [im.astype(np.uint8) for im in seq["images"]],
            seq["cam_t"], seq["imu_t"], seq["gyr"], seq["acc"],
            dict(p=seq["gt_p"], q=seq["gt_q"], v=seq["gt_v"], bg=seq["bg"], ba=seq["ba"]),
            CAM_RATE, IMU_RATE, gyr_noise=2e-4, acc_noise=0.005, exact=exact)
        back = euroc.load_euroc(r)
        check(len(back.cam_t) == len(seq["images"])
              and all(np.array_equal(back.load_image(i), im) for i, im in enumerate(seq["images"])),
              f"agent {cid}: the frames read back from the PNGs differ from phase 8's")
        check(not exact or (np.array_equal(back.gyr, seq["gyr"])
                            and np.array_equal(back.acc, seq["acc"])),
              f"agent {cid}: the IMU read back differs from phase 8's")
        roots.append(r)
    return roots


def config_differences(loaded, cfg) -> dict:
    """The fields of two `AgentConfig`s that differ, as {name: (a, b)}."""
    import dataclasses

    a, b = dataclasses.asdict(loaded), dataclasses.asdict(cfg)
    out = {}
    for k in a:
        if isinstance(a[k], dict):
            out.update({f"{k}.{f}": (a[k][f], b[k][f]) for f in a[k] if a[k][f] != b[k][f]})
        elif a[k] != b[k]:
            out[k] = (a[k], b[k])
    return out


def same_codec_dicts(a: dict, b: dict) -> bool:
    """Two codec dicts with the same fields, dtypes, shapes and bytes."""
    return sorted(a) == sorted(b) and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.asarray(a[k]).shape == np.asarray(b[k]).shape
        and np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


def saved_tracker(path: str) -> dict | None:
    """What an agent process (`apps.agent_process.run_agent`) saved of its
    tracker and window solver: its klt_track launches, the track graph's
    replays (one a tracked frame) and captures, and the same of window_lm
    and the solve graph (None where a package saved none of them: an
    earlier tree under a probe's `--package`)."""
    keys = ("klt_launches", "track_replays", "track_captures")
    solver = ("wlm_launches", "solve_replays", "solve_captures")
    with np.load(path, allow_pickle=False) as z:
        if not all(k in z.files for k in keys):
            return None
        return {k: int(z[k]) if k in z.files else None for k in keys + solver}


def topology_run(device, roots, cfg, dense, vocab_shape=(10, 4), drain_s=None):
    """One run of the deployment graph on the sequences at `roots`: a
    `CollaborativeServer` with background solves (`agent_pipeline_config(
    async_optimize=True)`, `cfg`'s camera for every client) behind
    `CollaborativeSocketServer(match_tol=1e-3)`, and one spawned agent
    process a root (`apps.agent_process`; on the card with no device
    argument, so the default device). Waits for the stream to drain, and
    fails at once if an agent process dies or the ingest thread raises; then
    a final solve (`flush`). On the card `CascadeRecorder` keeps four of the
    loop-verification cascades and `FrameRecorder` two graphed dense frames.
    Returns a dict: server, transport, sent / frame_ms / keyframe / tracker
    per agent (what each saved; tracker: its klt_track launches, track
    graph replays and captures), received (the codec dicts the server was given, per
    client), order (the client of each ingested packet), process_ms,
    stream_s, launches, recorders (the two, on the card) and peak (GiB,
    this process)."""
    import multiprocessing

    from cvids_tpu_torch import _build, native
    from cvids_tpu_torch.apps import agent_process
    from cvids_tpu_torch.camera import make_camera
    from cvids_tpu_torch.io import codec, transport
    from cvids_tpu_torch.ops import cuda_kernels as ck
    from cvids_tpu_torch.server import vocab
    from cvids_tpu_torch.server.pipeline import CollaborativeServer

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    n_agents = len(roots)
    c = cfg.camera
    drain_s = drain_s or TOPOLOGY_DRAIN_S
    # the parent builds what the server loads before any process starts
    if on_card:
        _build.build()
    check(native.available(), "the native host library (max clique) did not build")
    server = CollaborativeServer(vocab.generic_vocabulary(*vocab_shape, device=dev),
                                 agent_pipeline_config(c, dense, async_optimize=True), device=dev)
    for cid in range(n_agents):
        server.set_client_camera(cid, make_camera(c, device=dev))
    received = {cid: [] for cid in range(n_agents)}
    order, process_ms = [], []
    submit, process = server.submit, server.process

    def recording_submit(pkt):
        received[int(pkt.client_id)].append(codec.encode_packet(pkt))
        order.append(int(pkt.client_id))
        submit(pkt)

    def timed_process():
        t1 = time.perf_counter()
        n = process()
        process_ms.append((time.perf_counter() - t1) * 1e3)
        return n

    server.submit, server.process = recording_submit, timed_process
    outs = [os.path.join(os.path.dirname(roots[cid]), f"sent{cid}.npz") for cid in range(n_agents)]
    ctx = multiprocessing.get_context("spawn")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    recorder = CascadeRecorder() if on_card else contextlib.nullcontext()
    frames = FrameRecorder() if on_card else contextlib.nullcontext()
    srv = transport.CollaborativeSocketServer(server, match_tol=1e-3)
    # on the card the agents take the default device (no device argument);
    # a CPU rehearsal runs them on one intra-op thread each
    procs = [ctx.Process(target=agent_process.agent_main,
                         args=(roots[cid], cid, srv.port, outs[cid]) if on_card
                         else (roots[cid], cid, srv.port, outs[cid], "cpu", 1))
             for cid in range(n_agents)]
    t0 = time.perf_counter()
    try:
        with recorder, frames:
            for p in procs:
                p.start()
            while not srv.drain(timeout=1.0, min_conns=n_agents):
                dead = [(cid, p.exitcode) for cid, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                check(not dead, f"agent process(es) (client, exit code) {dead} died before the "
                                "stream drained")
                check(time.perf_counter() - t0 < drain_s,
                      f"the agents' streams did not drain in {drain_s:.0f} s")
            stream_s = time.perf_counter() - t0
            for p in procs:
                p.join(timeout=60.0)
            codes = [p.exitcode for p in procs]
            check(codes == [0] * n_agents, f"agent process exit codes {codes}")
            server.graph.flush()
            _sync(dev)
    finally:
        try:
            srv.stop()
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10.0)
            server.close()
    counts = dict(ck.launches)
    sent, frame_ms, keyframe = zip(*(agent_process.load_sent(out) for out in outs))
    return dict(server=server, transport=srv, sent=sent, frame_ms=frame_ms, keyframe=keyframe,
                tracker=[saved_tracker(out) for out in outs],
                received=received, order=order, process_ms=process_ms, stream_s=stream_s,
                launches=counts, recorders=(recorder, frames),
                peak=torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan"))


def topology_score(server, roots, cfg, dense) -> dict:
    """test_full_topology.py's figures of a run against the written ground
    truth: ATE sim3 per agent (m), the median inverse-depth RMS, the mesh
    (triangles, vertices, all finite, median scene distance m)."""
    from cvids_tpu_torch.io import euroc
    from cvids_tpu_torch.mapping.mesh import read_ply

    truth = [euroc.load_euroc(r) for r in roots]
    ates, rmses, _, dist, n_tri = agents_score(
        server, [dict(gt_t=t.gt_t, gt_p=t.gt_p, gt_q=t.gt_q) for t in truth], cfg, dense.height,
        dense.width, len(roots))
    mesh_path = os.path.join(os.path.dirname(roots[0]), "scene.ply")
    server.save_mesh(mesh_path)
    verts = np.asarray(read_ply(mesh_path)[0], np.float64).reshape(-1, 3)
    return dict(ates=ates, rms=float(np.median(rmses)) if rmses else float("inf"), mesh_m=dist,
                triangles=n_tri, vertices=len(verts), finite=bool(np.isfinite(verts).all()))


def topology_phase(device, seqs, phase8, root, camera=None, dense=None, vocab_shape=(10, 4)):
    """Phase 9: the reference's deployment graph (test_full_topology.py) at
    EuRoC's size. Phase 8's two sequences are written as EuRoC-format
    directories under `root` and read back (`write_sequences`), then
    `topology_run`: two spawned agent processes stream their packets over
    TCP into the server with background solves. Checks: both agents exit 0,
    the stream drains, every packet each agent sent arrived equal (codec
    dict, bit for bit, image included) with nothing dropped,
    test_full_topology.py's bounds (a background solve, a loop, both
    aligned, ATE sim3 < 10 cm against the written ground truth, >= 2 depth
    maps, a mesh of > 300 finite vertices), and calls 0, 1, 30 and 31 of
    each kernel equal to the twins. `camera`, `dense` and `vocab_shape` as
    for `agents_phase` (a CPU rehearsal passes phase 8's; there the agents
    run on the CPU too and no kernel is held). Returns (server, roots,
    launches)."""
    from cvids_tpu_torch.io import euroc

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    cfg = agent_config(camera)
    n_agents = len(seqs)
    roots = write_sequences(seqs, cfg, root)
    loaded = euroc.load_agent_config(roots[0])
    print(f"phase 9 topology: {n_agents} EuRoC-format sequences of {len(seqs[0]['cam_t'])} PNG "
          f"frames written and read back in {time.perf_counter() - t_phase:.1f} s, equal to "
          f"phase 8's bit for bit; AgentConfig fields where load_agent_config differs from "
          f"agent_config(): {config_differences(loaded, cfg) or 'none'}")
    dense = dense or agent_dense(cfg.camera)
    run = topology_run(dev, roots, cfg, dense, vocab_shape)
    server, srv, counts = run["server"], run["transport"], run["launches"]
    if on_card:
        recorded_checks(*run["recorders"], counts)
    for cid in range(n_agents):
        sent, got = run["sent"][cid], run["received"][cid]
        frame_ms, is_kf = run["frame_ms"][cid], run["keyframe"][cid]
        check(len(sent) == len(got) >= 8, f"agent {cid}: {len(sent)} packets sent, {len(got)} "
                                          "arrived (>= 8 needed)")
        bad = [i for i, (a, b) in enumerate(zip(sent, got)) if not same_codec_dicts(a, b)]
        check(not bad, f"agent {cid}: packets {bad} arrived different from what was sent")
        print(f"  agent {cid} (own process, two on one card): {len(frame_ms)} frames, "
              f"{len(sent)} packets sent and received equal field by field, image included; "
              f"host ms per plain frame {_ms_stats(frame_ms[~is_kf])}, per keyframe "
              f"{_ms_stats(frame_ms[is_kf])}")
    check(srv.msgs_dropped == 0 and srv.imgs_dropped == 0,
          f"dropped {srv.msgs_dropped} messages and {srv.imgs_dropped} images")
    sc = topology_score(server, roots, cfg, dense)
    g = server.graph
    print(f"  server: {srv.packets_matched} packets matched in {run['stream_s']:.1f} s of "
          f"stream, host ms per keyframe {_ms_stats(run['process_ms'])}; longest queue "
          f"{srv.max_queued}; {g.solve_count} background solves ({g.discarded_solves} "
          f"discarded); ingest order by client {''.join(map(str, run['order']))}; peak device "
          f"memory {run['peak']:.2f} GiB (this process)")
    vio = [round(vio_ate_cm([d["timestamp"] for d in sent], [d["p_wb"] for d in sent], seq), 2)
           for sent, seq in zip(run["sent"], seqs)]
    print(f"  aligned {[cl.aligned for cl in g.clients[:n_agents]]}; loops {g.loop_count}; ATE "
          f"sim3 cm {[round(a * 100, 2) for a in sc['ates']]} (the agents' own VIO poses "
          f"{vio}; phase 8 on the same frames: "
          f"{[round(a, 2) for a in phase8['ate_cm']]}); depth maps {server.depth_maps_published}, "
          f"inverse-depth RMS median {sc['rms']:.4f} (phase 8: {phase8['rms']:.4f}); mesh "
          f"{sc['triangles']} triangles, {sc['vertices']} vertices, median scene distance "
          f"{sc['mesh_m']:.4f} m (phase 8: {phase8['mesh_m']:.4f}); launches {counts}")
    check(g.solve_count >= 1, "the background optimizer never solved")
    check(g.loop_count >= 1, "no loop closure over the socket path")
    check(all(cl.aligned for cl in g.clients[:n_agents]), "a client never aligned")
    check(all(a < 0.10 for a in sc["ates"]), f"ATE sim3 {sc['ates']} m: not all < 0.10 (the "
                                             f"agents' own VIO poses {vio} cm; ROADMAP F8)")
    check(server.depth_maps_published >= 2, f"depth maps {server.depth_maps_published} < 2")
    check(sc["vertices"] > 300 and sc["finite"],
          f"mesh of {sc['vertices']} vertices (finite: {sc['finite']})")
    check(not on_card or all(counts[n] > 0 for n in DENSE_KERNELS + SERVER_KERNELS
                             if n != "warp_banded"), f"a kernel did not run in phase 9: {counts}")
    for cid, tr in enumerate(run["tracker"]):
        check(not on_card or (tr is not None and tr["track_replays"] > 0 and tr["klt_launches"]
                              == tr["track_replays"] + tr["track_captures"]),
              f"agent {cid}'s process: {tr}: klt_track did not launch once a tracked frame")
    for cid, tr in enumerate(run["tracker"]):
        check(not on_card or (tr is not None and tr["solve_replays"] and tr["wlm_launches"]
                              == tr["solve_replays"] + tr["solve_captures"]),
              f"agent {cid}'s process: {tr}: window_lm did not launch once a solve")
    if on_card:
        print(f"  the agent processes' klt_track launches (each its own process): "
              f"{[tr['klt_launches'] for tr in run['tracker']]}, once in each tracked frame "
              f"({[tr['track_replays'] for tr in run['tracker']]}) and each capture's warm-up; "
              f"window_lm {[tr['wlm_launches'] for tr in run['tracker']]}, once in each solve "
              f"({[tr['solve_replays'] for tr in run['tracker']]}) and each capture's warm-up")
    print(f"phase 9 topology: ok in {time.perf_counter() - t_phase:.1f} s")
    counts["klt_track"] = sum(tr["klt_launches"] for tr in run["tracker"] if tr)
    counts["window_lm"] = sum(tr["wlm_launches"] or 0 for tr in run["tracker"] if tr)
    return server, roots, counts


# ---------------------------------------------------------------------------
# Phase 10: the apps, the entry step and the viewers
# ---------------------------------------------------------------------------


def run_app(main_fn, argv) -> str:
    """An app's `main(argv)` with its standard output captured and echoed
    indented; fails unless it returns 0. Returns the output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    out = buf.getvalue()
    print("\n".join("    " + line for line in out.splitlines()))
    check(rc == 0, f"{main_fn.__module__} {argv} returned {rc}")
    return out


def apps_phase(device, server, roots, root):
    """Phase 10: `apps.run_synthetic` at its defaults with TUM, viewer and
    plot outputs (test_server.py's ATE bounds, as phase 5: the first agent
    < 5 cm, the others < 25 cm, raw), `apps.run_euroc` on phase 9's two
    sequences (test_full_topology.py's 10 cm for these frames), one call
    of `entry()`'s step, and on phase 9's server `export_viewer`,
    `save_loop_overlay` and a `live_viewer` read twice over HTTP (the
    second answer the cached body, nothing collected again). The TUM files
    read back equal; the HTML and JSON parse."""
    import urllib.request
    from html.parser import HTMLParser

    from cvids_tpu_torch.apps import run_euroc, run_synthetic
    from cvids_tpu_torch.entry import entry
    from cvids_tpu_torch.io import tum
    from cvids_tpu_torch.utils import viewer

    dev = torch.device(device)
    # on the card the apps take their default device: no --device
    dev_args = [] if dev.type == "cuda" else ["--device", str(dev)]
    t_phase = time.perf_counter()
    print("phase 10 apps: python -m cvids_tpu_torch.apps.run_synthetic (defaults)")
    html_path, plot_path = os.path.join(root, "synthetic.html"), os.path.join(root, "traj.png")
    out = run_app(run_synthetic.main, ["--tum-prefix", os.path.join(root, "syn_pose"),
                                       "--viewer", html_path, "--plot", plot_path] + dev_args)
    ates = [float(line.split("ATE")[1].split()[0]) for line in out.splitlines() if " ATE " in line]
    check(len(ates) == 2 and ates[0] < 5.0 and all(a < 25.0 for a in ates[1:]),
          f"run_synthetic ATE cm {ates}: bounds 5 (first agent), 25")
    check("aligned: [True, True]" in out, "run_synthetic: an agent never aligned")
    wrote_plot = os.path.exists(plot_path)
    check(wrote_plot == (f"wrote {plot_path}" in out), "run_synthetic's --plot report is wrong")
    for cid in range(2):
        rows = tum.read_tum(os.path.join(root, f"syn_pose{cid}.txt"))
        check(rows.shape[1] == 8 and len(rows) >= 8, f"run_synthetic TUM file {cid}: {rows.shape}")
    state = _page_state(html_path)
    check(len(state["agents"]) == 2, "run_synthetic's viewer page lacks an agent")

    print(f"  python -m cvids_tpu_torch.apps.run_euroc --seq {roots[0]} --seq {roots[1]}")
    out = run_app(run_euroc.main, [a for r in roots for a in ("--seq", r)]
                  + ["--tum-prefix", os.path.join(root, "euroc_pose")] + dev_args)
    ates = [float(line.split()[-2]) for line in out.splitlines() if "ATE (sim3)" in line]
    check(len(ates) == 2 and all(a < 10.0 for a in ates), f"run_euroc ATE cm {ates}: bound 10")

    step, args = entry(None if dev.type == "cuda" else dev)
    t0 = time.perf_counter()
    mu, t_solved = step(*args)
    _sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    check(mu.shape == (480, 640) and t_solved.shape == (256, 3) and mu.device == dev
          and bool(torch.isfinite(mu).all()) and bool(torch.isfinite(t_solved).all()),
          "entry()'s step: wrong shape, device or a non-finite value")

    page = server.export_viewer(os.path.join(root, "topology.html"))
    HTMLParser().feed(open(page).read())
    state = _page_state(page)
    check(len(state["agents"]) == 2 and state["mesh"]["n"] > 0 and state["loops"]["n"] >= 1,
          "phase 9's viewer page lacks an agent, the mesh or the loops")
    overlay = os.path.join(root, "loop.png")
    drew = server.save_loop_overlay(overlay)
    check(drew == os.path.exists(overlay), "save_loop_overlay's answer and its file disagree")
    collected = []
    real = viewer.collect_state
    with mock.patch.object(viewer, "collect_state",
                           lambda *a, **k: collected.append(1) or real(*a, **k)):
        lv = server.live_viewer()
        try:
            bodies = [urllib.request.urlopen(lv.url + "state.json", timeout=60).read()
                      for _ in range(2)]
        finally:
            lv.close()
    check(bodies[0] == bodies[1] and len(collected) == 1,
          f"live viewer: the second GET collected again ({len(collected)} collections)")
    live = json.loads(bodies[0])
    for cid in range(2):
        path = os.path.join(root, f"topology_pose{cid}.txt")
        tr = server.trajectory(cid)
        tum.write_tum(path, tr)
        back = tum.read_tum(path)
        check(back.shape == tr.shape and np.allclose(back, tr, rtol=0, atol=1e-8),
              f"TUM file of client {cid} reads back different")
    print(f"  entry() step (640x480x128 fusion + 256-keyframe 4-DoF) {step_ms:.1f} ms, finite; "
          f"phase 9's server: viewer page {os.path.getsize(page)} bytes ({state['mesh']['n']} "
          f"triangles, {state['loops']['n']} loops), loop overlay "
          f"{'written' if drew else 'not written (matplotlib is not installed)'}, trajectory plot "
          f"{'written' if wrote_plot else 'not written (matplotlib is not installed)'}; live "
          f"viewer /state.json rev {live['rev']}, {len(bodies[0])} bytes, the second GET the "
          f"cached body; TUM files read back equal")
    print(f"phase 10 apps: ok in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: the multi-GPU dry run

MULTI_RANKS = 4             # ranks of phase 11: one a card where there are 4
SOLVE_TOL = 2e-3            # t and yaw of the sharded 4-DoF solve against one card's
# the sharded solve's cost may exceed one card's by this share of the
# starting cost: the two sum the same terms in other orders in fp32
SOLVE_COST_SLACK = 1e-6


def dense_digests(d: dict, dev) -> list[str]:
    """Each agent of a dry-run dense problem (`entry.dryrun_problems`) fused
    by one `fuse_measurement` in this process: the digests of its filter
    and cost volumes, as `dryrun_multichip`'s ranks report theirs."""
    from cvids_tpu_torch.dense import estimator
    from cvids_tpu_torch.entry import tensor_digest

    cfg, as_dev = d["cfg"], (lambda x: torch.as_tensor(x, device=dev))
    out = []
    for ref, meas in zip(d["refs"], d["meas"]):
        st = estimator.fuse_measurement(cfg, estimator.init_reference(cfg, as_dev(ref)),
                                        as_dev(meas), as_dev(d["a"]), as_dev(d["b"]),
                                        banded_warp=d["gate"])
        out.append(tensor_digest(st.filt.mu, st.filt.sigma2, st.filt.a, st.filt.b,
                                 st.mean_cost, st.count))
    return out


def tsdf_digests(t: dict, n_ranks: int, dev) -> list[str]:
    """A dry-run TSDF problem integrated by one `integrate_chunks` over the
    whole pool in this process: the digest of each rank's block."""
    from cvids_tpu_torch.entry import tensor_digest
    from cvids_tpu_torch.mapping import tsdf

    cfg = t["cfg"]
    pool = tsdf._empty_pool(cfg.capacity, cfg.chunk_size, dev)
    tsdf.integrate_chunks(cfg, pool, torch.arange(cfg.capacity, device=dev), t["coords"],
                          t["depth"], t["color"], t["k"], t["r"], t["t"])
    per = cfg.capacity // n_ranks
    return [tensor_digest(*(x[r * per:(r + 1) * per] for x in pool)) for r in range(n_ranks)]


def solve_collectives(n_nodes: int, lm_iters: int, cg_iters: int) -> dict:
    """The calls and bytes of `shard_posegraph_solve`'s docstring: the
    first cost, then per LM iteration an (N, 8) buffer, cg_iters (N, 4)
    buffers and the trial cost, in fp32."""
    return {"count": 1 + lm_iters * (cg_iters + 2),
            "bytes": 4 * (1 + lm_iters * (cg_iters * 4 * n_nodes + 8 * n_nodes + 1))}


def window_collectives(k: int, l_padded: int, iters: int) -> dict:
    """The calls and bytes of `solve_window_schur_sharded`'s docstring: the
    first cost, per LM iteration the packed reduced system (2·(15K)² +
    2·15K + 1 floats), the trial cost and the three gain-ratio terms, and the
    (L', 3) landmark gather."""
    pc = 15 * k
    return {"count": 3 * iters + 2,
            "bytes": 4 * (1 + iters * (2 * pc * pc + 2 * pc + 1 + 1 + 3) + 3 * l_padded)}


def multichip_checks(res: dict, probs: dict, n_ranks: int, dev) -> None:
    """Holds a `dryrun_multichip` result to the single-process path on this
    process's card: (a) every rank's tensors on a card; (b) each agent's
    dense step and (c) each rank's TSDF block equal to one process's, bit
    for bit, with the five dense kernels launched on every rank; (d) the
    solves within SOLVE_TOL of `optimize_pose_graph`, at no higher cost;
    (e) the windows to test_parallel.py's bounds against `solve_window_fast`
    (the toy window, of random observations, only finite, as in the JAX dry
    run); (f) no collective in the dense steps and TSDFs, and the solves'
    and windows' calls and bytes by their formulas; (g) on NCCL the solves
    and windows replayed from one capture a shape, their eager reruns held to
    (d) and (e) and compared with them (`graphs_against_eager`), and on gloo
    no graph."""
    from cvids_tpu_torch.server import optimizer as opt
    from cvids_tpu_torch.vio import window_ba as ba

    ranks, phases = res["ranks"], res["phases"]
    prefixes = ("toy_", "") if res["production"] else ("toy_",)
    check(all(d.startswith(dev.type) for r in ranks for d in r["devices"]),
          f"a rank's tensors are off {dev.type}: {[r['devices'] for r in ranks]}")
    for name in (p + "dense" for p in prefixes):
        got = [dg for r in ranks for dg in r[name]["digests"]]
        check(got == dense_digests(probs[name], dev),
              f"{name}: a rank's filter or cost volume differs from one process's")
        check(dev.type != "cuda" or all(r[name]["launches"][k] > 0 for r in ranks
                                        for k in DENSE_KERNELS),
              f"{name}: a dense kernel did not run on a rank: {[r[name]['launches'] for r in ranks]}")
    for name in (p + "tsdf" for p in prefixes):
        check([r[name]["digest"] for r in ranks] == tsdf_digests(probs[name], n_ranks, dev),
              f"{name}: a rank's chunk block differs from one process's integration")
    for name in (p + q for p in prefixes for q in ("dense", "tsdf")):
        check(not phases[name]["collectives"], phases[name]["audit"])
    for name, lm_iters, cg_iters in (("toy_graph", 2, 8), ("graph", 12, 60))[:len(prefixes)]:
        nodes, edges = probs[name]
        t0 = time.perf_counter()
        want = opt.optimize_pose_graph(nodes, edges, lm_iters=lm_iters, cg_iters=cg_iters)
        _sync(dev)
        one_s = time.perf_counter() - t0
        for run in sharded_runs(res, name):
            got = nodes._replace(t=run["t"].to(dev), yaw=run["yaw"].to(dev))
            d_yaw = torch.remainder(got.yaw - want.yaw + np.pi, 2 * np.pi) - np.pi
            err = max(float((got.t - want.t).abs().max()), float(d_yaw.abs().max()))
            costs = [float(0.5 * torch.sum(opt.edge_residuals(nd, edges) ** 2))
                     for nd in (nodes, want, got)]
            print(f"  {run['as']}: max |t|, |yaw| against one card {err:.3g} (tolerance "
                  f"{SOLVE_TOL}); cost {costs[0]:.6g} -> {costs[2]:.6g} sharded, "
                  f"{costs[1]:.6g} on one card (the solve alone {one_s:.3f} s there)")
            check(err <= SOLVE_TOL, f"{run['as']}: the sharded solve is {err} from one card's")
            check(costs[2] <= costs[1] + SOLVE_COST_SLACK * costs[0],
                  f"{run['as']}: sharded cost {costs[2]} above one card's {costs[1]}")
        want_c = solve_collectives(len(nodes.yaw), lm_iters, cg_iters)
        check(phases[name]["collectives"] == [{"op": "all-reduce", **want_c}],
              f"{name}: collectives {phases[name]['collectives']}, expected {want_c}")
        graphs_against_eager(res, name, ("t", "yaw"))
    for name, iters in (("toy_window", 2), ("window", 8))[:len(prefixes)]:
        state, meas = probs[name]
        for run in sharded_runs(res, name):
            check(np.isfinite(float(run["cost"])) and bool(torch.isfinite(run["p"]).all()),
                  f"{run['as']}: a non-finite result")
        l_padded = -(-state.lm.shape[0] // n_ranks) * n_ranks
        want_c = window_collectives(state.p.shape[0], l_padded, iters)
        check(phases[name]["collectives"] == [{"op": "all-reduce", **want_c}],
              f"{name}: collectives {phases[name]['collectives']}, expected {want_c}")
        graphs_against_eager(res, name, ("p", "q", "lm", "cost"))
        if name == "window":
            # K = 21: the references are solve_window_fast's body on the CPU
            # and, on the card, its one window_lm launch
            for where in ("cpu", dev):
                t0 = time.perf_counter()
                ref, ref_cost = ba.solve_window_fast(*window_to(state, meas, where), iters=iters)
                float(ref_cost)
                one_s = time.perf_counter() - t0
                for run in sharded_runs(res, name):
                    p_err = float((run["p"].cpu() - ref.p.cpu()).abs().max())
                    print(f"  {run['as']}: cost {float(run['cost']):.2f} sharded, "
                          f"{float(ref_cost):.2f} by solve_window_fast on {torch.device(where)} "
                          f"({one_s:.3f} s); max |p| difference {p_err:.3g} (bound 5e-2)")
                    check(float(run["cost"]) < 1.2 * float(ref_cost) + 5.0 and p_err < 5e-2,
                          f"{run['as']}: the sharded Schur solve misses test_parallel.py's "
                          f"bounds against solve_window_fast on {where}")
    # (g) on NCCL one capture a shape of each sharded program's LM iteration
    # and lm_iters (iters) replays a graphed run, two graphed runs each; on
    # gloo no graph
    lm_iters, w_iters = (2, 12)[:len(prefixes)], (2, 8)[:len(prefixes)]
    want_g = ({"_lm_step": [len(prefixes), 2 * sum(lm_iters)],
               "_iteration": [len(prefixes), 2 * sum(w_iters)]}
              if "eager" in res["toy_graph"] else {})
    check(all(r["graphs"] == want_g for r in ranks),
          f"graphs [captures, replays] a rank {[r['graphs'] for r in ranks]}, expected {want_g}")


def sharded_runs(res: dict, name: str) -> list[dict]:
    """The dry run's result of a sharded solve or window `name`, and on NCCL
    its eager run too, each with "as", the name to print."""
    runs = [dict(res[name], **{"as": name})]
    if "eager" in res[name]:
        runs.append(dict(res[name]["eager"], **{"as": name + " eager"}))
    return runs


def graphs_against_eager(res: dict, name: str, fields: tuple[str, ...]) -> None:
    """On NCCL, where `dryrun_multichip` ran the sharded program `name`
    graphed, replayed and eagerly: the replays' bits, the eager run's bits
    (a difference is printed: NCCL may sum in another order under capture;
    both runs are held to phase 11's bounds by the caller) and the calls
    issued, call for call."""
    got, phases = res[name], res["phases"]
    if "eager" not in got:
        return
    for f in fields:
        check(torch.equal(got[f], got["replayed"][f]),
              f"{name}: the second graphed run's {f} differs from the first's")
    diff = {f: float((got[f].double() - got["eager"][f].double()).abs().max()) for f in fields}
    same = all(torch.equal(got[f], got["eager"][f]) for f in fields)
    calls = [phases[n]["calls"] for n in (name, name + "_replayed", name + "_eager")]
    print(f"  {name}: graphed {'bit-equal to' if same else 'differs from'} the eager run "
          f"under disable_graphs()" + ("" if same else f", max |difference| {diff}")
          + f"; {len(calls[0])} calls issued, the same call for call: "
          f"{calls[0] == calls[1] == calls[2]}")
    check(calls[0] == calls[1] == calls[2],
          f"{name}: the graphed runs' calls differ from the eager run's")


def scaling_line(res: dict, graph, n_ranks: int, backend: str, dev) -> None:
    """The production 4-DoF solve on one card against the sharded one:
    `optimize_pose_graph` eagerly and `optimize_pose_graph_graphed` with its
    graph captured (the second of two calls), each the mean of 3 after one,
    then t1 / (W * tW) with the sharded phases' seconds on rank 0: graphed
    (the "graph" phase, captures included, and "graph_replayed") and eager
    ("graph_eager"; on gloo the "graph" phase is eager)."""
    from cvids_tpu_torch.server import optimizer as opt

    nodes, edges = graph
    one = {}
    for kind, fn in (("eager", opt.optimize_pose_graph),
                     ("graphed", opt.optimize_pose_graph_graphed)):
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            fn(nodes, edges, lm_iters=12, cg_iters=60)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        one[kind] = sum(times[1:]) / 3
    ph = res["phases"]
    sharded = ({"graphed": ph["graph"]["seconds"], "graphed, replays only":
                ph["graph_replayed"]["seconds"], "eager": ph["graph_eager"]["seconds"]}
               if "graph_eager" in ph else {"eager": ph["graph"]["seconds"]})
    parts = [f"{kind} {t:.4f} s, t1/({n_ranks} t{n_ranks}) "
             f"{one['graphed' if kind.startswith('graphed') else 'eager'] / (n_ranks * t):.4f}"
             for kind, t in sharded.items()]
    print(f"  scaling of the 1024-KF solve ({backend}): one card eager {one['eager']:.4f} s, "
          f"graphed {one['graphed']:.4f} s; {n_ranks} ranks {'; '.join(parts)}")


def multichip_phase(device, n_ranks=MULTI_RANKS) -> dict:
    """Phase 11: `entry.dryrun_multichip(n_ranks)` on NCCL with one card a
    rank where the machine has n_ranks cards, else on gloo with every rank on
    this card (a stated layout: every tensor stays on the card), held to the
    single-process path by `multichip_checks`. Returns the dense kernels'
    launches on the production dense step and tsdf_integrate's on the
    production TSDF, summed over the ranks."""
    from cvids_tpu_torch.entry import dryrun_multichip, dryrun_problems

    dev = torch.device(device)
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= n_ranks else "gloo"
    print(f"phase 11 multi-GPU: dryrun_multichip({n_ranks}), backend {backend}, {n_ranks} "
          f"ranks on {n_ranks if backend == 'nccl' else 1} of {n_cards} cards")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    res = dryrun_multichip(n_ranks, backend=backend, device=None if backend == "nccl" else dev)
    run_s = time.perf_counter() - t_phase
    probs = dryrun_problems(n_ranks, dev)
    multichip_checks(res, probs, n_ranks, dev)
    for name, ph in res["phases"].items():
        calls = sum(c["count"] for c in ph["collectives"])
        nbytes = sum(c["bytes"] for c in ph["collectives"])
        print(f"  {name}: {ph['seconds']:.3f} s on rank 0; {calls} collective calls, {nbytes} "
              f"bytes" + (f", {ph['seconds'] / calls * 1e3:.3f} ms a call with the work "
                          f"between" if calls else ""))
    if "graph" in res:
        scaling_line(res, probs["graph"], n_ranks, backend, dev)
    print(f"  one all-reduce of the solve's (1024, 4) fp32 buffer alone, {backend}: "
          f"{res['all_reduce_ms']:.4f} ms a call (mean of 50 after 20)")
    print(f"  peak device memory per rank (GiB): "
          f"{[round(r['peak_gib'], 3) for r in res['ranks']]}; dense launches per rank: "
          f"{[r['dense']['launches'] for r in res['ranks']]}")
    print(f"phase 11 multi-GPU: ok in {time.perf_counter() - t_phase:.1f} s (dry run "
          f"{run_s:.1f} s, of it the ranks' start and stop; the checks on one card the rest)")
    counts = {k: sum(r["dense"]["launches"][k] for r in res["ranks"]) for k in SOURCES}
    counts["tsdf_integrate"] = sum(r["tsdf"]["launches"]["tsdf_integrate"] for r in res["ranks"])
    return counts


# ---------------------------------------------------------------------------
# Phase 12: the fisheye rig through the front-end (test_fisheye_e2e.py)
# ---------------------------------------------------------------------------


def repo_test_module(name: str):
    """The repo's tests/<name>.py, imported by its own name as pytest
    imports it (a spawned process finds it the same way): phases 12 and 13
    run the port tests' own flows on the card. The directory goes last on
    sys.path, so it shadows nothing."""
    import importlib

    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    return importlib.import_module(name)


def fisheye_phase(device) -> dict:
    """Phase 12: tests/test_torch_fisheye_e2e.py's `run_fisheye_rig` on the
    card: two agents' EuRoC-format sequences of a mild equidistant fisheye
    (320x240, 10 Hz), written and read back, through `AgentFrontend` (the
    camera's lift inside the graphs) into `CollaborativePoseGraph`, held to
    the reference test's bounds (>= 6 packets an agent, >= 1 loop, both
    aligned, ATE sim3 < 15 cm); `graph_checks` on agent 0's equidistant
    front-end; the Hamming kernel's kept calls of the run against the twin.
    Returns the run's kernel launches."""
    import tempfile

    from cvids_tpu_torch.ops import cuda_kernels as ck

    rig = repo_test_module("test_torch_fisheye_e2e")
    run_fisheye_rig, fisheye_ate_cm = rig.run_fisheye_rig, rig.fisheye_ate_cm
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    ck.reset_launches()
    rec = CascadeRecorder() if on_card else None
    with tempfile.TemporaryDirectory(prefix="cvids_fisheye_") as root, \
            rec or contextlib.nullcontext():
        fes, seqs, packets, server = run_fisheye_rig(root, dev)
        try:
            _sync(dev)
            counts = dict(ck.launches)
            n_pk = [len(p) for p in packets]
            ates = fisheye_ate_cm(server, seqs)
            aligned = [bool(server.clients[c].aligned) for c in range(2)]
            print(f"phase 12 fisheye rig: {type(fes[0].cam).__name__} agents, "
                  f"{[len(s_.cam_t) for s_ in seqs]} frames of 320x240 at 10 Hz; scores against "
                  f"test_fisheye_e2e.py's bounds: packets {n_pk} (>= 6 each), loops "
                  f"{server.loop_count} (>= 1), aligned {aligned}, ATE sim3 cm "
                  f"{[round(a, 2) for a in ates]} (< 15); launches {counts}")
            check(all(n >= 6 for n in n_pk), f"packets per agent {n_pk}: fewer than 6")
            check(server.loop_count >= 1, "no loop closures on the fisheye rig")
            check(all(aligned), f"aligned {aligned}")
            check(all(a < 15.0 for a in ates), f"fisheye ATE {ates} cm")
            check(not on_card or all(counts[n] > 0 for n in SERVER_KERNELS + RANSAC_KERNELS
                                     + FRONTEND_KERNELS),
                  f"a kernel of the rig did not run: {counts}")
            if on_card:
                track_launch_checks(fes, counts, "phase 12")
                solve_launch_checks(fes, counts, "phase 12")
            seq0 = seqs[0]
            last = len(seq0.cam_t) - 1
            sel = (seq0.imu_t >= seq0.cam_t[last - 1]) & (seq0.imu_t < seq0.cam_t[last])
            imu = (seq0.gyr[sel], seq0.acc[sel],
                   np.diff(np.append(seq0.imu_t[sel], seq0.cam_t[last])))
            if on_card:
                graph_checks(fes[0], seq0.load_image(last - 1), seq0.load_image(last), imu)
        finally:
            server.close()
    if on_card:
        cascade_checks(rec, counts)
    print(f"phase 12 fisheye rig: ok in {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 13: a checkpoint restored in fresh processes (test_checkpoint_e2e.py)
# ---------------------------------------------------------------------------


def checkpoint_phase(device) -> None:
    """Phase 13: tests/test_torch_checkpoint_e2e.py's flow with the pose
    graph on the card (graphed solves): an uninterrupted run; a run that
    ingests half the packets, saves and is discarded; a spawned process that
    restores the file on the card and one that restores it on the CPU, each
    finishing the mission. Both must reproduce the uninterrupted card run:
    the same keyframe count, loop count and alignment, world positions and
    yaws within 1e-4. The capacities (128 keyframes, 64 loops) hold the
    mission without growing (a store that grew cannot be restored in place,
    in either package)."""
    import tempfile

    from cvids_tpu_torch.utils import checkpoint

    e2e = repo_test_module("test_torch_checkpoint_e2e")
    _world, _make_server, _finish = e2e._world, e2e._make_server, e2e._finish
    dev = torch.device(device)
    t_phase = time.perf_counter()
    packets, _, descs = _world()
    split = len(packets) // 2
    server = _make_server(descs, dev)
    ref = _finish(server, packets, 0)
    server.close()
    check(ref["loop_count"] >= 1 and all(ref["aligned"]), f"the uninterrupted run: {ref}")
    check(ref["count"] <= 128 and ref["loop_count"] <= 64, "the mission outgrows the capacities")
    with tempfile.TemporaryDirectory(prefix="cvids_ckpt_") as root:
        server = _make_server(descs, dev)
        for _, _, _, pkt in packets[:split]:
            server.add_keyframe(pkt)
        ckpt = f"{root}/mid.npz"
        checkpoint.save_server(ckpt, server)
        server.close()
        del server
        worst = {}
        for where in (("cuda", "cpu") if dev.type == "cuda" else ("cpu",)):
            res = e2e.resume_in_fresh_process(ckpt, f"{root}/resumed_{where}.npz", split, where)
            e2e.assert_same_map(res, ref)
            worst[where] = (float(np.abs(res["world_p"] - ref["world_p"]).max()),
                            float(np.abs(np.unwrap(res["world_yaw"])
                                         - np.unwrap(ref["world_yaw"])).max()))
    print(f"phase 13 checkpoint: {len(packets)} packets, saved after {split} on {dev}, "
          f"restored in a fresh process on {' and on '.join(worst)}: {ref['count']} "
          f"keyframes, {ref['loop_count']} loops, aligned {ref['aligned']} as the uninterrupted "
          f"run; largest |dp| m, |dyaw| rad (bound 1e-4): {worst}; ok in "
          f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 14: the once-an-agent and offline programs
# ---------------------------------------------------------------------------

ONCE_RUNS = 20              # timed calls of each program, graphed and eager
CALIB_W, CALIB_H = 752, 480
CALIB_BOARD = (5, 6, 0.04)  # test_extras.py's board: rows, cols, square (m)
# model: (iterations, (fx, fy) indices or None, (cx, cy) indices, focal,
# projection-agreement bound in px or None): test_extras.py's bounds
CALIB_CASES = {"pinhole": (40, (0, 1), (2, 3), 300.0, None),
               "equidistant": (40, (0, 1), (2, 3), 250.0, 4.0),
               "mei": (50, None, (3, 4), None, 1.5),
               "scaramuzza": (100, None, (9, 10), None, 4.0)}


class CallRecorder:
    """A `GraphedCall` that keeps a clone of the arguments of every call
    (phase 8 records agent 0's once-an-agent programs with it for phase
    14); every other attribute is the wrapped call's."""

    def __init__(self, call):
        self.call, self.args = call, []

    def __call__(self, *args):
        from torch.utils import _pytree as pytree
        self.args.append(pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, args))
        return self.call(*args)

    def __getattr__(self, name):
        return getattr(self.call, name)


def graphed_against_eager(fn, args, runs: int = ONCE_RUNS) -> dict:
    """fn(*args) through a fresh `GraphedCall` and under `disable_graphs()`:
    the capturing call's seconds (with its warm-up call), the ms of a
    replay and of an eager call (host clock, the device synced after each,
    median of `runs`), each one's host launch calls in a profiled call, the
    linear-solver kernels of the profiled eager call, and whether every
    output leaf is bit-equal."""
    from torch.utils import _pytree as pytree

    from cvids_tpu_torch.utils.cuda_graph import GraphedCall, disable_graphs

    call = GraphedCall(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphed = call(*args)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    with disable_graphs():
        eager = fn(*args)
    leaves = list(zip(pytree.tree_leaves(graphed), pytree.tree_leaves(eager)))
    same = all(_same_bits(a, b) if torch.is_tensor(a) else a == b for a, b in leaves)

    def wall_ms(f):
        times = []
        for _ in range(runs):
            t1 = time.perf_counter()
            f()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(times)

    def eager_call():
        with disable_graphs():
            fn(*args)

    replay_ms, eager_ms = wall_ms(lambda: call(*args)), wall_ms(eager_call)
    _, acts, eager_calls = profile_frame(eager_call, host_launches=True)
    host = {"replayed": profile_frame(lambda: call(*args), host_launches=True)[2],
            "eager": eager_calls}
    # which library a linear solve took (cuSOLVER's or MAGMA's kernels, or cuBLAS's)
    solver = sorted({a[0][:60] for a in acts if any(
        k in a[0].lower() for k in ("getrf", "getrs", "potrf", "magma", "trsm", "laswp"))})
    return {"capture_s": capture_s, "replayed_ms": replay_ms, "eager_ms": eager_ms,
            "host_launch_calls": host, "bits_equal": same, "captures": call.captures,
            "leaves": len(leaves), "solver_kernels": solver}


def record_once_programs(fe) -> dict:
    """Wraps front-end `fe`'s once-an-agent programs in `CallRecorder`s:
    the pre-init essential pose and the bootstrap's two solves."""
    rec = {"essential_pose": CallRecorder(fe._epose), "gyro_bias": CallRecorder(fe._gyro_bias),
           "alignment": CallRecorder(fe._align)}
    fe._epose, fe._gyro_bias, fe._align = rec["essential_pose"], rec["gyro_bias"], rec["alignment"]
    return rec


def calib_camera(model: str, dev, w: int = CALIB_W, h: int = CALIB_H):
    """test_extras.py's true camera of `model` (320x240), with its principal
    point moved to the centre of a w x h image."""
    from cvids_tpu_torch.camera import PinholeCamera
    from cvids_tpu_torch.camera.models import EquidistantCamera, MeiCamera, ScaramuzzaCamera

    dx, dy = (w - 320) / 2.0, (h - 240) / 2.0
    if model == "pinhole":
        return PinholeCamera.create(300.0, 300.0, 160.0 + dx, 120.0 + dy,
                                    (-0.15, 0.05, 0.0, 0.0), w, h, device=dev)
    if model == "equidistant":
        return EquidistantCamera.create(250.0, 250.0, 160.0 + dx, 120.0 + dy,
                                        (-0.03, 0.006, 0.0, 0.0), w, h, device=dev)
    if model == "mei":
        return MeiCamera.create(0.9, 420.0, 420.0, 160.0 + dx, 120.0 + dy,
                                (-0.05, 0.01, 0.0, 0.0), w, h, device=dev)
    return ScaramuzzaCamera.create(poly=(-215.0, 0.0, 4.0e-4, 0.0, 0.0), c=1.002, d=0.0006,
                                   e=-0.0011, cx=160.5 + dx, cy=119.0 + dy, width=w, height=h,
                                   device=dev)


def _board_pose(yaw, pitch, tz, tx, ty):
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    r = (np.array([[cy_, -sy, 0], [sy, cy_, 0], [0, 0, 1]])
         @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])).astype(np.float32)
    return r, np.array([tx, ty, tz], np.float32)


# test_extras.py's views: _board_views' eleven placements (the whole field
# of view, the close-up, the strong tilts, the four corners) and the four of
# test_chessboard_detection_and_calibration (the pinhole)
BOARD_POSES = [(0.1, 0.15, 0.42, -0.12, -0.10), (-0.2, 0.1, 0.5, -0.10, -0.08),
               (0.15, -0.2, 0.38, -0.05, -0.05), (0.05, 0.05, 0.3, -0.12, -0.10),
               (0.45, 0.1, 0.42, -0.14, -0.10), (-0.1, 0.45, 0.45, -0.12, -0.12),
               (-0.4, -0.35, 0.45, -0.10, -0.06), (0.25, 0.0, 0.5, -0.34, -0.27),
               (0.0, 0.3, 0.5, 0.06, -0.27), (-0.3, 0.0, 0.5, -0.34, 0.03),
               (0.0, -0.25, 0.5, 0.06, 0.03)]
PINHOLE_BOARD_POSES = [(0.1, 0.15, 0.5, -0.10, -0.08), (-0.2, 0.1, 0.6, -0.10, -0.08),
                       (0.15, -0.2, 0.45, -0.10, -0.08), (0.0, 0.3, 0.55, -0.10, -0.08)]


def board_views(cam, poses=BOARD_POSES, rows=CALIB_BOARD[0], cols=CALIB_BOARD[1],
                sq=CALIB_BOARD[2]) -> list[np.ndarray]:
    """test_extras.py's `_board_views` through the port's `render_chessboard`
    (that one imports the JAX package; tests/test_torch_once_programs.py
    holds the two equal), the views rendered in threads."""
    from cvids_tpu_torch.camera.chessboard import render_chessboard

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda p: render_chessboard(rows, cols, 0, cam, *_board_pose(*p),
                                                         sq)[0], poses))


def projection_agreement(cam_true, cam_est, w, h) -> float:
    """test_extras.py's `_projection_agreement` on the port's cameras: the
    95th percentile pixel discrepancy of the two models over in-view rays
    within 170 px of the image centre."""
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 0.45, (512, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.8
    dev = cam_true.cx.device
    uv_t = cam_true.project(torch.as_tensor(pts, device=dev)).cpu().numpy()
    r_px = np.hypot(uv_t[:, 0] - w / 2, uv_t[:, 1] - h / 2)
    inview = ((uv_t[:, 0] > 10) & (uv_t[:, 0] < w - 10) & (uv_t[:, 1] > 10) & (uv_t[:, 1] < h - 10)
              & (r_px < 170.0))
    uv_e = cam_est.project(torch.as_tensor(pts, device=dev)).cpu().numpy()
    return float(np.quantile(np.linalg.norm((uv_e - uv_t)[inview], axis=1), 0.95))


def estimated_camera(model: str, p: np.ndarray, dev, w: int = CALIB_W, h: int = CALIB_H):
    """The camera of a calibration's parameters (test_extras.py's)."""
    from cvids_tpu_torch.camera.models import (EquidistantCamera, MeiCamera, ScaramuzzaCamera,
                                               fit_forward_poly)

    def arr(v):
        return torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
    if model == "equidistant":
        return EquidistantCamera(*(arr(v) for v in (p[0], p[1], p[2], p[3], p[4:8])), w, h)
    if model == "mei":
        return MeiCamera(*(arr(v) for v in (p[0], p[1], p[2], p[3], p[4], p[5:9])), w, h)
    poly = fit_forward_poly(arr(p[:6]), theta_max=-0.8)
    return ScaramuzzaCamera(poly, arr(p[:6]), *(arr(p[i]) for i in range(6, 11)), w, h)


class _RecordingCall:
    """Stands in for `GraphedCall` inside `camera.models` during a
    calibration: each one made is kept, with the arguments of its last
    call."""
    made: list = []

    def __init__(self, fn, **kw):
        from cvids_tpu_torch.utils.cuda_graph import GraphedCall
        self.inner, self.last = GraphedCall(fn, **kw), None
        _RecordingCall.made.append(self)

    def __call__(self, *args):
        self.last = args
        return self.inner(*args)


def calibration_checks(dev) -> dict:
    """`calibrate_chessboards` on the card for the four models on
    test_extras.py's rendered views at 752x480, held to test_extras.py's
    bounds against the truth; the response graph's and each calibrator's
    two graphs' captures and replays. Returns (a row a model, and the
    programs graphed against eager: each calibrator's last solve's two on
    their last call's inputs, the response on the first view)."""
    from cvids_tpu_torch.camera import chessboard, models

    rows, cols, sq = CALIB_BOARD
    out, programs = {}, {}
    for model, (iters, f_idx, c_idx, focal, agree_bound) in CALIB_CASES.items():
        cam = calib_camera(model, dev)
        t0 = time.perf_counter()
        views = board_views(cam, PINHOLE_BOARD_POSES if model == "pinhole" else BOARD_POSES)
        render_s = time.perf_counter() - t0
        resp0 = (chessboard._response_program.captures, chessboard._response_program.replays)
        _RecordingCall.made = []
        t0 = time.perf_counter()
        with mock.patch.object(models, "GraphedCall", _RecordingCall):
            params, poses, rms, used = chessboard.calibrate_chessboards(
                views, rows, cols, sq, CALIB_W, CALIB_H, iters=iters, model=model, device=dev)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        p, rms = params.cpu().numpy(), float(rms)
        centre = np.array([float(cam.cx), float(cam.cy)])
        check(params.device == dev and bool(np.all(used)), f"{model}: views used {used} on "
                                                           f"{params.device}")
        check(rms < 1.0, f"{model}: rms {rms} px")
        check(np.abs(p[list(c_idx)] - centre).max() < 8, f"{model}: centre {p[list(c_idx)]}, "
                                                          f"true {centre}")
        if f_idx is not None:
            check(np.abs(p[list(f_idx)] - focal).max() < 12, f"{model}: focal {p[list(f_idx)]}")
        agree = None
        if model == "pinhole":
            check(abs(p[4] + 0.15) < 0.08, f"pinhole: k1 {p[4]}")
        else:
            agree = projection_agreement(cam, estimated_camera(model, p, dev), CALIB_W, CALIB_H)
            check(agree < agree_bound, f"{model}: projection agreement {agree} px >= "
                                       f"{agree_bound}")
        resp = chessboard._response_program
        # `_calibrate_gn` makes the residuals' call, then the Jacobian's: a pair a solve
        made = _RecordingCall.made
        solves = list(zip(made[0::2], made[1::2]))
        counts = [[(c.inner.captures, c.inner.replays) for c in pair] for pair in solves]
        check(solves and all(k == 1 and r > 0 for pair in counts for k, r in pair),
              f"{model}: a calibrator program was not captured once and replayed: {counts}")
        check(resp.captures - resp0[0] <= 1 and resp.replays - resp0[1] == len(views),
              f"{model}: the response graph's captures and replays "
              f"{(resp.captures - resp0[0], resp.replays - resp0[1])} for {len(views)} views")
        out[model] = {"render_s": render_s, "calibrate_s": calib_s, "rms_px": rms,
                      "params": [float(x) for x in p], "agreement_px": agree,
                      "solves (residuals, jacobian) (captures, replays)": counts,
                      "response (captures, replays)": (resp.captures - resp0[0],
                                                       resp.replays - resp0[1])}
        res, jac = solves[-1]
        programs[f"{model} residuals"] = graphed_against_eager(res.inner.fn, res.last)
        programs[f"{model} jacobian"] = graphed_against_eager(jac.inner.fn, jac.last)
        if model == "pinhole":
            programs["chessboard_response"] = graphed_against_eager(
                chessboard.chessboard_response, (torch.as_tensor(views[0], device=dev),))
    return out, programs


def once_programs_phase(device, once: dict) -> dict:
    """Phase 14: the JAX package's last compiled programs as CUDA graphs on
    the card. The pre-init essential pose and the VI bootstrap's two solves
    (the gyro bias; the bias correction and the linear alignment) on the
    inputs of agent 0's last call of each in phase 8 (`once`: phase 8's
    `CallRecorder`s), whose replays and captures there are printed; then
    the calibration (`calibration_checks`). Each program through a fresh
    `GraphedCall` against `disable_graphs()`: bit for bit, with the capture
    s, replayed and eager ms and host launch calls."""
    from cvids_tpu_torch.ops import ransac
    from cvids_tpu_torch.vio import frontend, initializer

    dev = torch.device(device)
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    fns = {"essential_pose": ransac.essential_pose, "gyro_bias": initializer.calibrate_gyro_bias,
           "alignment": frontend._align_step}
    rows = {}
    for name, rec in once.items():
        check(rec.args and rec.captures >= 1 and rec.replays >= 1,
              f"phase 8: agent 0's {name} ran {len(rec.args)} times, captured {rec.captures}, "
              f"replayed {rec.replays}")
        rows[name] = {"phase8 (calls, captures, replays)": (len(rec.args), rec.captures,
                                                            rec.replays),
                      **graphed_against_eager(fns[name], rec.args[-1])}
    calib, programs = calibration_checks(dev)
    programs.update(rows)
    bad = [n for n, r in programs.items() if not r["bits_equal"]]
    check(not bad, f"phase 14: graph replays not bit-equal to the eager calls: {bad}")
    rows = {"programs": programs, "calibration": calib}
    print(f"phase 14 once-an-agent and offline programs ({smi}): " + json.dumps(rows))
    print(f"phase 14 once-an-agent and offline programs: every program replayed as a CUDA "
          f"graph, bit-equal to its eager call; calibrators within test_extras.py's bounds; ok "
          f"in {time.perf_counter() - t_phase:.1f} s")
    return rows


def _page_state(path: str) -> dict:
    """The state JSON embedded in an exported viewer page."""
    html = open(path).read()
    return json.loads(html.split("let STATE=", 1)[1].split("; const LIVE=", 1)[0])


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if "--package" in sys.argv[1:]:     # the package of another tree, for the probes
        check(any(a in sys.argv[1:] for a in ("--dense-probe", "--server-probe",
                                               "--kernels-probe")),
              "--package goes with --dense-probe, --server-probe or --kernels-probe")
        sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--package") + 1]).resolve()))
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

    if "--dense-probe" in sys.argv[1:]:
        dense_probe(dev)
        return 0
    if "--server-probe" in sys.argv[1:]:
        server_probe(dev)
        return 0
    if "--kernels-probe" in sys.argv[1:]:
        kernels_probe(dev)
        return 0
    if "--multichip" in sys.argv[1:]:
        multichip_phase(dev)
        return 0

    # phase 3: each kernel against its twin at the main path's shapes
    kernels_only = "--kernels-only" in sys.argv[1:]
    runs = (1, 1) if kernels_only else (10, 3)
    checks, extras = kernel_checks(dev, np.random.default_rng(1), runs=runs[0],
                                   twin_runs=runs[1])
    edge_checks(dev, np.random.default_rng(2))
    plan_checks()
    memory_checks(dev, np.random.default_rng(3))
    torch.cuda.synchronize()
    print("phase 3 kernels vs twins: all within tolerance")
    if kernels_only:
        return 0

    # phase 4: the dense step + 4-DoF solve as the server runs them
    # (replayed CUDA graphs), counted; then graphed against eager
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    med, share, mu, frame_ms, gates = dense_chain(dev, 0)
    before, after, pg_ms = pose_graph(dev)
    torch.cuda.synchronize()
    counts = {k: ck.launches[k] for k in DENSE_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 4 slice: median depth {med:.3f} m (true {DEPTH}), converged "
          f"{share:.3f} on the [40:-40] crop; banded gate {gates[0]}, rotated frame "
          f"gate {gates[1]}; graphed frame ms {[round(x, 3) for x in frame_ms]} (the first "
          f"captures); peak device memory {peak:.2f} GiB")
    print(f"  pose graph {N_NODES} KF (2 LM x 10 CG), graphed: residual norm {before:.4f} -> "
          f"{after:.4f}; solve ms {[round(x, 1) for x in pg_ms]} (the capturing call, a replay)")
    n_dense = N_FRAMES + 1      # the chain's banded frames and its one exact-warp frame
    print(f"  launches on the dense path: {counts} over {n_dense} frames (a capture's "
          f"warm-up call runs the kernels once)")
    check(abs(med - DEPTH) < 0.4, f"median depth {med} not within 0.4 m of {DEPTH}")
    check(gates == (True, False), f"gates {gates}: expected banded then exact")
    check(after <= before, f"pose graph residual grew: {before} -> {after}")
    check(all(v > 0 for v in counts.values()), f"a dense kernel did not run: {counts}")

    # the same chain through the twins on the card
    patches = twin_patches()
    for p in patches:
        p.start()
    try:
        _, _, mu_twin, _, _ = dense_chain(dev, 0, graphed=False)
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
    splat_check(dev)
    profile_slice(dev)
    frames = graph_frame_checks(dev)
    solve = solve_checks(dev)
    host = frames["graph"]["host_launches"]
    check(host <= 8, f"a graphed dense frame makes {host} host launch calls, more than 8")
    per_frame = frames["graph"]["kernel_launches"]
    check(set(per_frame) == set(DENSE_KERNELS) and all(v >= 1 for v in per_frame.values()),
          f"kernel launches per graphed frame {per_frame}")
    print(json.dumps({"dense_frame": frames, "solve": solve}))
    print("phase 4 slice: ok")

    # phase 5: the collaborative server, counted
    tree, server_info = server_phase(dev)

    # phase 6: the whole server, packets with images -> depth -> TSDF -> mesh
    pipe_counts, pipe_maps = pipeline_phase(dev, tree)

    # phase 7: distorted, fisheye and Mei clients through the whole server
    dist_counts = distorted_phase(dev, tree)

    # phase 8: two agents' front-ends on rendered pixels and IMU -> the server
    agent_counts, agent_seqs, agent_scores = agents_phase(dev)

    # phases 9 and 10: phase 8's frames as EuRoC sequences, agent processes
    # streaming over sockets into the server; then the apps and the viewers
    import tempfile
    with tempfile.TemporaryDirectory(prefix="cvids_topology_") as root:
        server, roots, topo_counts = topology_phase(dev, agent_seqs, agent_scores, root)
        del agent_seqs
        apps_phase(dev, server, roots, root)
        del server

    # phase 11: the sharded server step on 4 ranks, against one process
    multi_counts = multichip_phase(dev)

    # phase 12: the fisheye rig through the front-ends; phase 13: a
    # checkpoint restored in fresh processes on the card and on the CPU
    fish_counts = fisheye_phase(dev)
    checkpoint_phase(dev)

    # phase 14: the pre-init essential pose and the VI bootstrap on phase
    # 8's inputs, and the calibrators, as CUDA graphs against eager calls
    once_programs_phase(dev, agent_scores["once"])

    # launches: the whole server's run (phase 6), which drives the server's
    # seven (the five dense kernels, hamming_matrix and tsdf_integrate) and
    # small_eig;
    # launches_phase7: the distorted clients' run, which drives them again;
    # launches_phase8: the server fed by the agents' front-ends;
    # launches_phase9: the topology's server; launches_phase11: the dry
    # run's production dense step, summed over its ranks; launches_phase12:
    # the fisheye rig (front-ends and pose graph);
    # launches_per_frame: kernel launches per graphed dense frame of phase
    # 4's timed frames (replays count their captured kernels), and
    # host_launches_per_frame: the host's launch calls in a profiled graphed
    # and eager frame (HOST_LAUNCH_CALLS); the
    # Hamming kernel's launches_per_keyframe: of phase 6's stream.
    # floor_ms: the empty kernel through the same launch path, timed the same
    # way; share = bound / time, reach = max(bound, floor) / time;
    # profiler_ms: the device time of a kernel of microseconds in one profiled
    # call (null for the volume kernels: phase 4's profiled frame prints theirs).
    # library_ms: null, no single PyTorch call computes any of the six
    # ported kernels, nor klt_track, nor tsdf_integrate; for small_eig torch.linalg.eigh of the
    # same batches (replaced_ms: the torch.linalg calls it replaced on the
    # path, eigh and svd; accuracy: against float64 eigh, phase 3).
    # small_eig's launches_frontend_phase8: phase 8's front-ends (graph
    # replays count their kernels), and per camera frame; launches_phase5:
    # phase 5's pose graph, whose cascades each launch it four times (the
    # 8-point F's 9x9 and 3x3, the PnP DLT's 12x12 and 3x3); dlt_12x12: the
    # DLT's pair timed at its shapes (phase 3)
    rate = {k: {"launches_per_frame": v,
                "host_launches_per_frame": {m: frames[m]["host_launches"] for m in frames}}
            for k, v in per_frame.items()}
    rate["hamming_matrix"] = {"launches_per_keyframe":
                              pipe_counts["hamming_matrix"] / (PIPE_AGENTS * PIPE_KF)}
    fe_small = agent_scores["frontend_launches"]["small_eig"]
    dlt = extras["small_eig_dlt"]
    rate["small_eig"] = {"launches_frontend_phase8": fe_small,
                         "launches_per_frame_phase8": fe_small / agent_scores["frames"],
                         # phase 5's pose graph: every cascade replay runs the
                         # 8-point F's pair and the PnP DLT's pair
                         "launches_phase5": server_info["launches"]["small_eig"],
                         "launches_per_cascade_phase5":
                             server_info["programs"].get("cascade_launches", {}),
                         "cascades_phase5": server_info["programs"].get("cascade_calls"),
                         "replaced_ms": extras["replaced_ms"]["small_eig"],
                         "accuracy": extras["small_eig_accuracy"],
                         "dlt_12x12": {**dlt, "share": dlt["bound_ms"] / dlt["ms"],
                                       "reach": max(dlt["bound_ms"], extras["floor_ms"])
                                       / dlt["ms"]}}
    # klt_track's launches: phase 8's front-ends, its path (graph replays
    # count their kernel; one a tracked frame and one a capture's warm-up),
    # launches_per_frame_phase8 per camera frame, tracked_frames_phase8; the
    # launches_phase* of the server runs are 0 (no front-end there) but
    # phase 9's, which sums its agent processes', and phase 12's
    fe_klt = agent_scores["frontend_launches"]["klt_track"]
    # tsdf_integrate: one launch a published map (phase 6's maps and the
    # medians of its parts: the walk, _alloc, the device integrate, the
    # `mesh` span)
    rate["tsdf_integrate"] = {"launches_per_map_phase6": pipe_counts["tsdf_integrate"]
                              / max(pipe_maps["maps"], 1), "phase6_maps": pipe_maps}
    rate["klt_track"] = {"launches_frontend_phase8": fe_klt,
                         "launches_per_frame_phase8": fe_klt / agent_scores["frames"],
                         "tracked_frames_phase8": agent_scores["tracked_frames"]}
    # window_lm's launches: phase 8's front-ends (one a solve: each solve
    # graph's replay and each capture's warm-up), per keyframe; the data's
    # counts of phase 3's window for its bound
    fe_wlm = agent_scores["frontend_launches"]["window_lm"]
    rate["window_lm"] = {"launches_frontend_phase8": fe_wlm,
                         "launches_per_keyframe_phase8": fe_wlm / max(agent_scores["keyframes"], 1),
                         "solves_phase8": agent_scores["solves"],
                         "keyframes_phase8": agent_scores["keyframes"],
                         "phase3_window": extras["window_lm"]}
    floor = extras["floor_ms"]
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": pipe_counts[name],
                "launches_phase7": dist_counts[name],
                "launches_phase8": agent_counts[name],
                "launches_phase9": topo_counts[name],
                "launches_phase11": multi_counts[name],
                "launches_phase12": fish_counts[name], **rate[name],
                "max_abs_err": checks[name][0], "ms": checks[name][1],
                "plain_ms": checks[name][2], "bound_ms": checks[name][3],
                "bound_by": checks[name][4], "floor_ms": floor,
                "share": checks[name][3] / checks[name][1],
                "reach": max(checks[name][3], floor) / checks[name][1],
                "profiler_ms": extras["profiler_ms"].get(name),
                "library_ms": extras["library_ms"].get(name)}
               for name in SOURCES]
    next(k for k in kernels if k["name"] == "klt_track")["launches"] = fe_klt
    next(k for k in kernels if k["name"] == "window_lm")["launches"] = fe_wlm
    big = extras["hamming_2048"]
    next(k for k in kernels if k["name"] == "hamming_matrix")["at_2048x2048"] = {
        **big, "share": big["bound_ms"] / big["ms"],
        "reach": max(big["bound_ms"], floor) / big["ms"],
        "profiler_ms": extras["profiler_ms"].get("hamming_2048")}
    # the port ran without JAX and without the JAX package, and its readers,
    # transport, viewers and apps import no optional library
    ref_mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "cvids_tpu"))
    check(not ref_mods, f"JAX or JAX-package modules loaded: {ref_mods}")
    optional = ("jax", "cvids_tpu", "PIL", "imageio", "yaml", "matplotlib")
    res = subprocess.run([sys.executable, "-c", "import sys\n"
                          "import cvids_tpu_torch.io.transport, cvids_tpu_torch.io.euroc, "
                          "cvids_tpu_torch.utils.viewer, cvids_tpu_torch.apps.run_euroc\n"
                          f"print(sorted(m for m in sys.modules if m.split('.')[0] in {optional}))"],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parent))
    check(res.returncode == 0 and res.stdout.strip() == "[]",
          f"importing the transport, EuRoC reader, viewer and apps loaded {res.stdout}{res.stderr}")
    print("imports: no module of jax or cvids_tpu loaded; the transport, EuRoC reader, viewer "
          "and apps load none of jax, cvids_tpu, PIL, imageio, yaml, matplotlib")
    print(json.dumps({"launch_floor": {"ms": floor, "host_us": extras["launch_host_us"],
                                       "profiler_ms": extras["profiler_ms"].get("empty")}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

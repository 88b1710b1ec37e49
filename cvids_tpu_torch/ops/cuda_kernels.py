"""The port's CUDA kernels and their plain PyTorch twins (the counterpart
of ``cvids_tpu/ops/pallas_kernels.py``).

Each kernel has a wrapper and a twin with the same contract:

- `projective_warp_banded` — banded two-pass alignment warp, one kernel
  that computes its own sample positions (``csrc/warp_banded.cu``);
- `plane_sweep` — per-depth AD cost with the 3x3 box, written as an
  (H, W, D) volume with the -1 sentinel (``csrc/plane_sweep.cu``);
- `sgm_scan_bidir` — forward + backward SGM scan along axis 0 or 1 of a
  volume, pair-summed in the cost dtype (``csrc/sgm_scan.cu``);
- `wta` — fused winner-take-all over summed part volumes (``csrc/wta.cu``);
- `hamming_matrix` — pairwise Hamming distances of 256-bit descriptors with
  validity masks, the loop verification's matcher (``csrc/hamming.cu``);
- `depth_filter_update` — the fused Gaussian×Beta filter step of the dense
  path (``csrc/depth_filter.cu``);
- `small_eigh` — batched symmetric eigendecomposition of matrices up to
  12×12 by Jacobi in a parallel (round-robin) order, the 8-point
  fundamental matrix's eigensolver (``csrc/small_eig.cu``; no Pallas
  counterpart: it replaces torch.linalg calls that wait for the card);
- `klt_track` — pyramidal Lucas-Kanade tracking of a batch of points,
  forward and back with the forward-backward gate, one block a point
  (one thread a window pixel), one launch (``csrc/klt_track.cu``; no
  Pallas counterpart: the JAX package compiles `track_points` into one
  program). Its window sums run in one
  fixed order, `lane_sum`'s, in the kernel and the twin;
- `tsdf_integrate` — a depth + colour frame into M chunks of the TSDF
  pool, in place, one block a chunk (``csrc/tsdf_integrate.cu``; no Pallas
  counterpart: the JAX package compiles `_integrate_kernel` into one
  program);
- `window_lm` — the agent's whole window solve (`solve_window_fast`'s
  Levenberg-Marquardt with the landmarks' Schur complement) in one launch
  of one block (``csrc/window_lm.cu``; no Pallas counterpart: it replaces
  the JAX package's compiled `_solve_window_fast_jit`). Its twin
  `window_lm_twin` states the kernel's order of operations
  (``ops/window_lm.py``).

Dispatch: a wrapper given CPU tensors returns its twin's result; given CUDA
tensors it launches its kernel, or raises on anything the kernel does not
take. There is no fallback from a CUDA tensor to a twin. Each launch adds
one to ``launches[name]``, so a run can show which kernels its path went
through; a CUDA-graph capture counts its calls apart (`counted_apart`) and
each replay adds them (`add_launches`), since a capture runs no kernel.
Callers reach the wrappers as attributes of this module
(``cuda_kernels.plane_sweep(...)``).

The volume kernels need D a multiple of 32 with D <= 256; the twins take any
D. The scan's, the sweep's and the WTA's launches (lane groups, ring depth,
tile, grid, dynamic shared memory) are decided in their ``.cu`` files, as is
the Hamming kernel's tile, the tracker's shared memory and the TSDF
kernel's block and the window solve's shared memory and scratch;
`sgm_scan_plan`, `plane_sweep_plan`, `wta_plan`, `hamming_plan`,
`klt_plan`, `tsdf_plan` and `window_lm_plan` restate them
as pure functions, and the ``compiled_*_plan`` functions read them from the
built library. `kernel_work` gives the bytes and operations a call must at
least move and do, for a roofline bound. Descriptors are (N, 8) int32
tensors: the uint32 words of the packets, viewed as int32 (XOR and popcount
ignore the sign).
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from . import depth_filter
from .image import bilinear_sample, warp_pass_positions

__all__ = ["projective_warp_banded", "plane_sweep", "sgm_scan_bidir", "wta",
           "hamming_matrix", "depth_filter_update", "small_eigh",
           "projective_warp_banded_twin", "plane_sweep_twin",
           "sgm_scan_bidir_twin", "wta_twin", "hamming_matrix_twin",
           "depth_filter_update_twin", "small_eigh_twin", "klt_track", "klt_track_twin",
           "lane_sum", "klt_plan", "compiled_klt_plan", "KltPlan", "small_eig_schedule",
           "small_eig_rotate", "popcount32", "launches",
           "reset_launches", "sgm_scan_plan", "plane_sweep_plan", "wta_plan",
           "compiled_sgm_scan_plan", "compiled_plane_sweep_plan",
           "compiled_wta_plan", "hamming_plan", "compiled_hamming_plan",
           "kernel_work", "SgmScanPlan", "PlaneSweepPlan", "WtaPlan",
           "HammingPlan", "MAX_DYNAMIC_SMEM", "empty_launch", "counted_apart",
           "add_launches", "tsdf_integrate", "tsdf_integrate_twin", "tsdf_plan",
           "compiled_tsdf_plan", "TsdfPlan", "window_lm", "window_lm_twin", "window_lm_plan",
           "compiled_window_lm_plan", "WindowLmPlan", "WINDOW_LM_MAX_K",
           "window_lm_attrs"]

launches = {"warp_banded": 0, "plane_sweep": 0, "sgm_scan": 0, "wta": 0,
            "hamming_matrix": 0, "depth_filter_update": 0, "small_eig": 0, "klt_track": 0,
            "tsdf_integrate": 0, "window_lm": 0}

_BIG = 3.0e38   # the kernels' end-of-axis pad for the d±1 neighbours
_VOLUME_DTYPES = (torch.float32, torch.bfloat16)
MAX_DYNAMIC_SMEM = 232_448      # bytes a block can use on an H100 (227 KB)


_tls = threading.local()     # .tally: this thread's capture count, if any


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@contextlib.contextmanager
def counted_apart():
    """Within (on this thread), launches are counted into the yielded dict
    instead of `launches`: a CUDA-graph capture records kernels that have
    not run, and its replays add the dict (`add_launches`)."""
    saved = getattr(_tls, "tally", None)
    _tls.tally = tally = dict.fromkeys(launches, 0)
    try:
        yield tally
    finally:
        _tls.tally = saved


def add_launches(counts: dict) -> None:
    for k, v in counts.items():
        launches[k] += v


def _scalar(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """`torch.as_tensor(x, dtype=dtype, device=device)` for a Python scalar
    or a tensor, but a Python scalar becomes a fill on the device rather
    than a copy from host memory, which a CUDA graph cannot capture."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the twin runs), True for CUDA tensors (the
    kernel runs); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"kernel inputs must all be on the CPU or all on one "
                     f"CUDA device, got {sorted(str(t.device) for t in tensors)}")


def _require(t: torch.Tensor, name: str, shape: tuple, dtypes) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _require_depths(d: int) -> None:
    if d % 32 != 0 or not 32 <= d <= 256:
        raise ValueError(f"the CUDA kernels take D a multiple of 32 with "
                         f"D <= 256, got D = {d}")


def _require_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: storage must be 16-byte aligned for the "
                         f"kernel's vector accesses (offset {t.data_ptr() % 16})")


def _launch(name: str | None, fn_name: str, device: torch.device, *args) -> None:
    """Call the library's `fn_name` with `args` and PyTorch's current stream
    on `device`, raise on a CUDA error, and count the launch under `name`
    (None: not counted). The stream is read as a raw handle and the device
    is switched only for a tensor on another card than the current one: a
    `torch.cuda.device` context and a `Stream` object per call cost the host
    more than the call itself (``dev/torch_probe_launch_path.py``). The raw
    handle comes from the private `torch._C._cuda_getCurrentRawStream` (the
    call torch's own compiler uses to launch Triton kernels; run with torch
    2.11; the repo pins no torch version)."""
    from .. import _build
    lib = _build.load()
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = getattr(lib, fn_name)(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = getattr(lib, fn_name)(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        msg = lib.cvids_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} ({msg})")
    if name is not None:
        _count(name)


def _count(name: str) -> None:
    """One launch of kernel `name`: into `launches`, or into this thread's
    capture tally (`counted_apart`)."""
    tally = getattr(_tls, "tally", None)
    (launches if tally is None else tally)[name] += 1


def empty_launch(device: torch.device | str) -> None:
    """Launch the library's empty kernel (``csrc/empty.cu``) on `device`
    through `_launch`, uncounted: timed like any kernel of this module, it
    is the launch floor of this launch path on the card."""
    _launch(None, "cvids_empty", torch.device(device))


# ---------------------------------------------------------------------------
# Banded two-pass projective warp
# ---------------------------------------------------------------------------


def _banded_pass(vals: torch.Tensor, pos: torch.Tensor, band: int,
                 with_coverage: bool):
    """out[c, r, u] = sum over the two taps k in {floor(pos - u), +1} with
    |k| <= band of hat(pos - u - k) * vals[c, r, u + k]; taps outside the
    row add 0. Also returns the row-pass coverage (the in-image weights)
    when `with_coverage`."""
    length = vals.shape[-1]
    u = torch.arange(pos.shape[-1], dtype=torch.float32, device=pos.device)
    delta = pos - u
    k0 = torch.floor(delta)
    zero = torch.zeros((), device=pos.device)
    acc = torch.zeros_like(vals)
    cov = torch.zeros_like(pos)
    for t in (0.0, 1.0):
        k = k0 + t
        wk = torch.clamp(1.0 - torch.abs(delta - k), min=0.0)
        x = u + k
        use = (torch.abs(k) <= band) & (x >= 0) & (x <= length - 1)
        # index only through taps that count: a non-finite position (NaN
        # survives a clamp) fails `use` and reads index 0, so it gives
        # value 0 and coverage 0, as the kernel's band test does
        xi = torch.where(use, x, zero).to(torch.int64)
        tap = torch.gather(vals, 2, xi.expand(vals.shape[0], -1, -1))
        acc = acc + torch.where(use, wk * tap, zero)
        if with_coverage:
            cov = cov + torch.where(use, wk, zero)
    return acc, cov


def projective_warp_banded_twin(img: torch.Tensor, m: torch.Tensor,
                                band_x: int = 96, band_y: int = 48):
    """Plain PyTorch twin of `projective_warp_banded`."""
    h, w = img.shape
    g, y_in = warp_pass_positions(m, h, w)
    tmp, cov1 = _banded_pass(img.to(torch.float32)[None], g, band_x, True)
    # column pass on the transposed planes: rows are image columns u
    cols = torch.stack([tmp[0].T, cov1.T])                     # (2, W, H)
    out, _ = _banded_pass(cols, y_in.T, band_y, False)
    return out[0].T.contiguous(), out[1].T.contiguous()


def projective_warp_banded(img: torch.Tensor, m: torch.Tensor,
                           band_x: int = 96, band_y: int = 48):
    """Banded-shift projective warp: the contract of
    `ops.image.projective_warp_mxu` — returns (warped·coverage, coverage),
    each (H, W) fp32 — wherever the per-pass shifts stay within
    (band_x, band_y); larger shifts yield coverage 0.

    img: (H, W) fp32; m: (3, 3), contiguous, with [x_in, y_in, 1] ~ m @
    [u, v, 1]. On the card this is one kernel launch: the positions of
    `ops.image.warp_pass_positions` are computed in the kernel from `m`,
    which stays on the device."""
    if not _on_cuda(img, m):
        return projective_warp_banded_twin(img, m, band_x, band_y)
    if img.ndim != 2:
        raise ValueError(f"img must be (H, W), got {tuple(img.shape)}")
    h, w = img.shape
    _require(img, "img", (h, w), (torch.float32,))
    m32 = m.to(torch.float32)       # as the twin rounds it; the kernel reads it on the device
    _require(m32, "m", (3, 3), (torch.float32,))
    out = torch.empty_like(img)
    cov = torch.empty_like(img)
    if h * w == 0:
        return out, cov
    _launch("warp_banded", "cvids_warp_banded", img.device,
            img.data_ptr(), m32.data_ptr(), out.data_ptr(), cov.data_ptr(),
            h, w, int(band_x), int(band_y))
    return out, cov


# ---------------------------------------------------------------------------
# Plane-sweep AD cost
# ---------------------------------------------------------------------------


def plane_sweep_twin(ref: torch.Tensor, meas_al: torch.Tensor,
                     pos_x: torch.Tensor, pos_y: torch.Tensor,
                     mx: torch.Tensor, my: torch.Tensor,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch twin of `plane_sweep`, 32 depths at a time (bounds the
    (depths, H, W) fp32 temporaries)."""
    chunk = 32
    h, w = ref.shape
    d = pos_x.shape[0]
    dev = ref.device
    ref = ref.to(torch.float32)
    meas = meas_al.to(torch.float32)
    nine = torch.full((), 9.0, device=dev)
    zero = torch.zeros((), device=dev)
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    out = torch.empty((h, w, d), dtype=out_dtype, device=dev)
    for d0 in range(0, d, chunk):
        sl = slice(d0, min(d0 + chunk, d))
        px = pos_x[sl, None, :]                                  # (Dc, 1, W)
        py = pos_y[sl, :, None]                                  # (Dc, H, 1)
        m0 = mx[sl, 0, None, :] + my[sl, 0, :, None]            # (Dc, H, W)
        m1 = mx[sl, 1, None, :] + my[sl, 1, :, None]
        m2 = mx[sl, 2, None, :] + my[sl, 2, :, None]
        valid = ((px >= 0.0) & (px <= w - 1.0) & (py >= 0.0) & (py <= h - 1.0)
                 & (m2 > 1e-6) & (m0 >= 0.0) & (m0 <= (w - 1.0) * m2)
                 & (m1 >= 0.0) & (m1 <= (h - 1.0) * m2))
        x0, y0 = torch.floor(px), torch.floor(py)
        wx0 = torch.clamp(1.0 - torch.abs(px - x0), min=0.0)
        wx1 = torch.clamp(1.0 - torch.abs(px - (x0 + 1.0)), min=0.0)
        wy0 = torch.clamp(1.0 - torch.abs(py - y0), min=0.0)
        wy1 = torch.clamp(1.0 - torch.abs(py - (y0 + 1.0)), min=0.0)
        xi0 = x0.clamp(0, w - 1).to(torch.int64)
        yi0 = y0.clamp(0, h - 1).to(torch.int64)
        xi1 = (xi0 + 1).clamp(max=w - 1)
        yi1 = (yi0 + 1).clamp(max=h - 1)
        r0 = wx0 * meas[yi0, xi0] + wx1 * meas[yi0, xi1]
        r1 = wx0 * meas[yi1, xi0] + wx1 * meas[yi1, xi1]
        warped = wy0 * r0 + wy1 * r1
        ad = torch.where(valid, torch.abs(warped - ref), zero)
        # 3x3 box, edge-replicated, summed in the reference's tap order
        acc = torch.zeros_like(ad)
        for dy in range(3):
            ady = ad[:, (rows + dy - 1).clamp(0, h - 1)]
            for dx in range(3):
                acc = acc + ady[:, :, (cols + dx - 1).clamp(0, w - 1)]
        c = torch.where(valid, torch.clamp(acc / nine, min=0.0),
                        torch.full((), -1.0, device=dev))
        out[:, :, sl] = c.permute(1, 2, 0).to(out_dtype)
    return out


class PlaneSweepPlan(NamedTuple):
    """The sweep kernel's launch: a block owns `tile_h` x `tile_w` pixels
    and `tile_d` depths and keeps the absolute differences of the tile plus
    a 1-pixel halo in shared memory."""
    tile_h: int
    tile_w: int
    tile_d: int
    threads: int
    grid: tuple[int, int, int]
    smem_bytes: int


def plane_sweep_plan(h: int, w: int, d: int) -> PlaneSweepPlan:
    """Tile, grid and dynamic shared memory of one `plane_sweep` launch, as
    ``csrc/plane_sweep.cu`` compiles them, restated here so that they can be
    held to the card's limits without the card. The kernel owns the values:
    the wrapper passes it none of them, and `compiled_plane_sweep_plan`
    reads the built library's own for comparison.

    Shared memory holds (tile_h + 2) x (tile_w + 2) halo pixels x (tile_d +
    4) floats of absolute differences (the depth run padded by 4 floats, so
    the pixel-major stores hit 32 different banks and the depth-major float4
    reads stay aligned), two float4 per (halo row, depth) of row entries,
    and the reference tile. Two blocks must fit one SM."""
    th, tw, db = 8, 30, 64
    hh, hw = th + 2, tw + 2
    smem = 4 * hh * hw * (db + 4) + 2 * 16 * hh * db + 4 * hh * hw
    grid = (-(-w // tw), -(-h // th), -(-d // db))
    return PlaneSweepPlan(th, tw, db, 256, grid, smem)


def _compiled_plan(fn_name: str, n: int, *args) -> list[int]:
    """`n` ints that the built library's `fn_name` reports for `args`
    (builds the library; launches nothing)."""
    import ctypes

    from .. import _build
    lib = _build.load()
    buf = (ctypes.c_int * n)()
    err = getattr(lib, fn_name)(*args, buf)
    if err != 0:
        msg = lib.cvids_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} ({msg})")
    return list(buf)


def compiled_plane_sweep_plan(h: int, w: int, d: int) -> PlaneSweepPlan:
    """`plane_sweep_plan` as the built library reports it."""
    v = _compiled_plan("cvids_plane_sweep_plan", 8, h, w, d)
    return PlaneSweepPlan(v[0], v[1], v[2], v[3], (v[4], v[5], v[6]), v[7])


def plane_sweep(ref: torch.Tensor, meas_al: torch.Tensor,
                pos_x: torch.Tensor, pos_y: torch.Tensor,
                mx: torch.Tensor, my: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plane-sweep AD cost over all depths, as an (H, W, D) volume in
    `out_dtype` with -1 marking samples whose centre is out of view.

    ref, meas_al: (H, W) fp32 (meas_al = the measurement pre-warped by A and
    coverage-renormalized); pos_x (D, W), pos_y (D, H), mx (D, 3, W),
    my (D, 3, H) fp32 from `ops.costvolume._sweep_positions`. Each sample is
    the bilinear value of meas_al at (pos_x[d, p], pos_y[d, q]); the cost is
    the 3x3 edge-replicated box mean of |sample - ref| with invalid taps 0."""
    if not _on_cuda(ref, meas_al, pos_x, pos_y, mx, my):
        return plane_sweep_twin(ref, meas_al, pos_x, pos_y, mx, my, out_dtype)
    h, w = ref.shape
    d = pos_x.shape[0]
    f32 = (torch.float32,)
    _require(ref, "ref", (h, w), f32)
    _require(meas_al, "meas_al", (h, w), f32)
    _require(pos_x, "pos_x", (d, w), f32)
    _require(pos_y, "pos_y", (d, h), f32)
    _require(mx, "mx", (d, 3, w), f32)
    _require(my, "my", (d, 3, h), f32)
    _require_depths(d)
    if out_dtype not in _VOLUME_DTYPES:
        raise ValueError(f"out_dtype {out_dtype} not in {_VOLUME_DTYPES}")
    out = torch.empty((h, w, d), dtype=out_dtype, device=ref.device)
    _require_aligned(out, "out")
    if h * w == 0:
        return out
    _launch("plane_sweep", "cvids_plane_sweep", ref.device,
            ref.data_ptr(), meas_al.data_ptr(), pos_x.data_ptr(),
            pos_y.data_ptr(), mx.data_ptr(), my.data_ptr(),
            out.data_ptr(), h, w, d, int(out_dtype == torch.bfloat16))
    return out


# ---------------------------------------------------------------------------
# Bidirectional SGM scan
# ---------------------------------------------------------------------------


def _sgm_step(l_prev: torch.Tensor, c: torch.Tensor, p2: torch.Tensor,
              p1: torch.Tensor) -> torch.Tensor:
    """One fp32 recurrence step on an (X, D) slice."""
    big = torch.full_like(l_prev[:, :1], _BIG)
    sp = torch.cat([big, l_prev[:, :-1]], dim=1)
    sm = torch.cat([l_prev[:, 1:], big], dim=1)
    min_prev = torch.amin(l_prev, dim=-1, keepdim=True)
    cand = torch.minimum(
        l_prev, torch.minimum(torch.minimum(sp, sm) + p1, min_prev + p2[:, None]))
    return c + cand - min_prev


def sgm_scan_bidir_twin(cost: torch.Tensor, p2_eff: torch.Tensor, p1,
                        axis: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of `sgm_scan_bidir`: fp32 carries, each direction
    rounded to the cost dtype, then added in the cost dtype."""
    c = torch.movedim(cost, axis, 0)
    p2 = torch.movedim(p2_eff, axis, 0)
    p1 = _scalar(p1, cost.device).to(torch.float32)
    s = c.shape[0]

    def run(order):
        out = torch.empty_like(c)
        lv = c[order[0]].to(torch.float32)
        out[order[0]] = c[order[0]]
        for i in order[1:]:
            lv = _sgm_step(lv, c[i].to(torch.float32), p2[i].to(torch.float32), p1)
            out[i] = lv.to(cost.dtype)
        return out

    total = run(list(range(s))) + run(list(range(s - 1, -1, -1)))
    return torch.movedim(total, 0, axis).contiguous()


class SgmScanPlan(NamedTuple):
    """The scan kernel's launch: `group` lanes carry one line in one
    direction, `vectors` 16-byte vectors each; a block of `threads` carries
    32 / `group` lines in both directions with a `stages`-deep ring of cost
    rows and one of partial rows."""
    group: int
    vectors: int
    stages: int
    threads: int
    grid: int
    smem_bytes: int


def sgm_scan_plan(lines: int, d: int, dtype: torch.dtype) -> SgmScanPlan:
    """Lane groups, ring depth, grid and dynamic shared memory of one
    `sgm_scan_bidir` launch over `lines` scan lines of depth `d`, as
    ``csrc/sgm_scan.cu`` compiles them, restated here so that they can be
    held to the card's limits without the card. The kernel owns the values:
    the wrapper passes it none of them, and `compiled_sgm_scan_plan` reads
    the built library's own for comparison.

    A D-row is d * itemsize / 16 vectors of 16 bytes; the group is the
    largest power of two (<= 32) that divides that count, so every lane
    loads and stores whole vectors and the shuffles stay inside aligned
    lane groups. The ring is 8 rows deep (a step takes ~0.15 us on an H100,
    so 8 steps cover a trip to device memory; deeper rings measured no
    faster), 4 where a lane holds more than 4 vectors, which keeps a block's
    two rings within 64 KB."""
    _require_depths(d)
    if dtype not in _VOLUME_DTYPES:
        raise ValueError(f"dtype {dtype} not in {_VOLUME_DTYPES}")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    n_vec = d * itemsize // 16
    group = 32
    while n_vec % group:
        group //= 2
    vectors = n_vec // group
    stages = 8 if vectors <= 4 else 4
    threads = 64
    lines_per_block = 32 // group
    return SgmScanPlan(group, vectors, stages, threads, -(-lines // lines_per_block),
                       2 * stages * vectors * threads * 16)


def compiled_sgm_scan_plan(lines: int, d: int, dtype: torch.dtype) -> SgmScanPlan:
    """`sgm_scan_plan` as the built library reports it."""
    return SgmScanPlan(*_compiled_plan("cvids_sgm_scan_plan", 6, lines, d,
                                       int(dtype == torch.bfloat16)))


def sgm_scan_bidir(cost: torch.Tensor, p2_eff: torch.Tensor, p1,
                   axis: int = 0) -> torch.Tensor:
    """Forward + backward SGM aggregation along `axis` (0 or 1) of a 3-D
    cost volume whose last axis is D; returns dtype(fwd) + dtype(bwd) in the
    cost dtype. axis=0 is the contract of the reference's `sgm_scan_bidir`
    on (S, X, D), axis=1 that of `sgm_scan_bidir_axis1` on (H, W, D).

    p2_eff: cost.shape[:2], in the cost dtype; p1: scalar (a tensor stays on
    the device, so no host sync is needed). The first row of each direction
    is the cost itself; carries are fp32."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    p1_t = _scalar(p1, cost.device)
    if not _on_cuda(cost, p2_eff, p1_t):
        return sgm_scan_bidir_twin(cost, p2_eff, p1_t, axis)
    if cost.ndim != 3:
        raise ValueError(f"cost must be 3-D, got shape {tuple(cost.shape)}")
    a, b, d = cost.shape
    _require(cost, "cost", (a, b, d), _VOLUME_DTYPES)
    _require(p2_eff, "p2_eff", (a, b), (cost.dtype,))
    if p1_t.numel() != 1:
        raise ValueError("p1 must be a scalar")
    _require_depths(d)
    p1_f = p1_t.reshape(1).to(torch.float32).contiguous()
    out = torch.empty_like(cost)
    # every row start is a multiple of d * itemsize >= 64 bytes from the base
    _require_aligned(cost, "cost")
    _require_aligned(out, "out")
    if a * b == 0:
        return out
    if axis == 0:   # scan over rows a, lines b
        s, x, cs_s, cs_x, p2_s, p2_x = a, b, b * d, d, b, 1
    else:           # scan over columns b, lines a
        s, x, cs_s, cs_x, p2_s, p2_x = b, a, d, b * d, 1, b
    _launch("sgm_scan", "cvids_sgm_scan_bidir", cost.device,
            cost.data_ptr(), p2_eff.data_ptr(), p1_f.data_ptr(), out.data_ptr(),
            s, x, d, cs_s, cs_x, p2_s, p2_x, int(cost.dtype == torch.bfloat16))
    return out


# ---------------------------------------------------------------------------
# Fused winner-take-all
# ---------------------------------------------------------------------------


def wta_twin(*vols: torch.Tensor, peak_ratio: float = 0.98):
    """Plain PyTorch twin of `wta`."""
    x = vols[0].to(torch.float32)
    for v in vols[1:]:
        x = x + v.to(torch.float32)
    d = x.shape[-1]
    lane = torch.arange(d, device=x.device)
    c0 = torch.amin(x, dim=-1)
    idx = torch.where(x == c0[..., None], lane, d).amin(dim=-1)  # first min
    cm = torch.gather(x, -1, (idx - 1).clamp(min=0)[..., None])[..., 0]
    cp = torch.gather(x, -1, (idx + 1).clamp(max=d - 1)[..., None])[..., 0]
    denom = cm + cp - 2.0 * c0
    delta = torch.where(denom > 1e-6,
                        0.5 * (cm - cp) / torch.clamp(denom, min=1e-6),
                        torch.zeros((), device=x.device))
    idx_f = idx.to(torch.float32) + torch.clamp(delta, -1.0, 1.0)
    masked = torch.where(torch.abs(lane - idx[..., None]) <= 1,
                         torch.full((), _BIG, device=x.device), x)
    c2 = torch.amin(masked, dim=-1)
    conf = (c0 < peak_ratio * c2) & (idx > 0) & (idx < d - 1)
    return idx_f, conf


class WtaPlan(NamedTuple):
    """The WTA kernel's launch: `group` lanes own one pixel and load
    `vectors` 16-byte vectors each per part; a block of `threads` works on
    `pixels_per_block` pixels."""
    group: int
    vectors: int
    threads: int
    pixels_per_block: int
    grid: int


def wta_plan(npix: int, d: int, dtype: torch.dtype) -> WtaPlan:
    """Lane groups and grid of one `wta` launch over `npix` pixels of depth
    `d`, as ``csrc/wta.cu`` compiles them, restated here so that they can be
    held to the card's limits without the card. The kernel owns the values:
    the wrapper passes it none of them, and `compiled_wta_plan` reads the
    built library's own for comparison.

    A D-row of one part is d * itemsize / 16 vectors of 16 bytes; the group
    is the smallest power of two, from 4 to 32, whose lanes cover the row
    with at most 2 vectors each (32 lanes take what is left: 2 each at 256
    fp32 depths). Where the vectors do not fill the group's slots (12, 20,
    24, 28 ... vectors), the last slots load nothing."""
    _require_depths(d)
    if dtype not in _VOLUME_DTYPES:
        raise ValueError(f"dtype {dtype} not in {_VOLUME_DTYPES}")
    n_vec = d * (2 if dtype == torch.bfloat16 else 4) // 16
    group = 4
    while 2 * group < n_vec and group < 32:
        group *= 2
    threads = 256
    pixels = threads // group
    return WtaPlan(group, -(-n_vec // group), threads, pixels, -(-npix // pixels))


def compiled_wta_plan(npix: int, d: int, dtype: torch.dtype) -> WtaPlan:
    """`wta_plan` as the built library reports it."""
    return WtaPlan(*_compiled_plan("cvids_wta_plan", 5, npix, d,
                                   int(dtype == torch.bfloat16)))


def wta(*vols: torch.Tensor, peak_ratio: float = 0.98):
    """WTA over the summed volume `sum(vols)` (1 to 4 (H, W, D) volumes,
    summed in fp32 in the kernel, never in memory). Returns (idx_f (H, W)
    fp32, conf (H, W) bool) with the semantics of `ops.sgm.wta_depth`
    minus the valid_count gate, which the caller applies on (H, W) maps."""
    if not vols:
        raise ValueError("wta needs at least one volume")
    if not _on_cuda(*vols):
        return wta_twin(*vols, peak_ratio=peak_ratio)
    if len(vols) > 4:
        raise ValueError(f"the WTA kernel takes 1 to 4 volumes, got {len(vols)}")
    if vols[0].ndim != 3:
        raise ValueError(f"volumes must be (H, W, D), got {tuple(vols[0].shape)}")
    h, w, d = vols[0].shape
    for i, v in enumerate(vols):
        _require(v, f"vols[{i}]", (h, w, d), (vols[0].dtype,))
    if vols[0].dtype not in _VOLUME_DTYPES:
        raise ValueError(f"volume dtype {vols[0].dtype} not in {_VOLUME_DTYPES}")
    _require_depths(d)
    dev = vols[0].device
    idx_f = torch.empty((h, w), dtype=torch.float32, device=dev)
    conf = torch.empty((h, w), dtype=torch.bool, device=dev)
    # every row start is a multiple of d * itemsize >= 64 bytes from the base
    for i, v in enumerate(vols):
        _require_aligned(v, f"vols[{i}]")
    if h * w == 0:
        return idx_f, conf
    ptrs = [v.data_ptr() for v in vols] + [0] * (4 - len(vols))
    _launch("wta", "cvids_wta", dev, *ptrs, len(vols), idx_f.data_ptr(),
            conf.data_ptr(), h * w, d, int(vols[0].dtype == torch.bfloat16),
            float(peak_ratio))
    return idx_f, conf


# ---------------------------------------------------------------------------
# Hamming distance matrix
# ---------------------------------------------------------------------------


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor, as int64 (SWAR bit
    count on the zero-extended word; torch has no popcount op)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix_twin(a: torch.Tensor, b: torch.Tensor,
                        a_valid: torch.Tensor | None = None,
                        b_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of `hamming_matrix`."""
    d = popcount32(a[:, None, :] ^ b[None, :, :]).sum(-1).to(torch.int32)
    big = torch.full((), 512, dtype=torch.int32, device=d.device)
    if a_valid is not None:
        d = torch.where(a_valid[:, None], d, big)
    if b_valid is not None:
        d = torch.where(b_valid[None, :], d, big)
    return d


class HammingPlan(NamedTuple):
    """The Hamming kernel's launch: a block of `threads` owns `tile_m`
    columns (one a thread) and walks `tile_n` rows of `a`."""
    tile_m: int
    tile_n: int
    threads: int
    grid: tuple[int, int]


def hamming_plan(n: int, m: int) -> HammingPlan:
    """Tile and grid of one `hamming_matrix` launch at (n, m), as
    ``csrc/hamming.cu`` compiles them, restated here so that they can be
    held without the card. The kernel owns the values, and
    `compiled_hamming_plan` reads the built library's own for comparison.

    128 columns a block and 4 rows: the loop verification's 160 x 512 is
    160 blocks, more than an H100's 132 SMs. The row tiles lie along the
    grid's first extent, the column tiles along its second."""
    if n < 1 or m < 1:
        raise ValueError(f"the Hamming kernel takes n, m >= 1, got {n}, {m}")
    tile_m, tile_n = 128, 4
    return HammingPlan(tile_m, tile_n, tile_m, (-(-n // tile_n), -(-m // tile_m)))


def compiled_hamming_plan(n: int, m: int) -> HammingPlan:
    """`hamming_plan` as the built library reports it."""
    v = _compiled_plan("cvids_hamming_plan", 5, n, m)
    return HammingPlan(v[0], v[1], v[2], (v[3], v[4]))


def hamming_matrix(a: torch.Tensor, b: torch.Tensor,
                   a_valid: torch.Tensor | None = None,
                   b_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise Hamming distances: a (N, 8) and b (M, 8) int32 descriptor
    words -> (N, M) int32, 512 where a row (`a_valid`, (N,) bool) or a
    column (`b_valid`, (M,) bool) is invalid. The contract of
    `ops.hamming.hamming_distance_matrix`. On the card `a` and `b` must
    start at a 16-byte boundary (a descriptor is read as two 16-byte
    vectors): any whole tensor and any slice of whole descriptors does."""
    masks = [v for v in (a_valid, b_valid) if v is not None]
    if not _on_cuda(a, b, *masks):
        return hamming_matrix_twin(a, b, a_valid, b_valid)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"descriptors must be (N, 8) and (M, 8), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    n, m = a.shape[0], b.shape[0]
    _require(a, "a", (n, 8), (torch.int32,))
    _require(b, "b", (m, 8), (torch.int32,))
    if a_valid is not None:
        _require(a_valid, "a_valid", (n,), (torch.bool,))
    if b_valid is not None:
        _require(b_valid, "b_valid", (m,), (torch.bool,))
    out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    if n == 0 or m == 0:
        return out
    _require_aligned(a, "a")
    _require_aligned(b, "b")
    _launch("hamming_matrix", "cvids_hamming", a.device, a.data_ptr(), b.data_ptr(),
            0 if a_valid is None else a_valid.data_ptr(),
            0 if b_valid is None else b_valid.data_ptr(), out.data_ptr(), n, m)
    return out


# ---------------------------------------------------------------------------
# Gaussian × Beta depth-filter update
# ---------------------------------------------------------------------------


def depth_filter_update_twin(state: depth_filter.FilterState, x: torch.Tensor,
                             tau2, meas_valid: torch.Tensor,
                             mu_range: tuple[float, float] = (0.01, 100.0)
                             ) -> depth_filter.FilterState:
    """Plain PyTorch twin of `depth_filter_update`: `depth_filter.update`
    with a scalar tau2 taken as a 0-d tensor."""
    tau2 = _scalar(tau2, x.device, torch.float32)
    return depth_filter.update(state, x, tau2, meas_valid, mu_range)


def depth_filter_update(state: depth_filter.FilterState, x: torch.Tensor,
                        tau2, meas_valid: torch.Tensor,
                        mu_range: tuple[float, float] = (0.01, 100.0)
                        ) -> depth_filter.FilterState:
    """Fused filter step: the contract of `depth_filter.update`, returning a
    new `FilterState` (the old one is not written).

    state: four (H, W) fp32 maps; x (H, W) fp32 inverse depth; tau2 a float
    (passed by value, never expanded to a map) or an (H, W) fp32 map;
    meas_valid (H, W) bool."""
    tau2_t = tau2 if isinstance(tau2, torch.Tensor) else None
    tensors = [*state, x, meas_valid] + ([tau2_t] if tau2_t is not None else [])
    if not _on_cuda(*tensors):
        return depth_filter_update_twin(state, x, tau2, meas_valid, mu_range)
    if x.ndim != 2:
        raise ValueError(f"x must be (H, W), got {tuple(x.shape)}")
    h, w = x.shape
    f32 = (torch.float32,)
    for name, t in zip(depth_filter.FilterState._fields, state):
        _require(t, name, (h, w), f32)
    _require(x, "x", (h, w), f32)
    _require(meas_valid, "meas_valid", (h, w), (torch.bool,))
    if tau2_t is not None:
        _require(tau2_t, "tau2", (h, w), f32)
    out = depth_filter.FilterState(*(torch.empty_like(x) for _ in range(4)))
    if h * w == 0:
        return out
    lo, hi = float(mu_range[0]), float(mu_range[1])
    _launch("depth_filter_update", "cvids_depth_filter", x.device,
            *(t.data_ptr() for t in state), x.data_ptr(),
            0 if tau2_t is None else tau2_t.data_ptr(),
            0.0 if tau2_t is not None else float(tau2),
            meas_valid.data_ptr(), lo, hi, 1.0 / (hi - lo),
            *(t.data_ptr() for t in out), h * w)
    return out


# ---------------------------------------------------------------------------
# Batched small symmetric eigendecomposition (parallel-order Jacobi)
# ---------------------------------------------------------------------------

SMALL_EIG_MAX_N = 12
SMALL_EIG_SWEEPS = 8    # fp64 off-diagonals reach rounding in 7-8 (dev/torch_probe_small_eig.py)


def small_eig_schedule(n: int) -> list[list[tuple[int, int]]]:
    """The round-robin ("circle") schedule of one sweep over an n x n
    matrix, as ``csrc/small_eig.cu`` computes it: m = n + n % 2 indices, m -
    1 rounds of m / 2 slots; slot 0 of round r pairs m - 1 with r, slot k >
    0 pairs (r + k) % (m - 1) with (r - k) % (m - 1). Returns each round's
    rotations (p, q), p < q, disjoint within a round; for an odd n the slot
    with the dummy index n is left out (that round's p takes no rotation).
    Over a sweep every pair p < q < n meets exactly once."""
    m = n + n % 2
    rounds = []
    for r in range(m - 1):
        slots = []
        for k in range(m // 2):
            a, b = (m - 1, r) if k == 0 else ((r + k) % (m - 1), (r - k) % (m - 1))
            if max(a, b) < n:
                slots.append((min(a, b), max(a, b)))
        rounds.append(slots)
    return rounds


def small_eig_rotate(a: torch.Tensor, sweeps: int = SMALL_EIG_SWEEPS,
                     schedule: list[list[tuple[int, int]]] | None = None):
    """The kernel's rotations in plain PyTorch: `sweeps` sweeps of
    `small_eig_schedule` (or of `schedule`, another order of disjoint pairs
    a round, for comparing orders) over the symmetric matrices a (B, n, n),
    read from their lower triangle. Returns (the rotated matrices, the
    accumulated rotations V).

    Each round computes every pair's (c, s) from the matrix as it stood at
    the round's start (the classic rotation, none where a_pq is 0), then
    rotates the columns of the matrix and of V, then the rows of the
    matrix, as the kernel does element by element: index i of a pair (p, q)
    becomes c x_i + s_i x_partner with s_p = -s, s_q = s; an index without
    a partner keeps its value."""
    b, n = a.shape[0], a.shape[-1]
    dev = a.device
    lower = torch.ones((n, n), dtype=torch.bool, device=dev).tril()
    m = torch.where(lower, a, a.transpose(-1, -2))
    v = torch.eye(n, dtype=a.dtype, device=dev).expand(b, n, n)
    one = torch.ones((), dtype=a.dtype, device=dev)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    rounds = []
    for pairs in small_eig_schedule(n) if schedule is None else schedule:
        if not pairs:
            continue
        p, q = (torch.tensor(x, device=dev) for x in zip(*pairs))
        partner = torch.arange(n, device=dev)
        partner[p], partner[q] = q, p
        paired = torch.zeros(n, dtype=torch.bool, device=dev)
        paired[p] = paired[q] = True
        rounds.append((p, q, partner, paired))
    for _ in range(sweeps):
        for p, q, partner, paired in rounds:
            app, aqq, apq = m[:, p, p], m[:, q, q], m[:, p, q]        # (b, pairs)
            theta = (aqq - app) / (2.0 * apq)
            sign = torch.where(theta >= 0.0, one, -one)
            t = sign / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
            c = one / torch.sqrt(t * t + 1.0)
            s = t * c
            rot = apq != 0.0
            c = torch.where(rot, c, one)
            s = torch.where(rot, s, zero)
            cc = torch.ones((b, n), dtype=a.dtype, device=dev)
            ss = torch.zeros((b, n), dtype=a.dtype, device=dev)
            cc[:, p], cc[:, q] = c, c
            ss[:, p], ss[:, q] = -s, s
            m, v = (torch.where(paired, cc[:, None, :] * x + ss[:, None, :] * x[:, :, partner], x)
                    for x in (m, v))                                  # columns
            m = torch.where(paired[:, None],
                            cc[:, :, None] * m + ss[:, :, None] * m[:, partner, :], m)   # rows
    return m, v


def small_eigh_twin(a: torch.Tensor):
    """Plain PyTorch twin of `small_eigh`: `small_eig_rotate`'s rounds,
    vectorised over a round's pairs and the batch, then the kernel's sort
    (ascending, ties by index, NaN last)."""
    b, n = a.shape[0], a.shape[-1]
    m, v = small_eig_rotate(a)
    d = torch.diagonal(m, dim1=-2, dim2=-1)
    key = torch.where(torch.isnan(d), torch.full((), float("inf"), dtype=d.dtype,
                                                 device=a.device), d)
    idx = torch.arange(n, device=a.device)
    kj, kk = key[:, None, :], key[:, :, None]          # [b, k, j]: j ranks before k?
    rank = ((kj < kk) | ((kj == kk) & (idx[None, :] < idx[:, None]))).sum(-1)
    order = torch.argsort(rank, dim=-1)                 # rank -> index
    return d.gather(1, order), v.gather(2, order[:, None, :].expand(b, n, n))


def small_eigh(a: torch.Tensor):
    """Eigendecomposition of a batch of symmetric matrices, a (B, n, n)
    float32 or float64 with n <= 12, read from its lower triangle as torch.linalg.eigh
    reads it -> (eigenvalues (B, n) ascending, eigenvectors (B, n, n), column
    k for eigenvalue k; each column's sign is the rotations' and is free).
    SMALL_EIG_SWEEPS Jacobi sweeps in the round-robin order of
    `small_eig_schedule` (floor(n / 2) disjoint rotations a round),
    whatever the convergence; nothing is read back to the host, so a call
    can be captured in a CUDA graph."""
    if not _on_cuda(a):
        return small_eigh_twin(a)
    if a.ndim != 3 or a.shape[1] != a.shape[2] or not 1 <= a.shape[1] <= SMALL_EIG_MAX_N:
        raise ValueError(f"small_eigh takes (B, n, n) with 1 <= n <= {SMALL_EIG_MAX_N}, "
                         f"got {tuple(a.shape)}")
    b, n = a.shape[0], a.shape[1]
    _require(a, "a", (b, n, n), (torch.float32, torch.float64))
    w = torch.empty((b, n), dtype=a.dtype, device=a.device)
    v = torch.empty((b, n, n), dtype=a.dtype, device=a.device)
    if b == 0:
        return w, v
    _launch("small_eig", "cvids_small_eig", a.device, a.data_ptr(), w.data_ptr(),
            v.data_ptr(), b, n, SMALL_EIG_SWEEPS, int(a.dtype == torch.float64))
    return w, v


# ---------------------------------------------------------------------------
# Pyramidal Lucas-Kanade tracking, forward and back, one block a point
# ---------------------------------------------------------------------------

KLT_LANES = 32          # the lanes that add a window's sums (the summing warp)
KLT_MAX_LEVELS = 8
KLT_MAX_RADIUS = 24


def lane_sum(v: torch.Tensor) -> torch.Tensor:
    """Sums of (N, P) over P in the kernel's order: lane l of 32 adds
    columns l, l + 32, ... in increasing order to 0 (zero padding to a
    multiple of 32), then five halving adds, the xor butterfly's offsets 16,
    8, 4, 2, 1. Returns (N,)."""
    n, p = v.shape
    cols = -(-p // KLT_LANES)
    padded = torch.zeros((n, cols * KLT_LANES), dtype=v.dtype, device=v.device)
    padded[:, :p] = v
    cells = padded.view(n, cols, KLT_LANES)
    acc = torch.zeros((n, KLT_LANES), dtype=v.dtype, device=v.device)
    for k in range(cols):
        acc = acc + cells[:, k]
    half = KLT_LANES // 2
    while half:
        acc = acc[:, :half] + acc[:, half:2 * half]
        half //= 2
    return acc[:, 0]


def _klt_direction(src, dst, xy0, valid0, init_xy, radius, iters, max_residual, min_eig):
    """One direction of `klt_track_twin`: the points xy0 of image `src`
    (its pyramid) tracked into `dst`, seeded at init_xy. The arithmetic is
    the reference's compiled program's (XLA turns a division by the window
    size into a multiplication by its float32 reciprocal; the step is
    `inv_det (gyy bx - gxy by)`, then times the scale), the window sums
    `lane_sum`'s. Divisions are by tensors on the inputs' device: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which
    rounds differently from the kernel's IEEE division."""
    dev = xy0.device
    side = 2 * radius + 1
    one = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    inv_pix = one / torch.full((), float(side * side), device=dev)
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    oy, ox = (g.reshape(-1) for g in torch.meshgrid(r, r, indexing="ij"))

    def sample(img, x, y):
        return bilinear_sample(img, torch.stack((x, y), -1))

    x0, y0 = xy0[:, 0], xy0[:, 1]
    flow_x, flow_y = init_xy[:, 0] - x0, init_xy[:, 1] - y0
    residual = torch.zeros_like(x0)
    conditioned = torch.ones_like(valid0)
    for lvl in reversed(range(len(src))):
        scale = torch.full((), 2.0 ** lvl, device=dev)
        i0, i1 = src[lvl], dst[lvl]
        px, py = x0 / scale, y0 / scale
        cx, cy = px[:, None] + ox[None], py[:, None] + oy[None]
        t = sample(i0, cx, cy)
        gx = sample(i0, cx + 0.5, cy) - sample(i0, cx - 0.5, cy)
        gy = sample(i0, cx, cy + 0.5) - sample(i0, cx, cy - 0.5)
        t_zm = t - (lane_sum(t) * inv_pix)[:, None]
        gxx, gxy, gyy = lane_sum(gx * gx), lane_sum(gx * gy), lane_sum(gy * gy)
        det = gxx * gyy - gxy * gxy
        trace = gxx + gyy
        disc = trace * trace - 4.0 * det
        mineig = (trace - torch.sqrt(torch.where(disc < 0.0, zero, disc))) * 0.5
        conditioned = conditioned & (mineig * inv_pix > min_eig)
        inv_det = torch.where(torch.abs(det) > 1e-12, one / det, zero)
        for _ in range(iters):
            qx, qy = px + flow_x / scale, py + flow_y / scale
            w = sample(i1, qx[:, None] + ox[None], qy[:, None] + oy[None])
            e = (w - (lane_sum(w) * inv_pix)[:, None]) - t_zm
            bx, by = lane_sum(gx * e), lane_sum(gy * e)
            dx = inv_det * (gyy * bx - gxy * by)
            dy = inv_det * (-gxy * bx + gxx * by)
            flow_x, flow_y = flow_x - dx * scale, flow_y - dy * scale
        qx, qy = px + flow_x / scale, py + flow_y / scale
        w = sample(i1, qx[:, None] + ox[None], qy[:, None] + oy[None])
        residual = lane_sum(torch.abs(w - t)) * inv_pix
    x1, y1 = x0 + flow_x, y0 + flow_y
    h, w = dst[0].shape
    inb = (x1 >= radius) & (x1 <= w - 1 - radius) & (y1 >= radius) & (y1 <= h - 1 - radius)
    valid = valid0 & inb & conditioned & (residual < max_residual)
    return x1, y1, valid, residual


def klt_track_twin(pyr0, pyr1, xy0, valid0, init_xy, radius: int = 10, iters: int = 10,
                   max_residual: float = 25.0, min_eig: float = 1e-3,
                   fb_thresh: float | None = None):
    """Plain PyTorch twin of `klt_track`: every window sum by `lane_sum`,
    the rest in the kernel's operations and order."""
    x1, y1, valid, residual = _klt_direction(pyr0, pyr1, xy0, valid0, init_xy, radius, iters,
                                             max_residual, min_eig)
    if fb_thresh is not None:
        bx, by, back_valid, _ = _klt_direction(pyr1, pyr0, torch.stack((x1, y1), -1), valid,
                                               xy0, radius, iters, max_residual, min_eig)
        dx, dy = bx - xy0[:, 0], by - xy0[:, 1]
        valid = valid & back_valid & (torch.sqrt(dx * dx + dy * dy) < fb_thresh)
    return torch.stack((x1, y1), -1), valid, residual


class KltPlan(NamedTuple):
    """The tracker's launch: a block of `threads` a point (one a window
    slot, at most 1024), the summing warp's lanes adding `cols` window
    pixels each, `smem_bytes` of dynamic shared memory (the template, its
    two gradients and a pass's terms, `cols` x 32 slots each)."""
    threads: int
    cols: int
    smem_bytes: int
    grid: int


def klt_plan(n: int, radius: int) -> KltPlan:
    """Threads, pixels a lane, shared memory and grid of one `klt_track`
    launch over `n` points at `radius`, as ``csrc/klt_track.cu`` compiles
    them, restated here so that they can be held without the card;
    `compiled_klt_plan` reads the built library's own."""
    if n < 1 or not 0 <= radius <= KLT_MAX_RADIUS:
        raise ValueError(f"the KLT kernel takes n >= 1 and 0 <= radius <= {KLT_MAX_RADIUS}, "
                         f"got {n}, {radius}")
    cols = -(-(2 * radius + 1) ** 2 // KLT_LANES)
    return KltPlan(min(cols * KLT_LANES, 1024), cols, 4 * cols * KLT_LANES * 4, n)


def compiled_klt_plan(n: int, radius: int) -> KltPlan:
    """`klt_plan` as the built library reports it."""
    return KltPlan(*_compiled_plan("cvids_klt_plan", 4, n, radius))


def klt_track(pyr0, pyr1, xy0: torch.Tensor, valid0: torch.Tensor, init_xy: torch.Tensor,
              radius: int = 10, iters: int = 10, max_residual: float = 25.0,
              min_eig: float = 1e-3, fb_thresh: float | None = None):
    """Pyramidal LK of the points xy0 (N, 2) fp32 from image 0 to image 1,
    given both pyramids (lists of (h_l, w_l) fp32 levels, level 0 the
    image, the same shapes in both), seeded at init_xy (N, 2); valid0 (N,)
    bool. With `fb_thresh`, each point is tracked back from its result into
    image 0, seeded at xy0, and kept where it lands within `fb_thresh` px.
    Returns (xy (N, 2), valid (N,) bool, residual (N,)): the contract of
    `ops.klt.track_points` on built pyramids. Every point is tracked, valid
    or not. On the card one launch does both directions."""
    if not _on_cuda(*pyr0, *pyr1, xy0, valid0, init_xy):
        return klt_track_twin(pyr0, pyr1, xy0, valid0, init_xy, radius, iters, max_residual,
                              min_eig, fb_thresh)
    levels = len(pyr0)
    if not 1 <= levels <= KLT_MAX_LEVELS or len(pyr1) != levels:
        raise ValueError(f"the KLT kernel takes 1 to {KLT_MAX_LEVELS} levels, the same in "
                         f"both pyramids, got {levels} and {len(pyr1)}")
    shapes = []
    for lvl, (a, b) in enumerate(zip(pyr0, pyr1)):
        if a.ndim != 2 or min(a.shape) < 1:
            raise ValueError(f"pyramid level {lvl} must be (h, w) with h, w >= 1, got "
                             f"{tuple(a.shape)}")
        _require(a, f"pyr0[{lvl}]", a.shape, (torch.float32,))
        _require(b, f"pyr1[{lvl}]", a.shape, (torch.float32,))
        shapes.append(tuple(a.shape))
    n = xy0.shape[0] if xy0.ndim == 2 else -1
    _require(xy0, "xy0", (n, 2), (torch.float32,))
    _require(init_xy, "init_xy", (n, 2), (torch.float32,))
    _require(valid0, "valid0", (n,), (torch.bool,))
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    dev = xy0.device
    xy = torch.empty((n, 2), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    residual = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return xy, valid, residual
    klt_plan(n, radius)         # raises on a radius the kernel does not take
    import ctypes
    ptrs = ctypes.c_void_p * levels
    ints = ctypes.c_int * levels
    _launch("klt_track", "cvids_klt_track", dev,
            ptrs(*(a.data_ptr() for a in pyr0)), ptrs(*(b.data_ptr() for b in pyr1)),
            ints(*(s[0] for s in shapes)), ints(*(s[1] for s in shapes)), levels,
            xy0.data_ptr(), valid0.data_ptr(), init_xy.data_ptr(), xy.data_ptr(),
            valid.data_ptr(), residual.data_ptr(), n, int(radius), int(iters),
            float(max_residual), float(min_eig),
            0.0 if fb_thresh is None else float(fb_thresh), int(fb_thresh is not None))
    return xy, valid, residual


# ---------------------------------------------------------------------------
# TSDF integration of a frame into the chunk pool, one block a chunk
# ---------------------------------------------------------------------------

TSDF_THREADS = 256      # voxels a block works on at once
TSDF_TWIN_BATCH = 1024  # chunks a pass of the twin, which bound its (chunks, S³) temporaries


def tsdf_integrate_twin(cfg, pool, slots: torch.Tensor, coords: torch.Tensor,
                        depth: torch.Tensor, color: torch.Tensor, k_mat: torch.Tensor,
                        r_cw: torch.Tensor, t_cw: torch.Tensor,
                        batch: int = TSDF_TWIN_BATCH) -> None:
    """Plain PyTorch twin of `tsdf_integrate`, in its one explicit order:
    R c + t and K p as three-term sums in fp32, the rounding half to even
    and clamped as a float before the integer cast, every division a
    tensor's. Updates `pool` in place, `batch` chunks a pass (the chunks
    are independent, so any batch gives the same bits)."""
    for start in range(0, slots.shape[0], batch):
        _tsdf_twin_pass(cfg, pool, slots[start:start + batch], coords[start:start + batch],
                        depth, color, k_mat, r_cw, t_cw)


def _tsdf_twin_pass(cfg, pool, slots, coords, depth, color, k_mat, r_cw, t_cw) -> None:
    s = cfg.chunk_size
    vx = cfg.voxel_size
    h, w = depth.shape
    m = slots.shape[0]
    dev = depth.device
    r = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
    zz, yy, xx = torch.meshgrid(r, r, r, indexing="ij")
    offs = torch.stack([xx, yy, zz], -1).reshape(-1, 3)          # (V, 3), [z][y][x]
    origin = coords.to(torch.float32) * (s * vx)                 # (M, 3)
    cx, cy, cz = (origin[:, None, :] + offs * vx).unbind(-1)    # (M, V) each
    px, py, pz = (((cx * r_cw[i, 0] + cy * r_cw[i, 1]) + cz * r_cw[i, 2]) + t_cw[i]
                  for i in range(3))
    q0, q1, q2 = ((px * k_mat[i, 0] + py * k_mat[i, 1]) + pz * k_mat[i, 2] for i in range(3))
    den = torch.clamp(q2, min=1e-6)
    u, v = q0 / den, q1 / den
    # clip before the integer cast: a far off-image u stays a valid index
    ui = torch.clamp(torch.round(u), 0, w - 1).to(torch.int64)
    vi = torch.clamp(torch.round(v), 0, h - 1).to(torch.int64)
    in_img = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (pz > 1e-3)
    d = depth[vi, ui]                                            # (M, V)
    col = color[vi, ui]                                          # (M, V, 3)
    d_ok = in_img & (d > cfg.min_depth) & (d < cfg.max_depth)
    surf_dist = d - pz  # >0: voxel in front of surface
    tau = cfg.trunc_scale * vx + cfg.trunc_quad * d * d

    old_sdf = pool.sdf[slots].reshape(m, -1)
    old_w = pool.weight[slots].reshape(m, -1)
    old_c = pool.color[slots].reshape(m, -1, 3)

    upd = d_ok & (surf_dist > -tau) & (surf_dist < tau)
    u_clamped = torch.minimum(torch.maximum(surf_dist, -tau), tau)
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
    wsum = old_w + torch.where(upd, one, zero)
    denom = torch.clamp(wsum, min=1e-9)
    sdf = torch.where(upd, (old_sdf * old_w + u_clamped) / denom, old_sdf)
    cnew = torch.where(upd[..., None], (old_c * old_w[..., None] + col) / denom[..., None],
                       old_c)
    wout = torch.clamp(torch.where(upd, wsum, old_w), max=cfg.max_weight)
    if cfg.carving:
        carve = d_ok & (surf_dist > tau) & (old_w > 0)
        wout = torch.where(carve, torch.clamp(wout - cfg.carve_weight, min=0.0), wout)
        sdf = torch.where(carve & (wout <= 0.0), zero, sdf)
    pool.sdf.index_copy_(0, slots, sdf.reshape(m, s, s, s))
    pool.weight.index_copy_(0, slots, wout.reshape(m, s, s, s))
    pool.color.index_copy_(0, slots, cnew.reshape(m, s, s, s, 3))


class TsdfPlan(NamedTuple):
    """The TSDF kernel's launch: a block of `threads` a chunk, each thread
    `loops` voxels of it."""
    threads: int
    loops: int
    grid: int


def tsdf_plan(m: int, s: int) -> TsdfPlan:
    """Threads, voxel loops and grid of one `tsdf_integrate` launch over `m`
    chunks of s³ voxels, as ``csrc/tsdf_integrate.cu`` compiles them,
    restated here so that they can be held without the card;
    `compiled_tsdf_plan` reads the built library's own."""
    if m < 1 or s < 1:
        raise ValueError(f"the TSDF kernel takes m, s >= 1, got {m}, {s}")
    return TsdfPlan(TSDF_THREADS, -(-s ** 3 // TSDF_THREADS), m)


def compiled_tsdf_plan(m: int, s: int) -> TsdfPlan:
    """`tsdf_plan` as the built library reports it."""
    return TsdfPlan(*_compiled_plan("cvids_tsdf_integrate_plan", 3, m, s))


def tsdf_integrate(cfg, pool, slots: torch.Tensor, coords: torch.Tensor,
                   depth: torch.Tensor, color: torch.Tensor, k_mat: torch.Tensor,
                   r_cw: torch.Tensor, t_cw: torch.Tensor) -> None:
    """Integrate one depth + colour frame into the chunks at pool `slots`
    (M,) int64, distinct, whose grid coordinates are `coords` (M, 3) int32;
    updates `pool` (`mapping.tsdf.ChunkPool`: sdf and weight (C, S, S, S),
    color (C, S, S, S, 3), fp32, contiguous) IN PLACE. depth (H, W) and
    color (H, W, 3) fp32 with any strides (a stride-0 expand is read as
    it is); k_mat, r_cw (world -> camera) (3, 3) and t_cw (3,) fp32. `cfg`
    is a `mapping.tsdf.TsdfConfig`. The contract of the JAX package's
    `_integrate_kernel` on active chunks. On the card all M chunks are one
    launch and nothing is read back (so the slots are not checked on the
    host: the kernel skips a slot outside the pool, where the twin
    raises)."""
    tensors = (*pool, slots, coords, depth, color, k_mat, r_cw, t_cw)
    if not _on_cuda(*tensors):
        return tsdf_integrate_twin(cfg, pool, slots, coords, depth, color, k_mat, r_cw, t_cw)
    s = cfg.chunk_size
    c = pool.sdf.shape[0]
    _require(pool.sdf, "pool.sdf", (c, s, s, s), (torch.float32,))
    _require(pool.weight, "pool.weight", (c, s, s, s), (torch.float32,))
    _require(pool.color, "pool.color", (c, s, s, s, 3), (torch.float32,))
    m = slots.shape[0] if slots.ndim == 1 else -1
    _require(slots, "slots", (m,), (torch.int64,))
    _require(coords, "coords", (m, 3), (torch.int32,))
    for t, name, shape in ((k_mat, "k_mat", (3, 3)), (r_cw, "r_cw", (3, 3)), (t_cw, "t_cw", (3,))):
        _require(t, name, shape, (torch.float32,))
    if depth.ndim != 2 or min(depth.shape) < 1 or depth.dtype != torch.float32:
        raise ValueError(f"depth must be (H, W) fp32 with H, W >= 1, got "
                         f"{tuple(depth.shape)} {depth.dtype}")
    h, w = depth.shape
    if tuple(color.shape) != (h, w, 3) or color.dtype != torch.float32:
        raise ValueError(f"color must be ({h}, {w}, 3) fp32, got {tuple(color.shape)} "
                         f"{color.dtype}")
    if m == 0:
        return
    tsdf_plan(m, s)             # raises on a shape the kernel does not take
    _launch("tsdf_integrate", "cvids_tsdf_integrate", depth.device, pool.sdf.data_ptr(),
            pool.weight.data_ptr(), pool.color.data_ptr(), slots.data_ptr(), coords.data_ptr(),
            c, m, s, depth.data_ptr(), h, w, depth.stride(0), depth.stride(1), color.data_ptr(),
            *color.stride(), k_mat.data_ptr(), r_cw.data_ptr(), t_cw.data_ptr(),
            cfg.voxel_size, s * cfg.voxel_size, cfg.trunc_scale * cfg.voxel_size,
            cfg.trunc_quad, cfg.min_depth, cfg.max_depth, cfg.max_weight, cfg.carve_weight,
            int(cfg.carving))


# ---------------------------------------------------------------------------
# The window solve, one cluster of blocks a window
# ---------------------------------------------------------------------------

WINDOW_LM_MAX_K = 21        # keyframes: bench.py's window, its system over the cluster
_WLM_CLUSTER, _WLM_THREADS, _WLM_TL, _WLM_REC, _WLM_LREC = 4, 256, 16, 56, 32
_WLM_PB, _WLM_PS, _WLM_PBUFS = 16, 20, 3   # the Cholesky's panels: width, row stride, copies


class WindowLmPlan(NamedTuple):
    """The window solve's launch: one cluster of `cluster` blocks of
    `threads`, `smem_bytes` of dynamic shared memory a block (two tiles of
    landmark records, or the block's panels of the reduced system and
    copies of three panels in flight; the camera factors' rows; the state;
    the observed landmarks), and `scratch` float32 words of device scratch (the prior's
    Gram matrix, h_cc, every observation's and landmark's record, the
    stepped landmarks, the landmark sums, the prior's j transposed)."""
    smem_bytes: int
    scratch: int
    threads: int
    cluster: int


def window_lm_plan(k: int, l: int, n_prior: int) -> WindowLmPlan:
    """Shared memory, scratch, threads and cluster of one `window_lm` launch
    over k keyframes, l landmark slots and a prior of n_prior rows (0:
    none), as ``csrc/window_lm.cu``'s `layout` computes them, restated here
    so that they can be held without the card; `compiled_window_lm_plan`
    reads the built library's own."""
    if not 1 <= k <= WINDOW_LM_MAX_K or l < 0 or not 0 <= n_prior <= 15 * k + 1:
        raise ValueError(f"the window kernel takes 1 <= K <= {WINDOW_LM_MAX_K}, L >= 0 and a "
                         f"prior of at most 15K + 1 rows, got K = {k}, L = {l}, {n_prior} rows")
    n, pose = 15 * k, 6 * k
    low = pose * (pose + 1) // 2
    rows = 15 * (k - 1) + 4 + 6 * k + n_prior
    # block r holds panels r, r + cluster, ...; panel q is rows q PB .. n
    own_rows = max(sum(n + 1 - q * _WLM_PB for q in range(r, -(-n // _WLM_PB), _WLM_CLUSTER))
                   for r in range(_WLM_CLUSTER))
    tiles = 2 * k * (_WLM_TL * _WLM_REC + 12) + 8 * _WLM_TL
    panels = (own_rows + _WLM_PBUFS * max(0, n + 1 - _WLM_PB)) * _WLM_PS
    smem = (max(tiles, panels) + 3) & ~3
    smem += (k - 1) * 450 + 2 * rows + 9 * n + 9 * k + 4 + 2 * 16 * k + 9 * k + 2 * 7 * 32 + 16
    smem += _WLM_THREADS // 32 + l          # the warps' counts, the observed landmarks
    scratch = (2 * n * n + 3) & ~3
    scratch += k * l * _WLM_REC + l * _WLM_LREC + 3 * l + 2 * low + 2 * pose + n * n_prior
    if 4 * smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"the window kernel needs {4 * smem} bytes of shared memory at K = {k}")
    return WindowLmPlan(4 * smem, scratch, _WLM_THREADS, _WLM_CLUSTER)


def compiled_window_lm_plan(k: int, l: int, n_prior: int) -> WindowLmPlan:
    """`window_lm_plan` as the built library reports it."""
    return WindowLmPlan(*_compiled_plan("cvids_window_lm_plan", 4, k, l, n_prior))


def window_lm_attrs() -> dict:
    """The built window kernel as `cudaFuncGetAttributes` reports it:
    registers and local memory bytes a thread (0 when nothing spills), and
    its threads a block and blocks a cluster (builds the library; launches
    nothing)."""
    regs, local, threads, cluster = _compiled_plan("cvids_window_lm_attrs", 4)
    return {"registers": regs, "local_bytes": local, "threads": threads, "cluster": cluster}


def window_lm_twin(state, meas, iters: int = 8, init_lambda: float = 1e-3,
                   anchor_weight: float = 1e3):
    """Plain PyTorch twin of `window_lm`: the kernel's order of operations
    (``ops/window_lm.py``). Returns (state, cost)."""
    from . import window_lm as wl
    return wl.solve(state, meas, iters, init_lambda, anchor_weight)


def window_lm(state, meas, iters: int = 8, init_lambda: float = 1e-3,
              anchor_weight: float = 1e3):
    """The window solve of `vio.window_ba.solve_window_fast` (state a
    `WindowState`, meas a `WindowMeasurements` with a camera-only prior or
    none, float32) in one launch: returns (state, cost), kf_valid and
    lm_valid unchanged. On CPU tensors its twin. Raises, on either device,
    on what the kernel does not take: another dtype or shape, a full-tangent
    prior, K outside 1-21, a prior of more than 15K + 1 rows, iters < 0.
    Reads nothing back to the host."""
    from ..vio.window_ba import CamPriorFactor

    prior = meas.prior
    if prior is not None and not isinstance(prior, CamPriorFactor):
        raise ValueError("window_lm takes a camera-only prior (CamPriorFactor) or none")
    k, l = state.p.shape[0], state.lm.shape[0]
    n_prior = 0 if prior is None else prior.j.shape[0]
    plan = window_lm_plan(k, l, n_prior)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    f32, b8 = (torch.float32,), (torch.bool,)
    shapes = [(state.p, "p", (k, 3), f32), (state.q, "q", (k, 4), f32),
              (state.v, "v", (k, 3), f32), (state.bg, "bg", (k, 3), f32),
              (state.ba, "ba", (k, 3), f32), (state.lm, "lm", (l, 3), f32),
              (state.kf_valid, "kf_valid", (k,), b8), (state.lm_valid, "lm_valid", (l,), b8),
              (meas.obs, "obs", (k, l, 2), f32), (meas.vis, "vis", (k, l), b8)]
    pre_shapes = {"dp": (3,), "dv": (3,), "dq": (4,), "dt": (), "j_p_bg": (3, 3),
                  "j_p_ba": (3, 3), "j_v_bg": (3, 3), "j_v_ba": (3, 3), "j_q_bg": (3, 3),
                  "sqrt_info": (9, 9), "bg": (3,), "ba": (3,)}
    shapes += [(getattr(meas.pre, f), f"pre.{f}", (k - 1, *sh), f32)
               for f, sh in pre_shapes.items()]
    shapes += [(meas.pre_valid, "pre_valid", (k - 1,), b8), (meas.r_cb, "r_cb", (3, 3), f32),
               (meas.p_bc, "p_bc", (3,), f32), (meas.anchor_p, "anchor_p", (3,), f32),
               (meas.anchor_yaw, "anchor_yaw", (), f32)]
    if prior is not None:
        shapes += [(prior.j, "prior.j", (n_prior, 15 * k), f32),
                   (prior.r0, "prior.r0", (n_prior,), f32), (prior.p, "prior.p", (k, 3), f32),
                   (prior.q, "prior.q", (k, 4), f32), (prior.v, "prior.v", (k, 3), f32),
                   (prior.bg, "prior.bg", (k, 3), f32), (prior.ba, "prior.ba", (k, 3), f32)]
    ins = []
    for t, name, shape, dtypes in shapes:
        t = t.contiguous()
        _require(t, name, shape, dtypes)
        ins.append(t)
    if not _on_cuda(*ins):
        return window_lm_twin(state, meas, iters, init_lambda, anchor_weight)
    if prior is None:
        ins += [None] * 7
    dev = state.p.device
    outs = [torch.empty_like(ins[i]) for i in range(6)]
    cost = torch.empty((), dtype=torch.float32, device=dev)
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=dev)
    import ctypes
    ptrs = (ctypes.c_void_p * 42)(*(0 if t is None else t.data_ptr()
                                    for t in ins + outs + [cost, scratch]))
    ints = (ctypes.c_int * 5)(k, l, n_prior, int(iters), plan.scratch)
    floats = (ctypes.c_float * 7)(float(init_lambda), float(anchor_weight),
                                  float(meas.pix_weight), float(meas.huber_delta),
                                  float(meas.bias_weight), float(meas.ba_prior_weight),
                                  float(meas.bg_prior_weight))
    _launch("window_lm", "cvids_window_lm", dev, ptrs, ints, floats)
    return state._replace(p=outs[0], q=outs[1], v=outs[2], bg=outs[3], ba=outs[4],
                          lm=outs[5]), cost


# ---------------------------------------------------------------------------
# The least work of a call, for a roofline bound
# ---------------------------------------------------------------------------


def kernel_work(name: str, **shape) -> tuple[int, int]:
    """(bytes, operations) that one call of kernel `name` (a key of
    `launches`) must at least move and do at `shape`: every input read once
    and every output written once, whatever the kernel reads again, and the
    arithmetic the function needs, each value computed once where it is
    shared (every add, multiply, compare and min counts as one operation,
    although a card's peak rate assumes fused multiply-adds, so the
    operations time errs high). A time bound on a card is
    max(bytes / its memory rate, operations / its peak rate).

    Shapes: warp_banded h, w; plane_sweep h, w, d, itemsize; sgm_scan s, x,
    d, itemsize (one launch: one axis, both directions); wta h, w, d,
    itemsize, parts; depth_filter_update h, w, tau2_map (False: a scalar);
    hamming_matrix n, m, a_mask, b_mask (True: the validity mask is given);
    small_eig batch, n, itemsize (4 or 8: its operations are fp64 at 8);
    klt_track n points, p window pixels, levels, iters, fb (True: tracked
    back too), h, w (level 0; the levels halve with the floor);
    tsdf_integrate m chunks of s³ voxels from an h x w frame, `updated`
    of the voxels in the band, `written` pool words changed and `color_px`
    bytes a colour pixel as stored (by default the most: every voxel
    updated, every word written, 12); window_lm k keyframes, l landmark
    slots, iters, prior (its rows, 0: none), `obs` valid observations and
    `pairs` co-observations (landmark, keyframe pair m <= k) of this
    window (by default every slot observed from every keyframe)."""
    g = shape.get
    if name == "warp_banded":
        px = g("h") * g("w")
        # img in; out and coverage out; the 3x3 map. Two passes of two hat
        # taps with their bounds, and the positions: ~60 operations a pixel
        return 3 * 4 * px + 36, 60 * px
    if name == "plane_sweep":
        h, w, d = g("h"), g("w"), g("d")
        tables = 4 * d * (w + h) * 4           # pos_x, pos_y, mx (3), my (3)
        # per sample: the three m sums and the quad test 10, bilinear 9,
        # |diff| 2, 3x3 box with the division and the clamp 11: 32. The hat
        # weights (6) and the in-bounds test (2) depend on one coordinate
        # and the depth only: 8 per table entry, not per sample
        return (h * w * d * g("itemsize") + 2 * 4 * h * w + tables,
                32 * h * w * d + 8 * (w + h) * d)
    if name == "sgm_scan":
        s, x, d, es = g("s"), g("x"), g("d"), g("itemsize")
        # cost in, sum out, P2 in, P1. Per element and direction: the min
        # over D 1, the candidate 4, the update 2, rounding 1; then the sum
        return 2 * s * x * d * es + s * x * es + 4, 17 * s * x * d
    if name == "wta":
        h, w, d, n = g("h"), g("w"), g("d"), g("parts")
        # the parts in; idx_f (4 bytes) and conf (1) out. Per element: the
        # sum of the parts, first and second minimum with their masks
        return n * h * w * d * g("itemsize") + 5 * h * w, (n + 3) * h * w * d
    if name == "depth_filter_update":
        px = g("h") * g("w")
        maps = 4 + 1 + 4 + (1 if g("tau2_map", False) else 0)   # state, x, new state
        return maps * 4 * px + px, 60 * px
    if name == "hamming_matrix":
        n, m = g("n"), g("m")
        # 8 words a descriptor; xor, popcount and add per word pair
        masks = (n if g("a_mask", True) else 0) + (m if g("b_mask", True) else 0)
        return 32 * (n + m) + 4 * n * m + masks, 24 * n * m
    if name == "small_eig":
        b, n, es = g("batch"), g("n"), g("itemsize")
        # the matrix in; eigenvalues and eigenvectors out. Per rotation: its
        # angle ~15, then rows and columns p, q of the matrix and columns p,
        # q of the eigenvectors, 6 a row each; the sort's rank n² compares
        per_matrix = SMALL_EIG_SWEEPS * n * (n - 1) // 2 * (18 * n + 15) + n * n
        return es * b * (2 * n * n + n), b * per_matrix
    if name == "klt_track":
        n, p, levels, iters = g("n"), g("p"), g("levels"), g("iters")
        h, w = g("h"), g("w")
        pixels = sum((h >> lvl) * (w >> lvl) for lvl in range(levels))
        # both pyramids in; xy0 and init_xy (8 bytes each) and valid0 in; xy,
        # valid and residual out. Per window pixel, a bilinear sample is ~30
        # (floors, clamps, four taps, the inside test); a level's set-up 5
        # samples, the two differences, four products and sums: ~162; an
        # iteration a sample, its coordinates, the sum, e and the two
        # projections: ~38; the residual ~34. Per point and level ~20 more
        # (det, eigenvalue, step) and ~12 an iteration (means, the step)
        per_level = p * (162 + 38 * iters + 34) + 20 + 12 * iters
        directions = 2 if g("fb", True) else 1
        return 2 * 4 * pixels + 17 * n + 13 * n, n * directions * levels * per_level
    if name == "tsdf_integrate":
        vox = g("m") * g("s") ** 3
        updated = g("updated", vox)
        pixels = min(g("h") * g("w"), vox)
        # every voxel's sdf and weight read (8 bytes); an updated voxel's
        # colour read (12); the pool words that change written (`written`,
        # at most sdf, weight and colour of every voxel); at most a depth
        # and a colour sample a pixel, as stored (`color_px` bytes: 4 for
        # the server's stride-0 grey); the slots (8) and coords (12) a
        # chunk; K, R, t. Per voxel: the centre 6, R c + t 15, K p 15, the
        # division and the rounding 8, the in-image test 5, the depth
        # tests, d - z and tau 6: 55; an updated one the band and the
        # update 12, the colour 9, carving 6 more: 27
        return (8 * vox + 12 * updated + 4 * g("written", 5 * vox)
                + (4 + g("color_px", 12)) * pixels + 20 * g("m") + 84,
                55 * vox + 27 * updated)
    if name == "window_lm":
        k, l, iters, prior = g("k"), g("l"), g("iters"), g("prior", 0)
        n = 15 * k
        obs, pairs = g("obs", k * l), g("pairs", l * k * (k + 1) // 2)
        # the state, landmarks, masks, observations (8 bytes and a mask
        # byte each), the K-1 preintegrations (143 floats and a flag), the
        # rig, the anchor and the prior in; the state, landmarks, cost out
        nbytes = (2 * (64 * k + 12 * l + 4) + k + l + 9 * k * l + 573 * (k - 1) + 64
                  + (4 * prior * (n + 1) + 64 * k if prior else 0))
        # an iteration: an observation's blocks (projection, Huber, the 2x6
        # and 2x3 Jacobians, its H_ll, g_l, H_pl and H_pp terms) ~300, its W
        # 90, back-substitution 36 and cost 50; a landmark's inverse and
        # step ~80; a co-observation's 6x6 Schur block 216; the camera
        # factors' duals ~700 a seed column of an IMU factor, the system's
        # lower triangle ~70 an entry, the Cholesky n³/3, the prior's rows
        # and gradient 4 P n. Once: the prior's Gram matrix P n (n + 1)
        per_iter = (476 * obs + 80 * l + 216 * pairs + 700 * 30 * (k - 1)
                    + 70 * n * (n + 1) // 2 + n ** 3 // 3 + 2 * n * n + 4 * prior * n)
        return nbytes, iters * per_iter + prior * n * (n + 1)
    raise KeyError(f"no kernel named {name!r}")

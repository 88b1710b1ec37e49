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
  12×12 by cyclic Jacobi, the 8-point fundamental matrix's eigensolver
  (``csrc/small_eig.cu``; no Pallas counterpart: it replaces torch.linalg
  calls that wait for the card).

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
the Hamming kernel's tile; `sgm_scan_plan`, `plane_sweep_plan`, `wta_plan`
and `hamming_plan` restate them as pure functions, and the
``compiled_*_plan`` functions read them from the built library. `kernel_work` gives
the bytes and operations a call must at least move and do, for a roofline
bound. Descriptors are (N, 8) int32 tensors: the uint32 words of the
packets, viewed as int32 (XOR and popcount ignore the sign).
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from . import depth_filter
from .image import warp_pass_positions

__all__ = ["projective_warp_banded", "plane_sweep", "sgm_scan_bidir", "wta",
           "hamming_matrix", "depth_filter_update", "small_eigh",
           "projective_warp_banded_twin", "plane_sweep_twin",
           "sgm_scan_bidir_twin", "wta_twin", "hamming_matrix_twin",
           "depth_filter_update_twin", "small_eigh_twin", "popcount32", "launches",
           "reset_launches", "sgm_scan_plan", "plane_sweep_plan", "wta_plan",
           "compiled_sgm_scan_plan", "compiled_plane_sweep_plan",
           "compiled_wta_plan", "hamming_plan", "compiled_hamming_plan",
           "kernel_work", "SgmScanPlan", "PlaneSweepPlan", "WtaPlan",
           "HammingPlan", "MAX_DYNAMIC_SMEM", "empty_launch", "counted_apart",
           "add_launches"]

launches = {"warp_banded": 0, "plane_sweep": 0, "sgm_scan": 0, "wta": 0,
            "hamming_matrix": 0, "depth_filter_update": 0, "small_eig": 0}

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
# Batched small symmetric eigendecomposition (cyclic Jacobi)
# ---------------------------------------------------------------------------

SMALL_EIG_MAX_N = 12
SMALL_EIG_SWEEPS = 8    # cyclic sweeps: off-diagonals of a 12x12 reach rounding in ~6


def small_eigh_twin(a: torch.Tensor):
    """Plain PyTorch twin of `small_eigh`: the same rotations in the same
    order, one pair (p, q) at a time over the whole batch."""
    b, n = a.shape[0], a.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    m = torch.where(lower, a, a.transpose(-1, -2)).clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(b, n, n).clone()
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for _ in range(SMALL_EIG_SWEEPS):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = m[:, p, p], m[:, q, q], m[:, p, q]
                theta = (aqq - app) / (2.0 * apq)
                sign = torch.where(theta >= 0.0, one, -one)
                t = sign / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
                c = one / torch.sqrt(t * t + 1.0)
                s = t * c
                rot = apq != 0.0
                c = torch.where(rot, c, one)[:, None]
                s = torch.where(rot, s, 0.0 * one)[:, None]
                for x in (m, v):           # columns p and q
                    kp, kq = x[:, :, p].clone(), x[:, :, q]
                    x[:, :, p] = c * kp - s * kq
                    x[:, :, q] = s * kp + c * kq
                pk, qk = m[:, p, :].clone(), m[:, q, :]   # rows p and q
                m[:, p, :] = c * pk - s * qk
                m[:, q, :] = s * pk + c * qk
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
    SMALL_EIG_SWEEPS cyclic Jacobi sweeps, whatever the convergence;
    nothing is read back to the host, so a call can be captured in a CUDA
    graph."""
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
    small_eig batch, n, itemsize (4 or 8: its operations are fp64 at 8)."""
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
    raise KeyError(f"no kernel named {name!r}")

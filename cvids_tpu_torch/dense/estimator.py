"""Multi-view dense depth estimation pipeline (port of
``cvids_tpu/dense/estimator.py``).

A reference keyframe accumulates a plane-sweep cost volume over subsequent
measurement frames (running mean), optionally biased toward sparse VIO
depths; SGM + WTA give a depth measurement that a Gaussian×Beta filter
fuses; `finalize` masks unconverged pixels. On the card, one
`fuse_measurement` runs the alignment warp, the sweep, both SGM orientations,
the WTA and the filter update as the five CUDA kernels of
``ops/cuda_kernels.py``.

The reference compiles the frame into one XLA program per `(cfg,
banded_warp)`. Its counterpart here is `DenseStep`: one client's state in
buffers that outlive its references, and the frame over them replayed as
one CUDA graph per `(cfg, banded_warp, sparse bias or not)`
(`utils.cuda_graph.GraphedCall`), bit-equal to the eager frame. A
reference roll (`DenseStep.roll`: the sparse splat, the filter's forward
splat, the reference maps and the reset) is one more graph per `(cfg,
sparse bias or not, landmark tier)` over the same buffers, its host inputs
one copy (`roll_inputs`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import costvolume, cuda_kernels, depth_filter, sgm
from ..ops.image import bilinear_sample, image_gradients

__all__ = ["DenseConfig", "DenseState", "DenseStep", "init_reference",
           "fuse_measurement", "finalize", "splat_sparse", "landmark_tier",
           "roll_inputs", "unpack_roll_inputs", "roll_reference"]


@dataclass(frozen=True)
class DenseConfig:
    """Defaults mirror `dense_mapping_parameters.h:19-53`: 128 hypotheses,
    DEP_SAMPLE = 1/(0.11·461), SGM pi1=16 pi2=64 tau_so=8, sparse bias 15."""

    height: int = 480
    width: int = 640
    num_depths: int = 128
    dep_sample: float = 1.0 / (0.11 * 461.0)  # inverse-depth step
    pi1: float = 16.0
    pi2: float = 64.0
    tau_so: float = 8.0
    sparse_ratio: float = 15.0
    tau2_scale: float = 0.05   # measurement variance per (inv-depth step)²
    min_frames: int = 2
    # per-pixel SGM penalty modulation from the reference image's texture
    use_penalty_map: bool = True
    # cost-volume storage dtype ("bfloat16" or "float32"); the filter is fp32
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        """The volume dtype as a torch.dtype (the reference's `jdtype`)."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def inv_depths(self) -> np.ndarray:
        return (np.arange(self.num_depths, dtype=np.float32) + 1.0) * self.dep_sample


class DenseState(NamedTuple):
    """Per-reference-keyframe accumulation state (all tensors on one device)."""

    ref_img: torch.Tensor      # (H, W)
    grad: torch.Tensor         # (H, W) gradient magnitude of ref
    mean_cost: torch.Tensor    # (H, W, D) running-mean AD cost
    count: torch.Tensor        # (H, W, D) measurement counts
    sparse_bias: torch.Tensor | None  # (H, W, D) cost bias (None = no landmarks)
    penalty: torch.Tensor      # (H, W) per-pixel SGM penalty modulation
    filt: depth_filter.FilterState
    num_frames: torch.Tensor   # () int32


def init_reference(cfg: DenseConfig, ref_img: torch.Tensor,
                   sparse_uv: torch.Tensor | None = None,
                   sparse_inv_depth: torch.Tensor | None = None,
                   sparse_valid: torch.Tensor | None = None,
                   out: DenseState | None = None) -> DenseState:
    """Start a new reference keyframe on `ref_img`'s device. With `out`, the
    new state is written into `out`'s buffers (a bias into
    `out.sparse_bias`, allocated if that is None) and returned in them."""
    h, w, d = cfg.height, cfg.width, cfg.num_depths
    dt = cfg.torch_dtype
    dev = ref_img.device
    # no sparse landmarks -> no bias volume to read and add every frame
    bias = None
    if sparse_uv is not None:
        bias = splat_sparse(cfg, sparse_uv, sparse_inv_depth,
                            sparse_valid).to(dt)
    ref_img, grad, penalty = _reference_maps(cfg, ref_img)
    filt = depth_filter.init_state(h, w, device=dev)
    if out is not None:
        return _reset(out, ref_img, grad, penalty, bias, filt)
    return DenseState(
        ref_img=ref_img,
        grad=grad,
        mean_cost=torch.zeros((h, w, d), dtype=dt, device=dev),
        count=torch.zeros((h, w, d), dtype=dt, device=dev),
        sparse_bias=bias,
        penalty=penalty,
        filt=filt,
        num_frames=torch.zeros((), dtype=torch.int32, device=dev))


def _reference_maps(cfg: DenseConfig, ref_img: torch.Tensor):
    """(fp32 image, gradient magnitude, SGM penalty map) of a reference."""
    ref_img = ref_img.to(torch.float32)
    grad = image_gradients(ref_img)
    penalty = (penalty_map(grad) if cfg.use_penalty_map
               else torch.ones((cfg.height, cfg.width), dtype=torch.float32,
                               device=ref_img.device))
    return ref_img, grad, penalty


def _reset(out: DenseState, ref_img, grad, penalty, bias, filt) -> DenseState:
    """A new reference's state written into `out`'s buffers."""
    out.ref_img.copy_(ref_img)
    out.grad.copy_(grad)
    out.penalty.copy_(penalty)
    out.mean_cost.zero_()
    out.count.zero_()
    out.num_frames.zero_()
    for dst, src in zip(out.filt, filt):
        dst.copy_(src)
    if bias is None:
        return out._replace(sparse_bias=None)
    if out.sparse_bias is None:
        return out._replace(sparse_bias=bias.clone())
    out.sparse_bias.copy_(bias)
    return out


def penalty_map(grad: torch.Tensor) -> torch.Tensor:
    """Per-pixel SGM penalty modulation from reference-image texture, in the
    reference's bounded scale-free form `0.8 + 1.5 / (1 + (|grad|/mean)^3)`
    (in (0.8, 2.3])."""
    g = torch.abs(grad.to(torch.float32))
    rel = g / torch.clamp(torch.mean(g), min=1e-6)
    return (0.8 + 1.5 / (1.0 + rel ** 3)).to(torch.float32)


def splat_sparse(cfg: DenseConfig, uv: torch.Tensor, inv_depth: torch.Tensor,
                 valid: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Cost bias from sparse VIO landmarks: near each projected landmark, add
    `sparse_ratio * |d_hyp - d_sparse| / dep_sample * w(dist)` to the volume.

    uv: (P, 2) pixel coords in the reference image; inv_depth: (P,).
    """
    h, w = cfg.height, cfg.width
    dev = uv.device
    hyp = _inv_depths(cfg, dev)                                  # (D,)
    n = h * w
    px = torch.round(uv[:, 0]).to(torch.int64)
    py = torch.round(uv[:, 1]).to(torch.int64)
    ok = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    flat = torch.where(ok, py * w + px, n)
    # where several landmarks round to one pixel the last one wins, as in
    # the reference's scatter on the CPU: an indexed assignment with
    # duplicate indices keeps whichever write lands last on a card, so the
    # winner is found first (the largest landmark index per pixel, an
    # order-free reduction) and its depth gathered. Rejected landmarks all
    # go to the spare slot n
    p = uv.shape[0]
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, flat, torch.arange(p, device=dev), "amax")
    winner = winner[:n]
    hit_b = winner >= 0
    padded = torch.cat([inv_depth.to(torch.float32), torch.zeros(1, device=dev)])
    depth_map = padded[torch.where(hit_b, winner, p)].reshape(h, w)
    hit = hit_b.to(torch.float32).reshape(h, w)
    zero = torch.zeros((), device=dev)
    # dilate the splat over a (2r+1)² window with inverse-distance weights,
    # tap by tap in the reference's order: `acc_d += roll(d)·roll(hit)·wgt`,
    # `acc_w += roll(hit)·wgt`. roll(d)·roll(hit) is roll(d·hit) exactly,
    # and each tap's roll is a window of one circularly padded copy of
    # (d·hit, hit), so a tap is two launches on a card, not nine
    both = torch.stack([depth_map * hit, hit])
    rows = (torch.arange(h + 2 * radius, device=dev) - radius) % h
    cols = (torch.arange(w + 2 * radius, device=dev) - radius) % w
    ring = both[:, rows][:, :, cols]
    acc = torch.zeros((2, h, w), device=dev)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            wgt = 1.0 / (1.0 + np.hypot(dy, dx))
            acc = acc + ring[:, radius - dy:radius - dy + h, radius - dx:radius - dx + w] * wgt
    acc_d, acc_w = acc[0], acc[1]
    mean_d = torch.where(acc_w > 0, acc_d / torch.clamp(acc_w, min=1e-9), zero)
    bias = torch.abs(hyp[None, None, :] - mean_d[..., None]) / cfg.dep_sample
    return bias * cfg.sparse_ratio * torch.clamp(acc_w, max=1.0)[..., None]


_INV_DEPTHS: dict = {}


def _inv_depths(cfg: DenseConfig, device: torch.device) -> torch.Tensor:
    """`cfg.inv_depths` on `device`, copied there once per (cfg, device):
    the frame itself copies nothing from the host."""
    key = (cfg, torch.device(device))
    t = _INV_DEPTHS.get(key)
    if t is None:
        t = _INV_DEPTHS[key] = torch.as_tensor(cfg.inv_depths, device=device)
    return t


def fuse_measurement(cfg: DenseConfig, state: DenseState, meas_img: torch.Tensor,
                     a_mat: torch.Tensor, b_vec: torch.Tensor,
                     banded_warp: bool | None = None) -> DenseState:
    """Fuse one measurement frame: cost slice -> running mean -> (bias + SGM
    + WTA) -> filter.

    a_mat = K_m R_mr K_r^-1, b_vec = K_m t_mr (reference-to-measurement), as
    tensors on the state's device. `banded_warp` picks the banded alignment
    warp; hosts with the numpy a_mat in hand gate it on
    `costvolume.warp_shift_bounds_np`.

    Updates `state.mean_cost`, `state.count` and `state.num_frames` IN PLACE
    (the two (H, W, D) volumes are not copied per frame); the returned state
    shares them. It reads nothing back and copies nothing from the host, so
    it can be captured (`DenseStep`).
    """
    dev = state.ref_img.device
    inv_depths = _inv_depths(cfg, dev)
    c, v = costvolume.plane_sweep_cost(state.ref_img, meas_img.to(torch.float32),
                                       a_mat, b_vec, inv_depths,
                                       out_dtype=cfg.torch_dtype,
                                       banded_warp=banded_warp)
    mean_cost, count = costvolume.accumulate_cost(state.mean_cost, state.count, c, v)

    # SGM input: unobserved hypotheses get a high constant so they can't win
    observed = count > 0
    total = torch.where(observed, mean_cost,
                        torch.full((), 50.0, dtype=mean_cost.dtype, device=dev))
    if state.sparse_bias is not None:
        total = total + state.sparse_bias
    inv_depth, conf = sgm.sgm_depth(total, state.grad.to(total.dtype),
                                    inv_depths,
                                    valid_count=observed.sum(-1),
                                    min_count=cfg.num_depths * 0.25,
                                    pi1=cfg.pi1, pi2=cfg.pi2, tau_so=cfg.tau_so,
                                    penalty_scale=state.penalty)
    tau2 = (cfg.dep_sample ** 2) / cfg.tau2_scale
    filt = cuda_kernels.depth_filter_update(state.filt, inv_depth, tau2, conf)
    state.num_frames.add_(1)
    return state._replace(mean_cost=mean_cost, count=count, filt=filt)


def finalize(cfg: DenseConfig, state: DenseState,
             ratio: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """(inv_depth (H, W), valid (H, W)): the converged-pixel mask (inlier
    ratio >= `ratio`) after at least `cfg.min_frames` frames."""
    ok = depth_filter.converged_mask(state.filt, ratio)
    ok = ok & (state.num_frames >= cfg.min_frames)
    return state.filt.mu, ok


def propagate_reference(cfg: DenseConfig, prev: DenseState,
                        new_ref_img: torch.Tensor,
                        r_no: torch.Tensor, t_no: torch.Tensor,
                        k_mat: torch.Tensor,
                        sparse_bias: torch.Tensor | None = None,
                        out: DenseState | None = None) -> DenseState:
    """Start a new reference keyframe seeded from the previous one's filter
    state, forward-warped through the relative transform old-cam -> new-cam,
    so depth knowledge survives reference switches. With `out` (which may
    be `prev`'s own buffers), the new state is written into `out`'s
    buffers, as `init_reference` writes them."""
    from ..utils import tracing     # not at import: `utils` imports this module
    with tracing.sync():     # the inverse's error check blocks the host
        k_inv = torch.linalg.inv(k_mat)
    filt = depth_filter.propagate(prev.filt, r_no, t_no, k_mat, k_inv)
    bias = None if sparse_bias is None else sparse_bias.to(cfg.torch_dtype)
    if out is not None:
        return _reset(out, *_reference_maps(cfg, new_ref_img), bias, filt)
    st = init_reference(cfg, new_ref_img)
    return st._replace(sparse_bias=bias, filt=filt)


_SLOT = 128     # float32 words: a roll input starts where an allocation of its own would


def landmark_tier(p: int) -> int:
    """The rows a roll's `p` landmarks are padded to: a power of two from
    256, so that a client's rolls meet few shapes."""
    return max(256, 1 << max(p - 1, 0).bit_length())


def roll_inputs(r_no: np.ndarray, t_no: np.ndarray, k_mat: np.ndarray,
                landmarks: tuple | None, device) -> torch.Tensor:
    """A roll's host inputs as one float32 buffer on `device`, in one copy
    that does not wait for the stream on a card (from pinned memory, which
    PyTorch's host allocator keeps until the copy has run): r_no, t_no and
    K, each in a slot of its own, then the landmarks (uv (P, 2), inverse
    depth (P,), valid (P,) as 0 or 1) padded to `landmark_tier(P)` rows,
    the padded rows invalid. An invalid row goes to `splat_sparse`'s spare
    slot and never wins a pixel, so the bias is the unpadded landmarks' bit
    for bit. `unpack_roll_inputs` reads it."""
    tier = 0 if landmarks is None else landmark_tier(len(landmarks[0]))
    buf = np.zeros(3 * _SLOT + 4 * tier, np.float32)
    buf[:9] = np.asarray(r_no, np.float32).reshape(-1)
    buf[_SLOT:_SLOT + 3] = np.asarray(t_no, np.float32)
    buf[2 * _SLOT:2 * _SLOT + 9] = np.asarray(k_mat, np.float32).reshape(-1)
    if landmarks is not None:
        uv, inv_depth, valid = landmarks
        lm = buf[3 * _SLOT:].reshape(4, tier)       # uv in the first two rows
        lm[:2].reshape(-1)[:2 * len(uv)] = np.asarray(uv, np.float32).reshape(-1)
        lm[2, :len(uv)] = np.asarray(inv_depth, np.float32)
        lm[3, :len(uv)] = np.asarray(valid, bool)
    t = torch.from_numpy(buf)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def unpack_roll_inputs(inputs: torch.Tensor) -> tuple:
    """(r_no (3, 3), t_no (3,), k_mat (3, 3), landmarks): views of a
    `roll_inputs` buffer, the landmarks (uv, inverse depth, valid) with
    `valid` as bool, or None."""
    r_no = inputs[:9].view(3, 3)
    t_no = inputs[_SLOT:_SLOT + 3]
    k_mat = inputs[2 * _SLOT:2 * _SLOT + 9].view(3, 3)
    tier = (inputs.shape[0] - 3 * _SLOT) // 4
    if not tier:
        return r_no, t_no, k_mat, None
    lm = inputs[3 * _SLOT:].view(4, tier)
    return r_no, t_no, k_mat, (lm[:2].reshape(tier, 2), lm[2], lm[3] > 0.5)


def roll_reference(cfg: DenseConfig, state: DenseState, new_ref_img: torch.Tensor,
                   inputs: torch.Tensor, k_inv: torch.Tensor) -> None:
    """`propagate_reference(..., out=state)` in place on a `roll_inputs`
    buffer, with K's inverse given and the sparse bias, if the buffer has
    landmarks, splatted here into `state.sparse_bias`, which must then be a
    buffer (the copy casts it to the volume dtype). The same operations in
    the same order as the splat followed by `propagate_reference`; it reads
    nothing back and copies nothing from the host, so it can be captured
    (`DenseStep.roll`)."""
    r_no, t_no, k_mat, landmarks = unpack_roll_inputs(inputs)
    bias = None if landmarks is None else splat_sparse(cfg, *landmarks)
    filt = depth_filter.propagate(state.filt, r_no, t_no, k_mat, k_inv)
    _reset(state, *_reference_maps(cfg, new_ref_img), bias, filt)


class DenseStep:
    """One client's dense state in buffers that outlive its references, and
    the frame over them as a CUDA graph per `(cfg, banded_warp, sparse bias
    or not)`, the reference's jit signature (`cvids_tpu/dense/
    estimator.py:164`).

    `init_reference` and `roll` write a new reference into the buffers
    (the first call allocates them), so the graphs stay valid for the
    client's whole run; `fuse` copies the measurement image, `a_mat` and
    `b_vec` into the graph's inputs and replays it, and the frame's filter
    state lands in the bound filter buffers. `roll` is `roll_reference`
    (`propagate_reference` seeded from the current filter) over the
    buffers, replayed as one more graph per `(cfg, sparse bias or not,
    landmark tier)`. `graphs` and `rolls` may be
    shared by several steps (one pool each for a server's dense graphs, see
    `fuse_graphs`). On the CPU, and inside `utils.cuda_graph.
    disable_graphs()`, `fuse` and `roll` are the eager functions with the
    same effect."""

    def __init__(self, cfg: DenseConfig, graphs=None, rolls=None):
        self.cfg = cfg
        self.graphs = graphs if graphs is not None else fuse_graphs()
        self.rolls = rolls if rolls is not None else roll_graphs()
        self.state: DenseState | None = None
        self._bias: torch.Tensor | None = None    # kept while a reference has none

    def init_reference(self, ref_img: torch.Tensor, **sparse) -> DenseState:
        st = init_reference(self.cfg, ref_img, **sparse, out=self._buffers())
        if self.state is None:      # the step owns its buffers: not the caller's image
            st = st._replace(ref_img=st.ref_img.clone())
        return self._keep(st)

    def roll(self, new_ref_img: torch.Tensor, inputs: torch.Tensor,
             k_inv: torch.Tensor) -> DenseState:
        """The next reference, seeded from the current one's filter
        (`propagate_reference`), from a `roll_inputs` buffer and K's
        inverse: `roll_reference` through `rolls`, one graph replay on the
        card."""
        cfg = self.cfg
        out = self._buffers()._replace(sparse_bias=None)
        if inputs.shape[0] > 3 * _SLOT:     # landmarks: a bias into the kept buffer
            if self._bias is None:
                self._bias = torch.empty((cfg.height, cfg.width, cfg.num_depths),
                                         dtype=cfg.torch_dtype, device=self.state.ref_img.device)
            out = out._replace(sparse_bias=self._bias)
        self.rolls(cfg, out, new_ref_img, inputs, k_inv)
        return self._keep(out)

    def fuse(self, meas_img: torch.Tensor, a_mat: torch.Tensor, b_vec: torch.Tensor,
             banded_warp: bool | None = None) -> DenseState:
        self.graphs(self.cfg, self.state, meas_img.to(torch.float32), a_mat, b_vec,
                    banded_warp)
        return self.state

    def _buffers(self) -> DenseState | None:
        return None if self.state is None else self.state._replace(sparse_bias=self._bias)

    def _keep(self, state: DenseState) -> DenseState:
        if state.sparse_bias is not None:
            self._bias = state.sparse_bias
        self.state = state
        return state


def _fuse_into(cfg: DenseConfig, state: DenseState, meas_img, a_mat, b_vec,
               banded_warp) -> None:
    """`fuse_measurement` with the new filter state copied into the
    state's own filter buffers: the whole frame updates `state` in place."""
    new = fuse_measurement(cfg, state, meas_img, a_mat, b_vec, banded_warp=banded_warp)
    for dst, src in zip(state.filt, new.filt):
        dst.copy_(src)


def fuse_graphs():
    """The graphed frame of `DenseStep`, with the state bound (captured over
    the step's own buffers): one graph per state and signature, all in one
    memory pool (`utils.cuda_graph.GraphedCall`)."""
    from ..utils.cuda_graph import GraphedCall   # utils.config imports this module
    return GraphedCall(_fuse_into, bound=(1,))


def roll_graphs():
    """The graphed roll of `DenseStep.roll` (`roll_reference` with the state
    bound): one graph per state and signature, in a pool of its own."""
    from ..utils.cuda_graph import GraphedCall
    return GraphedCall(roll_reference, bound=(1,))


def regularize_depth(state: DenseState, strength: float = 1.0) -> DenseState:
    """Covariance-weighted 3×3 smoothing of the inverse-depth map: each
    pixel averages its neighborhood with weights 1/(sigma² + eps), pulled
    toward the center by `strength`; only converged-ish pixels vote."""
    mu, s2 = state.filt.mu, state.filt.sigma2
    w = 1.0 / (s2 + 1e-4)
    w = w * (state.filt.a / torch.clamp(state.filt.a + state.filt.b, min=1e-9))
    num = torch.zeros_like(mu)
    den = torch.zeros_like(mu)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0):
                wgt = 1.0
            else:
                wgt = strength / torch.sqrt(
                    torch.tensor(float(dy * dy + dx * dx), device=mu.device))
            mu_s = torch.roll(mu, (dy, dx), (0, 1))
            w_s = torch.roll(w, (dy, dx), (0, 1)) * wgt
            num = num + mu_s * w_s
            den = den + w_s
    mu_new = torch.where(den > 1e-9, num / torch.clamp(den, min=1e-9), mu)
    return state._replace(filt=state.filt._replace(mu=mu_new))


def validate_photometric(cfg: DenseConfig, state: DenseState,
                         meas_img: torch.Tensor, a_mat: torch.Tensor,
                         b_vec: torch.Tensor,
                         max_err: float = 20.0) -> torch.Tensor:
    """Photometric validation mask: warp each reference pixel into the
    measurement frame at its estimated inverse depth and keep pixels whose
    absolute intensity error is below `max_err`. Pixels whose warp lands
    outside the measurement are unvalidatable and kept."""
    h, w = cfg.height, cfg.width
    dev = state.ref_img.device
    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    base = torch.einsum("ij,jhw->ihw", a_mat,
                        torch.stack([uu, vv, torch.ones_like(uu)]))
    p = base + b_vec[:, None, None] * state.filt.mu[None]
    z = torch.where(torch.abs(p[2]) > 1e-6, p[2], torch.full_like(p[2], 1e-6))
    coords = torch.stack([p[0] / z, p[1] / z], dim=-1)
    warped = bilinear_sample(meas_img.to(torch.float32), coords, fill=math.nan)
    err = torch.abs(warped - state.ref_img)
    in_view = ((coords[..., 0] >= 0) & (coords[..., 0] <= w - 1)
               & (coords[..., 1] >= 0) & (coords[..., 1] <= h - 1))
    return ~in_view | (torch.isfinite(err) & (err < max_err))

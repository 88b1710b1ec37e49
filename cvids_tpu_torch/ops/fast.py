"""FAST-9/16 corner detection, vectorized (port of ``cvids_tpu/ops/fast.py``).

Replaces the reference's per-keyframe `cv::FAST(img, keypoints, 20, true)`
(`server_keyframe.cpp:267-290`) and the agent front-end's detection (max 150
features, 30 px min spacing, `euroc_config.yaml:44-45`): the segment test is
16 shifted-image comparisons, and spatial spreading takes the best corner of
each grid cell. The ring's shifts are views of one edge-padded copy. The
score sums the 16 taps in ring order, one add at a time, as XLA's reduction
over the leading axis does, so the score map equals the JAX package's bit for
bit. Top-k ties go to the lower index (a stable sort), as with `lax.top_k`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["fast_score_map", "select_keypoints", "Keypoints"]

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9


class Keypoints(NamedTuple):
    xy: torch.Tensor      # (K, 2) float32 pixel coords (x, y)
    score: torch.Tensor   # (K,)
    valid: torch.Tensor   # (K,) bool


def _shifts(img: torch.Tensor, offsets, pad: int = 3) -> list[torch.Tensor]:
    """Views out[y, x] = img[y + dy, x + dx] of (..., H, W), edge-padded."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    x = F.pad(img.reshape((-1, 1, h, w)), (pad, pad, pad, pad), mode="replicate")
    x = x.reshape(lead + (h + 2 * pad, w + 2 * pad))
    return [x[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w] for dy, dx in offsets]


def fast_score_map(img: torch.Tensor, threshold: float = 20.0,
                   nms: bool = True) -> torch.Tensor:
    """FAST-9 corner score map for (..., H, W) grayscale images.

    Score is the sum of threshold-exceeding contrast over the circle for the
    stronger polarity. Non-corners and (optionally) non-local-maxima score
    0; a 3-pixel border is zeroed."""
    img = img.to(torch.float32)
    taps = _shifts(img, _CIRCLE)
    circle = torch.stack(taps)                                   # (16, ..., H, W)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=img.device)
    bright = circle > img + thr
    dark = circle < img - thr

    def has_arc(mask):
        doubled = torch.cat([mask, mask[:ARC_LEN - 1]], dim=0).to(torch.int32)
        csum = torch.cumsum(doubled, dim=0)
        csum = torch.cat([torch.zeros_like(csum[:1]), csum], dim=0)
        runs = csum[ARC_LEN:] - csum[:-ARC_LEN]
        return torch.amax(runs, dim=0) >= ARC_LEN

    is_corner = has_arc(bright) | has_arc(dark)
    bright_c = torch.clamp(circle - img - thr, min=0.0)
    dark_c = torch.clamp(img - thr - circle, min=0.0)
    bright_sum, dark_sum = bright_c[0], dark_c[0]
    for i in range(1, 16):
        bright_sum = bright_sum + bright_c[i]
        dark_sum = dark_sum + dark_c[i]
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    score = torch.where(is_corner, torch.maximum(bright_sum, dark_sum), zero)

    h, w = img.shape[-2:]
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    score = torch.where(interior, score, zero)

    if nms:
        neigh = torch.stack(_shifts(score, [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                                            if (dy, dx) != (0, 0)], pad=1))
        score = torch.where(score >= torch.amax(neigh, dim=0), score, zero)
    return score


def select_keypoints(score: torch.Tensor, max_num: int, cell: int = 30,
                     min_score: float = 1e-6,
                     existing_xy: torch.Tensor | None = None,
                     existing_valid: torch.Tensor | None = None,
                     min_dist: float | None = None) -> Keypoints:
    """Spatially spread top-K: the best corner of each `cell`×`cell` grid
    cell (the first maximum in row-major order), then the global top-K by
    score, ties to the lower cell index.

    `existing_xy/valid`: already-tracked features; cells whose winner lies
    within `min_dist` (default `cell`) of one are suppressed."""
    h, w = score.shape[-2:]
    dev = score.device
    ncy, ncx = -(-h // cell), -(-w // cell)
    s = F.pad(score, (0, ncx * cell - w, 0, ncy * cell - h))
    cells = s.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(ncy * ncx, cell * cell)
    best = torch.argmax(cells, dim=1)
    cell_score = torch.gather(cells, 1, best[:, None])[:, 0]
    ids = torch.arange(ncy * ncx, device=dev)
    py = (ids // ncx) * cell + best // cell
    px = (ids % ncx) * cell + best % cell

    if existing_xy is not None:
        d2 = ((px[:, None] - existing_xy[None, :, 0]) ** 2
              + (py[:, None] - existing_xy[None, :, 1]) ** 2)
        if existing_valid is not None:
            d2 = torch.where(existing_valid[None, :], d2,
                             torch.full((), float("inf"), device=dev))
        r = (min_dist if min_dist is not None else cell) ** 2
        near = torch.any(d2 < r, dim=1)
        cell_score = torch.where(near, torch.zeros((), device=dev), cell_score)

    k = min(max_num, ncy * ncx)
    top_idx = torch.sort(cell_score, descending=True, stable=True).indices[:k]
    top_score = cell_score[top_idx]
    xy = torch.stack([px[top_idx], py[top_idx]], dim=-1).to(torch.float32)
    valid = top_score > min_score
    if k < max_num:
        xy = F.pad(xy, (0, 0, 0, max_num - k))
        top_score = F.pad(top_score, (0, max_num - k))
        valid = F.pad(valid, (0, max_num - k))
    return Keypoints(xy, top_score, valid)

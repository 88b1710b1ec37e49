"""Batched 256-bit binary-descriptor Hamming matching (port of
``cvids_tpu/ops/hamming.py``).

Descriptors are (N, 8) int32 tensors: the packets' uint32 words viewed as
int32 (`descriptors_to_torch`), since torch's uint32 supports few ops and XOR
and popcount do not care about the sign. The (N, M) distance matrix is the
`cuda_kernels.hamming_matrix` kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from . import cuda_kernels

__all__ = ["hamming_distance_matrix", "match_descriptors", "MatchResult",
           "pack_bits", "unpack_bits", "descriptors_to_torch"]

# Acceptance gates mirroring `ServerKeyFrame::SearchInArea`
# (`server_keyframe.cpp:294-332`): best distance < 80 and best < 0.7 * second.
DEFAULT_MAX_DIST = 80
DEFAULT_RATIO = 0.7


class MatchResult(NamedTuple):
    """indices: (N,) best match in B per A row; valid: (N,) bool mask."""

    indices: torch.Tensor
    distances: torch.Tensor
    valid: torch.Tensor


def descriptors_to_torch(desc: np.ndarray, device=None) -> torch.Tensor:
    """(..., 8) uint32 numpy descriptors -> int32 tensor of the same bits on
    `device` (None: the card, `cvids_tpu_torch.default_device()`)."""
    words = np.ascontiguousarray(desc, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words.copy()).to(resolve_device(device))


def hamming_distance_matrix(a: torch.Tensor, b: torch.Tensor,
                            a_valid: torch.Tensor | None = None,
                            b_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise Hamming distances: a (N, 8), b (M, 8) -> (N, M) int32.
    Invalid rows and columns get distance 512 (> any real 256-bit distance)."""
    return cuda_kernels.hamming_matrix(a, b, a_valid, b_valid)


def match_descriptors(a: torch.Tensor, b: torch.Tensor,
                      a_valid: torch.Tensor | None = None,
                      b_valid: torch.Tensor | None = None,
                      max_dist: int = DEFAULT_MAX_DIST,
                      ratio: float = DEFAULT_RATIO,
                      cross_check: bool = False) -> MatchResult:
    """Best match with absolute + Lowe ratio gates (reference semantics).

    A row matches iff best < max_dist and best < ratio * second best (the
    second-best test is skipped when M == 1, the reference's early exit).
    Ties go to the lowest column index."""
    d = hamming_distance_matrix(a, b, a_valid, b_valid)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    if d.shape[1] > 1:
        second = torch.amin(d.scatter(1, best_idx[:, None], 512), dim=1)
        ok = (best < max_dist) & (best.to(torch.float32) < ratio * second.to(torch.float32))
    else:
        ok = best < max_dist
    if cross_check:
        rev_best = torch.argmin(d, dim=0)       # for each B column, best A row
        ok = ok & (rev_best[best_idx] == torch.arange(d.shape[0], device=d.device))
    if a_valid is not None:
        ok = ok & a_valid
    return MatchResult(best_idx, best, ok)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} -> (..., 8) int32 words, little-endian within each
    word (the uint32 bit pattern)."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    shifts = torch.arange(32, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)   # wrap to int32


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 256) {0,1} uint8."""
    shifts = torch.arange(32, device=words.device)
    bits = ((words.to(torch.int64) & 0xFFFFFFFF)[..., :, None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (256,)).to(torch.uint8)

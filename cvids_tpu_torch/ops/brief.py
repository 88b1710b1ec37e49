"""BRIEF-256 binary descriptors with a fixed, reproducible test pattern
(port of ``cvids_tpu/ops/brief.py``).

The reference's DVision BRIEF extractor (`server_brief_extractor.cpp:6-30`,
`DVision/BRIEF.cpp:43-106`): 256 pairwise intensity tests on a σ=2-blurred
patch. The pattern is drawn from numpy's generator with a fixed seed, the
same draws as the JAX package's, so the two packages' descriptors and
vocabularies pair up. Descriptors are (N, 8) int32 tensors, the uint32 words
viewed as int32 (`ops.hamming`).
"""

from __future__ import annotations

import numpy as np
import torch

from .hamming import pack_bits
from .image import bilinear_sample, gaussian_blur

__all__ = ["brief_pattern", "compute_brief", "BRIEF_BITS", "PATCH_HALF",
           "load_brief_pattern_yaml", "save_brief_pattern_yaml"]

BRIEF_BITS = 256
PATCH_HALF = 24  # pattern coordinates live in [-24, 24], as in DVision BRIEF


def brief_pattern(seed: int = 7, bits: int = BRIEF_BITS,
                  half: int = PATCH_HALF) -> np.ndarray:
    """(bits, 4) int32 array of (x1, y1, x2, y2) test offsets, fixed seed."""
    rng = np.random.default_rng(seed)
    sigma = half / 2.5
    pts = rng.normal(0.0, sigma, size=(bits, 4))
    return np.clip(np.round(pts), -half, half).astype(np.int32)


_DEFAULT_PATTERN = brief_pattern()
_PATTERN_ON = {}     # device -> the default pattern as a float32 tensor there


def _pattern_tensor(pattern, device) -> torch.Tensor:
    if pattern is None:
        key = torch.device(device)
        if key not in _PATTERN_ON:
            _PATTERN_ON[key] = torch.from_numpy(_DEFAULT_PATTERN.astype(np.float32)).to(device)
        return _PATTERN_ON[key]
    return torch.as_tensor(np.asarray(pattern) if not isinstance(pattern, torch.Tensor)
                           else pattern, dtype=torch.float32, device=device)


def compute_brief(img: torch.Tensor, xy: torch.Tensor,
                  pattern: np.ndarray | torch.Tensor | None = None,
                  blur_sigma: float = 2.0,
                  pre_blurred: bool = False) -> torch.Tensor:
    """Descriptors for keypoints: img (H, W), xy (N, 2) float (x, y) ->
    (N, 8) int32 words. Bit b of word j is set iff I(p1) < I(p2) for test
    32 j + b (DVision). Taps outside the image read edge values (callers keep
    keypoints PATCH_HALF away from the border)."""
    pat = _pattern_tensor(pattern, img.device)
    blurred = img if pre_blurred else gaussian_blur(img, blur_sigma, radius=4)
    p1 = xy[:, None, :] + pat[None, :, 0:2]
    p2 = xy[:, None, :] + pat[None, :, 2:4]
    i1 = bilinear_sample(blurred, p1)
    i2 = bilinear_sample(blurred, p2)
    return pack_bits(i1 < i2)


def load_brief_pattern_yaml(path: str) -> np.ndarray:
    """Load a DVision BRIEF test pattern from the reference's
    `brief_pattern.yml` format (OpenCV FileStorage YAML with int lists x1,
    y1, x2, y2, read at `server_brief_extractor.cpp:14-23`). Returns the
    (bits, 4) int pattern for `compute_brief(..., pattern=...)`."""
    import re

    text = open(path).read()
    cols = []
    for key in ("x1", "y1", "x2", "y2"):
        m = re.search(rf"^\s*{key}\s*:\s*\[([^\]]*)\]", text,
                      re.MULTILINE | re.DOTALL)
        if m is None:
            raise ValueError(f"pattern file missing key {key!r}: {path}")
        cols.append(np.asarray(
            [int(tok) for tok in m.group(1).replace(",", " ").split()],
            np.int32))
    x1, y1, x2, y2 = cols
    if not (len(x1) == len(y1) == len(x2) == len(y2)):
        raise ValueError("pattern list lengths differ")
    return np.stack([x1, y1, x2, y2], axis=1)


def save_brief_pattern_yaml(path: str, pattern: np.ndarray) -> None:
    """Write a pattern in the OpenCV-FileStorage YAML layout the reference
    reads (round-trips through `load_brief_pattern_yaml`)."""
    p = np.asarray(pattern, np.int64)
    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        for key, col in zip(("x1", "y1", "x2", "y2"),
                            (p[:, 0], p[:, 1], p[:, 2], p[:, 3])):
            body = ", ".join(str(int(v)) for v in col)
            f.write(f"{key}: [ {body} ]\n")

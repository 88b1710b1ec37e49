"""The bytes and operations a layer's work needs, and the chip's published
peaks: the yardstick of the roofline shares.

The counts are of what the operation needs, never of what one
implementation does, so a later change that fuses, splits or renames
kernels is held to the same work. The per-element operation counts are a
frozen copy of those the program's `ops/cuda_kernels.kernel_work` states
for the same kernels (and `chip_smoke.roofline` divides by these peaks).
"""

from __future__ import annotations

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def dense_step_work(h: int, w: int, d: int, itemsize: int, bias: bool = True) -> tuple[int, int]:
    """(bytes, operations) of one fused frame at h x w x d, the volumes at
    `itemsize` bytes: the measurement image and the 3x3 maps read; the
    reference's image, gradient and penalty maps read; the running mean and
    count volumes read and written once; the landmark bias volume read once;
    the Gaussian x Beta state (4 maps) read and written. Operations: the
    alignment warp 60 a pixel; the sweep 32 a sample; the running mean 4 a
    sample; the four SGM scans 17 a sample and direction pair (x2); the
    winner-take-all over the two parts 5 a sample; the filter 60 a pixel."""
    px, vol = h * w, h * w * d
    nbytes = (4 * px + 2 * 36 + 3 * 4 * px + 2 * 2 * vol * itemsize
              + (vol * itemsize if bias else 0) + 2 * 4 * 4 * px)
    ops = 60 * px + (32 + 4 + 2 * 17 + 5) * vol + 60 * px
    return nbytes, ops


def tsdf_work(m: int, s: int, h: int, w: int, updated: int, carved: int,
              color_px: int = 4) -> tuple[int, int]:
    """(bytes, operations) of one published map's integrate into `m` chunks
    of s^3 voxels (`kernel_work("tsdf_integrate")`): every voxel's sdf and
    weight read, an updated voxel's colour read, the words that change
    written (5 an updated voxel, 1 a carved one), a depth and a colour
    sample a pixel at most, the slots and coordinates; 55 operations a
    voxel, 27 more an updated one."""
    vox = m * s ** 3
    pixels = min(h * w, vox)
    written = 5 * updated + carved
    return (8 * vox + 12 * updated + 4 * written + (4 + color_px) * pixels + 20 * m + 84,
            55 * vox + 27 * updated)


def bound_s(nbytes: int, ops: int) -> float:
    """The least time the chip could take: the larger of bytes over the
    memory rate and operations over the fp32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S)

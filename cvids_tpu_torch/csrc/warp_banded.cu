// Banded two-pass projective warp: the alignment warp of the plane sweep.
//
// Replaces projective_warp_banded in cvids_tpu/ops/pallas_kernels.py
// (_warp_rows_kernel, _warp_cols_kernel) and the position math its wrapper
// runs before them. There the TPU has no fast gather, so each 1-D pass is a
// static fan of 2*band+1 shifted taps, every one multiplied by its hat
// weight, and the two passes meet in an (H, W) intermediate. A hat weight is
// nonzero only at the two integer taps around the sample position, so here
// ONE kernel does both passes, one thread per output pixel (v, u):
// - it computes the column-pass position y_in(v, u) from the 3x3 map;
// - for each of the two column taps y = v + k that lie within the band and
//   the image, it computes the row-pass position g(y, u) and runs the row
//   pass at (y, u): two taps of the image, value and coverage;
// - it combines the two rows with the column weights.
// The row pass at (y, u) is the same arithmetic whichever thread runs it, so
// the result is that of two kernels with the intermediate in memory; the
// intermediate, the coverage of the row pass and both position planes never
// exist. The map is nine floats behind a device pointer, read by every
// thread (one cached line): the host never reads it.
//
// Bound on the card: memory, 3.7 MB at 640x480 (the image in, value and
// coverage out), about a microsecond; the kernel's time is launch latency.
// Its at most four image taps are neighbours of the thread's own pixel and
// come from L1/L2. Threads run along u, so a warp's reads and writes are one
// or two contiguous lines each.
//
// Semantics kept from the reference kernels:
// - a tap counts only if its offset from the output coordinate lies within
//   +-band (a larger shift gives coverage 0, the caller's cue to take the
//   exact warp instead);
// - row pass: a tap outside [0, W-1] adds 0 to the value and the coverage;
// - column pass: the coverage is resampled from the row-pass coverage;
// - a row r with |m11 - r m21| < 1e-3 is degenerate: g = -1e9, so no tap is
//   within the band;
// - a sample at exactly W-1 has weight 0 on its right-hand tap, which is
//   never read.
// Taps are added in increasing offset order, as the reference's fan does.
//
// Exact arithmetic: the positions follow ops/image.py's warp_pass_positions
// operation by operation, each rounded to fp32 (the library builds without
// fused multiply-adds), with IEEE divisions:
//   v_ur = (((r (m20 u + m22)) - m10 u) - m12) / safe_den
//   g    = ((m00 u + m01 v_ur) + m02) / guard((m20 u + m21 v_ur) + m22)
//   y_in = ((m10 u + m11 v) + m12) / guard((m20 u + m21 v) + m22)
// with guard(z) = z where |z| > 1e-6, else 1e-6. An offset is converted to
// an integer only after the band test (a degenerate row has k ~ -1e9).

#include "common.cuh"

namespace {

constexpr int WARP_THREADS = 128;

__device__ __forceinline__ float guard_den(float z) {
  return fabsf(z) > 1e-6f ? z : 1e-6f;
}

// the row pass at (r, u): value and coverage of input row r resampled at
// g(r, u), taps limited to +-band
__device__ __forceinline__ void row_pass(const float* __restrict__ img, const float* m,
                                         int r, int u, int w, float fband,
                                         float& val, float& cov) {
  const float fr = static_cast<float>(r);
  const float fu = static_cast<float>(u);
  const float den_v = m[4] - fr * m[7];
  const bool deg = fabsf(den_v) < 1e-3f;
  const float safe_den = deg ? 1.0f : den_v;
  const float v_ur = (((fr * (m[6] * fu + m[8])) - m[3] * fu) - m[5]) / safe_den;
  const float zd = guard_den((m[6] * fu + m[7] * v_ur) + m[8]);
  float g = ((m[0] * fu + m[1] * v_ur) + m[2]) / zd;
  if (deg) g = -1e9f;
  const float delta = g - fu;
  const float k0 = floorf(delta);
  const float* row = img + static_cast<long>(r) * w;
  val = 0.0f;
  cov = 0.0f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float k = k0 + static_cast<float>(t);
    if (fabsf(k) <= fband) {
      const float wk = fmaxf(0.0f, 1.0f - fabsf(delta - k));
      const int x = u + static_cast<int>(k);
      if (x >= 0 && x <= w - 1) {
        val = val + wk * row[x];
        cov = cov + wk;
      }
    }
  }
}

__global__ void __launch_bounds__(WARP_THREADS)
warp_banded_kernel(const float* __restrict__ img, const float* __restrict__ map,
                   float* __restrict__ out, float* __restrict__ cov_out, int h, int w,
                   int band_x, int band_y) {
  const int u = blockIdx.x * WARP_THREADS + threadIdx.x;
  const int v = blockIdx.y;
  if (u >= w) return;
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = __ldg(map + i);
  const float fu = static_cast<float>(u);
  const float fv = static_cast<float>(v);
  const float fband_x = static_cast<float>(band_x);
  const float fband_y = static_cast<float>(band_y);
  const float zz = guard_den((m[6] * fu + m[7] * fv) + m[8]);
  const float y_in = ((m[3] * fu + m[4] * fv) + m[5]) / zz;
  const float delta = y_in - fv;
  const float k0 = floorf(delta);
  float acc = 0.0f, cv = 0.0f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float k = k0 + static_cast<float>(t);
    if (fabsf(k) <= fband_y) {
      const float wk = fmaxf(0.0f, 1.0f - fabsf(delta - k));
      const int y = v + static_cast<int>(k);
      if (y >= 0 && y <= h - 1) {
        float val, c;
        row_pass(img, m, y, u, w, fband_x, val, c);
        acc = acc + wk * val;
        cv = cv + wk * c;
      }
    }
  }
  const long i = static_cast<long>(v) * w + u;
  out[i] = acc;
  cov_out[i] = cv;
}

}  // namespace

// img (h, w) fp32; map: the 3x3 fp32 matrix, row-major, on the device; out,
// cov (h, w) fp32. One launch.
extern "C" int cvids_warp_banded(const void* img, const void* map, void* out, void* cov,
                                 int h, int w, int band_x, int band_y, void* stream) {
  if (h < 1 || w < 1 || h > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + WARP_THREADS - 1) / WARP_THREADS, h);
  warp_banded_kernel<<<grid, WARP_THREADS, 0, st>>>(
      static_cast<const float*>(img), static_cast<const float*>(map),
      static_cast<float*>(out), static_cast<float*>(cov), h, w, band_x, band_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cvids_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

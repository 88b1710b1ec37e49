// Banded two-pass projective warp: the alignment warp of the plane sweep.
//
// Replaces projective_warp_banded in cvids_tpu/ops/pallas_kernels.py
// (_warp_rows_kernel, _warp_cols_kernel). There the TPU has no fast gather,
// so each 1-D pass is a static fan of 2*band+1 shifted taps, every one
// multiplied by its hat weight. A hat weight is nonzero only at the two
// integer taps around the sample position, so here each pass is one thread
// per output pixel that reads those two taps and nothing else.
//
// Bound on the card: memory. Each pass reads two (H, W) fp32 planes and
// writes two, about 5 MB per pass at 640x480; the taps are neighbours of the
// thread's own pixel and come from L1/L2. Threads run along u, so every
// read and write of a warp is one or two contiguous lines.
//
// Semantics kept from the reference kernels:
// - a tap counts only if its offset from the output coordinate lies within
//   +-band (a larger shift gives coverage 0, the caller's cue to take the
//   exact warp instead);
// - row pass: a tap outside [0, W-1] adds 0 to the value and the coverage;
// - column pass: the coverage is resampled from the row-pass coverage;
// - g = -1e9 marks degenerate rows: no tap is within the band;
// - a sample at exactly W-1 has weight 0 on its right-hand tap, which is
//   never read.
// Taps are added in increasing offset order, as the reference's fan does.

#include "common.cuh"

namespace {

__global__ void warp_rows_kernel(const float* __restrict__ img,
                                 const float* __restrict__ g,
                                 float* __restrict__ tmp, float* __restrict__ cov1,
                                 int h, int w, int band) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (u >= w) return;
  const long row = static_cast<long>(r) * w;
  const float delta = g[row + u] - static_cast<float>(u);
  const float k0 = floorf(delta);
  const float fband = static_cast<float>(band);
  float acc = 0.0f, cov = 0.0f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float k = k0 + static_cast<float>(t);
    if (fabsf(k) <= fband) {
      const float wk = fmaxf(0.0f, 1.0f - fabsf(delta - k));
      const int x = u + static_cast<int>(k);
      if (x >= 0 && x <= w - 1) {
        acc = acc + wk * img[row + x];
        cov = cov + wk;
      }
    }
  }
  tmp[row + u] = acc;
  cov1[row + u] = cov;
}

__global__ void warp_cols_kernel(const float* __restrict__ tmp,
                                 const float* __restrict__ cov1,
                                 const float* __restrict__ y_in,
                                 float* __restrict__ out, float* __restrict__ cov,
                                 int h, int w, int band) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y;
  if (u >= w) return;
  const long i = static_cast<long>(v) * w + u;
  const float delta = y_in[i] - static_cast<float>(v);
  const float k0 = floorf(delta);
  const float fband = static_cast<float>(band);
  float acc = 0.0f, cv = 0.0f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float k = k0 + static_cast<float>(t);
    if (fabsf(k) <= fband) {
      const float wk = fmaxf(0.0f, 1.0f - fabsf(delta - k));
      const int y = v + static_cast<int>(k);
      if (y >= 0 && y <= h - 1) {
        const long j = static_cast<long>(y) * w + u;
        acc = acc + wk * tmp[j];
        cv = cv + wk * cov1[j];
      }
    }
  }
  out[i] = acc;
  cov[i] = cv;
}

}  // namespace

extern "C" int cvids_warp_banded(const void* img, const void* g, const void* y_in,
                                 void* tmp, void* cov1, void* out, void* cov,
                                 int h, int w, int band_x, int band_y,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h);
  warp_rows_kernel<<<grid, block, 0, st>>>(
      static_cast<const float*>(img), static_cast<const float*>(g),
      static_cast<float*>(tmp), static_cast<float*>(cov1), h, w, band_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  warp_cols_kernel<<<grid, block, 0, st>>>(
      static_cast<const float*>(tmp), static_cast<const float*>(cov1),
      static_cast<const float*>(y_in), static_cast<float*>(out),
      static_cast<float*>(cov), h, w, band_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cvids_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

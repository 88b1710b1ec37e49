// Fused Gaussian x Beta (Vogiatzis) inverse-depth filter update.
//
// Replaces depth_filter_update in cvids_tpu/ops/pallas_kernels.py
// (_filter_kernel); the contract is ops/depth_filter.update. Per pixel:
// Gaussian fusion of (mu, sigma2) with the measurement (x, tau2), the
// Beta-uniform mixture responsibilities, Beta moment matching, the range gate
// (x outside [mu_lo, mu_hi] or an invalid pixel keeps the old state) and
// b + 1 on valid out-of-range measurements.
//
// Bound on the card: memory. 7 loads and 4 stores per pixel (13.5 MB at
// 640x480 with a scalar tau2), against ~60 flops. One thread per pixel, fp32
// throughout. The expression is written in the plain PyTorch version's
// operation order with its clamps (1e-12, 1e-10); the library is built with
// -fmad=false, so no multiply-add is contracted and the two round at the same
// points. tau2 is a scalar passed by value or an (H, W) map: a scalar is
// never expanded to a map in memory.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

__global__ void __launch_bounds__(THREADS)
depth_filter_kernel(const float* __restrict__ mu_in, const float* __restrict__ s2_in,
                    const float* __restrict__ a_in, const float* __restrict__ b_in,
                    const float* __restrict__ x_in, const float* __restrict__ tau2_in,
                    float tau2_value, const uint8_t* __restrict__ valid_in,
                    float mu_lo, float mu_hi, float uniform, float* __restrict__ mu_out,
                    float* __restrict__ s2_out, float* __restrict__ a_out,
                    float* __restrict__ b_out, long npix) {
  const long i = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= npix) return;
  const float mu = mu_in[i], s2 = s2_in[i], a = a_in[i], b = b_in[i], x = x_in[i];
  const float tau2 = tau2_in != nullptr ? tau2_in[i] : tau2_value;
  const bool valid = valid_in[i] != 0;

  const float norm_scale2 = s2 + tau2;
  const float s2c = clamp_min(s2, 1e-12f);
  const float tau2c = clamp_min(tau2, 1e-12f);
  const float s = 1.0f / (1.0f / s2c + 1.0f / tau2c);
  const float m = s * (mu / s2c + x / tau2c);
  const float nsc = clamp_min(norm_scale2, 1e-12f);
  const float dx = x - mu;
  const float two_pi = static_cast<float>(6.283185307179586);
  const float pdf = expf(-0.5f * (dx * dx) / nsc) / sqrtf(two_pi * nsc);
  float c1 = a / (a + b) * pdf;
  float c2 = b / (a + b) * uniform;
  const float denom = clamp_min(c1 + c2, 1e-12f);
  c1 = c1 / denom;
  c2 = c2 / denom;
  const float ab1 = a + b + 1.0f;
  const float ab2 = a + b + 2.0f;
  const float f = c1 * (a + 1.0f) / ab1 + c2 * a / ab1;
  const float e = c1 * (a + 1.0f) * (a + 2.0f) / (ab1 * ab2) +
                  c2 * a * (a + 1.0f) / (ab1 * ab2);
  const float mu_new = c1 * m + c2 * mu;
  const float s2_new = c1 * (s + m * m) + c2 * (s2 + mu * mu) - mu_new * mu_new;
  const float fc = clamp_min(f, 1e-12f);
  const float a_new = (e - f) / (f - e / fc);
  const float b_new = a_new * (1.0f - f) / fc;

  const bool hard_out = (x < mu_lo) || (x > mu_hi) || !valid;
  mu_out[i] = hard_out ? mu : mu_new;
  s2_out[i] = clamp_min(hard_out ? s2 : s2_new, 1e-10f);
  a_out[i] = hard_out ? a : a_new;
  b_out[i] = hard_out ? (valid ? b + 1.0f : b) : b_new;
}

}  // namespace

// mu, s2, a, b, x: (npix,) fp32; tau2: (npix,) fp32, or null (tau2_value
// used); valid: (npix,) bytes; the four outputs (npix,) fp32.
// uniform = 1 / (mu_hi - mu_lo) as the caller rounds it.
extern "C" int cvids_depth_filter(const void* mu, const void* s2, const void* a,
                                  const void* b, const void* x, const void* tau2,
                                  float tau2_value, const void* valid,
                                  float mu_lo, float mu_hi, float uniform, void* mu_out,
                                  void* s2_out, void* a_out, void* b_out, long npix,
                                  void* stream) {
  if (npix < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((npix + THREADS - 1) / THREADS);
  depth_filter_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(s2),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(x), static_cast<const float*>(tau2), tau2_value,
      static_cast<const uint8_t*>(valid), mu_lo, mu_hi, uniform,
      static_cast<float*>(mu_out), static_cast<float*>(s2_out),
      static_cast<float*>(a_out), static_cast<float*>(b_out), npix);
  return static_cast<int>(cudaGetLastError());
}

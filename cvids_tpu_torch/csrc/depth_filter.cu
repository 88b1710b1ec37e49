// Fused Gaussian x Beta (Vogiatzis) inverse-depth filter update.
//
// Replaces depth_filter_update in cvids_tpu/ops/pallas_kernels.py
// (_filter_kernel); the contract is ops/depth_filter.update. Per pixel:
// Gaussian fusion of (mu, sigma2) with the measurement (x, tau2), the
// Beta-uniform mixture responsibilities, Beta moment matching, the range gate
// (x outside [mu_lo, mu_hi] or an invalid pixel keeps the old state) and
// b + 1 on valid out-of-range measurements.
//
// Bound on the card: memory. 5 fp32 maps and a byte map in, 4 fp32 maps out
// (11.4 MB at 640x480 with a scalar tau2), each read or written once. The
// arithmetic is ~240 instructions a pixel (18 IEEE divisions, expf, sqrtf),
// which only a full set of resident warps hides behind the memory system.
// The design, chosen by timed variants (dev/torch_probe_hamming_variants.py,
// NVIDIA H100 80GB HBM3, 700 W, kernel time under the profiler):
// - one pixel a thread, 256 threads a block: 0.0055 ms at 640x480, which is
//   2.5 TB/s once the 0.0009 ms of an empty kernel are taken off, and 0.0280
//   ms at 1920x1080 (76.7 MB: 2.7 TB/s). A thread that owns two or four
//   neighbouring pixels and moves them as 8- or 16-byte vectors (the probe
//   carries that kernel) issues a quarter of the memory instructions but
//   leaves an SM a quarter of the warps, and the divisions' slow-path
//   branches keep the compiler from interleaving a thread's pixels:
//   0.0059-0.0068 and 0.0065-0.0077 ms at 640x480, 0.0281 and 0.0300 ms at
//   1920x1080. So the memory instructions were never the limit;
// - streaming accesses (__ldcs / __stcs): nothing is read twice, so the lines
//   are marked evict-first and leave the L2 to the volumes around this step.
//   Alone they time like plain accesses (0.0055-0.0057 ms).
// The per-pixel expression is written in the plain PyTorch version's
// operation order with its clamps (1e-12, 1e-10); the library is built with
// -fmad=false, so no multiply-add is contracted and the two round at the same
// points. tau2 is a scalar passed by value or an (H, W) map: a scalar is
// never expanded to a map in memory.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int FILTER_THREADS = 256;

__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

struct FilterOut {
  float mu, s2, a, b;
};

__device__ __forceinline__ FilterOut filter_pixel(float mu, float s2, float a, float b,
                                                  float x, float tau2, bool valid,
                                                  float mu_lo, float mu_hi, float uniform) {
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
  FilterOut o;
  o.mu = hard_out ? mu : mu_new;
  o.s2 = clamp_min(hard_out ? s2 : s2_new, 1e-10f);
  o.a = hard_out ? a : a_new;
  o.b = hard_out ? (valid ? b + 1.0f : b) : b_new;
  return o;
}

__global__ void __launch_bounds__(FILTER_THREADS)
depth_filter_kernel(const float* __restrict__ mu_in, const float* __restrict__ s2_in,
                    const float* __restrict__ a_in, const float* __restrict__ b_in,
                    const float* __restrict__ x_in, const float* __restrict__ tau2_in,
                    float tau2_value, const uint8_t* __restrict__ valid_in,
                    float mu_lo, float mu_hi, float uniform, float* __restrict__ mu_out,
                    float* __restrict__ s2_out, float* __restrict__ a_out,
                    float* __restrict__ b_out, long npix) {
  const long i = static_cast<long>(blockIdx.x) * FILTER_THREADS + threadIdx.x;
  if (i >= npix) return;
  const float tau2 = tau2_in != nullptr ? __ldcs(tau2_in + i) : tau2_value;
  const FilterOut o = filter_pixel(__ldcs(mu_in + i), __ldcs(s2_in + i), __ldcs(a_in + i),
                                   __ldcs(b_in + i), __ldcs(x_in + i), tau2,
                                   __ldcs(valid_in + i) != 0, mu_lo, mu_hi, uniform);
  __stcs(mu_out + i, o.mu);
  __stcs(s2_out + i, o.s2);
  __stcs(a_out + i, o.a);
  __stcs(b_out + i, o.b);
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
  const unsigned grid = static_cast<unsigned>((npix + FILTER_THREADS - 1) / FILTER_THREADS);
  depth_filter_kernel<<<grid, FILTER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(s2),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(x), static_cast<const float*>(tau2), tau2_value,
      static_cast<const uint8_t*>(valid), mu_lo, mu_hi, uniform,
      static_cast<float*>(mu_out), static_cast<float*>(s2_out),
      static_cast<float*>(a_out), static_cast<float*>(b_out), npix);
  return static_cast<int>(cudaGetLastError());
}

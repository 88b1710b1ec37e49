// Winner-take-all over the depth axis of summed SGM part volumes, with
// parabola subpixel refinement and peak-sharpness rejection.
//
// Replaces wta_pallas in cvids_tpu/ops/pallas_kernels.py (_wta_kernel). Per
// pixel: x = sum of the N part volumes in fp32; idx = first argmin over D;
// delta = 0.5 (x[idx-1] - x[idx+1]) / denom with the neighbours clamped to
// [0, D-1] and denom = x[idx-1] + x[idx+1] - 2 x[idx] (0 where denom <= 1e-6),
// clipped to +-1; c2 = min of x outside |d - idx| <= 1;
// conf = x[idx] < peak_ratio * c2 and 0 < idx < D-1.
//
// Bound on the card: memory. The parts are read once (157 MB for two bf16
// volumes at 640x480x128) and 5 bytes per pixel are written; the parts are
// summed in registers, never in memory. One warp per pixel: lane l holds
// depths [l*K, l*K+K), K = D/32, so a warp reads one contiguous run of the
// volume; the argmin, minimum and second-best are xor-shuffle reductions and
// the two parabola neighbours are one shuffle each from their owner lane.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;

template <typename T, int K>
__global__ void __launch_bounds__(WARPS * 32)
wta_kernel(const T* __restrict__ v0, const T* __restrict__ v1,
           const T* __restrict__ v2, const T* __restrict__ v3, int n,
           float* __restrict__ idx_out, bool* __restrict__ conf_out, long npix,
           float peak_ratio) {
  constexpr int D = 32 * K;
  const long pix = static_cast<long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pix >= npix) return;  // uniform across the warp
  const long base = pix * D + lane * K;
  float x[K];
#pragma unroll
  for (int j = 0; j < K; ++j) x[j] = cvids_to_f32(v0[base + j]);
  // parts added in order, as the reference kernel sums them
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (n > 1) x[j] = x[j] + cvids_to_f32(v1[base + j]);
    if (n > 2) x[j] = x[j] + cvids_to_f32(v2[base + j]);
    if (n > 3) x[j] = x[j] + cvids_to_f32(v3[base + j]);
  }

  float c0 = x[0];
#pragma unroll
  for (int j = 1; j < K; ++j) c0 = fminf(c0, x[j]);
  c0 = cvids_warp_min(c0);
  int first = D;
#pragma unroll
  for (int j = K - 1; j >= 0; --j)
    if (x[j] == c0) first = lane * K + j;
  const int idx = cvids_warp_min_int(first);

  const int im = max(idx - 1, 0);
  const int ip = min(idx + 1, D - 1);
  float sel_m = x[0], sel_p = x[0];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    if (j == im % K) sel_m = x[j];
    if (j == ip % K) sel_p = x[j];
  }
  const float cm = __shfl_sync(CVIDS_FULL_MASK, sel_m, im / K);
  const float cp = __shfl_sync(CVIDS_FULL_MASK, sel_p, ip / K);

  float c2 = CVIDS_BIG;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int dd = lane * K + j;
    if (abs(dd - idx) > 1) c2 = fminf(c2, x[j]);
  }
  c2 = cvids_warp_min(c2);

  if (lane == 0) {
    const float denom = cm + cp - 2.0f * c0;
    float delta = denom > 1e-6f ? 0.5f * (cm - cp) / fmaxf(denom, 1e-6f) : 0.0f;
    delta = fminf(fmaxf(delta, -1.0f), 1.0f);
    idx_out[pix] = static_cast<float>(idx) + delta;
    conf_out[pix] = (c0 < peak_ratio * c2) && (idx > 0) && (idx < D - 1);
  }
}

template <typename T>
int launch(const void* const* v, int n, float* idx, bool* conf, long npix, int D,
           float peak_ratio, cudaStream_t st) {
  const T* p[4] = {static_cast<const T*>(v[0]), static_cast<const T*>(v[1]),
                   static_cast<const T*>(v[2]), static_cast<const T*>(v[3])};
  const unsigned grid = static_cast<unsigned>((npix + WARPS - 1) / WARPS);
  switch (D / 32) {
#define CVIDS_WTA_CASE(KK)                                                        \
  case KK:                                                                        \
    wta_kernel<T, KK><<<grid, WARPS * 32, 0, st>>>(p[0], p[1], p[2], p[3], n, idx, \
                                                   conf, npix, peak_ratio);       \
    break;
    CVIDS_WTA_CASE(1)
    CVIDS_WTA_CASE(2)
    CVIDS_WTA_CASE(3)
    CVIDS_WTA_CASE(4)
    CVIDS_WTA_CASE(5)
    CVIDS_WTA_CASE(6)
    CVIDS_WTA_CASE(7)
    CVIDS_WTA_CASE(8)
#undef CVIDS_WTA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v0..v3: part volumes (npix, D), the first n used; idx_out (npix,) fp32,
// conf_out (npix,) bool.
extern "C" int cvids_wta(const void* v0, const void* v1, const void* v2, const void* v3,
                         int n, void* idx_out, void* conf_out, long npix, int D,
                         int bf16, float peak_ratio, void* stream) {
  if (n < 1 || n > 4 || D % 32 != 0 || D < 32 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* v[4] = {v0, v1, v2, v3};
  float* idx = static_cast<float*>(idx_out);
  bool* conf = static_cast<bool*>(conf_out);
  if (bf16) return launch<__nv_bfloat16>(v, n, idx, conf, npix, D, peak_ratio, st);
  return launch<float>(v, n, idx, conf, npix, D, peak_ratio, st);
}

// Plane-sweep absolute-difference cost over all depth hypotheses.
//
// Replaces plane_sweep_pallas in cvids_tpu/ops/pallas_kernels.py
// (_sweep_kernel). On the TPU each depth plane is resampled by two banded
// hat-weight matmuls on the MXU, a workaround for slow gathers. Here each
// sample is a direct 2x2 bilinear fetch of the aligned measurement image at
// (pos_x[d, p], pos_y[d, q]); the 1.2 MB image stays in L2.
//
// Bound on the card: the (H, W, D) output write (78.6 MB in bf16 at
// 640x480x128) and the 4 taps per sample. The design:
// - one block per 8x16-pixel tile and 32 depths; the absolute differences of
//   the tile plus a 1-pixel halo (halo coordinates clamped to the image, the
//   box's edge replication) go to shared memory once, and the 3x3 box reads
//   them 9 times from there;
// - neighbouring threads work on neighbouring depths, so the volume is
//   written directly in (H, W, D) order, D innermost, coalesced: the
//   (D, H, W) -> (H, W, D) transpose of the TPU path disappears;
// - the per-depth position tables come transposed, (W, D) and (H, D), so
//   their reads coalesce too.
// Validity is the centre sample only: in bounds, plus the aligned-image quad
// test m = mx + my. Invalid taps add 0 to the box; an invalid centre stores
// the -1 sentinel. fp32 compute, stored in the volume dtype.

#include "common.cuh"

namespace {

constexpr int TH = 8;    // tile rows
constexpr int TW = 16;   // tile columns
constexpr int DB = 32;   // depths per block
constexpr int HH = TH + 2;
constexpr int HW = TW + 2;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
plane_sweep_kernel(const float* __restrict__ ref, const float* __restrict__ meas,
                   const float* __restrict__ pos_x_t,  // (W, D)
                   const float* __restrict__ pos_y_t,  // (H, D)
                   const float* __restrict__ mx_t,     // (3, W, D)
                   const float* __restrict__ my_t,     // (3, H, D)
                   T* __restrict__ out,                // (H, W, D)
                   int h, int w, int d) {
  __shared__ float ad[HH * HW][DB];
  __shared__ unsigned char ok[HH * HW][DB];
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const int d0 = blockIdx.z * DB;
  const float wm1 = static_cast<float>(w - 1);
  const float hm1 = static_cast<float>(h - 1);

  for (int i = threadIdx.x; i < HH * HW * DB; i += THREADS) {
    const int dl = i % DB;
    const int pix = i / DB;
    const int q = min(max(ty0 + pix / HW - 1, 0), h - 1);
    const int p = min(max(tx0 + pix % HW - 1, 0), w - 1);
    const int dd = d0 + dl;
    float a = 0.0f;
    bool valid = false;
    if (dd < d) {
      const float px = pos_x_t[static_cast<long>(p) * d + dd];
      const float py = pos_y_t[static_cast<long>(q) * d + dd];
      const long wd = static_cast<long>(w) * d;
      const long hd = static_cast<long>(h) * d;
      const float m0 = mx_t[static_cast<long>(p) * d + dd] + my_t[static_cast<long>(q) * d + dd];
      const float m1 = mx_t[wd + static_cast<long>(p) * d + dd] + my_t[hd + static_cast<long>(q) * d + dd];
      const float m2 = mx_t[2 * wd + static_cast<long>(p) * d + dd] + my_t[2 * hd + static_cast<long>(q) * d + dd];
      valid = (px >= 0.0f) && (px <= wm1) && (py >= 0.0f) && (py <= hm1) &&
              (m2 > 1e-6f) && (m0 >= 0.0f) && (m0 <= wm1 * m2) &&
              (m1 >= 0.0f) && (m1 <= hm1 * m2);
      if (valid) {
        // hat weights at the two taps around the sample (the right-hand tap
        // of a sample at exactly W-1 or H-1 has weight 0; it is clamped)
        const float x0 = floorf(px), y0 = floorf(py);
        const float wx0 = fmaxf(0.0f, 1.0f - fabsf(px - x0));
        const float wx1 = fmaxf(0.0f, 1.0f - fabsf(px - (x0 + 1.0f)));
        const float wy0 = fmaxf(0.0f, 1.0f - fabsf(py - y0));
        const float wy1 = fmaxf(0.0f, 1.0f - fabsf(py - (y0 + 1.0f)));
        const int xi0 = static_cast<int>(x0), yi0 = static_cast<int>(y0);
        const int xi1 = min(xi0 + 1, w - 1), yi1 = min(yi0 + 1, h - 1);
        const float* r0p = meas + static_cast<long>(yi0) * w;
        const float* r1p = meas + static_cast<long>(yi1) * w;
        const float r0 = wx0 * r0p[xi0] + wx1 * r0p[xi1];
        const float r1 = wx0 * r1p[xi0] + wx1 * r1p[xi1];
        const float warped = wy0 * r0 + wy1 * r1;
        a = fabsf(warped - ref[static_cast<long>(q) * w + p]);
      }
    }
    ad[pix][dl] = a;
    ok[pix][dl] = valid;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TH * TW * DB; i += THREADS) {
    const int dl = i % DB;
    const int pix = i / DB;
    const int ly = pix / TW, lx = pix % TW;
    const int q = ty0 + ly, p = tx0 + lx, dd = d0 + dl;
    if (q >= h || p >= w || dd >= d) continue;
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) acc = acc + ad[(ly + dy) * HW + lx + dx][dl];
    const float c = ok[(ly + 1) * HW + lx + 1][dl] ? fmaxf(acc / 9.0f, 0.0f) : -1.0f;
    out[(static_cast<long>(q) * w + p) * d + dd] = cvids_from_f32<T>(c);
  }
}

}  // namespace

extern "C" int cvids_plane_sweep(const void* ref, const void* meas,
                                 const void* pos_x_t, const void* pos_y_t,
                                 const void* mx_t, const void* my_t, void* out,
                                 int h, int w, int d, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, (d + DB - 1) / DB);
  const float* f[6] = {static_cast<const float*>(ref), static_cast<const float*>(meas),
                       static_cast<const float*>(pos_x_t), static_cast<const float*>(pos_y_t),
                       static_cast<const float*>(mx_t), static_cast<const float*>(my_t)};
  if (out_bf16) {
    plane_sweep_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        f[0], f[1], f[2], f[3], f[4], f[5], static_cast<__nv_bfloat16*>(out), h, w, d);
  } else {
    plane_sweep_kernel<float><<<grid, THREADS, 0, st>>>(
        f[0], f[1], f[2], f[3], f[4], f[5], static_cast<float*>(out), h, w, d);
  }
  return static_cast<int>(cudaGetLastError());
}

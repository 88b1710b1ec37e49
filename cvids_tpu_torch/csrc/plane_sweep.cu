// Plane-sweep absolute-difference cost over all depth hypotheses.
//
// Replaces plane_sweep_pallas in cvids_tpu/ops/pallas_kernels.py
// (_sweep_kernel). On the TPU each depth plane is resampled by two banded
// hat-weight matmuls on the MXU, a workaround for slow gathers. Here each
// sample is a direct 2x2 bilinear fetch of the aligned measurement image at
// (pos_x[d, p], pos_y[d, q]); the 1.2 MB image stays in L2.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32): the (H, W, D) output write.
// At 640x480x128 in bf16 that is 78.6 MB, with 2.5 MB of images and 2.3 MB
// of tables 83.4 MB, 0.0249 ms. The function's fp32 work is below that: 32
// operations a sample (quad test, bilinear, |diff|, box), with the weights
// and in-bounds tests that depend on one coordinate only counted once per
// table entry, ~1.26 G operations, 0.019 ms (kernel_work in
// ops/cuda_kernels.py). In practice the instruction stream bounds it: a sample costs
// some forty instructions (validity, four taps, weights), so the design
// keeps the samples per output low, takes everything that depends on one
// coordinate only out of the sample loop, and makes every memory access
// wide or coalesced:
// - a block owns a tile of TH x 30 pixels and DB depths. The |sample - ref|
//   of the tile plus a 1-pixel halo (halo coordinates clamped to the image:
//   the box's edge replication), HH x 32 pixels, goes to shared memory once,
//   with -1 marking an invalid sample, and the 3x3 box reads it from there.
//   30 + 2 = 32 halo columns make the gather's thread map exact;
// - phase 0 stages what depends on (row, depth) only: the y weights, the two
//   row offsets into the measurement image, the y part of the quad test and
//   the row's in-bounds flag, as two float4 per (row, depth), and the tile of
//   the reference image;
// - phase 1, pixel-major: a warp covers 8 neighbouring columns x 4 depths,
//   so the four taps of a load instruction fall into a few 32-byte sectors
//   (a warp over 32 depths of one pixel, as before, touched up to 32), and
//   its shared-memory stores hit 32 different banks (the depth run of a
//   pixel is padded by 4 floats). A thread keeps its column's x weights, tap
//   columns and x part of the quad test in registers and walks down the
//   rows; the tables are read in their (D, W) / (D, H) layout, coalesced
//   along the row, with no transposed copies;
// - phase 2, depth-major: a thread owns one pixel column and 8 consecutive
//   depths, walks down the tile's rows with a rolling 3x3x8 window in
//   registers (three float4 pairs loaded per output row instead of nine),
//   sums the taps in the reference's order, and stores 8 depths at once:
//   16 bytes in bf16, 32 in fp32. The lanes of a pixel write its whole DB run
//   contiguously (128 bytes at DB = 64 in bf16).
// Tile size: TH = 8, DB = 64 needs 108,800 bytes of dynamic shared memory,
// so two blocks fit the SM's 227 KB and one block's gather overlaps the
// other's box sum and stores; 256 threads at <= 128 registers allow both.
// Measured against it on an H100: 16 x 30 x 32 (a smaller halo share, but
// half the box phase's threads idle) 6 % slower; three or four smaller
// blocks an SM (4 to 12 rows, 32 or 64 depths) 19-37 % slower.
// Validity is the centre sample only: in bounds, plus the aligned-image quad
// test m = mx + my. Invalid taps add 0 to the box; an invalid centre stores
// the -1 sentinel. fp32 compute, stored in the volume dtype.

#include "common.cuh"

namespace {

constexpr int TH = 8;                // tile rows
constexpr int TW = 30;               // tile columns
constexpr int DB = 64;               // depths per block
constexpr int HH = TH + 2;
constexpr int HW = TW + 2;           // 32: four groups of 8 halo columns
constexpr int DBP = DB + 4;          // padded depth run of a halo pixel
constexpr int CH = DB / 8;           // 8-depth chunks per block
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES =
    sizeof(float) * HH * HW * DBP + 2 * sizeof(float4) * HH * DB + sizeof(float) * HH * HW;

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float* f);
template <>
__device__ __forceinline__ void store8<float>(float* dst, const float* f) {
  reinterpret_cast<uint4*>(dst)[0] = Vec16<float>::pack(f);
  reinterpret_cast<uint4*>(dst)[1] = Vec16<float>::pack(f + 4);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* dst, const float* f) {
  *reinterpret_cast<uint4*>(dst) = Vec16<__nv_bfloat16>::pack(f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
plane_sweep_kernel(const float* __restrict__ ref, const float* __restrict__ meas,
                   const float* __restrict__ pos_x,  // (D, W)
                   const float* __restrict__ pos_y,  // (D, H)
                   const float* __restrict__ mx,     // (D, 3, W)
                   const float* __restrict__ my,     // (D, 3, H)
                   T* __restrict__ out,              // (H, W, D)
                   int h, int w, int d) {
  extern __shared__ float4 smem4[];
  float4* ye_a = smem4;                 // [HH][DB]: wy0, wy1, row offset 0, row offset 1
  float4* ye_b = ye_a + HH * DB;        // [HH][DB]: m0y, m1y, m2y, row in bounds
  float* ad = reinterpret_cast<float*>(ye_b + HH * DB);   // [HH * HW][DBP]
  float* refs = ad + HH * HW * DBP;                        // [HH][HW]

  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const int d0 = blockIdx.z * DB;
  const float wm1 = static_cast<float>(w - 1);
  const float hm1 = static_cast<float>(h - 1);
  const int tid = threadIdx.x;

  // phase 0: per-(row, depth) entries and the reference tile
  for (int i = tid; i < HH * DB; i += THREADS) {
    const int yh = i % HH, dl = i / HH;
    const int dd = d0 + dl;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (dd < d) {
      const int q = min(max(ty0 + yh - 1, 0), h - 1);
      const float py = pos_y[static_cast<long>(dd) * h + q];
      const float* myd = my + static_cast<long>(dd) * 3 * h + q;
      const bool ok = (py >= 0.0f) && (py <= hm1);
      if (ok) {
        // hat weights at the two taps around the sample (the lower tap of a
        // sample at exactly H-1 has weight 0; it is clamped)
        const float y0 = floorf(py);
        const int yi0 = static_cast<int>(y0);
        const int yi1 = min(yi0 + 1, h - 1);
        a = make_float4(fmaxf(0.0f, 1.0f - fabsf(py - y0)),
                        fmaxf(0.0f, 1.0f - fabsf(py - (y0 + 1.0f))),
                        __int_as_float(yi0 * w), __int_as_float(yi1 * w));
      }
      b = make_float4(myd[0], myd[h], myd[2 * h], ok ? 1.0f : 0.0f);
    }
    ye_a[yh * DB + dl] = a;
    ye_b[yh * DB + dl] = b;
  }
  for (int i = tid; i < HH * HW; i += THREADS) {
    const int q = min(max(ty0 + i / HW - 1, 0), h - 1);
    const int p = min(max(tx0 + i % HW - 1, 0), w - 1);
    refs[i] = ref[static_cast<long>(q) * w + p];
  }
  __syncthreads();

  // phase 1: a warp is 8 halo columns x 4 depths; a thread walks down the rows
  for (int col = tid; col < HW * DB; col += THREADS) {
    const int lane = col & 31;
    const int rest = col >> 5;
    const int xh = (rest & 3) * 8 + (lane >> 2);
    const int dl = (rest >> 2) * 4 + (lane & 3);
    const int dd = d0 + dl;
    float* adc = ad + xh * DBP + dl;
    if (dd >= d) {
      for (int yh = 0; yh < HH; ++yh) adc[yh * HW * DBP] = -1.0f;
      continue;
    }
    const int p = min(max(tx0 + xh - 1, 0), w - 1);
    const float px = pos_x[static_cast<long>(dd) * w + p];
    const float* mxd = mx + static_cast<long>(dd) * 3 * w + p;
    const float m0x = mxd[0], m1x = mxd[w], m2x = mxd[2 * w];
    const bool okx = (px >= 0.0f) && (px <= wm1);
    const float x0 = floorf(px);
    const float wx0 = fmaxf(0.0f, 1.0f - fabsf(px - x0));
    const float wx1 = fmaxf(0.0f, 1.0f - fabsf(px - (x0 + 1.0f)));
    const int xi0 = okx ? static_cast<int>(x0) : 0;
    const int xi1 = min(xi0 + 1, w - 1);
#pragma unroll 2
    for (int yh = 0; yh < HH; ++yh) {
      const float4 a = ye_a[yh * DB + dl];
      const float4 b = ye_b[yh * DB + dl];
      const float m0 = m0x + b.x, m1 = m1x + b.y, m2 = m2x + b.z;
      const bool valid = okx && (b.w != 0.0f) && (m2 > 1e-6f) && (m0 >= 0.0f) &&
                         (m0 <= wm1 * m2) && (m1 >= 0.0f) && (m1 <= hm1 * m2);
      float v = -1.0f;
      if (valid) {
        const float* r0p = meas + __float_as_int(a.z);
        const float* r1p = meas + __float_as_int(a.w);
        const float r0 = wx0 * __ldg(r0p + xi0) + wx1 * __ldg(r0p + xi1);
        const float r1 = wx0 * __ldg(r1p + xi0) + wx1 * __ldg(r1p + xi1);
        const float warped = a.x * r0 + a.y * r1;
        v = fabsf(warped - refs[yh * HW + xh]);
      }
      adc[yh * HW * DBP] = v;
    }
  }
  __syncthreads();

  // phase 2: a thread owns a pixel column and 8 depths; rolling 3x3x8 window
  for (int col = tid; col < TW * CH; col += THREADS) {
    const int c8 = (col % CH) * 8;
    const int x = col / CH;
    const int p = tx0 + x;
    if (p >= w || d0 + c8 >= d) continue;
    float win[3][3][8];     // [row % 3][dx][depth]: taps with invalid -> 0
    unsigned okc[3];        // centre-tap validity bits of each window row
    auto load_row = [&](int yh, int slot) {
      unsigned bits = 0;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4* src = reinterpret_cast<const float4*>(ad + (yh * HW + x + dx) * DBP + c8);
        const float4 lo = src[0], hi = src[1];
        const float raw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          win[slot][dx][j] = fmaxf(raw[j], 0.0f);
          if (dx == 1 && raw[j] >= 0.0f) bits |= 1u << j;
        }
      }
      okc[slot] = bits;
    };
    load_row(0, 0);
    load_row(1, 1);
#pragma unroll
    for (int y = 0; y < TH; ++y) {
      load_row(y + 2, (y + 2) % 3);
      const int q = ty0 + y;
      if (q < h) {
        float res[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) acc = acc + win[(y + dy) % 3][dx][j];
          res[j] = (okc[(y + 1) % 3] >> j) & 1u ? fmaxf(acc / 9.0f, 0.0f) : -1.0f;
        }
        store8<T>(out + (static_cast<long>(q) * w + p) * d + d0 + c8, res);
      }
    }
  }
}

dim3 grid_of(int h, int w, int d) {
  return dim3((w + TW - 1) / TW, (h + TH - 1) / TH, (d + DB - 1) / DB);
}

template <typename T>
int launch(const float* const* f, void* out, int h, int w, int d, cudaStream_t st) {
  auto kernel = plane_sweep_kernel<T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid_of(h, w, d), THREADS, SMEM_BYTES, st>>>(f[0], f[1], f[2], f[3], f[4], f[5],
                                            static_cast<T*>(out), h, w, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ref, meas: (H, W) fp32; pos_x (D, W), pos_y (D, H), mx (D, 3, W), my
// (D, 3, H) fp32; out (H, W, D) in fp32 or bf16, 16-byte aligned; D a
// multiple of 32.
extern "C" int cvids_plane_sweep(const void* ref, const void* meas, const void* pos_x,
                                 const void* pos_y, const void* mx, const void* my,
                                 void* out, int h, int w, int d, int out_bf16,
                                 void* stream) {
  if (d % 32 != 0 || d < 32 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<size_t>(out) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[6] = {static_cast<const float*>(ref), static_cast<const float*>(meas),
                       static_cast<const float*>(pos_x), static_cast<const float*>(pos_y),
                       static_cast<const float*>(mx), static_cast<const float*>(my)};
  if (out_bf16) return launch<__nv_bfloat16>(f, out, h, w, d, st);
  return launch<float>(f, out, h, w, d, st);
}

// what a launch at (h, w, d) takes, without launching: plan[0..7] = tile rows,
// tile columns, depths per block, threads per block, grid x, y, z, dynamic
// shared memory bytes
extern "C" int cvids_plane_sweep_plan(int h, int w, int d, int* plan) {
  if (plan == nullptr || d % 32 != 0 || d < 32 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(h, w, d);
  const int v[8] = {TH, TW, DB, THREADS, static_cast<int>(grid.x), static_cast<int>(grid.y),
                    static_cast<int>(grid.z), static_cast<int>(SMEM_BYTES)};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
}

// Winner-take-all over the depth axis of summed SGM part volumes, with
// parabola subpixel refinement and peak-sharpness rejection.
//
// Replaces wta_pallas in cvids_tpu/ops/pallas_kernels.py (_wta_kernel). Per
// pixel: x = sum of the N part volumes in fp32, in order; idx = first argmin
// over D; delta = 0.5 (x[idx-1] - x[idx+1]) / denom with the neighbours
// clamped to [0, D-1] and denom = x[idx-1] + x[idx+1] - 2 x[idx] (0 where
// denom <= 1e-6), clipped to +-1; c2 = min of x outside |d - idx| <= 1;
// conf = x[idx] < peak_ratio * c2 and 0 < idx < D-1.
//
// Bound on an H100 (3.35 TB/s): bytes. The parts are read once (157 MB for
// two bf16 volumes at 640x480x128, 0.047 ms) and 5 bytes per pixel are
// written; the parts are summed in registers, never in memory. What keeps a
// kernel above that bound is too few bytes in flight per thread and the
// chains of shuffles between a pixel's loads and its result. The design:
// - a group of G lanes (a power of two, 4 to 32) owns a pixel, so a warp
//   works on 32 / G pixels at once. A D-row of one part is NV = D * itemsize
//   / 16 vectors of 16 bytes; G is the smallest power of two with
//   WTA_MAX_VECTORS * G >= NV, and lane l loads vectors l, l + G, l + 2G, ...
//   (EV = ceil(NV / G) a part; a slot past NV loads nothing). The vectors are
//   interleaved so that every load instruction of a group reads G * 16
//   contiguous bytes, each 32-byte sector of the volume once;
// - all of a lane's loads, of every part, are issued before any arithmetic
//   (the number of parts is a template parameter, so this is straight-line
//   code), as streaming loads (ld.global.cs): the parts are read once and
//   never again, so they should not evict what the next kernels reuse;
// - the first minimum is ONE reduction over the group on (value, index)
//   pairs, log2(G) xor-shuffle steps of two shuffles each: the smaller value
//   wins, and of two equal values the lower index. Pairs, not a packed
//   integer key: float comparison orders negative values and treats -0 and
//   +0 as equal, as the twin's fminf and == do. Within a lane the slots are
//   in increasing depth order and a strict < keeps the first, so the result
//   is the lowest index over the whole row whatever the interleaving, also
//   where a plateau spans lanes. A slot past NV holds +infinity at an index
//   >= D and loses every tie;
// - the two parabola neighbours come by one shuffle each from their owner
//   lanes; the second minimum is a second, value-only reduction;
// - every shuffle names the full warp and stays inside its group by its xor
//   offset (< G) or its width argument (a shuffle over part of a warp
//   compiles to a uniformity loop). A ragged last block's spare groups load
//   nothing, run every shuffle and store nothing.

#include "common.cuh"

namespace {

constexpr int WTA_THREADS = 256;
constexpr int WTA_MAX_VECTORS = 2;   // 16-byte vectors a lane loads per part, where G < 32

// lanes per pixel for a D-row of NV vectors
__host__ __device__ constexpr int wta_group(int nv) {
  int g = 4;
  while (g * WTA_MAX_VECTORS < nv && g < 32) g *= 2;
  return g;
}

struct WtaParts {
  const uint4* p[4];
};

template <typename T, int NV, int NP>
__global__ void __launch_bounds__(WTA_THREADS)
wta_kernel(WtaParts parts, float* __restrict__ idx_out, bool* __restrict__ conf_out,
           long npix, float peak_ratio) {
  using V = Vec16<T>;
  constexpr int N = V::N;                    // depths per vector
  constexpr int G = wta_group(NV);
  constexpr int EV = (NV + G - 1) / G;       // vectors per lane and part
  constexpr int E = EV * N;                  // slots per lane
  constexpr int D = NV * N;
  constexpr int PIXELS = WTA_THREADS / G;    // pixels per block
  const int lig = threadIdx.x % G;
  const long pix = static_cast<long>(blockIdx.x) * PIXELS + threadIdx.x / G;
  const bool active = pix < npix;

  // every load of this lane first
  uint4 raw[NP][EV];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const uint4* row = parts.p[p] + pix * NV + lig;
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      raw[p][j] = make_uint4(0u, 0u, 0u, 0u);
      if (active && j * G + lig < NV) raw[p][j] = __ldcs(row + j * G);
    }
  }
  // parts added in order, as the reference kernel sums them
  float x[E];
#pragma unroll
  for (int j = 0; j < EV; ++j) {
    V::unpack(raw[0][j], x + j * N);
#pragma unroll
    for (int p = 1; p < NP; ++p) {
      float y[N];
      V::unpack(raw[p][j], y);
#pragma unroll
      for (int e = 0; e < N; ++e) x[j * N + e] = x[j * N + e] + y[e];
    }
    if (EV * G != NV && j * G + lig >= NV) {
#pragma unroll
      for (int e = 0; e < N; ++e) x[j * N + e] = __int_as_float(0x7f800000);
    }
  }
  // slot s of this lane is depth (s / N * G + lig) * N + s % N
  const int lane_base = lig * N;

  // first minimum: in the lane, then over the group on (value, index) pairs
  float c0 = x[0];
  int slot = 0;
#pragma unroll
  for (int s = 1; s < E; ++s)
    if (x[s] < c0) {
      c0 = x[s];
      slot = s;
    }
  int idx = (slot / N) * (G * N) + lane_base + slot % N;
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(CVIDS_FULL_MASK, c0, o);
    const int oi = __shfl_xor_sync(CVIDS_FULL_MASK, idx, o);
    if (ov < c0 || (ov == c0 && oi < idx)) {
      c0 = ov;
      idx = oi;
    }
  }

  // the parabola's neighbours, each from the lane that holds it
  const int im = max(idx - 1, 0);
  const int ip = min(idx + 1, D - 1);
  const int slot_m = (im / N / G) * N + im % N;
  const int slot_p = (ip / N / G) * N + ip % N;
  float sel_m = x[0], sel_p = x[0];
#pragma unroll
  for (int s = 1; s < E; ++s) {
    if (s == slot_m) sel_m = x[s];
    if (s == slot_p) sel_p = x[s];
  }
  const float cm = __shfl_sync(CVIDS_FULL_MASK, sel_m, (im / N) % G, G);
  const float cp = __shfl_sync(CVIDS_FULL_MASK, sel_p, (ip / N) % G, G);

  // second minimum, outside idx +- 1
  float c2 = CVIDS_BIG;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int dd = (s / N) * (G * N) + lane_base + s % N;
    if (abs(dd - idx) > 1) c2 = fminf(c2, x[s]);
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    c2 = fminf(c2, __shfl_xor_sync(CVIDS_FULL_MASK, c2, o));

  if (active && lig == 0) {
    const float denom = cm + cp - 2.0f * c0;
    float delta = denom > 1e-6f ? 0.5f * (cm - cp) / fmaxf(denom, 1e-6f) : 0.0f;
    delta = fminf(fmaxf(delta, -1.0f), 1.0f);
    idx_out[pix] = static_cast<float>(idx) + delta;
    conf_out[pix] = (c0 < peak_ratio * c2) && (idx > 0) && (idx < D - 1);
  }
}

// launches, or with `plan` only reports what it would launch: {lanes per
// pixel, vectors per lane and part, threads, pixels per block, blocks}
template <typename T, int NV, int NP>
int launch_one(const WtaParts& parts, float* idx, bool* conf, long npix, float peak_ratio,
               int* plan, cudaStream_t st) {
  constexpr int G = wta_group(NV);
  constexpr int PIXELS = WTA_THREADS / G;
  const long grid = (npix + PIXELS - 1) / PIXELS;
  if (grid > 2147483647L) return static_cast<int>(cudaErrorInvalidValue);
  if (plan != nullptr) {
    const int v[5] = {G, (NV + G - 1) / G, WTA_THREADS, PIXELS, static_cast<int>(grid)};
    for (int i = 0; i < 5; ++i) plan[i] = v[i];
    return 0;
  }
  wta_kernel<T, NV, NP><<<static_cast<unsigned>(grid), WTA_THREADS, 0, st>>>(
      parts, idx, conf, npix, peak_ratio);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NV>
int launch_parts(const WtaParts& parts, int n, float* idx, bool* conf, long npix,
                 float peak_ratio, int* plan, cudaStream_t st) {
  switch (n) {
    case 1: return launch_one<T, NV, 1>(parts, idx, conf, npix, peak_ratio, plan, st);
    case 2: return launch_one<T, NV, 2>(parts, idx, conf, npix, peak_ratio, plan, st);
    case 3: return launch_one<T, NV, 3>(parts, idx, conf, npix, peak_ratio, plan, st);
    case 4: return launch_one<T, NV, 4>(parts, idx, conf, npix, peak_ratio, plan, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const WtaParts& parts, int n, float* idx, bool* conf, long npix, int D,
           float peak_ratio, int* plan, cudaStream_t st) {
  if (D % 32 != 0 || D < 32 || D > 256 || npix < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int N = Vec16<T>::N;
  switch (D / 32) {
#define CVIDS_WTA_CASE(KK)                                                              \
  case KK:                                                                              \
    return launch_parts<T, KK * 32 / N>(parts, n, idx, conf, npix, peak_ratio, plan, st);
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
}

}  // namespace

// v0..v3: part volumes (npix, D), the first n used, each 16-byte aligned;
// idx_out (npix,) fp32, conf_out (npix,) bool. D a multiple of 32 up to 256.
extern "C" int cvids_wta(const void* v0, const void* v1, const void* v2, const void* v3,
                         int n, void* idx_out, void* conf_out, long npix, int D,
                         int bf16, float peak_ratio, void* stream) {
  const void* v[4] = {v0, v1, v2, v3};
  WtaParts parts;
  for (int i = 0; i < 4; ++i) {
    if (i < n && (reinterpret_cast<size_t>(v[i]) & 15))
      return static_cast<int>(cudaErrorMisalignedAddress);
    parts.p[i] = static_cast<const uint4*>(i < n ? v[i] : nullptr);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* idx = static_cast<float*>(idx_out);
  bool* conf = static_cast<bool*>(conf_out);
  if (bf16)
    return launch<__nv_bfloat16>(parts, n, idx, conf, npix, D, peak_ratio, nullptr, st);
  return launch<float>(parts, n, idx, conf, npix, D, peak_ratio, nullptr, st);
}

// what a launch over npix pixels of depth D takes, without launching:
// plan[0..4] = lanes per pixel, 16-byte vectors per lane and part, threads per
// block, pixels per block, blocks
extern "C" int cvids_wta_plan(long npix, int D, int bf16, int* plan) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const WtaParts none = {{nullptr, nullptr, nullptr, nullptr}};
  if (bf16)
    return launch<__nv_bfloat16>(none, 1, nullptr, nullptr, npix, D, 0.0f, plan, nullptr);
  return launch<float>(none, 1, nullptr, nullptr, npix, D, 0.0f, plan, nullptr);
}

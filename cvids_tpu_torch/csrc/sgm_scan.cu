// Bidirectional SGM scan along either spatial axis of an (H, W, D) volume.
//
// Replaces sgm_scan_bidir in cvids_tpu/ops/pallas_kernels.py
// (_sgm_bidir_kernel) and covers sgm_scan_bidir_axis1
// (_sgm_bidir_axis1_kernel). The recurrence along the scan axis is
//   L(s) = C(s) + min(L(s-1), min(L(s-1)[d-1], L(s-1)[d+1]) + P1,
//                     min_d L(s-1) + P2(s)) - min_d L(s-1),   L(0) = C(0),
// run forward and backward; the result is dtype(fwd) + dtype(bwd), added in
// the cost dtype, as the reference kernel's summed output.
//
// Bound on the card: latency, not bandwidth. The recurrence is sequential
// along S (480 or 640 steps) and there are only 640 or 480 scan lines, so the
// volume's 157 MB of traffic would take ~50 us at full bandwidth while the
// chain of dependent steps takes far longer. The design keeps each step short:
// - one warp per scan line and direction (a block of two warps per line);
//   lane l holds depths [l*K, l*K+K) of the fp32 carry in registers, K = D/32;
// - d-1 / d+1 across lanes are one __shfl_up / __shfl_down each, with the
//   3e38 pad at the ends; min over D is a 5-step xor-shuffle reduction;
// - the next step's cost row and P2 are loaded before the current step is
//   computed, so the load latency overlaps the arithmetic;
// - strides select the axis, so no (H, W, D) <-> (W, H, D) transpose is
//   made (the TPU path transposes for the horizontal orientation).
// Summing the two directions without a second volume: a row is reached
// first by one warp and later by the other. The first stores its own
// rounded value; the second (after one __syncthreads() at the halfway
// step, which orders every first-half store before every second-half load)
// loads it, adds its own rounded value, and stores the sum.

#include "common.cuh"

namespace {

template <typename T, int K>
__global__ void __launch_bounds__(64)
sgm_scan_kernel(const T* __restrict__ cost, const T* __restrict__ p2,
                const float* __restrict__ p1_ptr, T* __restrict__ out,
                int S, long cs_s, long cs_x, long p2_s, long p2_x) {
  const int x = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const bool fwd = threadIdx.x < 32;
  const float p1 = *p1_ptr;
  const T* cl = cost + x * cs_x + lane * K;
  T* ol = out + x * cs_x + lane * K;
  const T* pl = p2 + x * p2_x;
  const int mid = S / 2;

  float L[K], c[K];
  int s = fwd ? 0 : S - 1;
#pragma unroll
  for (int j = 0; j < K; ++j) c[j] = cvids_to_f32(cl[s * cs_s + j]);
  float p2v = cvids_to_f32(pl[s * p2_s]);

  for (int t = 0; t < S; ++t) {
    s = fwd ? t : S - 1 - t;
    // prefetch the next row of this direction
    float cn[K];
    float p2n = 0.0f;
    if (t + 1 < S) {
      const int sn = fwd ? t + 1 : S - 2 - t;
#pragma unroll
      for (int j = 0; j < K; ++j) cn[j] = cvids_to_f32(cl[sn * cs_s + j]);
      p2n = cvids_to_f32(pl[sn * p2_s]);
    }
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) L[j] = c[j];
    } else {
      float mn = L[0];
#pragma unroll
      for (int j = 1; j < K; ++j) mn = fminf(mn, L[j]);
      mn = cvids_warp_min(mn);
      float up = __shfl_up_sync(CVIDS_FULL_MASK, L[K - 1], 1);
      float dn = __shfl_down_sync(CVIDS_FULL_MASK, L[0], 1);
      if (lane == 0) up = CVIDS_BIG;
      if (lane == 31) dn = CVIDS_BIG;
      const float jump = mn + p2v;
      float nl[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float sp = j > 0 ? L[j - 1] : up;
        const float sm = j < K - 1 ? L[j + 1] : dn;
        const float cand = fminf(L[j], fminf(fminf(sp, sm) + p1, jump));
        nl[j] = c[j] + cand - mn;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) L[j] = nl[j];
    }

    T* o = ol + s * cs_s;
    if (t == mid) {
      if (S & 1) {
        // odd S: both directions meet on the middle row in this step
        if (fwd) {
#pragma unroll
          for (int j = 0; j < K; ++j) o[j] = cvids_from_f32<T>(L[j]);
        }
        __syncthreads();
        if (!fwd) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float other = cvids_load_cg(o + j);
            o[j] = cvids_from_f32<T>(other + cvids_to_f32(cvids_from_f32<T>(L[j])));
          }
        }
      } else {
        __syncthreads();
      }
    }
    if (!(t == mid && (S & 1))) {
      if (2 * t < S - 1) {
#pragma unroll
        for (int j = 0; j < K; ++j) o[j] = cvids_from_f32<T>(L[j]);
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float other = cvids_load_cg(o + j);
          o[j] = cvids_from_f32<T>(other + cvids_to_f32(cvids_from_f32<T>(L[j])));
        }
      }
    }
    if (t + 1 < S) {
#pragma unroll
      for (int j = 0; j < K; ++j) c[j] = cn[j];
      p2v = p2n;
    }
  }
}

template <typename T>
int launch(const void* cost, const void* p2, const void* p1, void* out, int S, int X,
           int D, long cs_s, long cs_x, long p2_s, long p2_x, cudaStream_t st) {
  const T* c = static_cast<const T*>(cost);
  const T* q = static_cast<const T*>(p2);
  const float* p = static_cast<const float*>(p1);
  T* o = static_cast<T*>(out);
  switch (D / 32) {
#define CVIDS_SGM_CASE(KK)                                                          \
  case KK:                                                                          \
    sgm_scan_kernel<T, KK><<<X, 64, 0, st>>>(c, q, p, o, S, cs_s, cs_x, p2_s, p2_x); \
    break;
    CVIDS_SGM_CASE(1)
    CVIDS_SGM_CASE(2)
    CVIDS_SGM_CASE(3)
    CVIDS_SGM_CASE(4)
    CVIDS_SGM_CASE(5)
    CVIDS_SGM_CASE(6)
    CVIDS_SGM_CASE(7)
    CVIDS_SGM_CASE(8)
#undef CVIDS_SGM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cost, out: (.., .., D) with the scan axis at stride cs_s and the line axis
// at stride cs_x (elements); p2 likewise with p2_s, p2_x; p1: one fp32 on the
// device. D = 32*K, K in 1..8.
extern "C" int cvids_sgm_scan_bidir(const void* cost, const void* p2, const void* p1,
                                    void* out, int S, int X, int D, int cs_s, int cs_x,
                                    int p2_s, int p2_x, int bf16, void* stream) {
  if (D % 32 != 0 || D < 32 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(cost, p2, p1, out, S, X, D, cs_s, cs_x, p2_s, p2_x, st);
  return launch<float>(cost, p2, p1, out, S, X, D, cs_s, cs_x, p2_s, p2_x, st);
}

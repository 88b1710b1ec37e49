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
// Bound on an H100 (3.35 TB/s): bytes. One launch reads the cost volume and
// the P2 map once and writes the summed volume once; a dense frame at
// 640x480x128 in bf16 makes two launches, 2 x (78.6 + 78.6 + 0.6) MB =
// 315.8 MB, 0.094 ms. What holds the kernel above that bound:
// - the recurrence is sequential along S (480 or 640 steps) with only 640 or
//   480 lines, so a step that waits for device memory (~0.7 us) costs ten
//   times the bound: the loads have to be in flight many steps ahead of the
//   step that uses them. Once they are, a step is bound by one warp's chain
//   of dependent instructions (there are only one or two warps a scheduler),
//   so every instruction taken out of the step counts;
// - the two directions meet in memory: a row is stored by the direction that
//   reaches it first and read, summed and stored again by the other, which
//   doubles the traffic unless the read hits L2. The second direction reads
//   rows in the reverse of the order they were written (last in, first out),
//   which is the order a cache keeps best.
// The design:
// - a group of G lanes owns one line and one direction, G the largest power
//   of two (<= 32) dividing the number of 16-byte vectors in a D-row; lane l
//   holds E = D/G consecutive depths of the fp32 carry in registers. At
//   D = 128 in bf16, G = 16 and E = 8: a warp carries both directions of one
//   line, and every load and store is 16 bytes a lane;
// - a ring of NS rows per lane in shared memory (8; 4 where a lane holds more
//   than 4 vectors), filled by cp.async (16 bytes, L2 only) NS steps ahead of
//   the recurrence. Each lane copies exactly the vectors it will read itself,
//   so the ring needs no barrier: cp.async.wait_group orders a lane's copies
//   before its own reads. A second ring carries the other direction's partial
//   rows in the second half, so the read-modify-write does not wait on memory
//   either. Rings of 2 to 32 rows measured alike;
// - d-1 / d+1 across lanes are one __shfl_up / __shfl_down each within the
//   group, with the 3e38 pad at the ends; the minimum over D is a tree of
//   fminf in the lane and, across the group, integer redux.sync on an
//   order-preserving key of the fp32 bits (log2(G) shuffle rounds otherwise).
//   All of them name the full warp (see group_min);
// - P2 is one scalar a step: the group loads G steps' values at once, two
//   batches ahead, and hands them round by shuffle;
// - a step is straight-line code: the scan is split into the steps that visit
//   a row first and those that visit it second, rows advance by pointer
//   increments, and bf16 converts in pairs;
// - strides select the axis, so no (H, W, D) <-> (W, H, D) transpose is made.
// Exact arithmetic: fminf is exact in any order; (c + cand) - mn in that
// order; each direction is rounded to the cost dtype before the add.
//
// The halfway hand-over. Both directions of a line run in one block, in step.
// With F = S / 2, forward reaches rows 0 .. F-1 (and the middle row F when S
// is odd) first, backward rows S-1 .. S-F. Every first visit stores its own
// rounded row with a plain store before the one __syncthreads(); every read of
// a partial row (a cp.async started by the other direction) comes after it.
// The barrier orders the block's global stores before the loads that follow
// it, and cp.async.cg reads at L2, where those stores land. No row is visited
// first after the barrier, so no partial row is written while it may be read.
// Right after the barrier each lane fetches the partial rows of its next NS
// second visits at once and waits for them (one round trip to L2, once per
// launch); from then on a partial row is fetched NS steps ahead like the cost
// rows. Every lane of a warp takes the same path through every instruction
// that synchronises lanes (the shuffles and the redux), whichever direction
// it carries: when S is odd the two directions differ only in which `emit`
// they run around the barrier.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int SGM_THREADS = 64;

__device__ __forceinline__ void cp_async16(uint4* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// order-preserving map of fp32 onto unsigned integers and back, so that a
// minimum over lanes can be an integer redux.sync (the minimum of the keys is
// the key of the minimum, so the result is the exact fminf of the lanes)
__device__ __forceinline__ unsigned min_key(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}
__device__ __forceinline__ float min_unkey(unsigned k) {
  return __uint_as_float(k ^ ((k & 0x80000000u) ? 0x80000000u : 0xffffffffu));
}

// minimum over each aligned group of G lanes. Every instruction names the
// whole warp: a redux.sync or shuffle over a part of the warp makes the
// compiler test the masks for uniformity and serialise the groups (measured:
// a third of a step). G = 32: one redux; G = 16: one redux per half, the other
// half's lanes contributing the largest key; G <= 8: log2(G) xor-shuffles.
template <int G>
__device__ __forceinline__ float group_min(float v, int lane) {
  if (G == 32) {
    return min_unkey(__reduce_min_sync(CVIDS_FULL_MASK, min_key(v)));
  } else if (G == 16) {
    const unsigned key = min_key(v);
    const bool low = lane < 16;
    const unsigned lo = __reduce_min_sync(CVIDS_FULL_MASK, low ? key : 0xffffffffu);
    const unsigned hi = __reduce_min_sync(CVIDS_FULL_MASK, low ? 0xffffffffu : key);
    return min_unkey(low ? lo : hi);
  } else {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      v = fminf(v, __shfl_xor_sync(CVIDS_FULL_MASK, v, o, G));
    return v;
  }
}

// ring depth for EV vectors per lane: both rings of a block within 64 KB
template <int EV>
struct Stages {
  static constexpr int value = EV <= 4 ? 8 : 4;
};

// G lanes per (line, direction), EV 16-byte vectors per lane and row
template <typename T, int G, int EV>
__global__ void __launch_bounds__(SGM_THREADS)
sgm_scan_kernel(const T* __restrict__ cost, const T* __restrict__ p2,
                const float* __restrict__ p1_ptr, T* out, int S, int X,
                long cs_s, long cs_x, long p2_s, long p2_x) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  constexpr int E = EV * N;          // depths per lane
  constexpr int LINES = 32 / G;      // lines per block (two directions each)
  constexpr int NS = Stages<EV>::value;
  constexpr int SLOT = EV * SGM_THREADS;   // uint4 per ring slot
  extern __shared__ uint4 ring[];    // [2][NS][EV][SGM_THREADS]

  const int tid = threadIdx.x;
  const int group = tid / G;
  const int lig = tid % G;
  const bool fwd = (group & 1) == 0;
  const int line_raw = blockIdx.x * LINES + group / 2;
  // a ragged block's spare groups run line X-1's cost through every step (the
  // shuffles need all lanes) but store nothing and fetch no partial row, so
  // they touch no memory that another group writes
  const bool active = line_raw < X;
  const int line = active ? line_raw : X - 1;
  const int S_part = active ? S : 0;   // partial rows are fetched for steps below it
  const float p1 = *p1_ptr;

  uint4* cring = ring + tid;
  uint4* pring = ring + NS * SLOT + tid;

  const int F = S / 2;
  // steps [0, first) visit their row first; steps [first, S) second
  const int first = F + (fwd ? (S & 1) : 0);
  const long step = fwd ? cs_s : -cs_s;           // elements from one step's row to the next
  const long row0 = fwd ? 0 : (S - 1) * cs_s;
  const T* cnext = cost + line * cs_x + lig * E + row0;   // cost row of the next step to fetch
  T* orow = out + line * cs_x + lig * E + row0;           // output row of the current step
  const T* pl = p2 + line * p2_x;

  auto p2_at = [&](int t) -> float {
    return t < S ? cvids_to_f32(__ldg(pl + (fwd ? t : S - 1 - t) * p2_s)) : 0.0f;
  };
  auto fetch_row = [&](uint4* slot, const T* src) {
#pragma unroll
    for (int v = 0; v < EV; ++v) cp_async16(slot + v * SGM_THREADS, src + v * N);
  };

  // fill the cost ring; one group per step, empty past the end
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (i < S) fetch_row(cring + i * SLOT, cnext);
    cnext += step;
    cp_async_commit();
  }
  float p2_cur = p2_at(lig), p2_n1 = p2_at(G + lig), p2_n2 = p2_at(2 * G + lig);

  float L[E];
  // A step is three straight-line pieces, so that the compiler can overlap
  // the copies, conversions and stores with the dependent chain min ->
  // candidates -> carry. `advance` (INIT: the first row of a direction is the
  // cost row as it is) holds every warp-synchronous instruction and is run by
  // all lanes together; the two `emit`s and `next_row` hold none, so the two
  // directions of a warp may take different ones in the middle step.
  auto advance = [&](auto init_c, int t) {
    constexpr bool INIT = decltype(init_c)::value;
    const int b = t & (G - 1);
    if (b == 0 && t > 0) {
      p2_cur = p2_n1;
      p2_n1 = p2_n2;
      p2_n2 = p2_at(t + 2 * G + lig);
    }
    const float p2v = __shfl_sync(CVIDS_FULL_MASK, p2_cur, b, G);

    cp_async_wait<NS - 1>();
    const uint4* cslot = cring + (t & (NS - 1)) * SLOT;
    float c[E];
#pragma unroll
    for (int v = 0; v < EV; ++v) V::unpack(cslot[v * SGM_THREADS], c + v * N);

    if (INIT) {
#pragma unroll
      for (int j = 0; j < E; ++j) L[j] = c[j];
    } else {
      float m[E];
#pragma unroll
      for (int j = 0; j < E; ++j) m[j] = L[j];
#pragma unroll
      for (int w = 1; w < E; w *= 2)          // tree: fminf is exact in any order
#pragma unroll
        for (int j = 0; j + w < E; j += 2 * w) m[j] = fminf(m[j], m[j + w]);
      const float mn = group_min<G>(m[0], tid & 31);
      float up = __shfl_up_sync(CVIDS_FULL_MASK, L[E - 1], 1, G);
      float dn = __shfl_down_sync(CVIDS_FULL_MASK, L[0], 1, G);
      if (lig == 0) up = CVIDS_BIG;
      if (lig == G - 1) dn = CVIDS_BIG;
      const float jump = mn + p2v;
      float prev = up;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float cur = L[j];
        const float next = j < E - 1 ? L[j + 1] : dn;
        const float cand = fminf(cur, fminf(fminf(prev, next) + p1, jump));
        L[j] = c[j] + cand - mn;
        prev = cur;
      }
    }
  };
  // first visit: store this direction's rounded row
  auto emit_first = [&]() {
    if (active) {
#pragma unroll
      for (int v = 0; v < EV; ++v)
        *reinterpret_cast<uint4*>(orow + v * N) = V::pack(L + v * N);
    }
  };
  // second visit: add the other direction's partial row, store the sum, and
  // ask for the partial row NS steps on
  auto emit_second = [&](int t) {
    uint4* pslot = pring + ((t - first) & (NS - 1)) * SLOT;
#pragma unroll
    for (int v = 0; v < EV; ++v) {
      float other[N], mine[N];
      V::unpack(pslot[v * SGM_THREADS], other);
      V::unpack(V::pack(L + v * N), mine);      // this direction, rounded to T
#pragma unroll
      for (int j = 0; j < N; ++j) other[j] = other[j] + mine[j];
      if (active) *reinterpret_cast<uint4*>(orow + v * N) = V::pack(other);
    }
    if (t + NS < S_part) fetch_row(pslot, orow + NS * step);
  };
  // ask for the cost row NS steps on and move to the next row
  auto next_row = [&](int t) {
    if (t + NS < S) fetch_row(cring + (t & (NS - 1)) * SLOT, cnext);
    cnext += step;
    orow += step;
    cp_async_commit();
  };
  const std::true_type yes;
  const std::false_type no;

  // steps [0, F): every lane visits its row first
  if (F > 0) {
    advance(yes, 0);
    emit_first();
    next_row(0);
  }
  for (int t = 1; t < F; ++t) {
    advance(no, t);
    emit_first();
    next_row(t);
  }
  // the middle step of an odd S: forward stores the middle row before the
  // barrier, backward sums it after
  if (S & 1) {
    if (F > 0) advance(no, F); else advance(yes, F);
    if (fwd) emit_first();
  }
  // every first visit is stored: fetch the partial rows of the next NS second
  // visits at once. orow is the row of step F here.
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NS; ++k)
    if (first + k < S_part) fetch_row(pring + k * SLOT, orow + (first - F + k) * step);
  cp_async_commit();
  cp_async_wait<0>();
  if (S & 1) {
    if (!fwd) emit_second(F);
    next_row(F);
  }
  // steps [F + (S & 1), S): every lane visits its row second
  for (int t = F + (S & 1); t < S; ++t) {
    advance(no, t);
    emit_second(t);
    next_row(t);
  }
  cp_async_wait<0>();
}

// launches, or with `plan` only reports what it would launch: {lanes per line
// and direction, vectors per lane, ring depth, threads, blocks, dynamic shared
// memory bytes}
template <typename T, int G, int EV>
int launch_one(const T* c, const T* q, const float* p, T* o, int S, int X, long cs_s,
               long cs_x, long p2_s, long p2_x, int* plan, cudaStream_t st) {
  constexpr int LINES = 32 / G;
  constexpr int NS = Stages<EV>::value;
  const int grid = (X + LINES - 1) / LINES;
  const size_t smem = sizeof(uint4) * 2 * NS * EV * SGM_THREADS;
  if (plan != nullptr) {
    const int v[6] = {G, EV, NS, SGM_THREADS, grid, static_cast<int>(smem)};
    for (int i = 0; i < 6; ++i) plan[i] = v[i];
    return 0;
  }
  auto kernel = sgm_scan_kernel<T, G, EV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, SGM_THREADS, smem, st>>>(c, q, p, o, S, X, cs_s, cs_x, p2_s, p2_x);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* cost, const void* p2, const void* p1, void* out, int S, int X,
           int D, long cs_s, long cs_x, long p2_s, long p2_x, int* plan,
           cudaStream_t st) {
  if (D % 32 != 0 || D < 32 || D > 256 || S < 1 || X < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* c = static_cast<const T*>(cost);
  const T* q = static_cast<const T*>(p2);
  const float* p = static_cast<const float*>(p1);
  T* o = static_cast<T*>(out);
  // vectors per D-row -> (G, EV): G the largest power of two dividing it
  switch (D / Vec16<T>::N) {
#define CVIDS_SGM_CASE(NV, GG, EE)                                                   \
  case NV:                                                                           \
    return launch_one<T, GG, EE>(c, q, p, o, S, X, cs_s, cs_x, p2_s, p2_x, plan, st);
    CVIDS_SGM_CASE(4, 4, 1)
    CVIDS_SGM_CASE(8, 8, 1)
    CVIDS_SGM_CASE(12, 4, 3)
    CVIDS_SGM_CASE(16, 16, 1)
    CVIDS_SGM_CASE(20, 4, 5)
    CVIDS_SGM_CASE(24, 8, 3)
    CVIDS_SGM_CASE(28, 4, 7)
    CVIDS_SGM_CASE(32, 32, 1)
    CVIDS_SGM_CASE(40, 8, 5)
    CVIDS_SGM_CASE(48, 16, 3)
    CVIDS_SGM_CASE(56, 8, 7)
    CVIDS_SGM_CASE(64, 32, 2)
#undef CVIDS_SGM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// cost, out: (.., .., D) with the scan axis at stride cs_s and the line axis
// at stride cs_x (elements), both 16-byte aligned; p2 likewise with p2_s,
// p2_x; p1: one fp32 on the device. D a multiple of 32 up to 256.
extern "C" int cvids_sgm_scan_bidir(const void* cost, const void* p2, const void* p1,
                                    void* out, int S, int X, int D, int cs_s, int cs_x,
                                    int p2_s, int p2_x, int bf16, void* stream) {
  if ((reinterpret_cast<size_t>(cost) | reinterpret_cast<size_t>(out)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(cost, p2, p1, out, S, X, D, cs_s, cs_x, p2_s, p2_x,
                                 nullptr, st);
  return launch<float>(cost, p2, p1, out, S, X, D, cs_s, cs_x, p2_s, p2_x, nullptr, st);
}

// what a launch over X lines of depth D takes, without launching: plan[0..5]
// = lanes per line and direction, 16-byte vectors per lane, ring depth,
// threads per block, blocks, dynamic shared memory bytes
extern "C" int cvids_sgm_scan_plan(int X, int D, int bf16, int* plan) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return launch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, 1, X, D, 0, 0, 0, 0,
                                 plan, nullptr);
  return launch<float>(nullptr, nullptr, nullptr, nullptr, 1, X, D, 0, 0, 0, 0, plan,
                       nullptr);
}

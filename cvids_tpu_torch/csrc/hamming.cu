// Pairwise Hamming distances between 256-bit binary descriptors, with
// validity masks.
//
// Replaces hamming_matrix in cvids_tpu/ops/pallas_kernels.py
// (_hamming_kernel) together with its masking wrapper
// hamming_distance_matrix: out[i, j] = sum_w popc(a[i, w] ^ b[j, w]) over the
// 8 words of a descriptor, or 512 (more than any real distance) where row i
// or column j is invalid.
//
// Bound on the card: at the loop-verification shape (160 x 512) the launch;
// at large shapes the (N, M) int32 store, 4 bytes per 24 integer operations.
// One thread per output column keeps its B descriptor in registers; a block
// of 128 columns walks a tile of TN A rows held in shared memory, which every
// thread reads at the same address (a broadcast). Neighbouring threads write
// neighbouring columns of a row, so each row's store is coalesced. Ragged
// edges are masked in the kernel; N == 0 or M == 0 never reaches it.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TM = 128;  // columns (B rows) per block, one per thread
constexpr int TN = 32;   // A rows per block
constexpr int WORDS = 8;

__global__ void __launch_bounds__(TM)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               const uint8_t* __restrict__ a_valid, const uint8_t* __restrict__ b_valid,
               int32_t* __restrict__ out, int n, int m) {
  __shared__ uint32_t sa[TN][WORDS];
  __shared__ bool sav[TN];
  const int i0 = blockIdx.y * TN;
  for (int k = threadIdx.x; k < TN * WORDS; k += TM) {
    const int r = i0 + k / WORDS;
    sa[k / WORDS][k % WORDS] = r < n ? a[static_cast<long>(r) * WORDS + k % WORDS] : 0u;
  }
  if (threadIdx.x < TN) {
    const int r = i0 + threadIdx.x;
    sav[threadIdx.x] = r < n && (a_valid == nullptr || a_valid[r] != 0);
  }
  __syncthreads();
  const int j = blockIdx.x * TM + threadIdx.x;
  if (j >= m) return;
  uint32_t bw[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) bw[w] = b[static_cast<long>(j) * WORDS + w];
  const bool bv = b_valid == nullptr || b_valid[j] != 0;
  const int rows = min(TN, n - i0);
  for (int r = 0; r < rows; ++r) {
    int d = 0;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) d += __popc(sa[r][w] ^ bw[w]);
    out[static_cast<long>(i0 + r) * m + j] = (bv && sav[r]) ? d : 512;
  }
}

}  // namespace

// a (n, 8) and b (m, 8) 32-bit words; a_valid (n,) / b_valid (m,) bytes or
// null (all valid); out (n, m) int32. n, m >= 1.
extern "C" int cvids_hamming(const void* a, const void* b, const void* a_valid,
                             const void* b_valid, void* out, int n, int m, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  hamming_kernel<<<grid, TM, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint8_t*>(a_valid), static_cast<const uint8_t*>(b_valid),
      static_cast<int32_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

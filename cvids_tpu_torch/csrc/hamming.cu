// Pairwise Hamming distances between 256-bit binary descriptors, with
// validity masks.
//
// Replaces hamming_matrix in cvids_tpu/ops/pallas_kernels.py
// (_hamming_kernel) together with its masking wrapper
// hamming_distance_matrix: out[i, j] = sum_w popc(a[i, w] ^ b[j, w]) over the
// 8 words of a descriptor, or 512 (more than any real distance) where row i
// or column j is invalid.
//
// Bound on the card: at the loop-verification shape (160 x 512: 82 k outputs,
// 328 KB) the launch itself; at large shapes the (N, M) int32 store, 4 bytes
// per 12 integer operations. The design:
// - a descriptor is 32 bytes: a thread loads its B descriptor as two 16-byte
//   vectors and keeps it in four 64-bit registers; a distance is four
//   __popcll of 64-bit XORs;
// - one thread per output column: a block of TM = 128 columns walks a tile of
//   TN A rows held in shared memory, which every thread reads at the same
//   address (a broadcast), and each warp stores 128 contiguous bytes of a row;
// - TN = 4 rows a block: the loop verification's 160 x 512 is 40 x 4 = 160
//   blocks, one for each of the card's 132 SMs and more, and a large matrix
//   is no slower for it (timed: 4 and 8 rows 0.0107 ms at 2048 x 2048, 16
//   rows 0.0111, 32 rows 0.0115; at 160 x 512 0.0020, 0.0023, 0.0031 and
//   0.0046 ms). The row tiles lie along the grid's x, which has no limit a
//   matrix could meet; the column tiles along y, which takes 65,535 x 128
//   columns.
// Ragged edges are masked in the kernel; N == 0 or M == 0 never reaches it.
// a and b must be 16-byte aligned (the wrapper checks).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TM = 128;      // columns (B rows) per block, one per thread
constexpr int TN = 4;        // A rows a block walks
constexpr int MAX_GRID_Y = 65535;
static_assert(2 * TN <= TM, "the first 2 TN threads of a block load its A tile");

__global__ void __launch_bounds__(TM)
hamming_kernel(const ulonglong2* __restrict__ a, const ulonglong2* __restrict__ b,
               const uint8_t* __restrict__ a_valid, const uint8_t* __restrict__ b_valid,
               int32_t* __restrict__ out, int n, int m) {
  __shared__ ulonglong2 sa[TN][2];
  __shared__ bool sav[TN];
  const int i0 = blockIdx.x * TN;
  if (threadIdx.x < 2 * TN) {
    const int r = i0 + threadIdx.x / 2;
    sa[threadIdx.x / 2][threadIdx.x % 2] =
        r < n ? a[static_cast<long>(r) * 2 + threadIdx.x % 2] : make_ulonglong2(0ull, 0ull);
  }
  if (threadIdx.x < TN) {
    const int r = i0 + threadIdx.x;
    sav[threadIdx.x] = r < n && (a_valid == nullptr || a_valid[r] != 0);
  }
  __syncthreads();
  const int j = blockIdx.y * TM + threadIdx.x;
  if (j >= m) return;
  const ulonglong2 b0 = b[static_cast<long>(j) * 2];
  const ulonglong2 b1 = b[static_cast<long>(j) * 2 + 1];
  const bool bv = b_valid == nullptr || b_valid[j] != 0;
  const int rows = min(TN, n - i0);
  int32_t* dst = out + static_cast<long>(i0) * m + j;
#pragma unroll
  for (int r = 0; r < TN; ++r) {
    if (r < rows) {
      const ulonglong2 a0 = sa[r][0];
      const ulonglong2 a1 = sa[r][1];
      const int d = __popcll(a0.x ^ b0.x) + __popcll(a0.y ^ b0.y) +
                    __popcll(a1.x ^ b1.x) + __popcll(a1.y ^ b1.y);
      dst[static_cast<long>(r) * m] = (bv && sav[r]) ? d : 512;
    }
  }
}

}  // namespace

// plan[0..4] = columns per block, A rows per block, threads, grid x, grid y
extern "C" int cvids_hamming_plan(int n, int m, int* plan) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = TM;
  plan[1] = TN;
  plan[2] = TM;
  plan[3] = (n + TN - 1) / TN;
  plan[4] = (m + TM - 1) / TM;
  return 0;
}

// a (n, 8) and b (m, 8) 32-bit words, 16-byte aligned; a_valid (n,) /
// b_valid (m,) bytes or null (all valid); out (n, m) int32. n, m >= 1.
extern "C" int cvids_hamming(const void* a, const void* b, const void* a_valid,
                             const void* b_valid, void* out, int n, int m, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  if (grid.y > MAX_GRID_Y) return static_cast<int>(cudaErrorInvalidValue);
  hamming_kernel<<<grid, TM, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ulonglong2*>(a), static_cast<const ulonglong2*>(b),
      static_cast<const uint8_t*>(a_valid), static_cast<const uint8_t*>(b_valid),
      static_cast<int32_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

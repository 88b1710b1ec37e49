// Batched symmetric eigendecomposition of small matrices (n <= 12) by cyclic
// Jacobi: eigenvalues ascending, eigenvectors as columns; fp32 or fp64.
//
// No Pallas counterpart: the JAX package leaves its small `eigh` to XLA. It
// replaces the torch.linalg.eigh and torch.linalg.svd calls of the 8-point
// fundamental matrix (ops/ransac.py, _eight_point: 128 9x9 systems AtA and
// the rank-2 projection through the 3x3 FtF, both in fp64 there: AtA squares
// the 8-point system's condition, and fp32 leaves F ~1e-3 off), whose error
// checks wait for the card; this kernel reads nothing back, so a RANSAC call
// can be captured in a CUDA graph.
//
// Bound on the card: the serial chain of rotations, not bytes or operations.
// A 9x9 matrix takes 8 sweeps x 36 rotations, each a few dependent
// operations and three warp-wide row/column updates: ~300 dependent steps
// against ~180 KB of traffic for the whole batch of 128 in fp64. The design:
// - one warp a matrix, the matrix and its accumulated rotations in shared
//   memory (rows padded by one element); lane k owns row k in the column
//   update and column k in the row update, so the two-sided rotation is two
//   conflict-free passes;
// - every lane computes the same rotation from the same three shared words,
//   so no broadcast is needed; a fixed sweep count, so the launch is a fixed
//   amount of work and the result does not depend on a convergence test;
// - the rotation is the classic one (t = sign(theta) / (|theta| +
//   sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1), s = t c; none where a_pq is
//   0), applied as a full update of rows and columns p and q, in the order
//   of the PyTorch twin `cuda_kernels.small_eigh_twin`; built with
//   -fmad=false, the two agree bit for bit in either precision;
// - the input's lower triangle is read (as torch.linalg.eigh reads it) and
//   mirrored; the eigenvalues are sorted by rank (ties by index, NaN last),
//   each lane writing its own eigenpair.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAX_N = 12;
constexpr int LD = MAX_N + 1;
constexpr int WARPS = 4;      // matrices a block

template <typename T>
__device__ __forceinline__ T sort_key(T x) {
  return isnan(x) ? T(INFINITY) : x;   // NaN ranks last
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
small_eig_kernel(const T* __restrict__ a, T* __restrict__ w, T* __restrict__ v, int batch,
                 int n, int sweeps) {
  __shared__ T sa[WARPS][MAX_N][LD];
  __shared__ T sv[WARPS][MAX_N][LD];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long b = static_cast<long>(blockIdx.x) * WARPS + warp;
  if (b >= batch) return;     // the whole warp: the kernel syncs warps only
  T(*A)[LD] = sa[warp];
  T(*V)[LD] = sv[warp];
  const T* src = a + b * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e % n;
    A[i][j] = i >= j ? src[e] : src[j * n + i];
    V[i][j] = i == j ? T(1) : T(0);
  }
  __syncwarp();
  for (int s = 0; s < sweeps; ++s) {
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const T app = A[p][p], aqq = A[q][q], apq = A[p][q];
        T c = T(1), sn = T(0);
        if (apq != T(0)) {
          const T theta = (aqq - app) / (T(2) * apq);
          const T t = (theta >= T(0) ? T(1) : T(-1)) / (fabs(theta) + sqrt(theta * theta + T(1)));
          c = T(1) / sqrt(t * t + T(1));
          sn = t * c;
        }
        __syncwarp();          // every lane has read a_pp, a_qq, a_pq
        if (lane < n) {        // columns p and q, row `lane`
          const T kp = A[lane][p], kq = A[lane][q];
          A[lane][p] = c * kp - sn * kq;
          A[lane][q] = sn * kp + c * kq;
          const T vp = V[lane][p], vq = V[lane][q];
          V[lane][p] = c * vp - sn * vq;
          V[lane][q] = sn * vp + c * vq;
        }
        __syncwarp();
        if (lane < n) {        // rows p and q, column `lane`
          const T pk = A[p][lane], qk = A[q][lane];
          A[p][lane] = c * pk - sn * qk;
          A[q][lane] = sn * pk + c * qk;
        }
        __syncwarp();
      }
    }
  }
  if (lane < n) {
    const T key = sort_key(A[lane][lane]);
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const T kj = sort_key(A[j][j]);
      rank += (kj < key || (kj == key && j < lane)) ? 1 : 0;
    }
    w[b * n + rank] = A[lane][lane];
    for (int r = 0; r < n; ++r) v[(b * n + r) * n + rank] = V[r][lane];
  }
}

}  // namespace

// a (batch, n, n), read from its lower triangle; w (batch, n) and v (batch,
// n, n) out; all fp64 if `fp64`, else fp32. 1 <= n <= 12, batch >= 1,
// sweeps >= 0.
extern "C" int cvids_small_eig(const void* a, void* w, void* v, int batch, int n, int sweeps,
                               int fp64, void* stream) {
  if (batch < 1 || n < 1 || n > MAX_N || sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + WARPS - 1) / WARPS;
  const auto st = static_cast<cudaStream_t>(stream);
  if (fp64)
    small_eig_kernel<double><<<blocks, 32 * WARPS, 0, st>>>(
        static_cast<const double*>(a), static_cast<double*>(w), static_cast<double*>(v), batch,
        n, sweeps);
  else
    small_eig_kernel<float><<<blocks, 32 * WARPS, 0, st>>>(
        static_cast<const float*>(a), static_cast<float*>(w), static_cast<float*>(v), batch, n,
        sweeps);
  return static_cast<int>(cudaGetLastError());
}

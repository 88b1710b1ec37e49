// Batched symmetric eigendecomposition of small matrices (n <= 12) by Jacobi
// rotations in a parallel (round-robin) order: eigenvalues ascending,
// eigenvectors as columns; fp32 or fp64.
//
// No Pallas counterpart: the JAX package leaves its small `eigh` to XLA. It
// replaces the torch.linalg.eigh and torch.linalg.svd calls of the 8-point
// fundamental matrix and of the PnP DLT (ops/ransac.py: 128 9x9 or 12x12
// systems AtA and the rank-2 projection through a 3x3, all in fp64 there:
// AtA squares the system's condition, and fp32 leaves F ~1e-3 off); this
// kernel reads nothing back, so a RANSAC call can be captured in a CUDA
// graph.
//
// The order. A sweep is the round-robin ("circle") schedule over m = n + n %
// 2 indices: m - 1 rounds of m / 2 disjoint pairs, slot 0 of round r pairing
// m - 1 with r and slot k > 0 pairing (r + k) % (m - 1) with (r - k) % (m -
// 1); for an odd n, index m - 1 = n is a dummy and its partner takes no
// rotation that round. Every pair p < q < n meets once a sweep, in n - 1
// rounds for an even n and n for an odd one, instead of n (n - 1) / 2 single
// rotations (12x12: 11 rounds instead of 66; 9x9: 9 instead of 36; 3x3: 3 as
// before). `cuda_kernels.small_eig_schedule` states the same schedule in
// Python, and the twin is built from it: any other order of rotations
// rounds differently, so the bit equality of kernel and twin holds the two
// schedules equal.
// A round:
// 1. thread k of the matrix's block computes slot k's rotation from the
//    matrix as it stood at the start of the round, the classic one: theta =
//    (a_qq - a_pp) / (2 a_pq), t = sign(theta) / (|theta| + sqrt(theta^2 +
//    1)), c = 1 / sqrt(t^2 + 1), s = t c; none (c = 1, s = 0) where a_pq is
//    0. It writes, for both indices of its pair, the partner, c and the
//    signed sine (-s for p, s for q); the unpaired index of an odd n gets no
//    partner;
// 2. every column j of A and V with a partner k becomes c x_j + s_j x_k,
//    then every row i of A with a partner k becomes c x_i + s_i x_k.
// The pairs are disjoint, so each element takes at most one column and one
// row rotation a round, in that order: element (i, j) of the new A is the
// row rotation of the column-rotated (i, j) and (part[i], j), computed from
// four elements of the old A with the same roundings as two separate
// passes, and the result does not depend on which thread does what. The
// twin `cuda_kernels.small_eigh_twin` (through `small_eig_rotate`) does the
// same rounds as two passes vectorised over the pairs and the batch; built
// with -fmad=false, the two agree bit for bit in either precision. A fixed
// sweep count (`cuda_kernels.SMALL_EIG_SWEEPS`, 8): the launch is a fixed
// amount of work and the result does not depend on a convergence test (in
// fp64 the off-diagonal norm reaches rounding after 8 sweeps at 12x12, 1.4e-15
// of the norm after 7, and after 7 at 9x9; `dev/torch_probe_small_eig.py`).
// The input's lower triangle is read (as torch.linalg.eigh reads it) and
// mirrored; the eigenvalues are sorted by rank (ties by index, NaN last),
// each thread k < n writing eigenpair k.
//
// Bound on the card: the chain of rounds, not bytes or operations (~180 KB
// and ~0.02 GFLOP fp64 for a batch of 128 9x9 and 3x3: well under the launch
// floor). A round is one dependent rotation (three fp64 divisions and two
// square roots) then one pass over the elements and two barriers: ~0.7 us a
// round on an H100 at any n (0.058 ms for 128 9x9, 0.062 for 128 12x12,
// 0.021 for 128 3x3), so the rotation's chain of divisions and square roots
// is what bounds it now. The cyclic order this replaces took ~0.46 us a
// rotation (0.137 ms at 9x9, 0.240 at 12x12); a first round-robin version
// with one warp a matrix, separate column and row passes and five warp
// barriers a round took ~1.1 us a round at 9x9 (PERF.md). The design:
// - one block a matrix, so a batch of 128 spreads over the SMs; the matrix
//   and its accumulated rotations in shared memory, rows padded by one
//   element, double-buffered: a round reads one copy and writes the other,
//   so it needs one barrier after the rotations are posted and one after
//   the pass, and no second pass;
// - enough threads that each updates at most two of A's and V's 2 n^2
//   elements a round (96 at 9x9, 160 at 12x12, one warp at 3x3, whose 18
//   elements fit one warp and whose barriers are then warp barriers), their
//   indices computed once;
// - n a template parameter for the sizes on the path (3, 9, 12), so the
//   element loop is unrolled and its registers fixed; every other n runs
//   the same code with n at run time and 160 threads (the same operations,
//   the same bits). The instances earn their place: with n at run time
//   and 160 threads at every n, 128 fp64 matrices took 0.0616 / 0.0731 /
//   0.0261 ms at 9x9 / 12x12 / 3x3 against 0.0581 / 0.0623 / 0.0211 ms
//   templated (6, 17 and 24 % slower; the F and the DLT pair 11 and 19 %;
//   PERF.md, PR 14).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAX_N = 12;
constexpr int LD = MAX_N + 1;

// slot k of round r of a sweep over m indices (m even): the pair (p, q), p < q
__device__ __forceinline__ void round_robin(int m, int r, int k, int* p, int* q) {
  int a, b;
  if (k == 0) {
    a = m - 1;
    b = r;
  } else {
    a = (r + k) % (m - 1);
    b = (r - k + m - 1) % (m - 1);
  }
  *p = a < b ? a : b;
  *q = a < b ? b : a;
}

template <typename T>
__device__ __forceinline__ T sort_key(T x) {
  return isnan(x) ? T(INFINITY) : x;   // NaN ranks last
}

// a block's threads for n: one warp for a 3x3, else enough warps that a
// thread updates at most two of the 2 n^2 elements of A and V a round
__host__ __device__ constexpr int eig_threads(int n) {
  return n > 0 && n <= 4 ? 32 : n == 9 ? 96 : 160;
}

template <int THREADS>
__device__ __forceinline__ void block_sync() {
  if (THREADS == 32)
    __syncwarp();
  else
    __syncthreads();
}

// N > 0: n == N, fixed at compile time; N == 0: n at run time
template <typename T, int N>
__global__ void __launch_bounds__(eig_threads(N))
small_eig_kernel(const T* __restrict__ a, T* __restrict__ w, T* __restrict__ v, int n_rt,
                 int sweeps) {
  constexpr int THREADS = eig_threads(N);
  constexpr int STEPS = N > 0 ? (2 * N * N + THREADS - 1) / THREADS
                              : (2 * MAX_N * MAX_N + THREADS - 1) / THREADS;
  __shared__ T A[2][MAX_N][LD];  // the matrix, as of the round's start in A[cur]
  __shared__ T V[2][MAX_N][LD];  // its accumulated rotations
  __shared__ T cc[MAX_N];        // this round's cosine of each index's pair
  __shared__ T ss[MAX_N];        // its signed sine: -s for p, s for q
  __shared__ int part[MAX_N];    // its partner, -1 for none
  const int n = N > 0 ? N : n_rt;
  const int nn = n * n;
  const int tid = threadIdx.x;
  const long b = blockIdx.x;
  const T* src = a + b * nn;
  for (int e = tid; e < nn; e += THREADS) {
    const int i = e / n, j = e % n;
    A[0][i][j] = i >= j ? src[e] : src[j * n + i];
    V[0][i][j] = i == j ? T(1) : T(0);
  }
  // this thread's elements: e < n^2 of A, the rest of V
  int ei[STEPS], ej[STEPS];
#pragma unroll
  for (int t = 0; t < STEPS; ++t) {
    const int e = tid + THREADS * t;
    const int f = e < nn ? e : e - nn;
    ei[t] = f / n;
    ej[t] = f % n;
  }
  const int m = n + (n & 1);
  int cur = 0;
  block_sync<THREADS>();
  for (int s = 0; s < sweeps; ++s) {
    for (int r = 0; r < m - 1; ++r) {
      if (tid < m / 2) {
        int p, q;
        round_robin(m, r, tid, &p, &q);
        if (q < n) {
          const T app = A[cur][p][p], aqq = A[cur][q][q], apq = A[cur][p][q];
          T c = T(1), sn = T(0);
          if (apq != T(0)) {
            const T theta = (aqq - app) / (T(2) * apq);
            const T t =
                (theta >= T(0) ? T(1) : T(-1)) / (fabs(theta) + sqrt(theta * theta + T(1)));
            c = T(1) / sqrt(t * t + T(1));
            sn = t * c;
          }
          part[p] = q;
          part[q] = p;
          cc[p] = c;
          cc[q] = c;
          ss[p] = -sn;
          ss[q] = sn;
        } else {
          part[p] = -1;            // the dummy's partner: no rotation this round
        }
      }
      block_sync<THREADS>();
      // element (i, j) after the round: the column rotation of column j
      // (rows i and part[i]), then the row rotation of row i; V by columns
      const T(*X)[LD] = A[cur];
      const T(*Y)[LD] = V[cur];
#pragma unroll
      for (int t = 0; t < STEPS; ++t) {
        const int e = tid + THREADS * t;
        if (e < 2 * nn) {
          const int i = ei[t], j = ej[t], kj = part[j];
          const T cj = cc[j], sj = ss[j];
          if (e < nn) {
            const T aij = kj >= 0 ? cj * X[i][j] + sj * X[i][kj] : X[i][j];
            const int ki = part[i];
            T out = aij;
            if (ki >= 0) {
              const T akj = kj >= 0 ? cj * X[ki][j] + sj * X[ki][kj] : X[ki][j];
              out = cc[i] * aij + ss[i] * akj;
            }
            A[cur ^ 1][i][j] = out;
          } else {
            V[cur ^ 1][i][j] = kj >= 0 ? cj * Y[i][j] + sj * Y[i][kj] : Y[i][j];
          }
        }
      }
      cur ^= 1;
      block_sync<THREADS>();
    }
  }
  if (tid < n) {
    const T key = sort_key(A[cur][tid][tid]);
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const T kj = sort_key(A[cur][j][j]);
      rank += (kj < key || (kj == key && j < tid)) ? 1 : 0;
    }
    w[b * n + rank] = A[cur][tid][tid];
    for (int r = 0; r < n; ++r) v[(b * n + r) * n + rank] = V[cur][r][tid];
  }
}

template <typename T>
void launch(const void* a, void* w, void* v, int batch, int n, int sweeps, cudaStream_t st) {
  const T* pa = static_cast<const T*>(a);
  T* pw = static_cast<T*>(w);
  T* pv = static_cast<T*>(v);
  switch (n) {
    case 3:
      small_eig_kernel<T, 3><<<batch, eig_threads(3), 0, st>>>(pa, pw, pv, n, sweeps);
      break;
    case 9:
      small_eig_kernel<T, 9><<<batch, eig_threads(9), 0, st>>>(pa, pw, pv, n, sweeps);
      break;
    case 12:
      small_eig_kernel<T, 12><<<batch, eig_threads(12), 0, st>>>(pa, pw, pv, n, sweeps);
      break;
    default:
      small_eig_kernel<T, 0><<<batch, eig_threads(0), 0, st>>>(pa, pw, pv, n, sweeps);
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
  const auto st = static_cast<cudaStream_t>(stream);
  if (fp64)
    launch<double>(a, w, v, batch, n, sweeps, st);
  else
    launch<float>(a, w, v, batch, n, sweeps, st);
  return static_cast<int>(cudaGetLastError());
}

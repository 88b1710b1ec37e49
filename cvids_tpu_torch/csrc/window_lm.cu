// The agent's sliding-window solve, `vio.window_ba.solve_window_fast`, in one
// launch: every Levenberg-Marquardt iteration of one window, with the
// landmarks eliminated by their 3x3 blocks (Schur complement) and the reduced
// camera system factored in the shared memory of a thread-block cluster.
//
// No Pallas counterpart: it replaces the JAX package's compiled program
// `_solve_window_fast_jit` (cvids_tpu/vio/window_ba.py:689), which the port
// ran as one CUDA graph of ~18,000 small kernels (~2,240 an iteration). This
// kernel computes what `cuda_kernels.window_lm_twin` (ops/window_lm.py)
// computes; built with -fmad=false, the two agree bit for bit. That module
// states the order of every sum; in short:
// - camera-only factors (IMU, anchors, bias priors, the camera-only prior) by
//   forward-mode dual numbers (struct Dual below), one thread a (factor, seed
//   column): an IMU factor's 15 rows over the 30 columns of its two slots,
//   the yaw anchor over slot 0's rotation, the prior's D (the derivative of
//   cam_local_diff, the identity but on the rotation blocks) a slot at a
//   time; the prior's Gram matrix is D^T (j^T j) D with j^T j formed once;
// - reprojection blocks in closed form, one thread a landmark looping over
//   the keyframes in slot order; a landmark's damped 3x3 block inverted by
//   its adjugate;
// - sums over landmarks (the pose blocks, the gradient, the Schur term
//   W H_pl^T of every lower pose pair, the gradient's correction) owned one
//   output a thread, in landmark order from +0 over tiles of landmarks staged
//   in shared memory, skipping observations that are not valid (their terms
//   are +-0 in the twin, which adds them: no change to a sum that started at
//   +0); no atomics anywhere, so the result is deterministic;
// - the (15K + 1) x 15K lower triangle (the system and its right-hand side as
//   a last row) factored by a right-looking Cholesky (each element's
//   subtractions in column order, then its division), then solved back; a
//   pivot that is not positive makes the step NaN, which the cost test
//   rejects;
// - block-wide sums: element i into logical thread i mod 1024 in order from
//   +0, then the warp's shuffles (offsets 16 .. 1) and the 32 warp sums the
//   same way.
//
// Bound on the card: a latency-bound chain, far under the card's rates. An
// iteration at K = 10, L = 600 is ~4 MFLOP and ~2 MB of L2 traffic (a few
// microseconds at the peaks), but it is ~20 dependent phases and a
// 150-column Cholesky, times `iters`. The design:
// - one cluster of CLUSTER blocks of THREADS threads on neighbouring SMs, the
//   1024 logical threads of the sums (logical thread = rank x THREADS +
//   tid); at 256 threads a block a thread may hold 255 registers, so the
//   camera factors' dual numbers do not spill;
// - every block keeps the small state (the window's slots, the camera rows
//   and Jacobians, the gradient, the step) in its own shared memory; what
//   one thread computes for all is stored into every block's copy through
//   distributed shared memory, and what is cheap is computed by every block
//   alike (the same operations give the same bits);
// - the landmark sums as warp-uniform tasks: a warp owns the 36 (or 21 + 6)
//   outputs of one keyframe pair, so its lanes take every landmark's
//   observation test the same way; the tiles of landmark records arrive by
//   cp.async while the previous tile is summed;
// - the system's columns in panels of PB, panel q in the shared memory of
//   block q mod CLUSTER (K up to 21: the 316 x 315 system is 398 KB, more
//   than one SM holds). A panel is factored by its owner (its diagonal
//   block by one warp in registers, then one row a thread), which stores
//   the rows below the block into every block's buffer q mod PBUFS; every
//   block applies it to its own later columns, each element in registers,
//   a panel's PB columns in order; the owner of the next panel updates and
//   factors that panel first (one cluster barrier a panel); the back
//   substitution goes panel by panel backwards the same way;
// - the per-observation records in an L2-resident scratch that the wrapper
//   allocates, in 16-byte pieces, read across blocks past the L1 (ld.cg,
//   cp.async.cg); the prior's j also transposed there, so that a row's
//   lanes read side by side. A cluster barrier's acquire empties the L1,
//   so what is read after one comes from the L2: reads are laid out for
//   the lanes of a warp to share lines;
// - divisions by fdiv, whose zero dividends skip the division's slow path.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CLUSTER = 4;    // blocks of the cluster, on neighbouring SMs
constexpr int THREADS = 256;  // threads a block: at most 255 registers each
constexpr int LANES = CLUSTER * THREADS;   // logical threads: block_sum's lanes
constexpr int WARPS = THREADS / 32;
constexpr int GWARPS = LANES / 32;
constexpr int MAX_K = 21;     // keyframes: bench.py's window
constexpr int TL = 16;        // landmarks a tile of the landmark sums
constexpr int REC = 56;       // floats an observation's record: 16-byte pieces
// a keyframe's part of a tile, padded to 12 mod 32 words: the lanes of a
// landmark-sum warp read different keyframes' records at different banks
constexpr int KSTRIDE = TL * REC + 12;
constexpr int PB = 16;        // columns a panel of the Cholesky
constexpr int PS = 20;        // floats a panel's row (padded off the banks)
constexpr int PBUFS = 3;      // the panels in flight: q - 1 applied, q read, q + 1 arriving

// H_pl (6 x 3, two floats of padding), W (the same), J_p (2 x 6), r (2, and two)
constexpr int R_HPL = 0, R_W = 20, R_JP = 40, R_R = 52;
constexpr int LREC = 32;      // floats a landmark's record, in 16-byte pieces
constexpr int L_HLL = 0, L_HINV = 12, L_GL = 24, L_MASK = 27, L_OBS = 28;

#define F(x) (static_cast<float>(x))
constexpr float PI_F = F(3.141592653589793);
constexpr float TWO_PI_F = F(2.0 * 3.141592653589793);

// ---------------------------------------------------------------------------
// Dual numbers: a value and one tangent; a float operand is a constant
// ---------------------------------------------------------------------------

// a / b rounded as the operator rounds it. A zero dividend of a finite,
// non-zero divisor is answered by a * b (the same signed zero) and divides
// 1 instead: the division's fast path refers a zero dividend to its slow
// path (~280 cycles against ~75 on an H100; the camera factors' tangents
// and the reduced system are mostly zeros). No branch: a warp's lanes stay
// together
__device__ __forceinline__ float fdiv(float a, float b) {
  const bool z = a == 0.0f && b != 0.0f && fabsf(b) <= 3.4028234663852886e38f;
  const float q = (z ? 1.0f : a) / b;
  return z ? a * b : q;
}

struct Dual {
  float v, d;
  __device__ Dual() : v(0.0f), d(0.0f) {}
  __device__ Dual(float v_, float d_) : v(v_), d(d_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator+(Dual a, float c) { return Dual(a.v + c, a.d); }
__device__ __forceinline__ Dual operator+(float c, Dual a) { return Dual(c + a.v, a.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator-(Dual a, float c) { return Dual(a.v - c, a.d); }
__device__ __forceinline__ Dual operator-(float c, Dual a) { return Dual(c - a.v, -a.d); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator*(Dual a, float c) { return Dual(a.v * c, a.d * c); }
__device__ __forceinline__ Dual operator*(float c, Dual a) { return Dual(c * a.v, c * a.d); }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float v = fdiv(a.v, b.v);
  return Dual(v, fdiv(a.d - v * b.d, b.v));
}
__device__ __forceinline__ Dual operator/(Dual a, float c) { return Dual(fdiv(a.v, c), fdiv(a.d, c)); }
__device__ __forceinline__ Dual operator/(float c, Dual b) {
  const float v = fdiv(c, b.v);
  return Dual(v, fdiv(-(v * b.d), b.v));
}

// a / b for either kind of operand
__device__ __forceinline__ float div_(float a, float b) { return fdiv(a, b); }
__device__ __forceinline__ Dual div_(Dual a, Dual b) { return a / b; }
__device__ __forceinline__ Dual div_(Dual a, float b) { return a / b; }
__device__ __forceinline__ Dual div_(float a, Dual b) { return a / b; }

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual t_sqrt(Dual x) {
  const float s = sqrtf(x.v);
  return Dual(s, fdiv(x.d, s * 2.0f));
}
__device__ __forceinline__ float t_sin(float x) { return sinf(x); }
__device__ __forceinline__ Dual t_sin(Dual x) { return Dual(sinf(x.v), cosf(x.v) * x.d); }
__device__ __forceinline__ float t_cos(float x) { return cosf(x); }
__device__ __forceinline__ Dual t_cos(Dual x) { return Dual(cosf(x.v), -sinf(x.v) * x.d); }
__device__ __forceinline__ float t_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ Dual t_atan2(Dual y, Dual x) {
  const float den = x.v * x.v + y.v * y.v;
  return Dual(atan2f(y.v, x.v), fdiv(x.v * y.d - y.v * x.d, den));
}
// torch.clamp (NaN stays NaN); the tangent passes where lo <= x <= hi
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_hi(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ Dual clamp_lo(Dual x, float lo) {
  return Dual(clamp_lo(x.v, lo), x.v >= lo ? x.d : 0.0f);
}
__device__ __forceinline__ Dual clamp_lohi(Dual x, float lo, float hi) {
  return Dual(clamp_hi(clamp_lo(x.v, lo), hi), (x.v >= lo && x.v <= hi) ? x.d : 0.0f);
}
__device__ __forceinline__ float clamp_lohi(float x, float lo, float hi) {
  return clamp_hi(clamp_lo(x, lo), hi);
}
__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? 3.4028234663852886e38f : -3.4028234663852886e38f;
  return x;
}

// ---------------------------------------------------------------------------
// Rotations on components (ops/window_lm.py's _qmul, _qnormalize, ...)
// ---------------------------------------------------------------------------

template <class A, class B, class R>
__device__ __forceinline__ void qmul(const A* a, const B* b, R* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

template <class T>
__device__ __forceinline__ void qconj(const T* q, T* o) {
  o[0] = q[0];
  o[1] = -q[1];
  o[2] = -q[2];
  o[3] = -q[3];
}

template <class T>
__device__ __forceinline__ void qnormalize(T* q) {
  const T n = clamp_lo(t_sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), F(1e-12));
  for (int i = 0; i < 4; ++i) q[i] = div_(q[i], n);
  if (val(q[0]) < 0.0f)
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
}

template <class T>
__device__ __forceinline__ void qmat(const T* q, T* m) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  m[0] = 1.0f - 2.0f * (yy + zz);
  m[1] = 2.0f * (xy - wz);
  m[2] = 2.0f * (xz + wy);
  m[3] = 2.0f * (xy + wz);
  m[4] = 1.0f - 2.0f * (xx + zz);
  m[5] = 2.0f * (yz - wx);
  m[6] = 2.0f * (xz - wy);
  m[7] = 2.0f * (yz + wx);
  m[8] = 1.0f - 2.0f * (xx + yy);
}

template <class T>
__device__ __forceinline__ void so3_exp(const T* w, T* o) {
  const T theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const T theta = t_sqrt(clamp_lo(theta2, F(1e-24)));
  T sho, cw;
  if (val(theta2) < F(1e-10)) {
    sho = 0.5f - div_(theta2, 48.0f);
    cw = 1.0f - div_(theta2, 8.0f);
  } else {
    const T half = 0.5f * theta;
    sho = div_(t_sin(half), theta);
    cw = t_cos(half);
  }
  o[0] = cw;
  o[1] = sho * w[0];
  o[2] = sho * w[1];
  o[3] = sho * w[2];
}

template <class T>
__device__ __forceinline__ void so3_log(const T* qin, T* o) {
  T q[4] = {qin[0], qin[1], qin[2], qin[3]};
  if (val(q[0]) < 0.0f)
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  const T w = clamp_lohi(q[0], -1.0f, 1.0f);
  const T sq = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  T scale;
  if (val(sq) < F(1e-14)) {
    scale = div_(2.0f, clamp_lo(w, F(1e-12)));
  } else {
    const T sin_half = t_sqrt(sq);
    const T half = t_atan2(sin_half, w);
    scale = div_(2.0f * half, clamp_lo(sin_half, F(1e-24)));
  }
  o[0] = scale * q[1];
  o[1] = scale * q[2];
  o[2] = scale * q[3];
}

// m (float, row-major rows x 3 or 9) times x, from the first product
template <class T>
__device__ __forceinline__ T dot3(const float* m, const T* x) {
  return m[0] * x[0] + m[1] * x[1] + m[2] * x[2];
}
template <class T>
__device__ __forceinline__ T dot3t(const T* m, const T* x) {
  return m[0] * x[0] + m[1] * x[1] + m[2] * x[2];
}

// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// The solve's arguments and its shared memory
// ---------------------------------------------------------------------------

struct Args {
  const float *p, *q, *v, *bg, *ba, *lm;
  const uint8_t *kf_valid, *lm_valid;
  const float* obs;
  const uint8_t* vis;
  const float *pre_dp, *pre_dv, *pre_dq, *pre_dt, *jpbg, *jpba, *jvbg, *jvba, *jqbg, *sqrt_info,
      *pre_bg, *pre_ba;
  const uint8_t* pre_valid;
  const float *r_cb, *p_bc, *anchor_p, *anchor_yaw;
  const float *prior_j, *prior_r0, *prior_p, *prior_q, *prior_v, *prior_bg, *prior_ba;
  float *out_p, *out_q, *out_v, *out_bg, *out_ba, *out_lm, *out_cost;
  float* scratch;
  int k, l, n_prior, iters;
  float init_lambda, anchor_weight, pix_weight, huber_delta, bias_weight, ba_prior_weight,
      bg_prior_weight;
};

// a keyframe's state in shared memory: p 0-2, q 3-6, v 7-9, bg 10-12, ba 13-15
constexpr int SLOT = 16;
constexpr int S_P = 0, S_Q = 3, S_V = 7, S_BG = 10, S_BA = 13;

struct Layout {
  // shared memory, offsets in floats; the landmark tiles and the panels
  // share one region (the sums end before the system is assembled)
  int tile0, tile1, tglm0, tglm1, own, pbuf, jimu, rc, rc2, cld, cldc, dmat, jy, u, g, d, dc, x, y, diag,
      cur, nxt, rot, red, misc, cnt, list, total;
  // global scratch, offsets in floats
  int g_a, g_hcc, g_rec, g_lrec, g_lm, g_slow, g_hpp, g_gp, g_corr, g_jt, g_total;
};

__host__ __device__ inline int n_rows_np(int k) { return 15 * (k - 1) + 4 + 6 * k; }

__host__ __device__ inline int n_panels(int k) { return (15 * k + PB - 1) / PB; }

// rows of the panels that block `rank` holds (panel q: rows q PB .. 15K)
__host__ __device__ inline int panel_rows(int k, int rank) {
  const int n = 15 * k;
  int rows = 0;
  for (int q = rank; q < n_panels(k); q += CLUSTER) rows += n + 1 - q * PB;
  return rows;
}

// where panel q begins in its owner's panel storage, in floats
__host__ __device__ inline int panel_base(int k, int q) {
  const int n = 15 * k;
  int o = 0;
  for (int q2 = q % CLUSTER; q2 < q; q2 += CLUSTER) o += (n + 1 - q2 * PB) * PS;
  return o;
}

__host__ __device__ inline Layout layout(int k, int l, int n_prior) {
  Layout s;
  const int n = 15 * k, pose = 6 * k, low = pose * (pose + 1) / 2, rows = n_rows_np(k) + n_prior;
  int own_rows = 0;
  for (int r = 0; r < CLUSTER; ++r) own_rows = own_rows > panel_rows(k, r) ? own_rows : panel_rows(k, r);
  int o = 0;
  s.tile0 = o;
  s.tile1 = o + k * KSTRIDE;
  s.tglm0 = o + 2 * k * KSTRIDE;
  s.tglm1 = s.tglm0 + 4 * TL;
  const int tiles = 2 * k * KSTRIDE + 8 * TL;
  s.own = o;
  s.pbuf = o + own_rows * PS;   // PBUFS copies of a panel's rows below its block
  const int panels = (own_rows + PBUFS * (n + 1 - PB > 0 ? n + 1 - PB : 0)) * PS;
  o += tiles > panels ? tiles : panels;
  o = (o + 3) & ~3;
  s.jimu = o; o += (k - 1) * 15 * 30;
  s.rc = o; o += rows;
  s.rc2 = o; o += rows;
  s.cld = o; o += n;
  s.cldc = o; o += n;
  s.dmat = o; o += 9 * k;
  s.jy = o; o += 4;
  s.u = o; o += n;
  s.g = o; o += n;
  s.d = o; o += n;
  s.dc = o; o += n;
  s.x = o; o += n;
  s.y = o; o += n;
  s.diag = o; o += n;
  s.cur = o; o += SLOT * k;
  s.nxt = o; o += SLOT * k;
  s.rot = o; o += 9 * k;
  s.red = o; o += 2 * 7 * 32;   // two buffers, taken in turns
  s.misc = o; o += 16;
  s.cnt = o; o += WARPS;
  s.list = o; o += l;         // the observed landmarks, in index order (ints)
  s.total = o;
  int g = 0;
  s.g_a = g; g += n * n;
  s.g_hcc = g; g += n * n;
  g = (g + 3) & ~3;           // 16-byte copies of the records
  s.g_rec = g; g += k * l * REC;
  s.g_lrec = g; g += l * LREC;
  s.g_lm = g; g += l * 3;
  s.g_slow = g; g += low;
  s.g_hpp = g; g += low;
  s.g_gp = g; g += pose;
  s.g_corr = g; g += pose;
  s.g_jt = g; g += n * n_prior;     // the prior's j transposed: a row's lanes side by side
  s.g_total = g;
  return s;
}

// misc slots
constexpr int M_LAM = 0, M_COST = 1, M_COST_NEW = 2, M_PRED = 3, M_ACCEPT = 4, M_FAIL = 5;

// ---------------------------------------------------------------------------
// The camera-only factors
// ---------------------------------------------------------------------------

// `imu.imu_residual`'s 15 rows of interval f for slots x_i, x_j (p, q, v,
// bg, ba each), constants from the preintegration
template <class T>
__device__ __forceinline__ void imu_rows(const Args& a, int f, const T* pi, const T* qi, const T* vi,
                         const T* bgi, const T* bai, const T* pj, const T* qj, const T* vj,
                         const T* bgj, const T* baj, T* out) {
  const float dt = a.pre_dt[f];
  T dbg[3], dba[3];
  for (int i = 0; i < 3; ++i) {
    dbg[i] = bgi[i] - a.pre_bg[3 * f + i];
    dba[i] = bai[i] - a.pre_ba[3 * f + i];
  }
  T qic[4], riw[9];
  qconj(qi, qic);
  qmat(qic, riw);
  const float* jpbg = a.jpbg + 9 * f;
  const float* jpba = a.jpba + 9 * f;
  const float* jvbg = a.jvbg + 9 * f;
  const float* jvba = a.jvba + 9 * f;
  const float* jqbg = a.jqbg + 9 * f;
  T dp_corr[3], dv_corr[3], eq_in[3];
  for (int i = 0; i < 3; ++i) {
    dp_corr[i] = a.pre_dp[3 * f + i] + dot3(jpbg + 3 * i, dbg) + dot3(jpba + 3 * i, dba);
    dv_corr[i] = a.pre_dv[3 * f + i] + dot3(jvbg + 3 * i, dbg) + dot3(jvba + 3 * i, dba);
    eq_in[i] = dot3(jqbg + 3 * i, dbg);
  }
  T eq[4], dq_corr[4];
  so3_exp(eq_in, eq);
  qmul(a.pre_dq + 4 * f, eq, dq_corr);
  const float grav[3] = {0.0f, 0.0f, F(-9.81)};
  T av[3], bv[3];
  for (int i = 0; i < 3; ++i) {
    const float hg = grav[i] * 0.5f;
    av[i] = pj[i] - pi[i] - vi[i] * dt - hg * dt * dt;
    bv[i] = vj[i] - vi[i] - grav[i] * dt;
  }
  T e[9];
  for (int i = 0; i < 3; ++i) {
    e[i] = dot3t(riw + 3 * i, av) - dp_corr[i];
    e[6 + i] = dot3t(riw + 3 * i, bv) - dv_corr[i];
  }
  T dqc[4], t1[4], t2[4];
  qconj(dq_corr, dqc);
  qmul(qic, qj, t1);
  qmul(dqc, t1, t2);
  so3_log(t2, e + 3);
  const float* si = a.sqrt_info + 81 * f;
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    T s = si[9 * r] * e[0];
#pragma unroll
    for (int c = 1; c < 9; ++c) s = s + si[9 * r + c] * e[c];
    out[r] = s;
  }
  const float wb = a.bias_weight;
  for (int i = 0; i < 3; ++i) {
    out[9 + i] = (bgj[i] - bgi[i]) * wb;
    out[12 + i] = (baj[i] - bai[i]) * wb;
  }
}

template <class T>
__device__ __forceinline__ T yaw_err(const T* q, float anchor_yaw) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T d_yaw = t_atan2(2.0f * (x * y + w * z), 1.0f - 2.0f * (y * y + z * z)) - anchor_yaw;
  const float wrap = floorf(fdiv(val(d_yaw) + PI_F, TWO_PI_F));
  return d_yaw - TWO_PI_F * wrap;
}

// slot s of a shared state, each component a Dual of value x + 0 whose
// tangent is 1 where its camera-block column (p 0-2, θ 3-5, v 6-8, bg 9-11,
// ba 12-14, offset by `base`) is `col`: the state retracted at dc = 0
__device__ __forceinline__ void seeded_slot(const float* st, int base, int col, Dual* p, Dual* q, Dual* v,
                            Dual* bg, Dual* ba) {
  Dual th[3];
  for (int i = 0; i < 3; ++i) {
    p[i] = st[S_P + i] + Dual(0.0f, col == base + i ? 1.0f : 0.0f);
    th[i] = Dual(0.0f, col == base + 3 + i ? 1.0f : 0.0f);
    v[i] = st[S_V + i] + Dual(0.0f, col == base + 6 + i ? 1.0f : 0.0f);
    bg[i] = st[S_BG + i] + Dual(0.0f, col == base + 9 + i ? 1.0f : 0.0f);
    ba[i] = st[S_BA + i] + Dual(0.0f, col == base + 12 + i ? 1.0f : 0.0f);
  }
  Dual e[4];
  so3_exp(th, e);
  qmul(st + S_Q, e, q);
  qnormalize(q);
}

// the rotation of slot s at q ⊗ Exp(seed), a Dual of seed column c in 0..2
__device__ __forceinline__ void seeded_rotation(const float* q0, int c, Dual* q) {
  Dual th[3];
  for (int i = 0; i < 3; ++i) th[i] = Dual(0.0f, c == i ? 1.0f : 0.0f);
  Dual e[4];
  so3_exp(th, e);
  qmul(q0, e, q);
  qnormalize(q);
}
// ---------------------------------------------------------------------------
// The cluster: ranks, distributed shared memory, barriers, copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the generic address, in block `rank`'s shared memory, of what `p` is in
// this block's
template <class T>
__device__ __forceinline__ T* remote(T* p, unsigned rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// a cluster barrier in two halves: the arrival releases this thread's
// writes (shared, distributed shared and global memory), the wait acquires
// every thread's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// 16 bytes from global memory (through the L2: other SMs wrote them) into
// shared memory, asynchronously
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v stored at `off` of every block's shared memory (rsm: their bases)
__device__ __forceinline__ void put_all(float* const* rsm, int off, float v) {
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) rsm[r][off] = v;
}

// ---------------------------------------------------------------------------
// Sums over the cluster's logical threads
// ---------------------------------------------------------------------------

// the sums over the 1024 logical threads of each thread's partials v[0..NQ)
// (which it added in its element order from +0): each warp's shuffles, the
// warp's sum stored into every block's `red` at its logical warp rank x
// WARPS + warp, then warp 0 of every block adds the 32 warp sums in the same
// tree. The results land in red[q * 32] of every block, alike; every thread
// calls it, and reads the results before its next cluster barrier (`red`
// alternates between two buffers, so the next call cannot overwrite them)
template <int NQ>
__device__ __forceinline__ void cluster_sums(float* v, float* red, unsigned rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = 0; q < NQ; ++q) {
    float x = v[q];
    for (int off = 16; off; off >>= 1) x = x + __shfl_down_sync(CVIDS_FULL_MASK, x, off);
    v[q] = x;
  }
  if (lane == 0) {
    const int gw = static_cast<int>(rank) * WARPS + warp;
    for (unsigned r = 0; r < CLUSTER; ++r) {
      float* dst = remote(red, r);
      for (int q = 0; q < NQ; ++q) dst[q * 32 + gw] = v[q];
    }
  }
  cluster_sync();
  if (warp == 0) {
    for (int q = 0; q < NQ; ++q) {
      float x = red[q * 32 + lane];
      for (int off = 16; off; off >>= 1) x = x + __shfl_down_sync(CVIDS_FULL_MASK, x, off);
      if (lane == 0) red[q * 32] = x;
    }
  }
  __syncthreads();
}

// clock64 a phase, for dev/torch_probe_window_lm_phases.py (thread 0 of
// block 0; nothing without -DCVIDS_WLM_CLOCKS)
#ifdef CVIDS_WLM_CLOCKS
__device__ unsigned long long cvids_wlm_clocks[32];
__shared__ long long cvids_wlm_t;
#define WLM_CLOCK_START                                                 \
  do {                                                                  \
    if (threadIdx.x == 0) cvids_wlm_t = clock64();                      \
  } while (0)
#define WLM_CLOCK(ph)                                                   \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                          \
      const long long t_ = clock64();                                   \
      cvids_wlm_clocks[ph] += static_cast<unsigned long long>(t_ - cvids_wlm_t); \
      cvids_wlm_t = t_;                                                 \
    }                                                                   \
  } while (0)
#else
#define WLM_CLOCK_START \
  do {                  \
  } while (0)
#define WLM_CLOCK(ph) \
  do {                \
  } while (0)
#endif
// the phases the clocks add to
// (dev/torch_probe_window_lm_phases.py names them in this order)
enum { C_INIT, C_BLOCKS, C_PRIOR, C_LIST, C_SUMS, C_SYSTEM, C_CHOL, C_BACK, C_STEP, C_COST,
       C_ACCEPT, C_SUMS_ADD, C_CHOL_WAIT, C_CHOL_DIAG, C_CHOL_NEXT, C_CHOL_FACTOR, C_CHOL_REST,
       C_BACK_SOLVE, C_BACK_SYNC, C_BACK_UPDATE, C_BLOCKS_OWN, C_STEP_HD, C_STEP_LM, C_SYS_OWN,
       C_DUAL_SEED, C_DUAL_IMU, C_DUAL_PUT, C_N };
// the cycles of the first IMU column's item, in its own thread
#ifdef CVIDS_WLM_CLOCKS
#define WLM_ITEM_T long long wlm_i_ = clock64()
#define WLM_ITEM(ph)                                                                       \
  do {                                                                                     \
    const long long t_ = clock64();                                                        \
    if (item == l) cvids_wlm_clocks[ph] += static_cast<unsigned long long>(t_ - wlm_i_); \
    wlm_i_ = t_;                                                                           \
  } while (0)
#else
#define WLM_ITEM_T \
  do {             \
  } while (0)
#define WLM_ITEM(ph) \
  do {               \
  } while (0)
#endif

// ---------------------------------------------------------------------------
// Reprojection of one observation
// ---------------------------------------------------------------------------

struct Obs {
  bool valid;
  float r[2], ro[2], jp[2][6], jl[2][3];
};

// `reprojection_jacobians` of keyframe kk (rotation rk, state sk) and
// landmark point x; with `blocks`, the Jacobians too
template <bool BLOCKS>
__device__ __forceinline__ void observe(const Args& a, const float* rk, const float* sk, const float* x,
                        bool lm_ok, int kk, int li, Obs& o) {
  float d[3], pb[3], e[3], pc[3];
  for (int i = 0; i < 3; ++i) d[i] = x[i] - sk[S_P + i];
  for (int i = 0; i < 3; ++i) pb[i] = rk[i] * d[0] + rk[3 + i] * d[1] + rk[6 + i] * d[2];
  for (int i = 0; i < 3; ++i) e[i] = pb[i] - a.p_bc[i];
  for (int i = 0; i < 3; ++i) pc[i] = a.r_cb[3 * i] * e[0] + a.r_cb[3 * i + 1] * e[1] +
                                      a.r_cb[3 * i + 2] * e[2];
  const float px = pc[0], py = pc[1], z = pc[2];
  const float zs = fabsf(z) > F(1e-6) ? z : F(1e-6);
  const size_t ol = static_cast<size_t>(kk) * a.l + li;
  o.valid = a.vis[ol] && z > F(0.05) && a.kf_valid[kk] && lm_ok;
  if (!o.valid) return;
  const float pixw = a.pix_weight, delta = a.huber_delta;
  o.r[0] = (fdiv(px, zs) - nan_to_num(a.obs[2 * ol])) * pixw;
  o.r[1] = (fdiv(py, zs) - nan_to_num(a.obs[2 * ol + 1])) * pixw;
  const float rn = sqrtf(o.r[0] * o.r[0] + o.r[1] * o.r[1]);
  const float s = sqrtf(clamp_hi(fdiv(delta, clamp_lo(rn, F(1e-9))), 1.0f));
  o.ro[0] = o.r[0] * s;
  o.ro[1] = o.r[1] * s;
  if (!BLOCKS) return;
  const float inv_z = fdiv(1.0f, zs);
  const float dp[2][3] = {{inv_z, 0.0f, -px * inv_z * inv_z}, {0.0f, inv_z, -py * inv_z * inv_z}};
  const bool big = rn > delta;
  const float den = clamp_lo(rn * rn, F(1e-18));
  float hub[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      hub[i][j] = s * ((i == j ? 1.0f : 0.0f) - (big ? 0.5f * fdiv(o.r[i] * o.r[j], den) : 0.0f));
  const float hat[3][3] = {{0.0f, -pb[2], pb[1]}, {pb[2], 0.0f, -pb[0]}, {-pb[1], pb[0], 0.0f}};
  for (int i = 0; i < 2; ++i) {
    float m1[3], jb[3];
    for (int c = 0; c < 3; ++c) m1[c] = hub[i][0] * dp[0][c] + hub[i][1] * dp[1][c];
    for (int c = 0; c < 3; ++c)
      jb[c] = pixw * (m1[0] * a.r_cb[c] + m1[1] * a.r_cb[3 + c] + m1[2] * a.r_cb[6 + c]);
    for (int c = 0; c < 3; ++c) {
      o.jl[i][c] = jb[0] * rk[3 * c] + jb[1] * rk[3 * c + 1] + jb[2] * rk[3 * c + 2];
      o.jp[i][c] = -o.jl[i][c];
      o.jp[i][3 + c] = jb[0] * hat[0][c] + jb[1] * hat[1][c] + jb[2] * hat[2][c];
    }
  }
}

// camera index (0 .. 6K-1) of a pose column -> keyframe and comp (dp 0-2, dθ 3-5)
__device__ __forceinline__ void pose_of(int i, int k, int& kk, int& a) {
  if (i < 3 * k) {
    kk = i / 3;
    a = i % 3;
  } else {
    kk = (i - 3 * k) / 3;
    a = 3 + (i - 3 * k) % 3;
  }
}

__device__ __forceinline__ void lower_pair(int t, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  j = t - i * (i + 1) / 2;
}

// ---------------------------------------------------------------------------
// The cost of a state (cur or nxt in shared memory, landmarks at `lm`)
// ---------------------------------------------------------------------------

// the camera rows at state st, every block alike: IMU (threads 0 .. K-2),
// anchors (K-1), bias (K .. 2K-1), the prior's cld (2K .. 3K-1); and st's
// rotations (threads 0 .. K-1). Read after a __syncthreads
__device__ __forceinline__ void cost_rows(const Args& a, const Layout& L, float* sm,
                                          const float* st) {
  const int k = a.k, tid = threadIdx.x, f_n = k - 1;
  float* rc2 = sm + L.rc2;
  float* cld = sm + L.cldc;
  if (tid < k) qmat(st + SLOT * tid + S_Q, sm + L.rot + 9 * tid);
  if (tid < f_n) {
    const float* si = st + SLOT * tid;
    const float* sj = si + SLOT;
    float out[15];
    imu_rows<float>(a, tid, si + S_P, si + S_Q, si + S_V, si + S_BG, si + S_BA, sj + S_P,
                    sj + S_Q, sj + S_V, sj + S_BG, sj + S_BA, out);
    const bool ok = a.pre_valid[tid] && a.kf_valid[tid] && a.kf_valid[tid + 1];
    for (int r = 0; r < 15; ++r) rc2[15 * tid + r] = ok ? out[r] : 0.0f;
  } else if (tid == f_n) {
    const int o = 15 * f_n;
    for (int i = 0; i < 3; ++i) rc2[o + i] = (st[S_P + i] - a.anchor_p[i]) * a.anchor_weight;
    rc2[o + 3] = yaw_err<float>(st + S_Q, a.anchor_yaw[0]) * a.anchor_weight;
  } else if (tid >= k && tid < 2 * k) {
    const int kk = tid - k, o = 15 * f_n + 4;
    const float m = a.kf_valid[kk] ? 1.0f : 0.0f;
    for (int i = 0; i < 3; ++i) {
      rc2[o + 3 * kk + i] = (st[SLOT * kk + S_BA + i] * m) * a.ba_prior_weight;
      rc2[o + 3 * k + 3 * kk + i] = (st[SLOT * kk + S_BG + i] * m) * a.bg_prior_weight;
    }
  } else if (a.n_prior && tid >= 2 * k && tid < 3 * k) {
    const int kk = tid - 2 * k;
    const float* s = st + SLOT * kk;
    float pq[4], t[4], rel[3];
    qconj(a.prior_q + 4 * kk, pq);
    qmul(pq, s + S_Q, t);
    so3_log(t, rel);
    for (int i = 0; i < 3; ++i) {
      cld[3 * kk + i] = s[S_P + i] - a.prior_p[3 * kk + i];
      cld[3 * k + 3 * kk + i] = rel[i];
      cld[6 * k + 3 * kk + i] = s[S_V + i] - a.prior_v[3 * kk + i];
      cld[9 * k + 3 * kk + i] = s[S_BG + i] - a.prior_bg[3 * kk + i];
      cld[12 * k + 3 * kk + i] = s[S_BA + i] - a.prior_ba[3 * kk + i];
    }
  }
}

// landmark li's reprojection terms at state st (its rotations in rot)
__device__ __forceinline__ float cost_landmark(const Args& a, const float* rot, const float* st,
                                               const float* lm, int li) {
  const float x[3] = {lm[3 * li], lm[3 * li + 1], lm[3 * li + 2]};
  const bool lm_ok = a.lm_valid[li];
  float e = 0.0f;
  for (int kk = 0; kk < a.k; ++kk) {
    Obs o;
    observe<false>(a, rot + 9 * kk, st + SLOT * kk, x, lm_ok, kk, li, o);
    if (o.valid) e = e + (o.ro[0] * o.ro[0] + o.ro[1] * o.ro[1]);
  }
  return e;
}

// the camera residuals' square terms of logical thread gt's rows (after
// cost_rows): a row of its own, or a prior row from j and cld
__device__ __forceinline__ float cost_cam(const Args& a, const Layout& L, const float* sm, int gt) {
  const int n = 15 * a.k, np = n_rows_np(a.k);
  float acc = 0.0f;
  for (int r = gt; r < np + a.n_prior; r += LANES) {
    float v;
    if (r < np) {
      v = sm[L.rc2 + r];
    } else {
      const int p = r - np;
      const float* jt = a.scratch + L.g_jt + p;   // j[p][c] at jt[c n_prior]
      const float* cld = sm + L.cldc;
      float s = __ldcg(jt) * cld[0];
      for (int c = 1; c < n; ++c) s = s + __ldcg(jt + static_cast<size_t>(c) * a.n_prior) * cld[c];
      v = s + a.prior_r0[p];
    }
    acc = acc + v * v;
  }
  return acc;
}

// the cost of a state (cur in shared memory, landmarks at `lm`): every
// thread calls it; `rb` picks the red buffer
__device__ __forceinline__ float state_cost(const Args& a, const Layout& L, float* sm,
                                            const float* st, const float* lm, unsigned rank,
                                            int& rb) {
  const int gt = static_cast<int>(rank) * THREADS + threadIdx.x;
  cost_rows(a, L, sm, st);
  __syncthreads();
  float acc_proj = 0.0f;
  for (int li = gt; li < a.l; li += LANES)
    acc_proj = acc_proj + cost_landmark(a, sm + L.rot, st, lm, li);
  float v[2] = {cost_cam(a, L, sm, gt), acc_proj};
  float* red = sm + L.red + 7 * 32 * rb;
  rb ^= 1;
  cluster_sums<2>(v, red, rank);
  return 0.5f * red[0] + 0.5f * red[32];
}

// ---------------------------------------------------------------------------
// The reduced camera system
// ---------------------------------------------------------------------------

// entry (i, j), j <= i < 15K, t = i (i + 1) / 2 + j: h_cc's into *hcc, and
// returned damped on the diagonal and less the Schur term
__device__ __forceinline__ float sys_entry(const Args& a, const Layout& L, const float* sm,
                                           const float* g_a, const float* slow,
                                           const float* hpp, int i, int j, int t, float lam,
                                           float* hcc) {
  const int k = a.k, n = 15 * k, f_n = k - 1, pose = 6 * k;
  const float* jimu = sm + L.jimu;
  const float* dm = sm + L.dmat;
  const float* jy = sm + L.jy;
  const float aw = a.anchor_weight;
  const int bi = i / (3 * k), si = (i % (3 * k)) / 3, ci = i % 3;
  const int bj = j / (3 * k), sj = (j % (3 * k)) / 3, cj = j % 3;
  float h = 0.0f;
  if (a.n_prior) {
    float pr;
    if (bi != 1 && bj != 1) {
      pr = g_a[i * n + j];
    } else if (bi == 1 && bj != 1) {
      const int r0 = 3 * k + 3 * si;
      const float* d = dm + 9 * si;
      pr = d[ci] * g_a[r0 * n + j] + d[3 + ci] * g_a[(r0 + 1) * n + j] +
           d[6 + ci] * g_a[(r0 + 2) * n + j];
    } else if (bi != 1) {
      const int c0 = 3 * k + 3 * sj;
      const float* d = dm + 9 * sj;
      pr = g_a[i * n + c0] * d[cj] + g_a[i * n + c0 + 1] * d[3 + cj] +
           g_a[i * n + c0 + 2] * d[6 + cj];
    } else {
      const int r0 = 3 * k + 3 * si, c0 = 3 * k + 3 * sj;
      const float* di = dm + 9 * si;
      const float* dj = dm + 9 * sj;
      float ad[3];
      for (int r = 0; r < 3; ++r)
        ad[r] = g_a[(r0 + r) * n + c0] * dj[cj] +
                g_a[(r0 + r) * n + c0 + 1] * dj[3 + cj] +
                g_a[(r0 + r) * n + c0 + 2] * dj[6 + cj];
      pr = di[ci] * ad[0] + di[3 + ci] * ad[1] + di[6 + ci] * ad[2];
    }
    h = h + pr;
  }
  const int lo = max(max(si, sj) - 1, 0), hi = min(min(si, sj), f_n - 1);
  for (int f = lo; f <= hi; ++f) {
    if (!(a.pre_valid[f] && a.kf_valid[f] && a.kf_valid[f + 1])) continue;
    const float* jf = jimu + f * 450;
    const int li = (si - f) * 15 + 3 * bi + ci, lj = (sj - f) * 15 + 3 * bj + cj;
    for (int r = 0; r < 15; ++r) h = h + jf[30 * r + li] * jf[30 * r + lj];
  }
  if (i == j && bi == 0 && si == 0) h = h + aw * aw;
  if (bi == 1 && si == 0 && bj == 1 && sj == 0) h = h + jy[ci] * jy[cj];
  if (i == j && (bi == 4 || bi == 3)) {
    const float jb = (a.kf_valid[si] ? 1.0f : 0.0f) *
                     (bi == 4 ? a.ba_prior_weight : a.bg_prior_weight);
    h = h + jb * jb;
  }
  const bool both_pose = i < pose && j < pose;
  if (both_pose) {
    int pki, pai, pkj, paj;
    pose_of(i, k, pki, pai);
    pose_of(j, k, pkj, paj);
    if (pki == pkj) h = h + __ldcg(hpp + t);
  }
  *hcc = h;
  if (i == j) h = h + lam * (h + F(1e-6));
  if (both_pose) h = h - __ldcg(slow + t);
  return h;
}

// the gradient g_c's entry i
__device__ __forceinline__ float grad_entry(const Args& a, const Layout& L, const float* sm,
                                            const float* gp, int i) {
  const int k = a.k, f_n = k - 1, pose = 6 * k;
  const float* jimu = sm + L.jimu;
  const float* rc = sm + L.rc;
  const float* dm = sm + L.dmat;
  const float* jy = sm + L.jy;
  const float aw = a.anchor_weight;
  const int bi = i / (3 * k), si = (i % (3 * k)) / 3, ci = i % 3;
  float g = 0.0f;
  if (a.n_prior) {
    const float* u = sm + L.u;
    if (bi == 1) {
      const int r0 = 3 * k + 3 * si;
      const float* d = dm + 9 * si;
      g = g + (d[ci] * u[r0] + d[3 + ci] * u[r0 + 1] + d[6 + ci] * u[r0 + 2]);
    } else {
      g = g + u[i];
    }
  }
  for (int f = max(si - 1, 0); f <= min(si, f_n - 1); ++f) {
    if (!(a.pre_valid[f] && a.kf_valid[f] && a.kf_valid[f + 1])) continue;
    const float* jf = jimu + f * 450;
    const int li = (si - f) * 15 + 3 * bi + ci;
    for (int r = 0; r < 15; ++r) g = g + jf[30 * r + li] * rc[15 * f + r];
  }
  const int oa = 15 * f_n, ob = oa + 4;
  if (bi == 0 && si == 0) g = g + aw * rc[oa + ci];
  if (bi == 1 && si == 0) g = g + jy[ci] * rc[oa + 3];
  if (bi == 4 || bi == 3) {
    const float jb = (a.kf_valid[si] ? 1.0f : 0.0f) *
                     (bi == 4 ? a.ba_prior_weight : a.bg_prior_weight);
    g = g + jb * rc[ob + (bi == 4 ? 0 : 3 * k) + 3 * si + ci];
  }
  if (i < pose) g = g + __ldcg(gp + i);
  return g;
}

// ---------------------------------------------------------------------------
// The Cholesky factor over the cluster, a panel of PB columns at a time
// ---------------------------------------------------------------------------

// panel q, in this block (its owner): its diagonal block by warp 0 in
// registers (a column's pivot, its division, the block's later columns
// updated), then the rows below, one a thread (a row's entry c less its
// products with the panel's columns 0 .. c-1 in order, then divided by
// L_cc): element by element the operations of the right-looking factor. A
// pivot that is not positive sets every block's fail flag
__device__ __forceinline__ void factor_panel(const Layout& L, float* sm, float* const* rsm, int k,
                                             int q) {
  const int n = 15 * k, j0 = q * PB, bq = min(PB, n - j0), tid = threadIdx.x, lane = tid & 31;
  // the rows below the block also go to every block's buffer q % PBUFS
  // (none after the last panel)
  const bool push = j0 + PB < n;
  const int pb = L.pbuf + (q % PBUFS) * (n + 1 - PB) * PS;
  float* blk = sm + L.own + panel_base(k, q);
  float* diag = sm + L.diag + j0;
  if (tid < 32) {
    float ar[PB];
#pragma unroll
    for (int c = 0; c < PB; ++c) ar[c] = (lane < bq && c <= lane) ? blk[lane * PS + c] : 0.0f;
    bool bad = false;
#pragma unroll
    for (int c = 0; c < PB; ++c) {
      if (c < bq) {
        const float ajj = __shfl_sync(CVIDS_FULL_MASK, ar[c], c);
        const float ljj = sqrtf(ajj);
        bad = bad || !(ajj > 0.0f);
        if (lane == c) diag[c] = ljj;
        if (lane > c && lane < bq) ar[c] = fdiv(ar[c], ljj);
#pragma unroll
        for (int c2 = c + 1; c2 < PB; ++c2) {
          const float lc = __shfl_sync(CVIDS_FULL_MASK, ar[c], c2);
          if (lane >= c2) ar[c2] = ar[c2] - ar[c] * lc;
        }
      }
    }
    if (lane < bq) {
#pragma unroll
      for (int c = 0; c < PB; ++c)
        if (c < lane) blk[lane * PS + c] = ar[c];
    }
    if (lane == 0 && bad) put_all(rsm, L.misc + M_FAIL, 1.0f);
  }
  __syncthreads();
  WLM_CLOCK(C_CHOL_DIAG);
  for (int i = j0 + bq + tid; i <= n; i += THREADS) {
    float* row = blk + (i - j0) * PS;
    float x[PB];
#pragma unroll
    for (int c4 = 0; c4 < PB / 4; ++c4) {
      const float4 v = reinterpret_cast<const float4*>(row)[c4];
      x[4 * c4] = v.x;
      x[4 * c4 + 1] = v.y;
      x[4 * c4 + 2] = v.z;
      x[4 * c4 + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < PB; ++c) {
      if (c < bq) {
        float v = x[c];
#pragma unroll
        for (int c0 = 0; c0 < c; ++c0) v = v - x[c0] * blk[c * PS + c0];
        x[c] = fdiv(v, diag[c]);
      }
    }
#pragma unroll
    for (int c4 = 0; c4 < PB / 4; ++c4) {
      const float4 v = make_float4(x[4 * c4], x[4 * c4 + 1], x[4 * c4 + 2], x[4 * c4 + 3]);
      reinterpret_cast<float4*>(row)[c4] = v;
      if (push)
#pragma unroll
        for (int r = 0; r < CLUSTER; ++r)
          reinterpret_cast<float4*>(rsm[r] + pb + (i - j0 - PB) * PS)[c4] = v;
    }
  }
}

// panel q (its rows below its block, in buffer q % PBUFS) applied to this
// block's panels q2, lo <= q2 < hi (q2 > q): a tile of 4 x 4 entries a
// thread in registers, each entry less its products with the panel's PB
// columns in order
__device__ __forceinline__ void apply_panel(const Layout& L, float* sm, int k, int q, int lo,
                                            int hi, unsigned rank) {
  const int n = 15 * k, j1 = (q + 1) * PB, tid = threadIdx.x;
  const float* buf = sm + L.pbuf + (q % PBUFS) * (n + 1 - PB) * PS;
  int done = 0;  // a panel's tiles go on from the thread after the last one's
  for (int q2 = lo + (static_cast<int>(rank) - lo % CLUSTER + CLUSTER) % CLUSTER; q2 < hi;
       q2 += CLUSTER) {
    const int c0 = q2 * PB, bq2 = min(PB, n - c0), items = (n + 1 - c0 + 3) / 4 * 4;
    float* blk = sm + L.own + panel_base(k, q2);
    for (int e = ((tid - done) % THREADS + THREADS) % THREADS; e < items; e += THREADS) {
      const int rq = e >> 2, cq = e & 3;
      if (cq > rq || 4 * cq >= bq2) continue;
      const int i0 = c0 + 4 * rq, k0 = c0 + 4 * cq;
      float acc[4][4];
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const float4 v = i0 + ri <= n
                             ? reinterpret_cast<const float4*>(blk + (i0 + ri - c0) * PS)[cq]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[ri][0] = v.x;
        acc[ri][1] = v.y;
        acc[ri][2] = v.z;
        acc[ri][3] = v.w;
      }
#pragma unroll
      for (int ch = 0; ch < PB / 4; ++ch) {
        float li[4][4], lk[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 a4 = i0 + r <= n
                                ? reinterpret_cast<const float4*>(buf + (i0 + r - j1) * PS)[ch]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 b4 = k0 + r <= n
                                ? reinterpret_cast<const float4*>(buf + (k0 + r - j1) * PS)[ch]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          li[r][0] = a4.x;
          li[r][1] = a4.y;
          li[r][2] = a4.z;
          li[r][3] = a4.w;
          lk[r][0] = b4.x;
          lk[r][1] = b4.y;
          lk[r][2] = b4.z;
          lk[r][3] = b4.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int ri = 0; ri < 4; ++ri)
#pragma unroll
            for (int ci = 0; ci < 4; ++ci) acc[ri][ci] = acc[ri][ci] - li[ri][c] * lk[ci][c];
      }
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int i = i0 + ri;
        if (i > n) continue;
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) {
          const int kc = k0 + ci;
          if (kc <= i && kc < c0 + bq2) blk[(i - c0) * PS + 4 * cq + ci] = acc[ri][ci];
        }
      }
    }
    done += items;
  }
}

// ---------------------------------------------------------------------------
// The landmark sums' units: a keyframe pair ka >= kb and its outputs
// ---------------------------------------------------------------------------

// pose index (the camera layout) of keyframe kk's component a: dp 0-2, dθ 3-5
__device__ __forceinline__ int pose_idx(int kk, int a, int k) {
  return a < 3 ? 3 * kk + a : 3 * k + 3 * kk + a - 3;
}

// combination c of an off-diagonal pair (component c / 6 of ka, c % 6 of kb)
// as the lower task it is: (ki, ai) the larger pose index, (kj, aj) the
// smaller, t its index in the lower triangle
__device__ __forceinline__ void pair_task(int ka, int kb, int c, int k, int& ki, int& ai, int& kj,
                                          int& aj, int& t) {
  const int a = c / 6, b = c % 6, pa = pose_idx(ka, a, k), pb = pose_idx(kb, b, k);
  if (pa > pb) {
    ki = ka, ai = a, kj = kb, aj = b, t = pa * (pa + 1) / 2 + pb;
  } else {
    ki = kb, ai = b, kj = ka, aj = a, t = pb * (pb + 1) / 2 + pa;
  }
}

// ---------------------------------------------------------------------------
// The kernel: one cluster of CLUSTER blocks
// ---------------------------------------------------------------------------

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    window_lm_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  WLM_CLOCK_START;
  const unsigned rank = cluster_rank();
  const int k = a.k, l = a.l, n = 15 * k, tid = threadIdx.x, f_n = k - 1;
  const int gt = static_cast<int>(rank) * THREADS + tid;   // the logical thread
  const int pose = 6 * k, np = n_rows_np(k), q_n = n_panels(k);
  const Layout L = layout(k, l, a.n_prior);
  float* rsm[CLUSTER];    // every block's shared memory
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) rsm[r] = remote(sm, static_cast<unsigned>(r));
  float* cur = sm + L.cur;
  float* nxt = sm + L.nxt;
  float* misc = sm + L.misc;
  float* g_a = a.scratch + L.g_a;
  float* g_hcc = a.scratch + L.g_hcc;
  float* g_rec = a.scratch + L.g_rec;
  float* g_lrec = a.scratch + L.g_lrec;
  float* g_lm = a.scratch + L.g_lm;
  float* g_slow = a.scratch + L.g_slow;
  float* g_hpp = a.scratch + L.g_hpp;
  float* g_gp = a.scratch + L.g_gp;
  float* g_corr = a.scratch + L.g_corr;
  int rb = 0;   // the red buffer of the next cluster sum

  // the state in (every block), the landmarks into out_lm (the current point
  // of the solve; a landmark is read and written by its own thread only)
  if (tid < k) {
    float* s = cur + SLOT * tid;
    for (int i = 0; i < 3; ++i) {
      s[S_P + i] = a.p[3 * tid + i];
      s[S_V + i] = a.v[3 * tid + i];
      s[S_BG + i] = a.bg[3 * tid + i];
      s[S_BA + i] = a.ba[3 * tid + i];
    }
    for (int i = 0; i < 4; ++i) s[S_Q + i] = a.q[4 * tid + i];
  }
  for (int li = gt; li < l; li += LANES)
    for (int c = 0; c < 3; ++c) a.out_lm[3 * li + c] = a.lm[3 * li + c];
  if (tid == 0) misc[M_LAM] = a.init_lambda;
  // the prior's Gram matrix A = j^T j into global scratch
  if (a.n_prior) {
    for (int t = gt; t < n * (n + 1) / 2; t += LANES) {
      int i, j;
      lower_pair(t, i, j);
      float s = 0.0f;
      for (int p = 0; p < a.n_prior; ++p)
        s = s + a.prior_j[static_cast<size_t>(p) * n + i] * a.prior_j[static_cast<size_t>(p) * n + j];
      g_a[i * n + j] = s;
      g_a[j * n + i] = s;
    }
    float* g_jt = a.scratch + L.g_jt;
    for (int e = gt; e < a.n_prior * n; e += LANES) g_jt[(e % n) * a.n_prior + e / n] = a.prior_j[e];
  }
  cluster_sync();   // A and j^T in L2
  {
    const float c0 = state_cost(a, L, sm, cur, a.out_lm, rank, rb);
    if (tid == 0) misc[M_COST] = c0;
  }
  __syncthreads();
  WLM_CLOCK(C_INIT);

  for (int it = 0; it < a.iters; ++it) {
    const float lam = misc[M_LAM];
    float* rot = sm + L.rot;
    if (tid < k) qmat(cur + SLOT * tid + S_Q, rot + 9 * tid);
    __syncthreads();

    // --- the landmarks' blocks and the camera factors' duals, over the
    // logical threads; the camera rows and Jacobians into every block
    const int cam_items = f_n * 30 + 3 * k + 3;
    for (int item = gt; item < l + cam_items; item += LANES) {
      if (item < l) {
        const int li = item;
        const float x[3] = {a.out_lm[3 * li], a.out_lm[3 * li + 1], a.out_lm[3 * li + 2]};
        const bool lm_ok = a.lm_valid[li];
        float hll[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, gl[3] = {0.f, 0.f, 0.f};
        unsigned mask = 0;
        for (int kk = 0; kk < k; ++kk) {
          Obs o;
          observe<true>(a, rot + 9 * kk, cur + SLOT * kk, x, lm_ok, kk, li, o);
          if (!o.valid) continue;
          mask |= 1u << kk;
          for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j)
              hll[3 * i + j] = hll[3 * i + j] + (o.jl[0][i] * o.jl[0][j] + o.jl[1][i] * o.jl[1][j]);
            gl[i] = gl[i] + (o.jl[0][i] * o.ro[0] + o.jl[1][i] * o.ro[1]);
          }
          float* rec = g_rec + (static_cast<size_t>(kk) * l + li) * REC;
          float hpl[20];
          for (int i = 0; i < 6; ++i)
            for (int j = 0; j < 3; ++j)
              hpl[3 * i + j] = o.jp[0][i] * o.jl[0][j] + o.jp[1][i] * o.jl[1][j];
          hpl[18] = hpl[19] = 0.0f;
          for (int q = 0; q < 5; ++q)
            reinterpret_cast<float4*>(rec + R_HPL)[q] =
                make_float4(hpl[4 * q], hpl[4 * q + 1], hpl[4 * q + 2], hpl[4 * q + 3]);
          for (int q = 0; q < 3; ++q)
            reinterpret_cast<float4*>(rec + R_JP)[q] =
                make_float4(o.jp[(4 * q) / 6][(4 * q) % 6], o.jp[(4 * q + 1) / 6][(4 * q + 1) % 6],
                            o.jp[(4 * q + 2) / 6][(4 * q + 2) % 6],
                            o.jp[(4 * q + 3) / 6][(4 * q + 3) % 6]);
          *reinterpret_cast<float4*>(rec + R_R) = make_float4(o.ro[0], o.ro[1], 0.0f, 0.0f);
        }
        float abs_sum = fabsf(hll[0]);
        for (int i = 1; i < 9; ++i) abs_sum = abs_sum + fabsf(hll[i]);
        const bool observed = abs_sum > F(1e-12);
        float h[9];
        for (int i = 0; i < 9; ++i) h[i] = hll[i];
        for (int i = 0; i < 3; ++i) h[4 * i] = hll[4 * i] + lam * (hll[4 * i] + F(1e-6));
        float inv[9];
        if (observed) {
          float adj[9];
          adj[0] = h[4] * h[8] - h[5] * h[7];
          adj[1] = h[2] * h[7] - h[1] * h[8];
          adj[2] = h[1] * h[5] - h[2] * h[4];
          adj[3] = h[5] * h[6] - h[3] * h[8];
          adj[4] = h[0] * h[8] - h[2] * h[6];
          adj[5] = h[2] * h[3] - h[0] * h[5];
          adj[6] = h[3] * h[7] - h[4] * h[6];
          adj[7] = h[1] * h[6] - h[0] * h[7];
          adj[8] = h[0] * h[4] - h[1] * h[3];
          const float det = h[0] * adj[0] + h[1] * adj[3] + h[2] * adj[6];
          for (int i = 0; i < 9; ++i) inv[i] = fdiv(adj[i], det);
        } else {
          for (int i = 0; i < 9; ++i) inv[i] = (i % 4 == 0) ? 1.0f : 0.0f;
        }
        for (int kk = 0; kk < k; ++kk) {
          if (!((mask >> kk) & 1u)) continue;
          float* rec = g_rec + (static_cast<size_t>(kk) * l + li) * REC;
          float hpl[20], w[20];
          for (int q = 0; q < 5; ++q) {
            const float4 v = reinterpret_cast<const float4*>(rec + R_HPL)[q];
            hpl[4 * q] = v.x;
            hpl[4 * q + 1] = v.y;
            hpl[4 * q + 2] = v.z;
            hpl[4 * q + 3] = v.w;
          }
          for (int i = 0; i < 6; ++i) {
            const float h0 = hpl[3 * i], h1 = hpl[3 * i + 1], h2 = hpl[3 * i + 2];
            for (int j = 0; j < 3; ++j)
              w[3 * i + j] = h0 * inv[j] + h1 * inv[3 + j] + h2 * inv[6 + j];
          }
          w[18] = w[19] = 0.0f;
          for (int q = 0; q < 5; ++q)
            reinterpret_cast<float4*>(rec + R_W)[q] =
                make_float4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
        }
        float4* lr = reinterpret_cast<float4*>(g_lrec + static_cast<size_t>(li) * LREC);
        lr[0] = make_float4(hll[0], hll[1], hll[2], hll[3]);
        lr[1] = make_float4(hll[4], hll[5], hll[6], hll[7]);
        lr[2] = make_float4(hll[8], 0.0f, 0.0f, 0.0f);
        lr[3] = make_float4(inv[0], inv[1], inv[2], inv[3]);
        lr[4] = make_float4(inv[4], inv[5], inv[6], inv[7]);
        lr[5] = make_float4(inv[8], 0.0f, 0.0f, 0.0f);
        lr[6] = make_float4(gl[0], gl[1], gl[2], __uint_as_float(mask));
        lr[7] = make_float4(observed ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
      } else if (item < l + f_n * 30) {
        // an IMU factor's 15 rows, tangent column col of its two slots
        const int f = (item - l) / 30, col = (item - l) % 30;
        WLM_ITEM_T;
        Dual xi[16], xj[16];
        seeded_slot(cur + SLOT * f, 0, col, xi + S_P, xi + S_Q, xi + S_V, xi + S_BG, xi + S_BA);
        seeded_slot(cur + SLOT * (f + 1), 15, col, xj + S_P, xj + S_Q, xj + S_V, xj + S_BG,
                    xj + S_BA);
        WLM_ITEM(C_DUAL_SEED);
        Dual out[15];
        imu_rows<Dual>(a, f, xi + S_P, xi + S_Q, xi + S_V, xi + S_BG, xi + S_BA, xj + S_P,
                       xj + S_Q, xj + S_V, xj + S_BG, xj + S_BA, out);
        WLM_ITEM(C_DUAL_IMU);
        const bool ok = a.pre_valid[f] && a.kf_valid[f] && a.kf_valid[f + 1];
        for (int r = 0; r < 15; ++r) put_all(rsm, L.jimu + f * 450 + 30 * r + col, ok ? out[r].d : 0.0f);
        if (col == 0)
          for (int r = 0; r < 15; ++r) put_all(rsm, L.rc + 15 * f + r, ok ? out[r].v : 0.0f);
        WLM_ITEM(C_DUAL_PUT);
      } else if (item < l + f_n * 30 + 3 * k) {
        // a slot's bias rows and prior difference (c == 0), and its D column c
        const int kk = (item - l - f_n * 30) / 3, c = (item - l - f_n * 30) % 3;
        const float* s = cur + SLOT * kk;
        Dual qk[4];
        if (c == 0) {
          const int o = 15 * f_n + 4;
          const float m = a.kf_valid[kk] ? 1.0f : 0.0f;
          for (int i = 0; i < 3; ++i) {
            put_all(rsm, L.rc + o + 3 * kk + i, ((s[S_BA + i] + 0.0f) * m) * a.ba_prior_weight);
            put_all(rsm, L.rc + o + 3 * k + 3 * kk + i,
                    ((s[S_BG + i] + 0.0f) * m) * a.bg_prior_weight);
          }
        }
        if (a.n_prior) {
          seeded_rotation(s + S_Q, c, qk);
          float pq[4];
          qconj(a.prior_q + 4 * kk, pq);
          Dual t[4], rel[3];
          qmul(pq, qk, t);
          so3_log(t, rel);
          for (int r = 0; r < 3; ++r) put_all(rsm, L.dmat + 9 * kk + 3 * r + c, rel[r].d);
          if (c == 0) {
            for (int i = 0; i < 3; ++i) {
              put_all(rsm, L.cld + 3 * kk + i, (s[S_P + i] + 0.0f) - a.prior_p[3 * kk + i]);
              put_all(rsm, L.cld + 3 * k + 3 * kk + i, rel[i].v);
              put_all(rsm, L.cld + 6 * k + 3 * kk + i, (s[S_V + i] + 0.0f) - a.prior_v[3 * kk + i]);
              put_all(rsm, L.cld + 9 * k + 3 * kk + i,
                      (s[S_BG + i] + 0.0f) - a.prior_bg[3 * kk + i]);
              put_all(rsm, L.cld + 12 * k + 3 * kk + i,
                      (s[S_BA + i] + 0.0f) - a.prior_ba[3 * kk + i]);
            }
          }
        }
      } else {
        // the yaw anchor, tangent column c of slot 0's rotation
        const int c = item - l - f_n * 30 - 3 * k;
        Dual q0[4];
        seeded_rotation(cur + S_Q, c, q0);
        const Dual y = yaw_err<Dual>(q0, a.anchor_yaw[0]) * a.anchor_weight;
        put_all(rsm, L.jy + c, y.d);
        if (c == 0) {
          const int o = 15 * f_n;
          for (int i = 0; i < 3; ++i)
            put_all(rsm, L.rc + o + i, ((cur[S_P + i] + 0.0f) - a.anchor_p[i]) * a.anchor_weight);
          put_all(rsm, L.rc + o + 3, y.v);
        }
      }
    }
    WLM_CLOCK(C_BLOCKS_OWN);
    cluster_sync();   // the records in L2, the camera rows in every block
    WLM_CLOCK(C_BLOCKS);

    // --- the prior's rows at retract(st, 0), then u = j^T r_p: every block
    float* rp = sm + L.rc + np;
    {
      const float* cld = sm + L.cld;
      for (int p = tid; p < a.n_prior; p += THREADS) {
        const float* jt = a.scratch + L.g_jt + p;   // j[p][c] at jt[c n_prior]
        float s = __ldcg(jt) * cld[0];
        for (int c = 1; c < n; ++c) s = s + __ldcg(jt + static_cast<size_t>(c) * a.n_prior) * cld[c];
        rp[p] = s + a.prior_r0[p];
      }
    }
    __syncthreads();
    if (a.n_prior)
      for (int i = tid; i < n; i += THREADS) {
        float s = 0.0f;
        for (int p = 0; p < a.n_prior; ++p)
          s = s + a.prior_j[static_cast<size_t>(p) * n + i] * rp[p];
        sm[L.u + i] = s;
      }
    WLM_CLOCK(C_PRIOR);

    // --- the landmarks that some keyframe observes, in index order (the
    // others add nothing to the sums), listed by every block for itself
    int* list = reinterpret_cast<int*>(sm + L.list);
    int n_obs = 0;
    {
      const int lane = tid & 31, warp = tid >> 5;
      int* counts = reinterpret_cast<int*>(sm + L.cnt);
      for (int base = 0; base < l; base += THREADS) {
        const int li = base + tid;
        const bool seen =
            li < l &&
            __ldcg(reinterpret_cast<const unsigned*>(g_lrec + static_cast<size_t>(li) * LREC) +
                   L_MASK) != 0u;
        const unsigned ballot = __ballot_sync(CVIDS_FULL_MASK, seen);
        if (lane == 0) counts[warp] = __popc(ballot);
        __syncthreads();
        int before = n_obs;
        for (int w = 0; w < warp; ++w) before += counts[w];
        if (seen) list[before + __popc(ballot & ((1u << lane) - 1u))] = li;
        for (int w = 0; w < WARPS; ++w) n_obs += counts[w];
        __syncthreads();
      }
      if (tid == 0) misc[M_FAIL] = 0.0f;   // before any block's factor can set it
    }
    WLM_CLOCK(C_LIST);

    // --- the sums over landmarks, in landmark order from +0: a warp a
    // keyframe pair ka >= kb (an off-diagonal pair's 36 W H^T outputs: lanes
    // 0-31 and again 0-3; a diagonal pair's 21 W H^T and J_p^T J_p outputs
    // and keyframe ka's 6 gradient ones), so that its lanes take every
    // landmark's observation test alike; tiles of TL landmarks' records
    // staged in shared memory, the next one arriving by cp.async while the
    // current one is summed
    {
      const int lane = tid & 31, gw = static_cast<int>(rank) * WARPS + (tid >> 5);
      const int units = k * (k + 1) / 2, n_tiles = (n_obs + TL - 1) / TL;
      // a record's REC / 4 16-byte pieces by as many threads, ROWS records
      // at a time
      constexpr int ROWS = THREADS / (REC / 4);
      const int q4 = tid % (REC / 4), row = tid / (REC / 4);
      auto load_tile = [&](int t) {
        float* tile = sm + ((t & 1) ? L.tile1 : L.tile0);
        float* tglm = sm + ((t & 1) ? L.tglm1 : L.tglm0);
        const int l0 = t * TL, nl = min(TL, n_obs - l0);
        if (row < ROWS)
          for (int kl = row; kl < k * TL; kl += ROWS) {
            const int kk = kl / TL, lt = kl % TL;
            if (lt < nl)
              cp_async16(tile + kk * KSTRIDE + lt * REC + 4 * q4,
                         g_rec + (static_cast<size_t>(kk) * l + list[l0 + lt]) * REC + 4 * q4);
          }
        if (tid < nl)
          cp_async16(tglm + 4 * tid, g_lrec + static_cast<size_t>(list[l0 + tid]) * LREC + L_GL);
        cp_async_commit();
      };
      // a warp's units: (units + GWARPS - 1) / GWARPS of them at most
      constexpr int SLOTS = (MAX_K * (MAX_K + 1) / 2 + GWARPS - 1) / GWARPS;
      float acc[SLOTS][3];
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = 0.0f;
      if (n_tiles > 0) load_tile(0);
      for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
          load_tile(t + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const float* tile = sm + ((t & 1) ? L.tile1 : L.tile0);
        const float* tglm = sm + ((t & 1) ? L.tglm1 : L.tglm0);
        const int nl = min(TL, n_obs - t * TL);
        unsigned mt[TL];   // the tile's observation masks
#pragma unroll
        for (int lt = 0; lt < TL; ++lt) mt[lt] = lt < nl ? __float_as_uint(tglm[4 * lt + 3]) : 0u;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int u = gw + GWARPS * s;
          if (u < units) {
            int ka, kb;
            lower_pair(u, ka, kb);
            const unsigned both = (1u << ka) | (1u << kb);
            // the tile's landmarks that both keyframes observe, alike in
            // every lane; four at a time, their loads first, then the terms
            // of those that pass added in landmark order
            unsigned pass = 0;
#pragma unroll
            for (int lt = 0; lt < TL; ++lt) pass |= ((mt[lt] & both) == both ? 1u : 0u) << lt;
            if (ka == kb) {
              if (lane < 21) {
                int ai, aj;
                lower_pair(lane, ai, aj);
                const float* wi0 = tile + ka * KSTRIDE + R_W + 3 * ai;
                const float* hj0 = tile + ka * KSTRIDE + R_HPL + 3 * aj;
                const float* jp0 = tile + ka * KSTRIDE + R_JP;
#pragma unroll
                for (int c4 = 0; c4 < TL; c4 += 4) {
                  const unsigned m4 = (pass >> c4) & 0xFu;
                  if (m4 == 0u) continue;
                  float sv[4], pv[4];
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    const float* wi = wi0 + (c4 + j) * REC;
                    const float* hj = hj0 + (c4 + j) * REC;
                    const float* jp = jp0 + (c4 + j) * REC;
                    sv[j] = wi[0] * hj[0] + wi[1] * hj[1] + wi[2] * hj[2];
                    pv[j] = jp[ai] * jp[aj] + jp[6 + ai] * jp[6 + aj];
                  }
#pragma unroll
                  for (int j = 0; j < 4; ++j)
                    if ((m4 >> j) & 1u) {
                      acc[s][0] = acc[s][0] + sv[j];
                      acc[s][1] = acc[s][1] + pv[j];
                    }
                }
              } else if (lane < 27) {
                const int ai = lane - 21;
                const float* rec0 = tile + ka * KSTRIDE;
#pragma unroll
                for (int c4 = 0; c4 < TL; c4 += 4) {
                  const unsigned m4 = (pass >> c4) & 0xFu;
                  if (m4 == 0u) continue;
                  float av[4], bv[4];
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    const float* rec = rec0 + (c4 + j) * REC;
                    const float* w = rec + R_W + 3 * ai;
                    const float* gl = tglm + 4 * (c4 + j);
                    av[j] = rec[R_JP + ai] * rec[R_R] + rec[R_JP + 6 + ai] * rec[R_R + 1];
                    bv[j] = w[0] * gl[0] + w[1] * gl[1] + w[2] * gl[2];
                  }
#pragma unroll
                  for (int j = 0; j < 4; ++j)
                    if ((m4 >> j) & 1u) {
                      acc[s][0] = acc[s][0] + av[j];
                      acc[s][1] = acc[s][1] + bv[j];
                    }
                }
              }
            } else {
              int ki, ai, kj, aj, ta, ki2 = 0, ai2 = 0, kj2 = 0, aj2 = 0, tb = 0;
              pair_task(ka, kb, lane, k, ki, ai, kj, aj, ta);
              const bool extra = lane < 4;   // combinations 32-35
              if (extra) pair_task(ka, kb, 32 + lane, k, ki2, ai2, kj2, aj2, tb);
              const float* wa0 = tile + ki * KSTRIDE + R_W + 3 * ai;
              const float* ha0 = tile + kj * KSTRIDE + R_HPL + 3 * aj;
              const float* wb0 = tile + ki2 * KSTRIDE + R_W + 3 * ai2;
              const float* hb0 = tile + kj2 * KSTRIDE + R_HPL + 3 * aj2;
#pragma unroll
              for (int c4 = 0; c4 < TL; c4 += 4) {
                const unsigned m4 = (pass >> c4) & 0xFu;
                if (m4 == 0u) continue;
                float sv[4], ev[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const float* w1 = wa0 + (c4 + j) * REC;
                  const float* h1 = ha0 + (c4 + j) * REC;
                  sv[j] = w1[0] * h1[0] + w1[1] * h1[1] + w1[2] * h1[2];
                }
                if (extra) {
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    const float* w2 = wb0 + (c4 + j) * REC;
                    const float* h2 = hb0 + (c4 + j) * REC;
                    ev[j] = w2[0] * h2[0] + w2[1] * h2[1] + w2[2] * h2[2];
                  }
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  if ((m4 >> j) & 1u) {
                    acc[s][0] = acc[s][0] + sv[j];
                    if (extra) acc[s][2] = acc[s][2] + ev[j];
                  }
              }
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int u = gw + GWARPS * s;
        if (u < units) {
          int ka, kb;
          lower_pair(u, ka, kb);
          if (ka == kb) {
            if (lane < 21) {
              int ai, aj;
              lower_pair(lane, ai, aj);
              const int pi = pose_idx(ka, ai, k), pj = pose_idx(ka, aj, k);
              g_slow[pi * (pi + 1) / 2 + pj] = acc[s][0];
              g_hpp[pi * (pi + 1) / 2 + pj] = acc[s][1];
            } else if (lane < 27) {
              const int p = pose_idx(ka, lane - 21, k);
              g_gp[p] = acc[s][0];
              g_corr[p] = acc[s][1];
            }
          } else {
            int ki, ai, kj, aj, t;
            pair_task(ka, kb, lane, k, ki, ai, kj, aj, t);
            g_slow[t] = acc[s][0];
            if (lane < 4) {
              pair_task(ka, kb, 32 + lane, k, ki, ai, kj, aj, t);
              g_slow[t] = acc[s][2];
            }
          }
        }
      }
    }
    WLM_CLOCK(C_SUMS_ADD);
    cluster_sync();   // the landmark sums in L2
    WLM_CLOCK(C_SUMS);

    // --- the reduced camera system: this block's panels' entries, then the
    // diagonal's scale d and the gradient in every block, then the scaled
    // entries and the right-hand side as row 15K
    {
      int done = 0;
      for (int q = rank; q < q_n; q += CLUSTER) {
        const int j0 = q * PB, bq = min(PB, n - j0), items = (n - j0) * PB;
        float* blk = sm + L.own + panel_base(k, q);
        for (int e = ((tid - done) % THREADS + THREADS) % THREADS; e < items; e += THREADS) {
          const int r = e / PB, c = e % PB, i = j0 + r, j = j0 + c;
          if (c >= bq || j > i) continue;
          float hcc;
          blk[r * PS + c] = sys_entry(a, L, sm, g_a, g_slow, g_hpp, i, j, i * (i + 1) / 2 + j,
                                      lam, &hcc);
          g_hcc[i * n + j] = hcc;
          g_hcc[j * n + i] = hcc;
        }
        done += items;
      }
      WLM_CLOCK(C_SYS_OWN);
      for (int i = tid; i < n; i += THREADS) {
        float hcc;
        const float h = sys_entry(a, L, sm, g_a, g_slow, g_hpp, i, i, i * (i + 1) / 2 + i, lam,
                                  &hcc);
        sm[L.d + i] = fdiv(1.0f, sqrtf(h + F(1e-12)));
        sm[L.g + i] = grad_entry(a, L, sm, g_gp, i);
      }
      __syncthreads();
      const float* d = sm + L.d;
      done = 0;
      for (int q = rank; q < q_n; q += CLUSTER) {
        const int j0 = q * PB, bq = min(PB, n - j0), items = (n + 1 - j0) * PB;
        float* blk = sm + L.own + panel_base(k, q);
        for (int e = ((tid - done) % THREADS + THREADS) % THREADS; e < items; e += THREADS) {
          const int r = e / PB, c = e % PB, i = j0 + r, j = j0 + c;
          if (c >= bq || j > i) continue;
          if (i < n) {
            blk[r * PS + c] = (blk[r * PS + c] * d[i]) * d[j];
          } else {
            const float g_red = j < pose ? sm[L.g + j] - __ldcg(g_corr + j) : sm[L.g + j];
            blk[r * PS + c] = -(g_red * d[j]);
          }
        }
        done += items;
      }
      __syncthreads();
    }
    WLM_CLOCK(C_SYSTEM);

    // --- Cholesky, the right-hand side as row 15K (the forward
    // substitution): panel q factored by its owner, which stores the rows
    // below its block into every block's buffer q % PBUFS; every block
    // applies it to its own later panels, the owner of panel q + 1 to that
    // panel first, then factors it and arrives
    if (rank == 0) factor_panel(L, sm, rsm, k, 0);
    cluster_arrive();
    for (int q = 0; q + 1 < q_n; ++q) {
      WLM_CLOCK(C_CHOL);
      cluster_wait();               // panel q is factored, in every block's buffer
      WLM_CLOCK(C_CHOL_WAIT);
      const bool next = (q + 1) % CLUSTER == static_cast<int>(rank);
      if (next) {
        apply_panel(L, sm, k, q, q + 1, q + 2, rank);
        __syncthreads();
        WLM_CLOCK(C_CHOL_NEXT);
        factor_panel(L, sm, rsm, k, q + 1);
        WLM_CLOCK(C_CHOL_FACTOR);
      }
      cluster_arrive();             // (the owner's) panel q + 1 is factored
      apply_panel(L, sm, k, q, next ? q + 2 : q + 1, q_n, rank);
      __syncthreads();
      WLM_CLOCK(C_CHOL_REST);
    }
    cluster_wait();
    WLM_CLOCK(C_CHOL);

    // --- the back substitution, a panel at a time from the last: its owner's
    // warp 0 solves the diagonal block (lane r holding y[r], row j's entries
    // of its column), stores its x into every block, then every block takes
    // x_j L_ji off its own y_i, j from the panel's last down; dc = d x
    {
      float* y = sm + L.y;
      float* x = sm + L.x;
      const int lane = tid & 31;
      for (int q = rank; q < q_n; q += CLUSTER) {
        const float* blk = sm + L.own + panel_base(k, q);
        const int j0 = q * PB, bq = min(PB, n - j0);
        for (int c = tid; c < bq; c += THREADS) y[j0 + c] = blk[(n - j0) * PS + c];
      }
      __syncthreads();
      for (int q = q_n - 1; q >= 0; --q) {
        const int j0 = q * PB, bq = min(PB, n - j0);
        if (q % CLUSTER == static_cast<int>(rank) && tid < 32) {
          const float* blk = sm + L.own + panel_base(k, q);
          const float* diag = sm + L.diag + j0;
          float yv = lane < bq ? y[j0 + lane] : 0.0f;
          float lc[PB];
#pragma unroll
          for (int c = 0; c < PB; ++c) lc[c] = (c < bq && lane < c) ? blk[c * PS + lane] : 0.0f;
#pragma unroll
          for (int c = PB - 1; c >= 0; --c) {
            if (c < bq) {
              const float xj = fdiv(__shfl_sync(CVIDS_FULL_MASK, yv, c), diag[c]);
              if (lane < c)
                yv = yv - lc[c] * xj;
              else if (lane == c)
                yv = xj;
            }
          }
          if (lane < bq) put_all(rsm, L.x + j0 + lane, yv);
        }
        WLM_CLOCK(C_BACK_SOLVE);
        cluster_sync();             // the panel's x in every block
        WLM_CLOCK(C_BACK_SYNC);
        if (q > 0) {
          for (int e = tid;; e += THREADS) {
            const int q2 = static_cast<int>(rank) + CLUSTER * (e / PB);
            if (q2 >= q) break;
            const int i = q2 * PB + e % PB;
            const float* col = sm + L.own + panel_base(k, q2) + (i - q2 * PB);
            float v = y[i];
            for (int c = bq - 1; c >= 0; --c) v = v - col[(j0 + c - q2 * PB) * PS] * x[j0 + c];
            y[i] = v;
          }
          __syncthreads();
        }
        WLM_CLOCK(C_BACK_UPDATE);
      }
      const bool fail = misc[M_FAIL] != 0.0f;
      for (int i = tid; i < n; i += THREADS)
        sm[L.dc + i] = sm[L.d + i] * (fail ? __int_as_float(0x7fc00000) : x[i]);
      __syncthreads();
    }
    WLM_CLOCK(C_BACK);

    // --- the step and the cost there: camera states (every block), then
    // their camera rows; a landmark's step and its reprojection terms at
    // the step (its thread); the predicted reduction's parts and the cost's
    // two sums over the logical threads, in one cluster sum
    float cost_new;
    {
      const float* dc = sm + L.dc;
      if (tid < k) {
        const float* s = cur + SLOT * tid;
        float* o = nxt + SLOT * tid;
        float w[3], e[4], qn[4];
        for (int i = 0; i < 3; ++i) {
          o[S_P + i] = s[S_P + i] + dc[3 * tid + i];
          w[i] = dc[3 * k + 3 * tid + i];
          o[S_V + i] = s[S_V + i] + dc[6 * k + 3 * tid + i];
          o[S_BG + i] = s[S_BG + i] + dc[9 * k + 3 * tid + i];
          o[S_BA + i] = s[S_BA + i] + dc[12 * k + 3 * tid + i];
        }
        so3_exp(w, e);
        qmul(s + S_Q, e, qn);
        qnormalize(qn);
        for (int i = 0; i < 4; ++i) o[S_Q + i] = qn[i];
      }
      __syncthreads();
      cost_rows(a, L, sm, nxt);
      __syncthreads();
      // g_c dc, dc h_cc dc, g_l dl, u dl, dl H_ll dl; the camera rows' and
      // the reprojections' square terms at the step
      float part[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (gt < n) {
        part[0] = part[0] + sm[L.g + gt] * dc[gt];
        // row gt of h_cc read as its column (the same numbers; the lanes'
        // loads side by side)
        const float* hc = g_hcc + gt;
        float hd = 0.0f;
        for (int j0 = 0; j0 < n; j0 += 32) {   // 32 loads in flight, then their sums in order
          float hv[32];
#pragma unroll
          for (int u = 0; u < 32; ++u)
            hv[u] = j0 + u < n ? __ldcg(hc + static_cast<size_t>(j0 + u) * n) : 0.0f;
#pragma unroll
          for (int u = 0; u < 32; ++u) {
            const int j = j0 + u;
            if (j == 0)
              hd = hv[0] * dc[0];
            else if (j < n)
              hd = hd + hv[u] * dc[j];
          }
        }
        part[1] = part[1] + dc[gt] * hd;
      }
      WLM_CLOCK(C_STEP_HD);
      for (int li = gt; li < l; li += LANES) {
        float lr[32];
        for (int q = 0; q < 8; ++q) {
          const float4 v = reinterpret_cast<const float4*>(g_lrec + static_cast<size_t>(li) * LREC)[q];
          lr[4 * q] = v.x;
          lr[4 * q + 1] = v.y;
          lr[4 * q + 2] = v.z;
          lr[4 * q + 3] = v.w;
        }
        const unsigned mask = __float_as_uint(lr[L_MASK]);
        float u[3] = {0.f, 0.f, 0.f};
        for (int kk = 0; kk < k; ++kk) {
          if (!((mask >> kk) & 1u)) continue;
          float hp[20];
          for (int q = 0; q < 5; ++q) {
            const float4 v = reinterpret_cast<const float4*>(
                g_rec + (static_cast<size_t>(kk) * l + li) * REC + R_HPL)[q];
            hp[4 * q] = v.x;
            hp[4 * q + 1] = v.y;
            hp[4 * q + 2] = v.z;
            hp[4 * q + 3] = v.w;
          }
          float dcp[6];
          for (int i = 0; i < 3; ++i) {
            dcp[i] = dc[3 * kk + i];
            dcp[3 + i] = dc[3 * k + 3 * kk + i];
          }
          for (int b = 0; b < 3; ++b) {
            float t = hp[b] * dcp[0];
            for (int i = 1; i < 6; ++i) t = t + hp[3 * i + b] * dcp[i];
            u[b] = u[b] + t;
          }
        }
        const float* gl = lr + L_GL;
        const float* hinv = lr + L_HINV;
        const float* hll = lr + L_HLL;
        float rhs[3], dl[3], hv[3];
        for (int b = 0; b < 3; ++b) rhs[b] = -gl[b] - u[b];
        const bool observed = lr[L_OBS] != 0.0f;
        for (int i = 0; i < 3; ++i)
          dl[i] = observed ? hinv[3 * i] * rhs[0] + hinv[3 * i + 1] * rhs[1] + hinv[3 * i + 2] * rhs[2]
                           : 0.0f;
        for (int i = 0; i < 3; ++i) {
          g_lm[3 * li + i] = a.out_lm[3 * li + i] + dl[i];
          hv[i] = hll[3 * i] * dl[0] + hll[3 * i + 1] * dl[1] + hll[3 * i + 2] * dl[2];
        }
        part[2] = part[2] + (gl[0] * dl[0] + gl[1] * dl[1] + gl[2] * dl[2]);
        part[3] = part[3] + (u[0] * dl[0] + u[1] * dl[1] + u[2] * dl[2]);
        part[4] = part[4] + (dl[0] * hv[0] + dl[1] * hv[1] + dl[2] * hv[2]);
        part[6] = part[6] + cost_landmark(a, sm + L.rot, nxt, g_lm, li);
      }
      WLM_CLOCK(C_STEP_LM);
      part[5] = cost_cam(a, L, sm, gt);
      WLM_CLOCK(C_COST);
      float* red = sm + L.red + 7 * 32 * rb;
      rb ^= 1;
      cluster_sums<7>(part, red, rank);
      if (tid == 0)
        misc[M_PRED] = -(red[0] + red[64]) - 0.5f * (red[32] + 2.0f * red[96] + red[128]);
      cost_new = 0.5f * red[160] + 0.5f * red[192];
      __syncthreads();
    }
    WLM_CLOCK(C_STEP);

    // --- the Levenberg-Marquardt update (every block alike)
    if (tid == 0) {
      const float cost = misc[M_COST], pred = misc[M_PRED], lam0 = misc[M_LAM];
      const bool accept = cost_new < cost;
      const float rho = fdiv(cost - cost_new, clamp_lo(pred, F(1e-12)));
      const float t = 2.0f * rho - 1.0f;
      const float shrink = clamp_lo(1.0f - t * t * t, F(1.0 / 3.0));
      misc[M_LAM] = accept ? clamp_lo(lam0 * shrink, F(1e-10)) : clamp_hi(lam0 * 4.0f, F(1e8));
      misc[M_COST] = accept ? cost_new : cost;
      misc[M_ACCEPT] = accept ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (misc[M_ACCEPT] != 0.0f) {
      for (int i = tid; i < SLOT * k; i += THREADS) cur[i] = nxt[i];
      for (int li = gt; li < l; li += LANES)
        for (int c = 0; c < 3; ++c) a.out_lm[3 * li + c] = g_lm[3 * li + c];
    }
    __syncthreads();
    WLM_CLOCK(C_ACCEPT);
  }

  if (rank == 0) {
    if (tid < k) {
      const float* s = cur + SLOT * tid;
      for (int i = 0; i < 3; ++i) {
        a.out_p[3 * tid + i] = s[S_P + i];
        a.out_v[3 * tid + i] = s[S_V + i];
        a.out_bg[3 * tid + i] = s[S_BG + i];
        a.out_ba[3 * tid + i] = s[S_BA + i];
      }
      for (int i = 0; i < 4; ++i) a.out_q[4 * tid + i] = s[S_Q + i];
    }
    if (tid == 0) a.out_cost[0] = misc[M_COST];
  }
}

}  // namespace

// ptrs: the 42 device pointers of the solve in the order of
// `cuda_kernels.window_lm` (the state, the measurements, the prior or nulls,
// the outputs, the scratch); ints: k (1-21), l, the prior's rows (0: none,
// at most 15k + 1), iters, the scratch's floats; floats: init_lambda,
// anchor_weight, pix_weight, huber_delta, bias_weight, ba_prior_weight,
// bg_prior_weight. One cluster of CLUSTER blocks of THREADS threads.
extern "C" int cvids_window_lm(void* const* ptrs, const int* ints, const float* floats,
                               void* stream) {
  const int k = ints[0], l = ints[1], n_prior = ints[2], iters = ints[3], scratch = ints[4];
  if (k < 1 || k > MAX_K || l < 0 || n_prior < 0 || n_prior > 15 * k + 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(k, l, n_prior);
  const size_t smem = static_cast<size_t>(lay.total) * sizeof(float);
  if (scratch < lay.g_total || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  const float** fp[] = {&a.p, &a.q, &a.v, &a.bg, &a.ba, &a.lm};
  for (int i = 0; i < 6; ++i) *fp[i] = static_cast<const float*>(ptrs[i]);
  a.kf_valid = static_cast<const uint8_t*>(ptrs[6]);
  a.lm_valid = static_cast<const uint8_t*>(ptrs[7]);
  a.obs = static_cast<const float*>(ptrs[8]);
  a.vis = static_cast<const uint8_t*>(ptrs[9]);
  const float** pre[] = {&a.pre_dp, &a.pre_dv, &a.pre_dq, &a.pre_dt, &a.jpbg, &a.jpba,
                         &a.jvbg,   &a.jvba,   &a.jqbg,  &a.sqrt_info, &a.pre_bg, &a.pre_ba};
  for (int i = 0; i < 12; ++i) *pre[i] = static_cast<const float*>(ptrs[10 + i]);
  a.pre_valid = static_cast<const uint8_t*>(ptrs[22]);
  const float** geo[] = {&a.r_cb, &a.p_bc, &a.anchor_p, &a.anchor_yaw, &a.prior_j, &a.prior_r0,
                         &a.prior_p, &a.prior_q, &a.prior_v, &a.prior_bg, &a.prior_ba};
  for (int i = 0; i < 11; ++i) *geo[i] = static_cast<const float*>(ptrs[23 + i]);
  float** out[] = {&a.out_p, &a.out_q, &a.out_v, &a.out_bg, &a.out_ba, &a.out_lm, &a.out_cost,
                   &a.scratch};
  for (int i = 0; i < 8; ++i) *out[i] = static_cast<float*>(ptrs[34 + i]);
  a.k = k;
  a.l = l;
  a.n_prior = n_prior;
  a.iters = iters;
  a.init_lambda = floats[0];
  a.anchor_weight = floats[1];
  a.pix_weight = floats[2];
  a.huber_delta = floats[3];
  a.bias_weight = floats[4];
  a.ba_prior_weight = floats[5];
  a.bg_prior_weight = floats[6];
  const cudaError_t e = cudaFuncSetAttribute(
      window_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  window_lm_kernel<<<CLUSTER, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// what a solve of k keyframes, l landmark slots and a prior of n_prior rows
// takes, without launching: plan[0..3] = dynamic shared memory bytes a
// block, scratch floats, threads a block, blocks of the cluster
extern "C" int cvids_window_lm_plan(int k, int l, int n_prior, int* plan) {
  if (plan == nullptr || k < 1 || k > MAX_K || l < 0 || n_prior < 0 || n_prior > 15 * k + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(k, l, n_prior);
  plan[0] = lay.total * static_cast<int>(sizeof(float));
  plan[1] = lay.g_total;
  plan[2] = THREADS;
  plan[3] = CLUSTER;
  return 0;
}

// the compiled kernel as the runtime reports it: out[0..3] = registers a
// thread, local memory bytes a thread, threads a block, blocks of the cluster
extern "C" int cvids_window_lm_attrs(int* out) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, window_lm_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = THREADS;
  out[3] = CLUSTER;
  return 0;
}

#ifdef CVIDS_WLM_CLOCKS
// the phases' clock64 sums since the last read (all 32 slots), then zeroed
extern "C" int cvids_wlm_clocks_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, cvids_wlm_clocks, sizeof(unsigned long long) * 32);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[32] = {};
  return static_cast<int>(cudaMemcpyToSymbol(cvids_wlm_clocks, zero, sizeof(zero)));
}
#endif

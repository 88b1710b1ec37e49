// The agent's sliding-window solve, `vio.window_ba.solve_window_fast`, in one
// launch: every Levenberg-Marquardt iteration of one window, with the
// landmarks eliminated by their 3x3 blocks (Schur complement) and the reduced
// camera system factored in shared memory.
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
//   a last row) factored by a right-looking Cholesky, two barriers a column,
//   then the back substitution by one warp; a pivot that is not positive
//   makes the step NaN, which the cost test rejects;
// - block-wide sums: element i into thread i mod 1024 in order from +0, then
//   the warp's shuffles (offsets 16 .. 1) and the 32 warp sums the same way.
//
// Bound on the card: a latency-bound chain, far under the card's rates. An
// iteration at K = 10, L = 600 is ~4 MFLOP and ~2 MB of L2 traffic (a few
// microseconds at the peaks), but it is ~25 dependent phases and a
// 150-column Cholesky (300 barriers), times `iters`. The design keeps the
// whole solve in one launch (no launch gaps, no host round trip), the state
// and the reduced system in shared memory, the per-observation blocks in an
// L2-resident scratch that the wrapper allocates.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_K = 12;     // the (15K + 1) x 15K system in shared memory
constexpr int TL = 16;        // landmarks a tile of the landmark sums
constexpr int REC = 52;       // floats an observation's record
// a keyframe's part of a tile, padded to 12 mod 32 words: the lanes of a
// landmark-sum warp read different keyframes' records at different banks
constexpr int KSTRIDE = TL * REC + 12;

constexpr int R_HPL = 0, R_W = 18, R_JP = 36, R_R = 48;
constexpr int LREC = 32;      // floats a landmark's record
constexpr int L_HLL = 0, L_HINV = 9, L_GL = 18, L_OBS = 21, L_MASK = 22;
constexpr int MAX_TASKS = 3;  // landmark-sum tasks a thread (K <= 12)

#define F(x) (static_cast<float>(x))
constexpr float PI_F = F(3.141592653589793);
constexpr float TWO_PI_F = F(2.0 * 3.141592653589793);

// ---------------------------------------------------------------------------
// Dual numbers: a value and one tangent; a float operand is a constant
// ---------------------------------------------------------------------------

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
  const float v = a.v / b.v;
  return Dual(v, (a.d - v * b.d) / b.v);
}
__device__ __forceinline__ Dual operator/(Dual a, float c) { return Dual(a.v / c, a.d / c); }
__device__ __forceinline__ Dual operator/(float c, Dual b) {
  const float v = c / b.v;
  return Dual(v, -(v * b.d) / b.v);
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual t_sqrt(Dual x) {
  const float s = sqrtf(x.v);
  return Dual(s, x.d / (s * 2.0f));
}
__device__ __forceinline__ float t_sin(float x) { return sinf(x); }
__device__ __forceinline__ Dual t_sin(Dual x) { return Dual(sinf(x.v), cosf(x.v) * x.d); }
__device__ __forceinline__ float t_cos(float x) { return cosf(x); }
__device__ __forceinline__ Dual t_cos(Dual x) { return Dual(cosf(x.v), -sinf(x.v) * x.d); }
__device__ __forceinline__ float t_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ Dual t_atan2(Dual y, Dual x) {
  const float den = x.v * x.v + y.v * y.v;
  return Dual(atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / den);
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
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
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
    sho = 0.5f - theta2 / 48.0f;
    cw = 1.0f - theta2 / 8.0f;
  } else {
    const T half = 0.5f * theta;
    sho = t_sin(half) / theta;
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
    scale = 2.0f / clamp_lo(w, F(1e-12));
  } else {
    const T sin_half = t_sqrt(sq);
    const T half = t_atan2(sin_half, w);
    scale = (2.0f * half) / clamp_lo(sin_half, F(1e-24));
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
  // shared memory, offsets in floats
  int chol, tile, tile_gl, tile_mask, s_low, hpp_low, gp, corr, jimu, rc, rc2, cld, dmat, jy, g,
      d, dc, u, cur, nxt, rot, red, misc, total;
  // global scratch, offsets in floats
  int g_a, g_hcc, g_rec, g_lrec, g_lm, g_list, g_total;
};

__host__ __device__ inline int n_rows_np(int k) { return 15 * (k - 1) + 4 + 6 * k; }

__host__ __device__ inline Layout layout(int k, int l, int n_prior) {
  Layout s;
  const int n = 15 * k, pose = 6 * k, low = pose * (pose + 1) / 2;
  int o = 0;
  s.chol = o; o += (n + 1) * n;
  o = (o + 3) & ~3;           // float4 stores into the tile
  s.tile = o; o += KSTRIDE * k;
  s.tile_gl = o; o += TL * 3;
  s.tile_mask = o; o += TL;
  s.s_low = o; o += low;
  s.hpp_low = o; o += low;
  s.gp = o; o += pose;
  s.corr = o; o += pose;
  s.jimu = o; o += (k - 1) * 15 * 30;
  s.rc = o; o += n_rows_np(k) + n_prior;
  s.rc2 = o; o += n_rows_np(k) + n_prior;
  s.cld = o; o += n;
  s.dmat = o; o += 9 * k;
  s.jy = o; o += 4;
  s.g = o; o += n;
  s.d = o; o += n;
  s.dc = o; o += n;
  s.u = o; o += n;
  s.cur = o; o += SLOT * k;
  s.nxt = o; o += SLOT * k;
  s.rot = o; o += 9 * k;
  s.red = o; o += 8 * 32;
  s.misc = o; o += 16;
  s.total = o;  // (the warp counts of the landmark list reuse `red`)
  int g = 0;
  s.g_a = g; g += n * n;
  s.g_hcc = g; g += n * n;
  g = (g + 3) & ~3;           // float4 loads of the records
  s.g_rec = g; g += k * l * REC;
  s.g_lrec = g; g += l * LREC;
  s.g_lm = g; g += l * 3;
  s.g_list = g; g += l;       // the observed landmarks, in index order (ints)
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
  const float wrap = floorf((val(d_yaw) + PI_F) / TWO_PI_F);
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
// Block-wide sums
// ---------------------------------------------------------------------------

// the sums over the block of each thread's partials v[0..nq), which each
// thread added in its element order from +0; the results land in red[q * 32]
// (read after the call; every thread calls it)
template <int NQ>
__device__ __forceinline__ void block_sums(float* v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = 0; q < NQ; ++q) {
    float x = v[q];
    for (int off = 16; off; off >>= 1) x = x + __shfl_down_sync(CVIDS_FULL_MASK, x, off);
    v[q] = x;
  }
  __syncthreads();            // red is free
  if (lane == 0)
    for (int q = 0; q < NQ; ++q) red[q * 32 + warp] = v[q];
  __syncthreads();
  if (warp == 0) {
    for (int q = 0; q < NQ; ++q) {
      float x = red[q * 32 + lane];
      for (int off = 16; off; off >>= 1) x = x + __shfl_down_sync(CVIDS_FULL_MASK, x, off);
      if (lane == 0) red[q * 32] = x;
    }
  }
  __syncthreads();
}

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
  o.r[0] = (px / zs - nan_to_num(a.obs[2 * ol])) * pixw;
  o.r[1] = (py / zs - nan_to_num(a.obs[2 * ol + 1])) * pixw;
  const float rn = sqrtf(o.r[0] * o.r[0] + o.r[1] * o.r[1]);
  const float s = sqrtf(clamp_hi(delta / clamp_lo(rn, F(1e-9)), 1.0f));
  o.ro[0] = o.r[0] * s;
  o.ro[1] = o.r[1] * s;
  if (!BLOCKS) return;
  const float inv_z = 1.0f / zs;
  const float dp[2][3] = {{inv_z, 0.0f, -px * inv_z * inv_z}, {0.0f, inv_z, -py * inv_z * inv_z}};
  const bool big = rn > delta;
  const float den = clamp_lo(rn * rn, F(1e-18));
  float hub[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      hub[i][j] = s * ((i == j ? 1.0f : 0.0f) - (big ? 0.5f * ((o.r[i] * o.r[j]) / den) : 0.0f));
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

__device__ float state_cost(const Args& a, const Layout& L, float* sm, const float* st,
                            const float* lm) {
  const int k = a.k, l = a.l, n = 15 * k, tid = threadIdx.x;
  const int f_n = k - 1, np = n_rows_np(k);
  float* rot = sm + L.rot;
  float* rc2 = sm + L.rc2;
  float* cld = sm + L.cld;
  if (tid < k) qmat(st + SLOT * tid + S_Q, rot + 9 * tid);
  __syncthreads();
  float acc_proj = 0.0f;
  for (int li = tid; li < l; li += THREADS) {
    const float x[3] = {lm[3 * li], lm[3 * li + 1], lm[3 * li + 2]};
    const bool lm_ok = a.lm_valid[li];
    float e = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      Obs o;
      observe<false>(a, rot + 9 * kk, st + SLOT * kk, x, lm_ok, kk, li, o);
      if (o.valid) e = e + (o.ro[0] * o.ro[0] + o.ro[1] * o.ro[1]);
    }
    acc_proj = acc_proj + e;
  }
  // camera rows: IMU (threads 0 .. K-2), anchors (K-1), bias (K .. 2K-1),
  // the prior's cld (2K .. 3K-1)
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
  __syncthreads();
  if (tid < a.n_prior) {
    const float* jr = a.prior_j + static_cast<size_t>(tid) * n;
    float s = jr[0] * cld[0];
    for (int c = 1; c < n; ++c) s = s + jr[c] * cld[c];
    rc2[np + tid] = s + a.prior_r0[tid];
  }
  __syncthreads();
  float acc_cam = 0.0f;
  for (int r = tid; r < np + a.n_prior; r += THREADS) acc_cam = acc_cam + rc2[r] * rc2[r];
  float v[2] = {acc_cam, acc_proj};
  block_sums<2>(v, sm + L.red);
  return 0.5f * sm[L.red] + 0.5f * sm[L.red + 32];
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1) window_lm_kernel(const Args a) {
  extern __shared__ float sm[];
  const int k = a.k, l = a.l, n = 15 * k, tid = threadIdx.x, f_n = k - 1;
  const int pose = 6 * k, n_low = pose * (pose + 1) / 2, np = n_rows_np(k);
  const Layout L = layout(k, l, a.n_prior);
  float* chol = sm + L.chol;
  float* cur = sm + L.cur;
  float* nxt = sm + L.nxt;
  float* misc = sm + L.misc;
  float* g_a = a.scratch + L.g_a;
  float* g_hcc = a.scratch + L.g_hcc;
  float* g_rec = a.scratch + L.g_rec;
  float* g_lrec = a.scratch + L.g_lrec;
  float* g_lm = a.scratch + L.g_lm;

  // the state in, the landmarks into out_lm (the current point of the solve)
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
  for (int i = tid; i < 3 * l; i += THREADS) a.out_lm[i] = a.lm[i];
  if (tid == 0) misc[M_LAM] = a.init_lambda;
  // the prior's Gram matrix A = j^T j, j staged in the Cholesky buffer
  if (a.n_prior) {
    for (int i = tid; i < a.n_prior * n; i += THREADS) chol[i] = a.prior_j[i];
    __syncthreads();
    for (int t = tid; t < n * (n + 1) / 2; t += THREADS) {
      int i, j;
      lower_pair(t, i, j);
      float s = 0.0f;
      for (int p = 0; p < a.n_prior; ++p) s = s + chol[p * n + i] * chol[p * n + j];
      g_a[i * n + j] = s;
      g_a[j * n + i] = s;
    }
  }
  __syncthreads();
  {
    const float c0 = state_cost(a, L, sm, cur, a.out_lm);
    if (tid == 0) misc[M_COST] = c0;
  }
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    const float lam = misc[M_LAM];
    float* rot = sm + L.rot;
    if (tid < k) qmat(cur + SLOT * tid + S_Q, rot + 9 * tid);
    __syncthreads();

    // --- the landmarks' blocks and the camera factors' duals
    const int cam_items = f_n * 30 + 3 * k + 3;
    for (int item = tid; item < l + cam_items; item += THREADS) {
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
          for (int i = 0; i < 6; ++i)
            for (int j = 0; j < 3; ++j)
              rec[R_HPL + 3 * i + j] = o.jp[0][i] * o.jl[0][j] + o.jp[1][i] * o.jl[1][j];
          for (int r = 0; r < 2; ++r)
            for (int i = 0; i < 6; ++i) rec[R_JP + 6 * r + i] = o.jp[r][i];
          rec[R_R] = o.ro[0];
          rec[R_R + 1] = o.ro[1];
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
          for (int i = 0; i < 9; ++i) inv[i] = adj[i] / det;
        } else {
          for (int i = 0; i < 9; ++i) inv[i] = (i % 4 == 0) ? 1.0f : 0.0f;
        }
        for (int kk = 0; kk < k; ++kk) {
          if (!((mask >> kk) & 1u)) continue;
          float* rec = g_rec + (static_cast<size_t>(kk) * l + li) * REC;
          for (int i = 0; i < 6; ++i) {
            const float h0 = rec[R_HPL + 3 * i], h1 = rec[R_HPL + 3 * i + 1],
                        h2 = rec[R_HPL + 3 * i + 2];
            for (int j = 0; j < 3; ++j)
              rec[R_W + 3 * i + j] = h0 * inv[j] + h1 * inv[3 + j] + h2 * inv[6 + j];
          }
        }
        float* lr = g_lrec + static_cast<size_t>(li) * LREC;
        for (int i = 0; i < 9; ++i) {
          lr[L_HLL + i] = hll[i];
          lr[L_HINV + i] = inv[i];
        }
        for (int i = 0; i < 3; ++i) lr[L_GL + i] = gl[i];
        lr[L_OBS] = observed ? 1.0f : 0.0f;
        reinterpret_cast<unsigned*>(lr)[L_MASK] = mask;
      } else if (item < l + f_n * 30) {
        // an IMU factor's 15 rows, tangent column col of its two slots
        const int f = (item - l) / 30, col = (item - l) % 30;
        Dual xi[16], xj[16];
        seeded_slot(cur + SLOT * f, 0, col, xi + S_P, xi + S_Q, xi + S_V, xi + S_BG, xi + S_BA);
        seeded_slot(cur + SLOT * (f + 1), 15, col, xj + S_P, xj + S_Q, xj + S_V, xj + S_BG,
                    xj + S_BA);
        Dual out[15];
        imu_rows<Dual>(a, f, xi + S_P, xi + S_Q, xi + S_V, xi + S_BG, xi + S_BA, xj + S_P,
                       xj + S_Q, xj + S_V, xj + S_BG, xj + S_BA, out);
        const bool ok = a.pre_valid[f] && a.kf_valid[f] && a.kf_valid[f + 1];
        float* jf = sm + L.jimu + f * 450;
        for (int r = 0; r < 15; ++r) jf[30 * r + col] = ok ? out[r].d : 0.0f;
        if (col == 0)
          for (int r = 0; r < 15; ++r) sm[L.rc + 15 * f + r] = ok ? out[r].v : 0.0f;
      } else if (item < l + f_n * 30 + 3 * k) {
        // a slot's bias rows and prior difference (c == 0), and its D column c
        const int kk = (item - l - f_n * 30) / 3, c = (item - l - f_n * 30) % 3;
        const float* s = cur + SLOT * kk;
        Dual qk[4];
        if (c == 0) {
          const int o = 15 * f_n + 4;
          const float m = a.kf_valid[kk] ? 1.0f : 0.0f;
          for (int i = 0; i < 3; ++i) {
            sm[L.rc + o + 3 * kk + i] = ((s[S_BA + i] + 0.0f) * m) * a.ba_prior_weight;
            sm[L.rc + o + 3 * k + 3 * kk + i] = ((s[S_BG + i] + 0.0f) * m) * a.bg_prior_weight;
          }
        }
        if (a.n_prior) {
          seeded_rotation(s + S_Q, c, qk);
          float pq[4];
          qconj(a.prior_q + 4 * kk, pq);
          Dual t[4], rel[3];
          qmul(pq, qk, t);
          so3_log(t, rel);
          float* dm = sm + L.dmat + 9 * kk;
          for (int r = 0; r < 3; ++r) dm[3 * r + c] = rel[r].d;
          if (c == 0) {
            float* cld = sm + L.cld;
            for (int i = 0; i < 3; ++i) {
              cld[3 * kk + i] = (s[S_P + i] + 0.0f) - a.prior_p[3 * kk + i];
              cld[3 * k + 3 * kk + i] = rel[i].v;
              cld[6 * k + 3 * kk + i] = (s[S_V + i] + 0.0f) - a.prior_v[3 * kk + i];
              cld[9 * k + 3 * kk + i] = (s[S_BG + i] + 0.0f) - a.prior_bg[3 * kk + i];
              cld[12 * k + 3 * kk + i] = (s[S_BA + i] + 0.0f) - a.prior_ba[3 * kk + i];
            }
          }
        }
      } else {
        // the yaw anchor, tangent column c of slot 0's rotation
        const int c = item - l - f_n * 30 - 3 * k;
        Dual q0[4];
        seeded_rotation(cur + S_Q, c, q0);
        const Dual y = yaw_err<Dual>(q0, a.anchor_yaw[0]) * a.anchor_weight;
        sm[L.jy + c] = y.d;
        if (c == 0) {
          const int o = 15 * f_n;
          for (int i = 0; i < 3; ++i)
            sm[L.rc + o + i] = ((cur[S_P + i] + 0.0f) - a.anchor_p[i]) * a.anchor_weight;
          sm[L.rc + o + 3] = y.v;
        }
      }
    }
    __syncthreads();

    // --- the prior's rows at retract(st, 0), then u = j^T r_p
    float* rp = sm + L.rc + np;
    if (tid < a.n_prior) {
      const float* jr = a.prior_j + static_cast<size_t>(tid) * n;
      const float* cld = sm + L.cld;
      float s = jr[0] * cld[0];
      for (int c = 1; c < n; ++c) s = s + jr[c] * cld[c];
      rp[tid] = s + a.prior_r0[tid];
    }
    __syncthreads();
    if (a.n_prior && tid < n) {
      float s = 0.0f;
      for (int p = 0; p < a.n_prior; ++p) s = s + a.prior_j[static_cast<size_t>(p) * n + tid] * rp[p];
      sm[L.u + tid] = s;
    }

    // --- the sums over landmarks, in landmark order from +0: the landmarks
    // that some keyframe observes listed in index order (the others add
    // nothing), then tiles of them staged in shared memory
    int* list = reinterpret_cast<int*>(a.scratch + L.g_list);
    int n_obs = 0;
    {
      const int lane = tid & 31, warp = tid >> 5;
      int* counts = reinterpret_cast<int*>(sm + L.red);
      for (int base = 0; base < l; base += THREADS) {
        const int li = base + tid;
        const bool seen = li < l &&
            reinterpret_cast<const unsigned*>(g_lrec + static_cast<size_t>(li) * LREC)[L_MASK];
        const unsigned ballot = __ballot_sync(CVIDS_FULL_MASK, seen);
        if (lane == 0) counts[warp] = __popc(ballot);
        __syncthreads();
        int before = n_obs;
        for (int w = 0; w < warp; ++w) before += counts[w];
        if (seen) list[before + __popc(ballot & ((1u << lane) - 1u))] = li;
        for (int w = 0; w < 32; ++w) n_obs += counts[w];
        __syncthreads();
      }
    }
    {
      const int n_tasks = n_low + pose;
      float acc0[MAX_TASKS], acc1[MAX_TASKS];
#pragma unroll
      for (int j = 0; j < MAX_TASKS; ++j) acc0[j] = acc1[j] = 0.0f;
      float* tile = sm + L.tile;
      float* tgl = sm + L.tile_gl;
      unsigned* tmask = reinterpret_cast<unsigned*>(sm + L.tile_mask);
      for (int l0 = 0; l0 < n_obs; l0 += TL) {
        const int nl = min(TL, n_obs - l0);
        for (int i = tid; i < k * nl * (REC / 4); i += THREADS) {
          const int q4 = i % (REC / 4), rest = i / (REC / 4), lt = rest % nl, kk = rest / nl;
          reinterpret_cast<float4*>(tile + kk * KSTRIDE + lt * REC)[q4] =
              reinterpret_cast<const float4*>(
                  g_rec + (static_cast<size_t>(kk) * l + list[l0 + lt]) * REC)[q4];
        }
        for (int i = tid; i < nl; i += THREADS) {
          const float* lr = g_lrec + static_cast<size_t>(list[l0 + i]) * LREC;
          for (int c = 0; c < 3; ++c) tgl[3 * i + c] = lr[L_GL + c];
          tmask[i] = reinterpret_cast<const unsigned*>(lr)[L_MASK];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < MAX_TASKS; ++j) {
          const int t = tid + j * THREADS;
          if (t < n_low) {
            int pi, pj, ki, ai, kj, aj;
            lower_pair(t, pi, pj);
            pose_of(pi, k, ki, ai);
            pose_of(pj, k, kj, aj);
            const unsigned both = (1u << ki) | (1u << kj);
            for (int lt = 0; lt < nl; ++lt) {
              if ((tmask[lt] & both) != both) continue;
              const float* wi = tile + ki * KSTRIDE + lt * REC + R_W + 3 * ai;
              const float* hj = tile + kj * KSTRIDE + lt * REC + R_HPL + 3 * aj;
              acc0[j] = acc0[j] + (wi[0] * hj[0] + wi[1] * hj[1] + wi[2] * hj[2]);
              if (ki == kj) {
                const float* jp = tile + ki * KSTRIDE + lt * REC + R_JP;
                acc1[j] = acc1[j] + (jp[ai] * jp[aj] + jp[6 + ai] * jp[6 + aj]);
              }
            }
          } else if (t < n_tasks) {
            int ki, ai;
            pose_of(t - n_low, k, ki, ai);
            for (int lt = 0; lt < nl; ++lt) {
              if (!((tmask[lt] >> ki) & 1u)) continue;
              const float* rec = tile + ki * KSTRIDE + lt * REC;
              acc0[j] = acc0[j] + (rec[R_JP + ai] * rec[R_R] + rec[R_JP + 6 + ai] * rec[R_R + 1]);
              const float* w = rec + R_W + 3 * ai;
              const float* gl = tgl + 3 * lt;
              acc1[j] = acc1[j] + (w[0] * gl[0] + w[1] * gl[1] + w[2] * gl[2]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < MAX_TASKS; ++j) {
        const int t = tid + j * THREADS;
        if (t < n_low) {
          sm[L.s_low + t] = acc0[j];
          sm[L.hpp_low + t] = acc1[j];
        } else if (t < n_tasks) {
          sm[L.gp + t - n_low] = acc0[j];
          sm[L.corr + t - n_low] = acc1[j];
        }
      }
    }
    __syncthreads();

    // --- the reduced camera system's lower triangle, h_cc, the gradient
    {
      const float* jimu = sm + L.jimu;
      const float* rc = sm + L.rc;
      const float* dm = sm + L.dmat;
      const float* jy = sm + L.jy;
      const float aw = a.anchor_weight;
      for (int t = tid; t < n * (n + 1) / 2; t += THREADS) {
        int i, j;
        lower_pair(t, i, j);
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
              ad[r] = g_a[(r0 + r) * n + c0] * dj[cj] + g_a[(r0 + r) * n + c0 + 1] * dj[3 + cj] +
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
        int pki = 0, pai = 0, pkj = 0, paj = 0;
        if (both_pose) {
          pose_of(i, k, pki, pai);
          pose_of(j, k, pkj, paj);
          if (pki == pkj) h = h + sm[L.hpp_low + t];
        }
        g_hcc[i * n + j] = h;
        g_hcc[j * n + i] = h;
        if (i == j) h = h + lam * (h + F(1e-6));
        if (both_pose) h = h - sm[L.s_low + t];
        chol[i * n + j] = h;
      }
      if (tid < n) {
        const int i = tid, bi = i / (3 * k), si = (i % (3 * k)) / 3, ci = i % 3;
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
        if (i < pose) g = g + sm[L.gp + i];
        sm[L.g + i] = g;       // g_c
      }
    }
    __syncthreads();
    if (tid < n) {
      sm[L.d + tid] = 1.0f / sqrtf(chol[tid * n + tid] + F(1e-12));
    }
    __syncthreads();
    {
      const float* d = sm + L.d;
      for (int t = tid; t < n * (n + 1) / 2; t += THREADS) {
        int i, j;
        lower_pair(t, i, j);
        chol[i * n + j] = (chol[i * n + j] * d[i]) * d[j];
      }
      if (tid < n) {
        const float g_red = tid < pose ? sm[L.g + tid] - sm[L.corr + tid] : sm[L.g + tid];
        chol[n * n + tid] = -(g_red * d[tid]);
      }
      if (tid == 0) misc[M_FAIL] = 0.0f;
    }
    __syncthreads();

    // --- Cholesky, the right-hand side as row n (the forward substitution)
    float* diag = sm + L.u;     // L_jj (u is not needed past here)
    for (int j = 0; j < n; ++j) {
      const float ajj = chol[j * n + j];
      const float ljj = sqrtf(ajj);
      if (tid == 0) {
        if (!(ajj > 0.0f)) misc[M_FAIL] = 1.0f;
        diag[j] = ljj;
      }
      for (int i = j + 1 + tid; i <= n; i += THREADS) chol[i * n + j] = chol[i * n + j] / ljj;
      __syncthreads();
      // thread t: row j + 1 + t / 8 (+ 128 a pass), every 8th column from
      // j + 1 + t % 8, four updates in flight
      for (int i = j + 1 + (tid >> 3); i <= n; i += THREADS / 8) {
        const float lij = chol[i * n + j];
        const int kend = i < n ? i : n - 1;
#pragma unroll 4
        for (int kc = j + 1 + (tid & 7); kc <= kend; kc += 8)
          chol[i * n + kc] = chol[i * n + kc] - lij * chol[kc * n + j];
      }
      __syncthreads();
    }
    // --- the back substitution by one warp, lane r holding y[r + 32 m] in
    // registers, row j's entries loaded before x_j is; then dc = d x
    if (tid < 32) {
      constexpr int NS = MAX_K * 15 / 32 + 1;
      const float* y_in = chol + n * n;
      float y[NS];
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const int i = tid + 32 * m;
        y[m] = i < n ? y_in[i] : 0.0f;
      }
      for (int j = n - 1; j >= 0; --j) {
        const float* lrow = chol + j * n;
        float lv[NS];
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          const int i = tid + 32 * m;
          lv[m] = i < j ? lrow[i] : 0.0f;
        }
        const float dj = diag[j];
        const int mj = j >> 5;
        float yj = 0.0f;
#pragma unroll
        for (int m = 0; m < NS; ++m)
          if (m == mj) yj = y[m];
        const float xj = __shfl_sync(CVIDS_FULL_MASK, yj, j & 31) / dj;
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          const int i = tid + 32 * m;
          if (i < j) y[m] = y[m] - lv[m] * xj;
          else if (i == j) y[m] = xj;
        }
      }
      const bool fail = misc[M_FAIL] != 0.0f;
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const int i = tid + 32 * m;
        if (i < n) sm[L.dc + i] = sm[L.d + i] * (fail ? __int_as_float(0x7fc00000) : y[m]);
      }
    }
    __syncthreads();

    // --- the step: camera states, landmarks, the predicted reduction's parts
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
      float part[5] = {0.f, 0.f, 0.f, 0.f, 0.f};   // g_c dc, dc h_cc dc, g_l dl, u dl, dl H_ll dl
      if (tid < n) {
        part[0] = part[0] + sm[L.g + tid] * dc[tid];
        const float* hr = g_hcc + static_cast<size_t>(tid) * n;
        float hd = hr[0] * dc[0];
        for (int j = 1; j < n; ++j) hd = hd + hr[j] * dc[j];
        part[1] = part[1] + dc[tid] * hd;
      }
      for (int li = tid; li < l; li += THREADS) {
        const float* lr = g_lrec + static_cast<size_t>(li) * LREC;
        const unsigned mask = reinterpret_cast<const unsigned*>(lr)[L_MASK];
        float u[3] = {0.f, 0.f, 0.f};
        for (int kk = 0; kk < k; ++kk) {
          if (!((mask >> kk) & 1u)) continue;
          const float* hp = g_rec + (static_cast<size_t>(kk) * l + li) * REC + R_HPL;
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
      }
      block_sums<5>(part, sm + L.red);
      if (tid == 0) {
        const float* red = sm + L.red;
        misc[M_PRED] = -(red[0] + red[64]) - 0.5f * (red[32] + 2.0f * red[96] + red[128]);
      }
      __syncthreads();
    }

    // --- the cost at the step, and the Levenberg-Marquardt update
    const float cost_new = state_cost(a, L, sm, nxt, g_lm);
    if (tid == 0) {
      const float cost = misc[M_COST], pred = misc[M_PRED], lam0 = misc[M_LAM];
      const bool accept = cost_new < cost;
      const float rho = (cost - cost_new) / clamp_lo(pred, F(1e-12));
      const float t = 2.0f * rho - 1.0f;
      const float shrink = clamp_lo(1.0f - t * t * t, F(1.0 / 3.0));
      misc[M_LAM] = accept ? clamp_lo(lam0 * shrink, F(1e-10)) : clamp_hi(lam0 * 4.0f, F(1e8));
      misc[M_COST] = accept ? cost_new : cost;
      misc[M_ACCEPT] = accept ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (misc[M_ACCEPT] != 0.0f) {
      if (tid < SLOT * k) cur[tid] = nxt[tid];
      for (int i = tid; i < 3 * l; i += THREADS) a.out_lm[i] = g_lm[i];
    }
    __syncthreads();
  }

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

}  // namespace

// ptrs: the 42 device pointers of the solve in the order of
// `cuda_kernels.window_lm` (the state, the measurements, the prior or nulls,
// the outputs, the scratch); ints: k (1-12), l, the prior's rows (0: none,
// at most 15k + 1), iters, the scratch's floats; floats: init_lambda,
// anchor_weight, pix_weight, huber_delta, bias_weight, ba_prior_weight,
// bg_prior_weight. One block of 1024 threads.
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
  window_lm_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// what a solve of k keyframes, l landmark slots and a prior of n_prior rows
// takes, without launching: plan[0..2] = dynamic shared memory bytes,
// scratch floats, threads
extern "C" int cvids_window_lm_plan(int k, int l, int n_prior, int* plan) {
  if (plan == nullptr || k < 1 || k > MAX_K || l < 0 || n_prior < 0 || n_prior > 15 * k + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(k, l, n_prior);
  plan[0] = lay.total * static_cast<int>(sizeof(float));
  plan[1] = lay.g_total;
  plan[2] = THREADS;
  return 0;
}

// Pyramidal Lucas-Kanade tracking of a batch of points from one image to the
// next, forward and (optionally) back with the forward-backward gate, in one
// launch.
//
// No Pallas counterpart: the JAX package compiles `track_points`
// (cvids_tpu/ops/klt.py:35-152) into one XLA program; the port ran the same
// maths as ~40 small launches an LK iteration, ~8,200 kernels a front-end
// frame at 4 levels x 15 iterations forward and back. This kernel computes
// what `cuda_kernels.klt_track_twin` computes; built with -fmad=false, the two
// agree bit for bit.
//
// Per point and direction (from image A to image B; back: from B to A,
// starting at the forward result and seeded at the start point), from the
// coarsest level to the finest, with scale = 2^level and the window's pixel
// i at offset (i % (2r+1) - r, i / (2r+1) - r), P = (2r+1)^2 pixels:
// - the template t and the half-pixel central differences gx, gy, sampled
//   bilinearly in level `level` of A at xy0 / scale + offset;
// - the Gram sums gxx, gxy, gyy and the template's sum; det, trace, the
//   smaller eigenvalue (trace - sqrt(max(trace^2 - 4 det, 0))) / 2, the
//   condition test eigenvalue / P > min_eig, inv_det = 1 / det where |det| >
//   1e-12, else 0;
// - `iters` Gauss-Newton steps on the flow: w sampled in B at (xy0 / scale +
//   flow / scale) + offset, the mean of w, then e = (w - mean w) - (t - mean
//   t), then the projections bx = sum gx e, by = sum gy e (two sums over the
//   window an iteration), then dx = inv_det (gyy bx - gxy by), dy = inv_det
//   (-gxy bx + gxx by), flow -= (dx, dy) scale;
// - the level's mean |w - t| at the final flow.
// Then xy1 = xy0 + flow; the point stays valid if it was, lies at least r
// pixels inside level 0, was conditioned at every level and its residual is
// below max_residual. With the gate, `valid` also needs the backward track's
// validity and sqrt(dx dx + dy dy) < fb_thresh for its distance to xy0. A
// sample outside [0, w-1] x [0, h-1] is 0; its taps are clamped to the image
// (the formula of ops/image.bilinear_sample).
//
// The order of every sum over the window, shared with the twin:
// - lane l of the point's warp adds the terms of pixels l, l + 32, l + 64, ...
//   in increasing order to 0.0f, a pixel index >= P adding 0.0f
//   (ceil(P / 32) terms a lane, 14 at radius 10);
// - the 32 partial sums are combined by an xor butterfly with offsets 16, 8,
//   4, 2, 1: each lane adds the other lane's value to its own, so lane l < o
//   holds s[l] + s[l + o], the twin's halving add (IEEE addition is
//   commutative, so every lane ends with the same bits);
// - a mean is that sum * (1.0f / (float)P), and the eigenvalue test scales
//   by the same reciprocal: the reference's compiled program multiplies by
//   the float32 reciprocal of the window size (XLA rewrites a division by a
//   constant so), and the step is the reference's algebra, not the 2x2
//   inverse as a matrix. Every other division is an IEEE division.
//
// Bound on the card: the serial chain, not bytes or operations. The front-end
// tracks ~150 points through 2 directions x 4 levels x 15 iterations; each
// iteration is a round of dependent samples (gathers from L2-resident
// pyramids, ~3.9 MB at 752x480) and two butterflies, ~120 dependent rounds a
// point, against ~0.4 GFLOP and ~4 MB for the whole batch (a few
// microseconds at the card's peaks, about the launch floor). The design is
// the simple one: one warp (one block) a point, so 150 points are 150 warps
// spread over the 132 SMs and the launch is latency-bound; the template, its
// gradients and the iteration's samples sit in shared memory, each lane
// reading back only its own slots (no barrier); the pyramids are read
// through the read-only cache. Both directions and the gate run in the same
// warp, so a front-end frame's tracking is one launch.

#include "common.cuh"

namespace {

constexpr int KLT_THREADS = 32;      // one warp a point
constexpr int KLT_MAX_LEVELS = 8;
constexpr int KLT_MAX_RADIUS = 24;   // 2401 pixels, 76 a lane, 38.9 KB of shared memory

struct Pyramids {
  const float* a[KLT_MAX_LEVELS];    // image A's levels, (h[l], w[l]) each
  const float* b[KLT_MAX_LEVELS];    // image B's, the same shapes
  int h[KLT_MAX_LEVELS];
  int w[KLT_MAX_LEVELS];
  int levels;
};

struct Track {
  float x, y, residual;
  bool valid;
};

// window pixels a lane owns
__host__ __device__ constexpr int klt_cols(int radius) {
  return ((2 * radius + 1) * (2 * radius + 1) + KLT_THREADS - 1) / KLT_THREADS;
}

// four per-lane arrays of klt_cols(radius) * 32 floats: t, gx, gy, w
__host__ __device__ constexpr int klt_smem_bytes(int radius) {
  return 4 * klt_cols(radius) * KLT_THREADS * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(CVIDS_FULL_MASK, v, o);
  return v;
}

// bilinear sample of an (h, w) image at (x, y): ops/image.bilinear_sample's
// operations in its order; 0 outside [0, w-1] x [0, h-1]
__device__ __forceinline__ float sample(const float* __restrict__ img, int h, int w, float x,
                                        float y) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  // the floor, saturated into int range (the taps are clamped to the image
  // anyway; a NaN lands on -1 and reads pixel 0, and the inside test fails)
  const int xi = static_cast<int>(fminf(fmaxf(x0, -1.0f), static_cast<float>(w)));
  const int yi = static_cast<int>(fminf(fmaxf(y0, -1.0f), static_cast<float>(h)));
  const int c0 = min(max(xi, 0), w - 1);
  const int c1 = min(max(xi + 1, 0), w - 1);
  const int r0 = min(max(yi, 0), h - 1) * w;
  const int r1 = min(max(yi + 1, 0), h - 1) * w;
  const float v00 = __ldg(img + r0 + c0);
  const float v01 = __ldg(img + r0 + c1);
  const float v10 = __ldg(img + r1 + c0);
  const float v11 = __ldg(img + r1 + c1);
  const float gx = 1.0f - fx;
  const float top = v00 * gx + v01 * fx;
  const float bot = v10 * gx + v11 * fx;
  const float out = top * (1.0f - fy) + bot * fy;
  const bool inside = x >= 0.0f && x <= static_cast<float>(w - 1) && y >= 0.0f &&
                      y <= static_cast<float>(h - 1);
  return inside ? out : 0.0f;
}

// one direction for one point, run by the whole warp; every lane returns the
// same result
__device__ Track track_direction(const Pyramids& pyr, bool forward, float x0, float y0,
                                 float init_x, float init_y, bool valid0, int radius,
                                 int iters, float max_residual, float min_eig, float* T,
                                 float* GX, float* GY, float* WS, int lane) {
  const int side = 2 * radius + 1;
  const int n_pix = side * side;
  const int cols = klt_cols(radius);
  const float inv_pix = 1.0f / static_cast<float>(n_pix);
  float flow_x = init_x - x0;
  float flow_y = init_y - y0;
  float residual = 0.0f;
  bool conditioned = true;
  for (int lvl = pyr.levels - 1; lvl >= 0; --lvl) {
    const float scale = static_cast<float>(1 << lvl);
    const float* i0 = forward ? pyr.a[lvl] : pyr.b[lvl];
    const float* i1 = forward ? pyr.b[lvl] : pyr.a[lvl];
    const int h = pyr.h[lvl];
    const int w = pyr.w[lvl];
    const float px = x0 / scale;
    const float py = y0 / scale;

    // template, gradients and their sums
    float s_t = 0.0f, s_xx = 0.0f, s_xy = 0.0f, s_yy = 0.0f;
    for (int k = 0; k < cols; ++k) {
      const int i = lane + KLT_THREADS * k;
      float t = 0.0f, gx = 0.0f, gy = 0.0f;
      if (i < n_pix) {
        const float cx = px + static_cast<float>(i % side - radius);
        const float cy = py + static_cast<float>(i / side - radius);
        t = sample(i0, h, w, cx, cy);
        gx = sample(i0, h, w, cx + 0.5f, cy) - sample(i0, h, w, cx - 0.5f, cy);
        gy = sample(i0, h, w, cx, cy + 0.5f) - sample(i0, h, w, cx, cy - 0.5f);
      }
      T[i] = t;
      GX[i] = gx;
      GY[i] = gy;
      s_t = s_t + t;
      s_xx = s_xx + gx * gx;
      s_xy = s_xy + gx * gy;
      s_yy = s_yy + gy * gy;
    }
    const float mean_t = warp_sum(s_t) * inv_pix;
    const float gxx = warp_sum(s_xx);
    const float gxy = warp_sum(s_xy);
    const float gyy = warp_sum(s_yy);
    const float det = gxx * gyy - gxy * gxy;
    const float trace = gxx + gyy;
    const float disc = trace * trace - 4.0f * det;
    const float mineig = (trace - sqrtf(disc < 0.0f ? 0.0f : disc)) * 0.5f;
    conditioned = conditioned && (mineig * inv_pix > min_eig);
    const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;

    for (int it = 0; it < iters; ++it) {
      const float qx = px + flow_x / scale;
      const float qy = py + flow_y / scale;
      float s_w = 0.0f;
      for (int k = 0; k < cols; ++k) {
        const int i = lane + KLT_THREADS * k;
        float wv = 0.0f;
        if (i < n_pix)
          wv = sample(i1, h, w, qx + static_cast<float>(i % side - radius),
                      qy + static_cast<float>(i / side - radius));
        WS[i] = wv;
        s_w = s_w + wv;
      }
      const float mean_w = warp_sum(s_w) * inv_pix;
      float s_bx = 0.0f, s_by = 0.0f;
      for (int k = 0; k < cols; ++k) {
        const int i = lane + KLT_THREADS * k;
        float ex = 0.0f, ey = 0.0f;
        if (i < n_pix) {
          const float e = (WS[i] - mean_w) - (T[i] - mean_t);
          ex = GX[i] * e;
          ey = GY[i] * e;
        }
        s_bx = s_bx + ex;
        s_by = s_by + ey;
      }
      const float bx = warp_sum(s_bx);
      const float by = warp_sum(s_by);
      const float dx = inv_det * (gyy * bx - gxy * by);
      const float dy = inv_det * (-gxy * bx + gxx * by);
      flow_x = flow_x - dx * scale;
      flow_y = flow_y - dy * scale;
    }

    const float qx = px + flow_x / scale;
    const float qy = py + flow_y / scale;
    float s_r = 0.0f;
    for (int k = 0; k < cols; ++k) {
      const int i = lane + KLT_THREADS * k;
      float r = 0.0f;
      if (i < n_pix)
        r = fabsf(sample(i1, h, w, qx + static_cast<float>(i % side - radius),
                         qy + static_cast<float>(i / side - radius)) -
                  T[i]);
      s_r = s_r + r;
    }
    residual = warp_sum(s_r) * inv_pix;
  }
  Track out;
  out.x = x0 + flow_x;
  out.y = y0 + flow_y;
  out.residual = residual;
  const float rf = static_cast<float>(radius);
  const bool inb = out.x >= rf && out.x <= static_cast<float>(pyr.w[0] - 1 - radius) &&
                   out.y >= rf && out.y <= static_cast<float>(pyr.h[0] - 1 - radius);
  out.valid = valid0 && inb && conditioned && residual < max_residual;
  return out;
}

__global__ void __launch_bounds__(KLT_THREADS)
klt_track_kernel(Pyramids pyr, const float* __restrict__ xy0, const bool* __restrict__ valid0,
                 const float* __restrict__ init_xy, float* __restrict__ xy_out,
                 bool* __restrict__ valid_out, float* __restrict__ residual_out, int radius,
                 int iters, float max_residual, float min_eig, float fb_thresh, int use_fb) {
  extern __shared__ float smem[];
  const int slots = klt_cols(radius) * KLT_THREADS;
  float* T = smem;
  float* GX = T + slots;
  float* GY = GX + slots;
  float* WS = GY + slots;
  const long p = blockIdx.x;
  const int lane = threadIdx.x;
  const float ax = xy0[2 * p], ay = xy0[2 * p + 1];
  const Track fwd = track_direction(pyr, true, ax, ay, init_xy[2 * p], init_xy[2 * p + 1],
                                    valid0[p], radius, iters, max_residual, min_eig, T, GX, GY,
                                    WS, lane);
  bool ok = fwd.valid;
  if (use_fb) {
    const Track back = track_direction(pyr, false, fwd.x, fwd.y, ax, ay, fwd.valid, radius,
                                       iters, max_residual, min_eig, T, GX, GY, WS, lane);
    const float dx = back.x - ax;
    const float dy = back.y - ay;
    ok = fwd.valid && back.valid && sqrtf(dx * dx + dy * dy) < fb_thresh;
  }
  if (lane == 0) {
    xy_out[2 * p] = fwd.x;
    xy_out[2 * p + 1] = fwd.y;
    valid_out[p] = ok;
    residual_out[p] = fwd.residual;
  }
}

int klt_plan(int n, int radius, int* plan) {
  if (n < 1 || radius < 0 || radius > KLT_MAX_RADIUS) return -1;
  plan[0] = KLT_THREADS;
  plan[1] = klt_cols(radius);
  plan[2] = klt_smem_bytes(radius);
  plan[3] = n;
  return 0;
}

}  // namespace

// pyr_a, pyr_b: `levels` (1-8) device pointers each, level l of both (h[l],
// w[l]) fp32, h, w >= 1 (host arrays, copied into the launch's arguments);
// xy0 and init_xy (n, 2) fp32, valid0 (n,) bool; xy_out (n, 2) fp32,
// valid_out (n,) bool, residual_out (n,) fp32. 0 <= radius <= 24, iters >= 0;
// use_fb: track back from B to A and gate by fb_thresh.
extern "C" int cvids_klt_track(const void* const* pyr_a, const void* const* pyr_b, const int* h,
                               const int* w, int levels, const void* xy0, const void* valid0,
                               const void* init_xy, void* xy_out, void* valid_out,
                               void* residual_out, int n, int radius, int iters,
                               float max_residual, float min_eig, float fb_thresh, int use_fb,
                               void* stream) {
  int plan[4];
  if (levels < 1 || levels > KLT_MAX_LEVELS || iters < 0 || klt_plan(n, radius, plan) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramids pyr = {};
  for (int l = 0; l < levels; ++l) {
    if (h[l] < 1 || w[l] < 1 || pyr_a[l] == nullptr || pyr_b[l] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    pyr.a[l] = static_cast<const float*>(pyr_a[l]);
    pyr.b[l] = static_cast<const float*>(pyr_b[l]);
    pyr.h[l] = h[l];
    pyr.w[l] = w[l];
  }
  pyr.levels = levels;
  klt_track_kernel<<<plan[3], plan[0], plan[2], static_cast<cudaStream_t>(stream)>>>(
      pyr, static_cast<const float*>(xy0), static_cast<const bool*>(valid0),
      static_cast<const float*>(init_xy), static_cast<float*>(xy_out),
      static_cast<bool*>(valid_out), static_cast<float*>(residual_out), radius, iters,
      max_residual, min_eig, fb_thresh, use_fb);
  return static_cast<int>(cudaGetLastError());
}

// what a launch over n points at `radius` takes, without launching:
// plan[0..3] = threads per block (one warp a point), window pixels a lane,
// dynamic shared memory bytes, blocks
extern "C" int cvids_klt_plan(int n, int radius, int* plan) {
  if (plan == nullptr || klt_plan(n, radius, plan) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

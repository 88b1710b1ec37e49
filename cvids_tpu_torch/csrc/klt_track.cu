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
// - lane l of the summing warp adds the terms of pixels l, l + 32, l + 64, ...
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
// Bound on the card: the chain of dependent rounds, not bytes or operations.
// The front-end tracks ~150 points through 2 directions x 4 levels x (15
// iterations + a template and a residual pass); each iteration is a round of
// samples (gathers from pyramids that stay in L2 and, a window at a time, in
// L1: ~3.9 MB at 752x480), then the window sums, then the step, which the
// next round's sample positions need: ~136 dependent rounds a point, against
// ~0.4 GFLOP and ~4 MB for the whole batch (a few microseconds at the card's
// peaks, about the launch floor). The design spreads a point's window over a
// block so that a round's gathers are all in flight at once, and keeps the
// sums in the order above:
// - one block a point, one thread a window pixel (the block is the window's
//   ceil(P / 32) * 32 slots, 448 threads at radius 10; above 1024 slots,
//   radius > 15, a thread takes slots t, t + 1024, ...). In each pass every
//   thread samples its pixel (the template and its two gradients, 5 samples;
//   an iteration's w; the residual's |w - t|) and stores it in shared memory,
//   so a round's ~1,800 taps are issued together by 14 warps instead of 14
//   dependent samples a lane;
// - after a barrier the first warp, the summing warp, adds the stored terms
//   in the order above (lane l: slots l, l + 32, ...; the products gx gx, gx
//   e, ... formed from the stored samples as the twin forms them), runs the
//   butterflies, computes the step and stores the new flow; after a second
//   barrier every thread reads it for the next round's positions. Only the
//   summing warp holds the Gram sums, the means, the condition test and the
//   residual; the start of the back direction is broadcast the same way;
// - the radius is a template parameter for the path's radius (10): the
//   summing warp's 14-slot loops unroll and their shared-memory loads issue
//   together; every other radius runs the same code with the radius at run
//   time (the same operations, the same bits). At the path's call the
//   run-time instance took 0.2427 ms against 0.1490-0.1502 templated
//   (PERF.md, PR 14).
// A round now costs one sampling pass (~40 instructions a thread, L1/L2
// latency once) and two barriers with the summing warp's sums between them:
// ~1.1 us a round, 0.149 ms a front-end call on an H100 (0.535 ms one warp a
// point; PERF.md). What bounds it now is the summing warp's two dependent
// 14-term sums and butterflies an iteration (the mean of w before the
// projections), which the fixed order keeps in one warp. 150 blocks of 448
// threads over 132 SMs, 7 KB of shared memory a block at radius 10.

#include "common.cuh"

namespace {

constexpr int KLT_LANES = 32;        // the summing warp's lanes
constexpr int KLT_MAX_THREADS = 1024;
constexpr int KLT_MAX_LEVELS = 8;
constexpr int KLT_MAX_RADIUS = 24;   // 2401 pixels, 76 slots a lane, 38.9 KB of shared memory

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

// window pixels a summing lane adds
__host__ __device__ constexpr int klt_cols(int radius) {
  return ((2 * radius + 1) * (2 * radius + 1) + KLT_LANES - 1) / KLT_LANES;
}

// a block's threads: one a slot, at most 1024
__host__ __device__ constexpr int klt_threads(int radius) {
  return klt_cols(radius) * KLT_LANES < KLT_MAX_THREADS ? klt_cols(radius) * KLT_LANES
                                                        : KLT_MAX_THREADS;
}

// four arrays of klt_cols(radius) * 32 floats: t, gx, gy and a pass's terms
__host__ __device__ constexpr int klt_smem_bytes(int radius) {
  return 4 * klt_cols(radius) * KLT_LANES * static_cast<int>(sizeof(float));
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

// the shared memory of a block: the window's template, gradients and a
// pass's terms, slot i of each for window pixel i (0 for i >= P); and the
// summing warp's broadcasts
struct Window {
  float* t;
  float* gx;
  float* gy;
  float* terms;
  float* bcast;
};

// one direction for one point, run by the whole block; the summing warp's
// lanes return the result (the other threads' is not defined)
template <int R>
__device__ Track track_direction(const Pyramids& pyr, bool forward, float x0, float y0,
                                 float init_x, float init_y, bool valid0, int radius_rt,
                                 int iters, float max_residual, float min_eig, const Window& win) {
  const int radius = R >= 0 ? R : radius_rt;
  const int side = 2 * radius + 1;
  const int n_pix = side * side;
  constexpr int COLS = R >= 0 ? klt_cols(R) : 0;
  const int cols = R >= 0 ? COLS : klt_cols(radius);
  const int slots = cols * KLT_LANES;
  const int nthreads = R >= 0 ? klt_threads(R) : static_cast<int>(blockDim.x);
  const int tid = threadIdx.x;
  const bool summing = tid < KLT_LANES;
  const int lane = tid;
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

    // template and gradients, a pixel a thread
    for (int i = tid; i < slots; i += nthreads) {
      float t = 0.0f, gx = 0.0f, gy = 0.0f;
      if (i < n_pix) {
        const float cx = px + static_cast<float>(i % side - radius);
        const float cy = py + static_cast<float>(i / side - radius);
        t = sample(i0, h, w, cx, cy);
        gx = sample(i0, h, w, cx + 0.5f, cy) - sample(i0, h, w, cx - 0.5f, cy);
        gy = sample(i0, h, w, cx, cy + 0.5f) - sample(i0, h, w, cx, cy - 0.5f);
      }
      win.t[i] = t;
      win.gx[i] = gx;
      win.gy[i] = gy;
    }
    __syncthreads();
    float mean_t = 0.0f, gxx = 0.0f, gxy = 0.0f, gyy = 0.0f, inv_det = 0.0f;
    if (summing) {
      float s_t = 0.0f, s_xx = 0.0f, s_xy = 0.0f, s_yy = 0.0f;
#pragma unroll(R >= 0 ? klt_cols(R) : 4)
      for (int k = 0; k < cols; ++k) {
        const int i = lane + KLT_LANES * k;
        const float t = win.t[i], gx = win.gx[i], gy = win.gy[i];
        s_t = s_t + t;
        s_xx = s_xx + gx * gx;
        s_xy = s_xy + gx * gy;
        s_yy = s_yy + gy * gy;
      }
      mean_t = warp_sum(s_t) * inv_pix;
      gxx = warp_sum(s_xx);
      gxy = warp_sum(s_xy);
      gyy = warp_sum(s_yy);
      const float det = gxx * gyy - gxy * gxy;
      const float trace = gxx + gyy;
      const float disc = trace * trace - 4.0f * det;
      const float mineig = (trace - sqrtf(disc < 0.0f ? 0.0f : disc)) * 0.5f;
      conditioned = conditioned && (mineig * inv_pix > min_eig);
      inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
    }

    for (int it = 0; it < iters; ++it) {
      const float qx = px + flow_x / scale;
      const float qy = py + flow_y / scale;
      for (int i = tid; i < slots; i += nthreads) {
        float wv = 0.0f;
        if (i < n_pix)
          wv = sample(i1, h, w, qx + static_cast<float>(i % side - radius),
                      qy + static_cast<float>(i / side - radius));
        win.terms[i] = wv;
      }
      __syncthreads();
      if (summing) {
        float s_w = 0.0f;
#pragma unroll(R >= 0 ? klt_cols(R) : 4)
        for (int k = 0; k < cols; ++k) s_w = s_w + win.terms[lane + KLT_LANES * k];
        const float mean_w = warp_sum(s_w) * inv_pix;
        float s_bx = 0.0f, s_by = 0.0f;
#pragma unroll(R >= 0 ? klt_cols(R) : 4)
        for (int k = 0; k < cols; ++k) {
          const int i = lane + KLT_LANES * k;
          float ex = 0.0f, ey = 0.0f;
          if (i < n_pix) {
            const float e = (win.terms[i] - mean_w) - (win.t[i] - mean_t);
            ex = win.gx[i] * e;
            ey = win.gy[i] * e;
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
        if (lane == 0) {
          win.bcast[0] = flow_x;
          win.bcast[1] = flow_y;
        }
      }
      __syncthreads();
      flow_x = win.bcast[0];
      flow_y = win.bcast[1];
    }

    // the residual's terms |w - t|, a pixel a thread (each thread reads back
    // only its own template slots)
    const float qx = px + flow_x / scale;
    const float qy = py + flow_y / scale;
    for (int i = tid; i < slots; i += nthreads) {
      float r = 0.0f;
      if (i < n_pix)
        r = fabsf(sample(i1, h, w, qx + static_cast<float>(i % side - radius),
                         qy + static_cast<float>(i / side - radius)) -
                  win.t[i]);
      win.terms[i] = r;
    }
    __syncthreads();
    if (summing) {
      float s_r = 0.0f;
#pragma unroll(R >= 0 ? klt_cols(R) : 4)
      for (int k = 0; k < cols; ++k) s_r = s_r + win.terms[lane + KLT_LANES * k];
      residual = warp_sum(s_r) * inv_pix;
    }
    // the next level's template pass writes t, gx, gy, which the summing warp
    // no longer reads; its first iteration writes the terms only after the
    // template's barrier, which the summing warp reaches after this sum
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

template <int R>
__global__ void __launch_bounds__(R >= 0 ? klt_threads(R) : KLT_MAX_THREADS)
klt_track_kernel(Pyramids pyr, const float* __restrict__ xy0, const bool* __restrict__ valid0,
                 const float* __restrict__ init_xy, float* __restrict__ xy_out,
                 bool* __restrict__ valid_out, float* __restrict__ residual_out, int radius,
                 int iters, float max_residual, float min_eig, float fb_thresh, int use_fb) {
  extern __shared__ float smem[];
  __shared__ float bcast[3];
  const int slots = klt_cols(R >= 0 ? R : radius) * KLT_LANES;
  const Window win = {smem, smem + slots, smem + 2 * slots, smem + 3 * slots, bcast};
  const long p = blockIdx.x;
  const int tid = threadIdx.x;
  const float ax = xy0[2 * p], ay = xy0[2 * p + 1];
  const Track fwd = track_direction<R>(pyr, true, ax, ay, init_xy[2 * p], init_xy[2 * p + 1],
                                       valid0[p], radius, iters, max_residual, min_eig, win);
  bool ok = fwd.valid;
  if (use_fb) {
    // the back direction starts where the forward one ended: the summing
    // warp's result, broadcast (after the barrier that ends its last
    // iteration, every thread has read the flow, so bcast is free)
    __syncthreads();
    if (tid == 0) {
      bcast[0] = fwd.x;
      bcast[1] = fwd.y;
      bcast[2] = fwd.valid ? 1.0f : 0.0f;
    }
    __syncthreads();
    const float fx = bcast[0], fy = bcast[1];
    const bool fvalid = bcast[2] != 0.0f;
    const Track back = track_direction<R>(pyr, false, fx, fy, ax, ay, fvalid, radius, iters,
                                          max_residual, min_eig, win);
    const float dx = back.x - ax;
    const float dy = back.y - ay;
    ok = fwd.valid && back.valid && sqrtf(dx * dx + dy * dy) < fb_thresh;
  }
  if (tid == 0) {
    xy_out[2 * p] = fwd.x;
    xy_out[2 * p + 1] = fwd.y;
    valid_out[p] = ok;
    residual_out[p] = fwd.residual;
  }
}

int klt_plan(int n, int radius, int* plan) {
  if (n < 1 || radius < 0 || radius > KLT_MAX_RADIUS) return -1;
  plan[0] = klt_threads(radius);
  plan[1] = klt_cols(radius);
  plan[2] = klt_smem_bytes(radius);
  plan[3] = n;
  return 0;
}

// the path's radius, compiled with its loops unrolled
constexpr int KLT_PATH_RADIUS = 10;

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
  const auto st = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto kernel) {
    kernel<<<plan[3], plan[0], plan[2], st>>>(
        pyr, static_cast<const float*>(xy0), static_cast<const bool*>(valid0),
        static_cast<const float*>(init_xy), static_cast<float*>(xy_out),
        static_cast<bool*>(valid_out), static_cast<float*>(residual_out), radius, iters,
        max_residual, min_eig, fb_thresh, use_fb);
  };
  if (radius == KLT_PATH_RADIUS)
    args(klt_track_kernel<KLT_PATH_RADIUS>);
  else
    args(klt_track_kernel<-1>);
  return static_cast<int>(cudaGetLastError());
}

// what a launch over n points at `radius` takes, without launching:
// plan[0..3] = threads per block (one a window slot, at most 1024), window
// pixels a summing lane adds, dynamic shared memory bytes, blocks (one a
// point)
extern "C" int cvids_klt_plan(int n, int radius, int* plan) {
  if (plan == nullptr || klt_plan(n, radius, plan) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

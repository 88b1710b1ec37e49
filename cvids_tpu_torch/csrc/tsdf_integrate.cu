// TSDF integration of one depth + colour frame into M chunks of the chunk
// pool, in place.
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's
// compiled TSDF program, _integrate_kernel (cvids_tpu/mapping/tsdf.py:70-146,
// jax.jit with the pool donated), which the port ran as ~40 eager launches
// over (M, S^3, 3) temporaries and three index_copy_. Per voxel of a chunk
// (ProjectionIntegrator::IntegrateColor's voxel-centroid projection): the
// centre to the camera (R_cw c + t_cw), projected by K, rounded to the
// nearest pixel (half to even); where it lands in the image with a depth in
// (min_depth, max_depth), the signed distance d - z within the truncation
// band tau = trunc + tq d^2 updates sdf, weight and colour as a running
// mean (weight capped at max_weight), and with carving a voxel in front of
// the band loses carve_weight (its sdf reset to 0 when its weight reaches 0).
//
// Bound on the card: bytes. Every voxel's sdf and weight are read (8
// bytes); a voxel in the band reads its colour and writes sdf, weight and
// colour (32 more), a carved voxel writes its weight (and its sdf when it
// empties); depth and colour are read from the image as stored (a stride-0
// grey colour is 4 bytes a pixel), at most one sample a pixel; ~55
// operations a voxel and ~27 more an updated one. A published map of the
// whole-server run (~240 chunks of 8^3, ~30 % of the voxels in the band)
// moves ~3 MB, ~1 us at 3.35 TB/s, under the ~5 us launch floor.
// The design is the simple one:
// - one block a chunk, one thread a voxel, a loop over the chunk's voxels
//   when S^3 exceeds the block; M is an argument, so a map of any size is
//   one launch (no capture tiers, no padded batches);
// - the slots (int64), chunk coordinates (int32), K, R_cw and t_cw are read
//   from device memory: nothing comes back to the host;
// - depth and colour are read through their strides (the server passes its
//   grey reference image expanded to three channels, a stride-0 view);
// - each voxel's sdf, weight and colour are read and written by its own
//   thread, so the slots must be distinct (the wrapper's contract); its
//   words are stored only where they change.
// Arithmetic: the twin's (cuda_kernels.tsdf_integrate_twin), in the twin's
// order: explicit three-term sums for R c + t and K p, rintf (half to
// even), the float clamp before the integer cast, IEEE divisions, no FMA
// contraction (-fmad=false), so the two agree bit for bit.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // voxels a block works on at once

struct TsdfParams {
  float vx;            // voxel size
  float s_vx;          // chunk size * voxel size, rounded once from double
  float trunc;         // trunc_scale * voxel size, rounded once from double
  float tq;            // trunc_quad
  float min_depth, max_depth, max_weight, carve_weight;
  int carving;
};

// torch.clamp's min and max: a NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_hi(float x, float hi) { return x > hi ? hi : x; }

__device__ __forceinline__ int pixel(float c, int n) {
  // torch.clamp(torch.round(c), 0, n - 1).to(int64); the int clamp only keeps
  // a NaN coordinate's read inside the image
  const float f = clamp_hi(clamp_lo(rintf(c), 0.0f), static_cast<float>(n - 1));
  return min(max(static_cast<int>(f), 0), n - 1);
}

__global__ void __launch_bounds__(THREADS)
tsdf_integrate_kernel(float* __restrict__ sdf, float* __restrict__ weight,
                      float* __restrict__ color_pool, const int64_t* __restrict__ slots,
                      const int32_t* __restrict__ coords, long capacity, int s,
                      const float* __restrict__ depth, int h, int w, long ds0, long ds1,
                      const float* __restrict__ color, long cs0, long cs1, long cs2,
                      const float* __restrict__ k_mat, const float* __restrict__ r_cw,
                      const float* __restrict__ t_cw, TsdfParams p) {
  const int chunk = blockIdx.x;
  const long slot = slots[chunk];
  if (slot < 0 || slot >= capacity) return;   // outside the pool: no access
  const long nvox = static_cast<long>(s) * s * s;
  const long base = slot * nvox;
  const float ox = static_cast<float>(coords[3 * chunk]) * p.s_vx;
  const float oy = static_cast<float>(coords[3 * chunk + 1]) * p.s_vx;
  const float oz = static_cast<float>(coords[3 * chunk + 2]) * p.s_vx;
  float r[9], k[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    r[i] = r_cw[i];
    k[i] = k_mat[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = t_cw[i];
  const float wmax = static_cast<float>(w - 1), hmax = static_cast<float>(h - 1);

  for (long v = threadIdx.x; v < nvox; v += THREADS) {
    // the pool's voxel order is [z][y][x]
    const int x = static_cast<int>(v % s), y = static_cast<int>((v / s) % s);
    const int z = static_cast<int>(v / (static_cast<long>(s) * s));
    const float cx = ox + (static_cast<float>(x) + 0.5f) * p.vx;
    const float cy = oy + (static_cast<float>(y) + 0.5f) * p.vx;
    const float cz = oz + (static_cast<float>(z) + 0.5f) * p.vx;
    const float px = ((cx * r[0] + cy * r[1]) + cz * r[2]) + t[0];
    const float py = ((cx * r[3] + cy * r[4]) + cz * r[5]) + t[1];
    const float pz = ((cx * r[6] + cy * r[7]) + cz * r[8]) + t[2];
    const float q0 = (px * k[0] + py * k[1]) + pz * k[2];
    const float q1 = (px * k[3] + py * k[4]) + pz * k[5];
    const float q2 = (px * k[6] + py * k[7]) + pz * k[8];
    const float den = clamp_lo(q2, 1e-6f);
    const float u = q0 / den, vv = q1 / den;
    const int ui = pixel(u, w), vi = pixel(vv, h);
    const bool in_img = u >= 0.0f && u <= wmax && vv >= 0.0f && vv <= hmax && pz > 1e-3f;
    const float d = depth[vi * ds0 + ui * ds1];
    const bool d_ok = in_img && d > p.min_depth && d < p.max_depth;
    const float surf = d - pz;
    const float tau = p.trunc + (p.tq * d) * d;

    const long at = base + v;
    const float old_s = sdf[at], old_w = weight[at];
    const bool upd = d_ok && surf > -tau && surf < tau;
    const float uc = clamp_hi(clamp_lo(surf, -tau), tau);
    const float wsum = old_w + (upd ? 1.0f : 0.0f);
    const float denom = clamp_lo(wsum, 1e-9f);
    float new_s = upd ? (old_s * old_w + uc) / denom : old_s;
    float new_w = clamp_hi(upd ? wsum : old_w, p.max_weight);
    if (p.carving) {
      const bool carve = d_ok && surf > tau && old_w > 0.0f;
      if (carve) new_w = clamp_lo(new_w - p.carve_weight, 0.0f);
      if (carve && new_w <= 0.0f) new_s = 0.0f;
    }
    // only what changes is stored: the colour of a voxel in the band, and
    // sdf and weight where their bits change
    if (upd) {
      const float* col = color + vi * cs0 + ui * cs1;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        color_pool[3 * at + c] = (color_pool[3 * at + c] * old_w + col[c * cs2]) / denom;
    }
    if (__float_as_uint(new_s) != __float_as_uint(old_s)) sdf[at] = new_s;
    if (__float_as_uint(new_w) != __float_as_uint(old_w)) weight[at] = new_w;
  }
}

}  // namespace

// plan[0..2] = threads a block, voxel loops a thread, blocks (one a chunk)
extern "C" int cvids_tsdf_integrate_plan(int m, int s, int* plan) {
  if (m < 1 || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = THREADS;
  plan[1] = static_cast<int>((static_cast<long>(s) * s * s + THREADS - 1) / THREADS);
  plan[2] = m;
  return 0;
}

// sdf, weight (C, S, S, S) and color_pool (C, S, S, S, 3) fp32, contiguous,
// updated in place at the m distinct slots (int64; a slot outside [0, C) is
// skipped, so a bad slot cannot reach past the pool); coords (m, 3) int32;
// depth (h, w) fp32 and color (h, w, 3) fp32 with strides in elements;
// k_mat, r_cw (3, 3) and t_cw (3,) fp32, contiguous. m, s >= 1.
extern "C" int cvids_tsdf_integrate(void* sdf, void* weight, void* color_pool,
                                    const void* slots, const void* coords, long capacity,
                                    int m, int s,
                                    const void* depth, int h, int w, long ds0, long ds1,
                                    const void* color, long cs0, long cs1, long cs2,
                                    const void* k_mat, const void* r_cw, const void* t_cw,
                                    float vx, float s_vx, float trunc, float tq,
                                    float min_depth, float max_depth, float max_weight,
                                    float carve_weight, int carving, void* stream) {
  if (m < 1 || s < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const TsdfParams p{vx, s_vx, trunc, tq, min_depth, max_depth, max_weight, carve_weight,
                     carving};
  tsdf_integrate_kernel<<<m, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(sdf), static_cast<float*>(weight), static_cast<float*>(color_pool),
      static_cast<const int64_t*>(slots), static_cast<const int32_t*>(coords), capacity, s,
      static_cast<const float*>(depth), h, w, ds0, ds1, static_cast<const float*>(color), cs0,
      cs1, cs2, static_cast<const float*>(k_mat), static_cast<const float*>(r_cw),
      static_cast<const float*>(t_cw), p);
  return static_cast<int>(cudaGetLastError());
}

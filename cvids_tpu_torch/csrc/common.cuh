// Shared helpers of the port's CUDA kernels: element loads and stores for the
// two volume types (fp32 and bf16, both computed in fp32) and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define CVIDS_FULL_MASK 0xffffffffu

// the reference kernels' "+infinity" pad: finite, so BIG + P1 stays finite
#define CVIDS_BIG 3.0e38f

__device__ __forceinline__ float cvids_to_f32(float v) { return v; }
__device__ __forceinline__ float cvids_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T cvids_from_f32(float v);
template <>
__device__ __forceinline__ float cvids_from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvids_from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// load that bypasses L1: reads a value another warp of the block stored
// before a __syncthreads()
__device__ __forceinline__ float cvids_load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float cvids_load_cg(const __nv_bfloat16* p) {
  unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ float cvids_warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(CVIDS_FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ int cvids_warp_min_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(CVIDS_FULL_MASK, v, o));
  return v;
}

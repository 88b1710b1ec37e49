// Shared helpers of the port's CUDA kernels: element loads and stores for the
// two volume types (fp32 and bf16, both computed in fp32) and their 16-byte
// vectors.
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

// a 16-byte vector of cost elements, unpacked to and packed from fp32
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo: the low half
    return *reinterpret_cast<const unsigned*>(&h);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// The CUDA features that csrc/window_lm.cu uses, emulated on the CPU for
// dev/wlm_emulator/build.py: one OS thread a CUDA thread, std::barrier for a
// block's, a warp's and a cluster's barriers, warp shuffles and ballots
// through a per-warp exchange array, distributed shared memory as an offset
// into another block's array, cp.async as a plain copy. Float arithmetic is
// the host's IEEE single precision (built with -ffp-contract=off), so two
// kernel sources that order their operations alike agree bit for bit here
// as they do on the card; the math library (sinf, atan2f, ...) is the
// host's, so a source is compared with another source, not with the card.
// It checks order and synchronization logic, not timing, memory-model
// subtleties or the asynchrony of copies.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <optional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __cluster_dims__(...)
#define __align__(n) __attribute__((aligned(n)))

struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct uint3s { unsigned x, y, z; };
inline thread_local uint3s threadIdx, blockIdx;

struct EmuBlock {
  std::vector<float> smem;
  std::barrier<>* bar;
  std::barrier<>* wbar[32];
  float xch[32][32];
  unsigned bal[32][32];
};
inline std::vector<EmuBlock*> emu_blocks;
inline std::barrier<>* emu_cluster_bar = nullptr;
inline thread_local std::optional<std::barrier<>::arrival_token> emu_token;

inline EmuBlock& emu_block() { return *emu_blocks[blockIdx.x]; }
inline float* emu_smem() { return emu_block().smem.data(); }
inline void __syncthreads() { emu_block().bar->arrive_and_wait(); }
inline void emu_warp_sync() { emu_block().wbar[threadIdx.x / 32]->arrive_and_wait(); }
inline float emu_shfl(float v, int src) {
  EmuBlock& b = emu_block();
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  b.xch[w][lane] = v;
  emu_warp_sync();
  const float r = (src >= 0 && src < 32) ? b.xch[w][src] : v;
  emu_warp_sync();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) { return emu_shfl(v, src & 31); }
inline float __shfl_down_sync(unsigned, float v, int off) {
  const int lane = threadIdx.x % 32;
  return emu_shfl(v, lane + off < 32 ? lane + off : lane);
}
inline unsigned __ballot_sync(unsigned, bool p) {
  EmuBlock& b = emu_block();
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  b.bal[w][lane] = p ? 1u : 0u;
  emu_warp_sync();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= b.bal[w][i] << i;
  emu_warp_sync();
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
inline int __float_as_int(float x) { int u; std::memcpy(&u, &x, 4); return u; }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline long long clock64() { return 0; }
inline size_t __cvta_generic_to_shared(const void*) { return 0; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// mapa: the same offset in another block's shared memory
inline uint64_t emu_remote(uint64_t p, unsigned rank) {
  const char* base = reinterpret_cast<const char*>(emu_block().smem.data());
  const char* other = reinterpret_cast<const char*>(emu_blocks[rank]->smem.data());
  return reinterpret_cast<uint64_t>(other + (reinterpret_cast<const char*>(p) - base));
}
inline void emu_cluster_arrive() { emu_token.emplace(emu_cluster_bar->arrive()); }
inline void emu_cluster_wait() {
  emu_cluster_bar->wait(std::move(*emu_token));
  emu_token.reset();
}

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; int maxThreadsPerBlock; };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  *a = {};
  return 0;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class T> cudaError_t cudaMemcpyFromSymbol(void* d, const T& s, size_t n) {
  std::memcpy(d, &s, n);
  return 0;
}
template <class T> cudaError_t cudaMemcpyToSymbol(T& s, const void* d, size_t n) {
  std::memcpy(&s, d, n);
  return 0;
}

// kernel<<<grid, block, smem>>>(a): grid blocks (one cluster) of `block`
// threads, each block's shared memory filled with a signalling NaN
template <class K, class A>
void emu_launch(K kernel, int grid, int block, size_t smem, const A& a) {
  std::vector<EmuBlock*> blocks;
  for (int b = 0; b < grid; ++b) {
    auto* e = new EmuBlock();
    e->smem.assign(smem / 4 + 4, __int_as_float(0x7fa00000));
    e->bar = new std::barrier<>(block);
    for (int w = 0; w < 32; ++w) e->wbar[w] = new std::barrier<>(32);
    blocks.push_back(e);
  }
  emu_blocks = blocks;
  emu_cluster_bar = new std::barrier<>(grid * block);
  std::vector<std::thread> threads;
  for (int b = 0; b < grid; ++b)
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] {
        blockIdx = {static_cast<unsigned>(b), 0, 0};
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        kernel(a);
      });
  for (auto& th : threads) th.join();
  for (auto* e : blocks) {
    delete e->bar;
    for (auto* w : e->wbar) delete w;
    delete e;
  }
  delete emu_cluster_bar;
}

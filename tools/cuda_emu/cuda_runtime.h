// A CPU stand-in for the parts of the CUDA runtime that the port's kernel
// sources use, so that tools/cuda_emu/emulate.py can compile a source with
// g++ and run its kernels on the CPU: every block in turn, each of its
// threads a std::thread, __syncthreads and __syncwarp as barriers, shared
// memory one static array filled with NaN before each block (a read of
// what no thread wrote shows up as NaN), cp.async as a copy that checks
// its alignment and its bounds.  It checks indexing, staging and
// barriers, not speed and not the card's floating-point contraction.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(x)
#define __shared__
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisaligned = 74 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int emu_error = 0;
inline size_t emu_max_smem = 0;
template <class F>
inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { int e = emu_error; emu_error = 0; return e; }
alignas(16) inline float emu_smem[1 << 18];
inline std::barrier<>* emu_block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_bar;
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_bar[threadIdx.x / 32]->arrive_and_wait();
}
inline std::vector<std::vector<float>> emu_shfl;  // one row per warp
inline float emu_shfl_from(float v, int lane_of) {
  auto& row = emu_shfl[threadIdx.x / 32];
  row[threadIdx.x % 32] = v;
  __syncwarp();
  const float out = row[lane_of];
  __syncwarp();
  return out;
}
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  const int lane = threadIdx.x % 32;
  return emu_shfl_from(v, (lane & ~(width - 1)) + (src & (width - 1)));
}
inline float __shfl_xor_sync(unsigned, float v, int m, int width = 32) {
  const int lane = threadIdx.x % 32;
  return emu_shfl_from(v, (lane & ~(width - 1)) + ((lane ^ m) & (width - 1)));
}
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
template <class T> inline T __ldg(const T* p) { return *p; }
// async copies: performed at issue (EMU_DEFER unset) or at the wait that
// covers them (EMU_DEFER=1)
struct EmuCopy { void* d; const void* s; size_t n; };
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline thread_local std::vector<EmuCopy> emu_open;
inline bool emu_defer = std::getenv("EMU_DEFER") != nullptr;
inline void __pipeline_memcpy_async(void* d, const void* s, size_t n) {
  if (((uintptr_t)d % n) || ((uintptr_t)s % n)) emu_error = cudaErrorMisaligned;
  const char* lo = (const char*)emu_smem;
  if ((const char*)d < lo || (const char*)d + n > lo + emu_max_smem) {
    std::fprintf(stderr, "cp.async out of the block's shared memory\n");
    emu_error = 77;
  }
  if (emu_defer) emu_open.push_back({d, s, n}); else std::memcpy(d, s, n);
}
inline void __pipeline_commit() { emu_groups.push_back(emu_open); emu_open.clear(); }
inline void __pipeline_wait_prior(size_t n) {
  while (emu_groups.size() > n) {
    for (auto& c : emu_groups.front()) std::memcpy(c.d, c.s, c.n);
    emu_groups.erase(emu_groups.begin());
  }
}
inline long emu_last[5];  // grid x, grid y, block x, shared bytes, launches
template <class... P, class... A>
void emu_launch(void (*k)(P...), dim3 grid, dim3 block, size_t smem,
                cudaStream_t, A... args) {
  if (smem > sizeof(emu_smem)) { emu_error = 78; return; }
  emu_max_smem = smem;
  gridDim = grid; blockDim = block;
  emu_last[0] = grid.x; emu_last[1] = grid.y; emu_last[2] = block.x;
  emu_last[3] = (long)smem; emu_last[4] += 1;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      for (size_t i = 0; i < smem / 4; ++i) emu_smem[i] = NAN;
      std::barrier<> bar(block.x);
      emu_block_bar = &bar;
      emu_warp_bar.clear();
      emu_shfl.assign((block.x + 31) / 32, std::vector<float>(32));
      for (unsigned w = 0; w * 32 < block.x; ++w)
        emu_warp_bar.emplace_back(new std::barrier<>(min(32u, block.x - 32 * w)));
      std::vector<std::thread> th;
      for (unsigned t = 0; t < block.x; ++t)
        th.emplace_back([&, t] {
          threadIdx = dim3(t);
          emu_groups.clear(); emu_open.clear();
          k(args...);
        });
      for (auto& x : th) x.join();
    }
}

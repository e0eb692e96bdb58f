// Host emulation of the CUDA subset myldpccppapi/cuda/minsum_decoder.cu
// uses, for testing its arithmetic and control flow without a GPU: one
// std::thread per CUDA thread of a block, __syncthreads as a std::barrier,
// shared memory as one buffer per block.  The *_rn intrinsics go through
// volatile stores so the host compiler cannot contract them either.
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstddef>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __align__(x)
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 1 };
struct dim3_ { int x, y, z; };
inline thread_local dim3_ threadIdx, blockIdx;
inline dim3_ blockDim;
inline std::barrier<>* g_bar = nullptr;   // the running block's barrier
inline std::atomic<int> g_or{0};
inline unsigned char* g_smem = nullptr;   // the running block's shared memory
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  if (p) g_or.fetch_or(1);
  g_bar->arrive_and_wait();
  int res = g_or.load();
  g_bar->arrive_and_wait();
  if (threadIdx.x == 0) g_or.store(0);
  g_bar->arrive_and_wait();
  return res;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
inline cudaError_t cudaGetLastError() { return 0; }

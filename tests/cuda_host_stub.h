// The CUDA features of a kernel that uses one CTA-wide barrier and no warp
// intrinsics, on the host: each CUDA thread a host thread, the CTAs one after
// another, __syncthreads a barrier of the CTA's threads, __shared__ a static
// (one CTA at a time), __ldg a plain load. A test compiles a kernel source
// with g++ against this header, its `#include <cuda_runtime.h>` replaced by
// this one and its `kernel<<<grid, block, 0, stream>>>(args)` by
// `emu_launch(kernel, grid, block, args)`, and calls its C entry through
// ctypes on CPU tensors.
#pragma once
#include <stdint.h>

#include <barrier>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct emu_dim3 {
  unsigned x, y, z;
};
inline thread_local emu_dim3 threadIdx, blockIdx;

struct uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}

inline std::barrier<>* emu_cta_barrier;
inline void __syncthreads() { emu_cta_barrier->arrive_and_wait(); }

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

template <class F, class... A>
void emu_launch(F kernel, unsigned grid, unsigned block, A... args) {
  for (unsigned b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    emu_cta_barrier = &bar;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}

// The CUDA features of the port's kernels whose threads meet only at CTA
// barriers, warp barriers, warp shuffles and ballots, on the host: each CUDA
// thread a fiber (its own stack, switched cooperatively on one host thread),
// the CTAs one after another, __syncthreads a barrier of the CTA's threads,
// __syncwarp a barrier of the warp's 32 threads, a shuffle (xor or from a
// lane) or a ballot a write, a warp barrier, a read and a warp barrier,
// __shared__ a static (one CTA at a time), __ldg a plain load, bf16 its 16
// bits, and the rounded float intrinsics (__fadd_rn, __fmaf_rn, ...) the
// plain float operations they name (compile with -ffp-contract=off, so
// that no product is fused into a sum the source did not fuse). A fiber
// runs until it waits at a barrier; the next one in thread order runs
// then, so a barrier costs one switch per thread and the run is the same on
// a loaded host. A barrier that some threads never reach (a divergent
// __syncwarp) aborts the process. Dynamic shared memory
// (`extern __shared__ T name[];`, which a test rewrites to
// `T* name = (T*)emu_dyn_smem;`) is one static buffer, filled with 0xff
// bytes (NaNs, out-of-range indices) before each CTA, so a read of what no
// thread wrote shows. A test compiles a kernel source with g++ (x86-64)
// against this header, its `#include <cuda_runtime.h>` replaced by this
// one and its `kernel<<<grid, block, 0, stream>>>(args)` by
// `emu_launch(kernel, grid, block, args)` (with dynamic shared memory,
// `<<<grid, block, bytes, stream>>>` by
// `emu_launch_smem(kernel, grid, block, bytes, args)`), and calls its C
// entry through ctypes on CPU tensors.
#pragma once
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <functional>
#include <vector>

#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct emu_dim3 {
  unsigned x, y, z;
};
// the running fiber's: the scheduler sets them before it resumes one
inline emu_dim3 threadIdx, blockIdx, blockDim, gridDim;

struct uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
struct alignas(8) int2 {
  int x, y;
};
inline int2 make_int2(int a, int b) { return {a, b}; }
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}

// -- fibers: emu_switch(&from_sp, to_sp) saves the callee-saved registers
//    on the current stack, stores its pointer in from_sp and resumes the
//    stack to_sp (System V x86-64)
extern "C" void emu_switch(void** from_sp, void* to_sp);
asm(R"(
.text
.globl emu_switch
.hidden emu_switch
.type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
.size emu_switch, .-emu_switch
)");

struct EmuFiber {
  void* sp;
  bool done;
};

struct EmuScheduler {
  std::vector<EmuFiber> fibers;
  std::vector<char> stacks;
  void* main_sp = nullptr;
  unsigned cur = 0;
  unsigned long progress = 0;  // barriers passed and fibers finished
  std::function<void()> body;
};
inline EmuScheduler emu_sched;
constexpr size_t kEmuStack = 1 << 16;

inline void emu_yield() {
  emu_switch(&emu_sched.fibers[emu_sched.cur].sp, emu_sched.main_sp);
}

struct EmuBarrier {
  unsigned expected = 0, arrived = 0;
  unsigned long gen = 0;
};
constexpr int kEmuMaxWarps = 32;
inline EmuBarrier emu_cta_barrier, emu_warp_barrier[kEmuMaxWarps];
inline uint64_t emu_lane_word[kEmuMaxWarps][32];

inline void emu_wait(EmuBarrier& b) {
  const unsigned long g = b.gen;
  if (++b.arrived == b.expected) {
    b.arrived = 0;
    ++b.gen;
    ++emu_sched.progress;
    return;
  }
  while (b.gen == g) emu_yield();
}

inline void __syncthreads() { emu_wait(emu_cta_barrier); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_wait(emu_warp_barrier[threadIdx.x / 32]);
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "a shuffled word");
  const unsigned w = threadIdx.x / 32, l = threadIdx.x % 32;
  memcpy(&emu_lane_word[w][l], &v, sizeof(T));
  __syncwarp();
  T r;
  memcpy(&r, &emu_lane_word[w][l ^ (unsigned)lane_mask], sizeof(T));
  __syncwarp();
  return r;
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "a shuffled word");
  const unsigned w = threadIdx.x / 32, l = threadIdx.x % 32;
  memcpy(&emu_lane_word[w][l], &v, sizeof(T));
  __syncwarp();
  T r;
  memcpy(&r, &emu_lane_word[w][(unsigned)src_lane & 31u], sizeof(T));
  __syncwarp();
  return r;
}

inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_lane_word[w][l] = pred ? 1u : 0u;
  __syncwarp();
  unsigned bits = 0;
  for (unsigned j = 0; j < 32; ++j)
    bits |= (unsigned)(emu_lane_word[w][j] & 1u) << j;
  __syncwarp();
  return bits;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
// the four byte products of a and b, added to c
inline unsigned __dp4a(unsigned a, unsigned b, unsigned c) {
  for (int i = 0; i < 32; i += 8) c += ((a >> i) & 255u) * ((b >> i) & 255u);
  return c;
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline int max(int a, int b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }

inline float __int_as_float(int x) {
  float f;
  memcpy(&f, &x, sizeof f);
  return f;
}
// bf16 as its 16 bits; float to bf16 rounds to nearest even (NaN stays NaN)
struct __nv_bfloat16 {
  uint16_t x;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.x << 16;
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return sqrtf(a); }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }

// one fiber at a time: a read-modify-write is atomic
inline int atomicMin(int* p, int v) {
  const int old = *p;
  if (v < old) *p = v;
  return old;
}
inline int atomicMax(int* p, int v) {
  const int old = *p;
  if (v > old) *p = v;
  return old;
}

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

constexpr size_t kEmuDynSmem = 1 << 17;
alignas(16) inline unsigned char emu_dyn_smem[kEmuDynSmem];

inline void emu_fiber_main() {
  emu_sched.body();
  emu_sched.fibers[emu_sched.cur].done = true;
  ++emu_sched.progress;
  emu_yield();  // never resumed
}

template <class F, class... A>
void emu_launch(F kernel, unsigned grid, unsigned block, A... args) {
  EmuScheduler& s = emu_sched;
  blockDim = {block, 1, 1};
  gridDim = {grid, 1, 1};
  s.body = [=] { kernel(args...); };
  s.fibers.assign(block, EmuFiber{nullptr, false});
  s.stacks.assign(block * kEmuStack + 16, 0);
  const unsigned n_warps = (block + 31) / 32;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx = {b, 0, 0};
    memset(emu_dyn_smem, 0xff, kEmuDynSmem);
    emu_cta_barrier = EmuBarrier{block};
    for (unsigned w = 0; w < n_warps; ++w)
      emu_warp_barrier[w] =
          EmuBarrier{block - 32 * w < 32 ? block - 32 * w : 32u};
    for (unsigned t = 0; t < block; ++t) {
      // a fresh stack whose first switch "returns" into emu_fiber_main
      // with the stack aligned as at a call
      uintptr_t top = (uintptr_t)(s.stacks.data() + (t + 1) * kEmuStack);
      void** sp = (void**)(top & ~(uintptr_t)15);
      *--sp = nullptr;
      *--sp = (void*)&emu_fiber_main;
      for (int r = 0; r < 6; ++r) *--sp = nullptr;
      s.fibers[t] = EmuFiber{sp, false};
    }
    for (unsigned live = block; live;) {
      const unsigned long before = s.progress;
      live = 0;
      for (unsigned t = 0; t < block; ++t) {
        if (s.fibers[t].done) continue;
        s.cur = t;
        threadIdx = {t, 0, 0};
        emu_switch(&s.main_sp, s.fibers[t].sp);
        live += !s.fibers[t].done;
      }
      if (live && s.progress == before) {
        fprintf(stderr, "emu_launch: CTA %u deadlocked: a barrier that not "
                        "every thread reaches\n", b);
        abort();
      }
    }
  }
}

template <class F, class... A>
void emu_launch_smem(F kernel, unsigned grid, unsigned block, size_t smem,
                     A... args) {
  if (smem > kEmuDynSmem) {
    fprintf(stderr, "emu_launch_smem: %zu bytes of dynamic shared memory, "
                    "at most %zu\n", smem, kEmuDynSmem);
    abort();
  }
  emu_launch(kernel, grid, block, args...);
}

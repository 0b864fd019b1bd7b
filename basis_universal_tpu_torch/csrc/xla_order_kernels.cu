// Hand-written Hopper (sm_90a) kernels for XLA-CPU's float32 orders.
//
// The JAX reference's results on the CPU are those of XLA's compiled code:
// a product feeding one add is a fused multiply-add, and a short
// contraction is summed in a fixed order. The port spells these orders out
// (basis_universal_tpu_torch/ops/xla_order.py) wherever a rounding decides
// a code. Its plain PyTorch versions emulate each fused multiply-add through
// float64, six operators and a float64 copy per operand; on the card these
// two kernels compute the same values with one launch:
//
// - xla_fma: out = fma(a, b, c) elementwise, each operand a broadcast view
//   (any strides, 0 where broadcast) or a scalar;
// - xla_reduce<order>: out[i] = the sum over a K-long axis of a[i, k] (or of
//   a[i, k] * b[i, k]) in one of the orders of xla_order.py: `_sum` (adds in
//   index order), `_dot` (the first product, then fused multiply-adds in
//   index order), `_dot_mm` (four accumulators taking every fourth term,
//   added pairwise at the end; a chain below four terms) and `_dot_vec16`
//   (16 terms: eight rounded products added in turn, then eight fused
//   multiply-adds).
//
// Every rounding is spelled out (__fmaf_rn, __fmul_rn, __fadd_rn), so the
// card gives XLA's bits; the float64 emulation on the CPU rounds twice and
// may differ from a true fused multiply-add in the last bit when the float64
// sum lands on a float32 midpoint (rare; the CPU tests hold the plain
// version to the reference).
//
// Both are bound by their bytes (a few operations per element). A thread
// owns one output element, found from its linear index through the output
// shape (at most kMaxDims dimensions after the wrapper merges contiguous
// ones), and reads each operand at its own strides, so no broadcast
// operand is materialised.
//
// Every launcher takes raw device pointers, the shape and strides by value,
// and a cudaStream_t; it launches asynchronously and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;

// The output shape and up to three operands' strides (elements) over it.
struct Layout {
  int nd;
  long long size[kMaxDims];
  long long st[3][kMaxDims];
};

__device__ __forceinline__ void offsets(const Layout& m, long long i,
                                        long long (&off)[3]) {
  off[0] = off[1] = off[2] = 0;
  for (int d = m.nd - 1; d >= 0; --d) {
    const long long q = i / m.size[d];
    const long long r = i - q * m.size[d];
    off[0] += r * m.st[0][d];
    off[1] += r * m.st[1][d];
    off[2] += r * m.st[2][d];
    i = q;
  }
}

__global__ void __launch_bounds__(kThreads)
xla_fma_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ c, float av, float bv, float cv,
               float* __restrict__ out, long long n, Layout m) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    long long off[3];
    offsets(m, i, off);
    const float x = a ? a[off[0]] : av;
    const float y = b ? b[off[1]] : bv;
    const float z = c ? c[off[2]] : cv;
    out[i] = __fmaf_rn(x, y, z);
  }
}

enum Order { kSum = 0, kDot = 1, kDotMm = 2, kDotVec16 = 3 };

template <int kOrder>
__global__ void __launch_bounds__(kThreads)
xla_reduce_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, long long n, int k_len,
                  long long ka, long long kb, Layout m) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    long long off[3];
    offsets(m, i, off);
    const float* pa = a + off[0];
    float acc;
    if constexpr (kOrder == kSum) {
      acc = pa[0];
      for (int k = 1; k < k_len; ++k) acc = __fadd_rn(acc, pa[k * ka]);
    } else {
      const float* pb = b + off[1];
      if (kOrder == kDotVec16) {
        acc = __fmul_rn(pa[0], pb[0]);
#pragma unroll
        for (int k = 1; k < 8; ++k)
          acc = __fadd_rn(acc, __fmul_rn(pa[k * ka], pb[k * kb]));
#pragma unroll
        for (int k = 8; k < 16; ++k)
          acc = __fmaf_rn(pa[k * ka], pb[k * kb], acc);
      } else if (kOrder == kDotMm && k_len >= 4) {
        float s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = __fmul_rn(pa[j * ka], pb[j * kb]);
        for (int k = 4; k < k_len; ++k)
          s[k & 3] = __fmaf_rn(pa[k * ka], pb[k * kb], s[k & 3]);
        acc = __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
      } else {
        acc = __fmul_rn(pa[0], pb[0]);
        for (int k = 1; k < k_len; ++k)
          acc = __fmaf_rn(pa[k * ka], pb[k * kb], acc);
      }
    }
    out[i] = acc;
  }
}

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 132 * 64 ? blocks : 132 * 64);
}

// meta: kMaxDims sizes, then 3 x kMaxDims strides (operand x, dim d at
// kMaxDims + x * kMaxDims + d); the first nd of each are used.
Layout layout_of(int nd, const long long* meta) {
  Layout m;
  m.nd = nd;
  for (int d = 0; d < kMaxDims; ++d) {
    m.size[d] = d < nd ? meta[d] : 1;
    for (int x = 0; x < 3; ++x)
      m.st[x][d] = d < nd ? meta[kMaxDims + x * kMaxDims + d] : 0;
  }
  return m;
}

}  // namespace

extern "C" {

// meta: the output's layout (layout_of). A null operand pointer takes its
// scalar.
int xla_fma(const float* a, const float* b, const float* c, float av,
            float bv, float cv, float* out, long long n, int nd,
            const long long* meta, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nd < 1 || nd > kMaxDims) return (int)cudaErrorInvalidValue;
  xla_fma_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, c, av, bv, cv, out, n, layout_of(nd, meta));
  return (int)cudaGetLastError();
}

// order: 0 `_sum` (b unused), 1 `_dot`, 2 `_dot_mm`, 3 `_dot_vec16` (k_len
// 16); ka / kb the operands' strides along the summed axis.
int xla_reduce(const float* a, const float* b, float* out, long long n,
               int k_len, long long ka, long long kb, int order, int nd,
               const long long* meta, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nd < 1 || nd > kMaxDims || k_len < 1 ||
      (order == kDotVec16 && k_len != 16))
    return (int)cudaErrorInvalidValue;
  const Layout m = layout_of(nd, meta);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = grid_for(n);
  switch (order) {
    case kSum:
      xla_reduce_kernel<kSum><<<g, kThreads, 0, s>>>(a, b, out, n, k_len, ka,
                                                     kb, m);
      break;
    case kDot:
      xla_reduce_kernel<kDot><<<g, kThreads, 0, s>>>(a, b, out, n, k_len, ka,
                                                     kb, m);
      break;
    case kDotMm:
      xla_reduce_kernel<kDotMm><<<g, kThreads, 0, s>>>(a, b, out, n, k_len,
                                                       ka, kb, m);
      break;
    case kDotVec16:
      xla_reduce_kernel<kDotVec16><<<g, kThreads, 0, s>>>(a, b, out, n,
                                                          k_len, ka, kb, m);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

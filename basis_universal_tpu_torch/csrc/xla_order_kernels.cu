// Hand-written Hopper (sm_90a) kernels for XLA-CPU's float32 orders.
//
// The JAX reference's results on the CPU are those of XLA's compiled code:
// a product feeding one add is a fused multiply-add, and a short
// contraction is summed in a fixed order. The port spells these orders out
// (basis_universal_tpu_torch/ops/xla_order.py) wherever a rounding decides
// a code. Its plain PyTorch versions emulate each fused multiply-add through
// float64, a dozen operators and a float64 copy per operand; on the card these
// kernels compute the same values with one launch:
//
// - xla_fma: out = fma(a, b, c) elementwise, each operand a broadcast view
//   (any strides, 0 where broadcast) or a scalar;
// - xla_reduce<order>: out[i] = the sum over a K-long axis of a[i, k] (or of
//   a[i, k] * b[i, k]) in one of the orders of xla_order.py: `_sum` (adds in
//   index order), `_dot` (the first product, then fused multiply-adds in
//   index order), `_dot_mm` (four accumulators taking every fourth term,
//   added pairwise at the end; a chain below four terms) and `_dot_vec16`
//   (16 terms: eight rounded products added in turn, then eight fused
//   multiply-adds);
// - uastc_line_fit<C>: a whole masked line fit of the UASTC search
//   (`codecs/uastc/encode.py`, `line_fit_reference`) for every subset of a
//   partition: the masked mean, the power iteration, the endpoints on the
//   axis, the search over the weight levels and the least-squares steps,
//   one launch for the ~50 operators of each subset's plain version;
// - uastc_mode_trial<C>: a whole single-subset single-plane mode trial
//   (`mode_trial_reference`): the same fit with the endpoints quantised
//   through the mode's tables, and the full-pixel error.
//
// Every rounding is spelled out (__fmaf_rn, __fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so the card gives XLA's bits, the fused kernels
// the bits of the generic ones, and the plain versions' (whose float64
// emulation rounds each fused multiply-add once, through round-to-odd).
//
// What bounds them on the H100: xla_fma and xla_reduce move a few bytes per
// operation, so their bytes; at the UASTC searches' shapes (a few MB) the
// launch itself. The design keeps the index arithmetic off the critical
// path: a 32-bit layout whose divisions by the dimension sizes are
// multiply-shifts precomputed on the host (a 64-bit divide is a long
// software routine on the GPU; the 64-bit kernels stay for tensors past
// 2^31 elements), a float4 path for rows whose operands are contiguous or
// broadcast along the row, and in xla_reduce a block that stages the union
// of its outputs' K-long slices in shared memory with coalesced loads before
// each thread runs its chain from there. The line-fit kernels run a lane per
// pixel (below), so at the search's 24,576 blocks they hold 393k threads;
// a warp issues the ordered chains and the power iteration once for its two
// blocks, and that serial part, not the per-pixel search, sets their time
// (fitting a partition's subsets side by side, each pixel searching once,
// measured slower at every register budget tried).
//
// Every launcher takes raw device pointers, the shape and strides by value,
// and a cudaStream_t; it launches asynchronously and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;
constexpr int kReduceThreads = 128;
constexpr int kStageFloats = 3072;  // per staged operand of xla_reduce

// ---------------------------------------------------------------------------
// layouts
// ---------------------------------------------------------------------------

// floor(n / d) = umulhi(n, mul) >> shift for every n < 2^31 (d > 1).
struct FastDiv {
  uint32_t d, mul, shift;
};

FastDiv fast_div(uint32_t d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    uint32_t l = 0;
    while ((1ull << l) < d) ++l;  // ceil(log2 d)
    const uint32_t p = 31 + l;
    f.mul = (uint32_t)(((1ull << p) + d - 1) / d);
    f.shift = p - 32;
  }
  return f;
}

__device__ __forceinline__ uint32_t div_of(const FastDiv& f, uint32_t n) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shift;
}

// The output shape and up to three operands' strides (elements) over it,
// in 32 bits: taken where every index and offset stays below 2^31.
struct Layout32 {
  int nd;
  FastDiv div[kMaxDims];
  int32_t st[3][kMaxDims];
};

__device__ __forceinline__ void offsets32(const Layout32& m, uint32_t i,
                                          int32_t (&off)[3]) {
  off[0] = off[1] = off[2] = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d >= 1; --d) {
    if (d < m.nd) {
      const uint32_t q = div_of(m.div[d], i);
      const int32_t r = (int32_t)(i - q * m.div[d].d);
      off[0] += r * m.st[0][d];
      off[1] += r * m.st[1][d];
      off[2] += r * m.st[2][d];
      i = q;
    }
  }
  off[0] += (int32_t)i * m.st[0][0];
  off[1] += (int32_t)i * m.st[1][0];
  off[2] += (int32_t)i * m.st[2][0];
}

// The same in 64 bits, for tensors past the 32-bit range.
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

// ---------------------------------------------------------------------------
// xla_fma
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
xla_fma_kernel32(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ c, float av, float bv, float cv,
                 float* __restrict__ out, int n, Layout32 m) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    int32_t off[3];
    offsets32(m, (uint32_t)i, off);
    const float x = a ? a[off[0]] : av;
    const float y = b ? b[off[1]] : bv;
    const float z = c ? c[off[2]] : cv;
    out[i] = __fmaf_rn(x, y, z);
  }
}

// Rows of w (a multiple of 4) floats: an operand is read as float4 where
// its row is contiguous (inner stride 1) and as one float per row where it
// is broadcast along the row (inner stride 0); row r of operand x starts at
// r * outer[x]. Each thread writes 4 consecutive outputs.
struct Rows {
  int32_t outer[3], inner[3];
};

__device__ __forceinline__ float4 row_load(const float* p, float v,
                                           int32_t row_off, int32_t inner,
                                           uint32_t col) {
  if (!p) return make_float4(v, v, v, v);
  if (inner == 0) {
    const float s = p[row_off];
    return make_float4(s, s, s, s);
  }
  return *reinterpret_cast<const float4*>(p + row_off + col);
}

__global__ void __launch_bounds__(kThreads)
xla_fma_kernel_rows(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ c, float av, float bv, float cv,
                    float* __restrict__ out, int n4, FastDiv w4, Rows r) {
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < n4;
       g += gridDim.x * kThreads) {
    const uint32_t row = div_of(w4, (uint32_t)g);
    const uint32_t col = 4u * ((uint32_t)g - row * w4.d);
    const int32_t ri = (int32_t)row;
    const float4 x = row_load(a, av, ri * r.outer[0], r.inner[0], col);
    const float4 y = row_load(b, bv, ri * r.outer[1], r.inner[1], col);
    const float4 z = row_load(c, cv, ri * r.outer[2], r.inner[2], col);
    float4 o;
    o.x = __fmaf_rn(x.x, y.x, z.x);
    o.y = __fmaf_rn(x.y, y.y, z.y);
    o.z = __fmaf_rn(x.z, y.z, z.z);
    o.w = __fmaf_rn(x.w, y.w, z.w);
    reinterpret_cast<float4*>(out)[g] = o;
  }
}

__global__ void __launch_bounds__(kThreads)
xla_fma_kernel64(const float* __restrict__ a, const float* __restrict__ b,
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

// ---------------------------------------------------------------------------
// xla_reduce
// ---------------------------------------------------------------------------

enum Order { kSum = 0, kDot = 1, kDotMm = 2, kDotVec16 = 3 };

// The K-long chain of one output from pa, pb (global or shared memory).
template <int kOrder, typename I>
__device__ __forceinline__ float chain(const float* pa, I ka, const float* pb,
                                       I kb, int k_len) {
  float acc;
  if constexpr (kOrder == kSum) {
    acc = pa[0];
    for (int k = 1; k < k_len; ++k) acc = __fadd_rn(acc, pa[k * ka]);
  } else if constexpr (kOrder == kDotVec16) {
    acc = __fmul_rn(pa[0], pb[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k)
      acc = __fadd_rn(acc, __fmul_rn(pa[k * ka], pb[k * kb]));
#pragma unroll
    for (int k = 8; k < 16; ++k) acc = __fmaf_rn(pa[k * ka], pb[k * kb], acc);
  } else {
    if (kOrder == kDotMm && k_len >= 4) {
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
  return acc;
}

// One block of kReduceThreads outputs at a time: the block's lowest and
// highest operand offsets bound the span its chains read; a span of at most
// kStageFloats is copied to shared memory with coalesced loads, and every
// thread runs its chain from there (a wider span is read in place).
template <int kOrder>
__global__ void __launch_bounds__(kReduceThreads)
xla_reduce_kernel32(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int n, int k_len, int ka, int kb,
                    Layout32 m) {
  constexpr int n_ops = kOrder == kSum ? 1 : 2;
  __shared__ float stage[n_ops][kStageFloats];
  __shared__ int lo[2], hi[2];
  const float* src[2] = {a, b};
  const int kst[2] = {ka, kb};
  for (int base = blockIdx.x * kReduceThreads; base < n;
       base += gridDim.x * kReduceThreads) {
    const int i = base + threadIdx.x;
    const bool live = i < n;
    int32_t off[3] = {0, 0, 0};
    if (live) offsets32(m, (uint32_t)i, off);
    if (threadIdx.x < 2) {
      lo[threadIdx.x] = INT_MAX;
      hi[threadIdx.x] = -1;
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int x = 0; x < n_ops; ++x) {
        atomicMin(&lo[x], off[x]);
        atomicMax(&hi[x], off[x]);
      }
    }
    __syncthreads();
    bool staged[2] = {false, false};
    int first[2] = {0, 0};
#pragma unroll
    for (int x = 0; x < n_ops; ++x) {
      first[x] = lo[x];
      const int span = hi[x] - lo[x] + (k_len - 1) * kst[x] + 1;
      staged[x] = span <= kStageFloats;
      if (staged[x])
        for (int j = threadIdx.x; j < span; j += kReduceThreads)
          stage[x][j] = src[x][first[x] + j];
    }
    __syncthreads();
    if (live) {
      const float* pa = staged[0] ? stage[0] + (off[0] - first[0]) : a + off[0];
      const float* pb = nullptr;
      if constexpr (n_ops == 2)
        pb = staged[1] ? stage[1] + (off[1] - first[1]) : b + off[1];
      out[i] = chain<kOrder>(pa, ka, pb, kb, k_len);
    }
    __syncthreads();
  }
}

template <int kOrder>
__global__ void __launch_bounds__(kThreads)
xla_reduce_kernel64(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, long long n, int k_len,
                    long long ka, long long kb, Layout m) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    long long off[3];
    offsets(m, i, off);
    out[i] = chain<kOrder>(a + off[0], ka, kOrder == kSum ? nullptr
                                                          : b + off[1],
                           kb, k_len);
  }
}

// ---------------------------------------------------------------------------
// uastc_line_fit, uastc_mode_trial: the UASTC search's line fits
// ---------------------------------------------------------------------------
//
// A lane per pixel: each 4x4 block takes 16 lanes (two blocks a warp), and
// its scratch lives in the warp's slice of shared memory, which only its own
// 16 lanes read and write (ordered by __syncwarp, no CTA barrier). Work that
// is per pixel (centring, projections, the search over the weight levels)
// runs across the lanes; every sum whose result can round stays one chain
// in pixel order, each on a lane of its own (the C means, the C x C
// covariance chains, the 2C least-squares chains) or, where every lane needs
// the result at once, on every lane (the masked error); the weights'
// moments, whole multiples of 1/4096, and the whole-numbered errors of the
// mode trials are exact in any order and are summed by shuffles.

constexpr int kFitSlots = 8;                 // 4x4 blocks per CTA
constexpr int kFitThreads = 16 * kFitSlots;  // a lane per pixel
constexpr int kMaxLevels = 32;
constexpr float kInv64 = 1.0f / 64.0f;
constexpr float kInv16384 = 1.0f / 16384.0f;
constexpr float kThird = 1.0f / 3.0f;        // float32(1/3), as `THIRD`

__device__ __forceinline__ float clamp255(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 255.0f);
}

// One 4x4 block's scratch.
struct alignas(16) FitScratch {
  float4 v[16];            // the pixels' channels (the fitted ones)
  float4 c[16];            // centred (and masked) pixels
  float4 rec[kMaxLevels];  // the reconstruction at each weight level
  float2 ab[16];           // least-squares weights (a, b) of each pixel
  float e[16];             // the terms of an ordered sum over the pixels
  float cov[16];           // covariance, C x C row-major
  float red[8];            // chain results: the mean (C); P (C), Q (C)
};

__device__ __forceinline__ float chan(const float4& f, int c) {
  return reinterpret_cast<const float*>(&f)[c];
}

template <int C>
__device__ __forceinline__ float4 pack4(const float (&x)[C]) {
  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < C; ++c) r[c] = x[c];
  return make_float4(r[0], r[1], r[2], r[3]);
}

// The sum over the block's 16 lanes of a value whose partial sums are all
// exact (whole numbers below 2^24, or multiples of 1/4096 up to 16).
__device__ __forceinline__ float exact_sum16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// sh.e added in pixel order, on every lane.
__device__ __forceinline__ float pixel_sum(const FitScratch& sh) {
  const float4* e4 = reinterpret_cast<const float4*>(sh.e);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 q = e4[i];
    acc = i ? __fadd_rn(acc, q.x) : q.x;
    acc = __fadd_rn(acc, q.y);
    acc = __fadd_rn(acc, q.z);
    acc = __fadd_rn(acc, q.w);
  }
  return acc;
}

// The power iteration of `principal_axis_reference` on the centred pixels
// sh.c (published by the caller, this lane's own in cx): the C x C
// covariance chains (lane k runs entry k), then `iters` rounds of the
// product chain, the rounded sum of squares, the correctly rounded root,
// + 1e-6 and the divide, on every lane; returns this lane's projection.
template <int C>
__device__ __forceinline__ float principal(FitScratch& sh, int p,
                                           const float (&cx)[C], int iters,
                                           float (&ax)[C]) {
  if (p < C * C) {
    const int i = p / C, j = p % C;
    float s = __fmul_rn(chan(sh.c[0], i), chan(sh.c[0], j));
#pragma unroll
    for (int q = 1; q < 16; ++q)
      s = __fmaf_rn(chan(sh.c[q], i), chan(sh.c[q], j), s);
    sh.cov[p] = s;
  }
  __syncwarp();
  float cov[C][C];
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) cov[i][j] = sh.cov[i * C + j];
#pragma unroll
  for (int i = 0; i < C; ++i) ax[i] = 1.0f;
  for (int it = 0; it < iters; ++it) {
    float w[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      float s = __fmul_rn(cov[i][0], ax[0]);
#pragma unroll
      for (int j = 1; j < C; ++j) s = __fmaf_rn(cov[i][j], ax[j], s);
      w[i] = s;
    }
    float sq = __fmul_rn(w[0], w[0]);
#pragma unroll
    for (int i = 1; i < C; ++i) sq = __fadd_rn(sq, __fmul_rn(w[i], w[i]));
    const float den = __fadd_rn(__fsqrt_rn(sq), 1e-6f);
#pragma unroll
    for (int i = 0; i < C; ++i) ax[i] = __fdiv_rn(w[i], den);
  }
  float pr = __fmul_rn(cx[0], ax[0]);
#pragma unroll
  for (int j = 1; j < C; ++j) pr = __fmaf_rn(cx[j], ax[j], pr);
  return pr;
}

// sh.rec[l] for float endpoints (`_rec16_fused`): fma(64 - w, lo, hi * w),
// then fma(acc, 257, 32), scaled and floored.
template <int C>
__device__ __forceinline__ void rec_fused(FitScratch& sh, const float* lev,
                                          int n_lev, int p,
                                          const float (&lo)[C],
                                          const float (&hi)[C]) {
  __syncwarp();
  for (int l = p; l < n_lev; l += 16) {
    const float w = lev[l], w0 = __fsub_rn(64.0f, w);
    float r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float acc = __fmaf_rn(w0, lo[c], __fmul_rn(hi[c], w));
      r[c] = floorf(__fmul_rn(__fmaf_rn(acc, 257.0f, 32.0f), kInv16384));
    }
    sh.rec[l] = pack4<C>(r);
  }
  __syncwarp();
}

// The decoder's reconstruction of quantised endpoints (`_rec16`), exact.
__device__ __forceinline__ float rec16(float lo_u, float hi_u, float w) {
  const float acc = __fadd_rn(__fmul_rn(lo_u, __fsub_rn(64.0f, w)),
                              __fmul_rn(hi_u, w));
  return floorf(__fmul_rn(__fadd_rn(__fmul_rn(acc, 257.0f), 32.0f),
                          kInv16384));
}

template <int C>
__device__ __forceinline__ void rec_exact(FitScratch& sh, const float* lev,
                                          int n_lev, int p,
                                          const float (&lo_u)[C],
                                          const float (&hi_u)[C]) {
  __syncwarp();
  for (int l = p; l < n_lev; l += 16) {
    float r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = rec16(lo_u[c], hi_u[c], lev[l]);
    sh.rec[l] = pack4<C>(r);
  }
  __syncwarp();
}

// This lane's pixel against every level of sh.rec: the squared differences
// rounded and added over the channels in order, the first minimum (w);
// returns the block's error, the minima times m added in pixel order.
template <int C>
__device__ __forceinline__ float level_search(FitScratch& sh, int p,
                                              const float (&x)[C], int n_lev,
                                              float m, int& w) {
  float best = INFINITY;
  int arg = 0;
  for (int l = 0; l < n_lev; ++l) {
    const float4 r = sh.rec[l];
    float d = __fsub_rn(x[0], r.x);
    float e = __fmul_rn(d, d);
    if constexpr (C > 1) {
      d = __fsub_rn(x[1], r.y);
      e = __fadd_rn(e, __fmul_rn(d, d));
    }
    if constexpr (C > 2) {
      d = __fsub_rn(x[2], r.z);
      e = __fadd_rn(e, __fmul_rn(d, d));
    }
    if constexpr (C > 3) {
      d = __fsub_rn(x[3], r.w);
      e = __fadd_rn(e, __fmul_rn(d, d));
    }
    if (e < best) {
      best = e;
      arg = l;
    }
  }
  w = arg;
  sh.e[p] = __fmul_rn(best, m);
  __syncwarp();
  const float err = pixel_sum(sh);
  __syncwarp();
  return err;
}

// One least-squares step (`ls_step_reference`): the weights a = (64 - w) /
// 64, b = w / 64 (times m with a mask), their moments, the P and Q chains
// over the pixels of sh.v (lane k < C runs P_k, lane C + k Q_k), the 2x2
// solve; where it is singular lo / hi; clamped.
template <int C, bool kMask>
__device__ __forceinline__ void ls_solve(FitScratch& sh, const float* lev,
                                         int p, int w, float m,
                                         const float (&lo)[C],
                                         const float (&hi)[C],
                                         float (&lo2)[C], float (&hi2)[C]) {
  const float wl = lev[w];
  float a = __fmul_rn(__fsub_rn(64.0f, wl), kInv64);
  float b = __fmul_rn(wl, kInv64);
  if (kMask) {
    a = __fmul_rn(a, m);
    b = __fmul_rn(b, m);
  }
  const float sa = exact_sum16(__fmul_rn(a, a));
  const float sab = exact_sum16(__fmul_rn(a, b));
  const float sb2 = exact_sum16(__fmul_rn(b, b));
  sh.ab[p] = make_float2(a, b);
  __syncwarp();
  if (p < 2 * C) {
    const bool q_chain = p >= C;
    const int ch = q_chain ? p - C : p;
    float2 t = sh.ab[0];
    float acc = __fmul_rn(q_chain ? t.y : t.x, chan(sh.v[0], ch));
#pragma unroll
    for (int q = 1; q < 16; ++q) {
      t = sh.ab[q];
      acc = __fmaf_rn(q_chain ? t.y : t.x, chan(sh.v[q], ch), acc);
    }
    sh.red[p] = acc;
  }
  __syncwarp();
  const float det = __fmaf_rn(sa, sb2, -__fmul_rn(sab, sab));
  const bool ok = fabsf(det) > 1e-6f;
  const float dd = ok ? det : 1.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float P = sh.red[c], Q = sh.red[C + c];
    const float ln = __fdiv_rn(__fmaf_rn(sb2, P, -__fmul_rn(sab, Q)), dd);
    const float hn = __fdiv_rn(__fmaf_rn(sa, Q, -__fmul_rn(sab, P)), dd);
    lo2[c] = clamp255(ok ? ln : lo[c]);
    hi2[c] = clamp255(ok ? hn : hi[c]);
  }
  __syncwarp();
}

// The block's mean of sh.v over the pixels of `bits` (all 16 without a
// mask): lane c < C adds channel c in pixel order (each term times its
// mask), then divides by the count; on every lane.
template <int C, bool kMask>
__device__ __forceinline__ void block_mean(FitScratch& sh, int p,
                                           unsigned bits, float cnt,
                                           float (&mean)[C]) {
  if (p < C) {
    float acc = chan(sh.v[0], p);
    if (kMask) acc = __fmul_rn(acc, (bits & 1u) ? 1.0f : 0.0f);
#pragma unroll
    for (int q = 1; q < 16; ++q) {
      float t = chan(sh.v[q], p);
      if (kMask) t = __fmul_rn(t, (bits >> q) & 1u ? 1.0f : 0.0f);
      acc = __fadd_rn(acc, t);
    }
    sh.red[p] = __fdiv_rn(acc, cnt);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < C; ++c) mean[c] = sh.red[c];
  __syncwarp();
}

// v: (n, 16, C) at strides (sb, sp, sc); label: (n, 16) int64 subset of
// each pixel (null: all 0); lev: the n_lev weight levels; lo, hi: (n, S, C).
// `_fit_line_masked` of each subset s < n_sub (mask label == s), its
// endpoints only.
template <int C>
__global__ void __launch_bounds__(kFitThreads)
line_fit_kernel(const float* __restrict__ v, long long sb, long long sp,
                long long sc, const long long* __restrict__ label, int n_sub,
                const float* __restrict__ levels, int n_lev, int ls_iters,
                float* __restrict__ lo_out, float* __restrict__ hi_out,
                int n) {
  __shared__ float lev[kMaxLevels];
  __shared__ FitScratch scratch[kFitSlots];
  if ((int)threadIdx.x < n_lev) lev[threadIdx.x] = levels[threadIdx.x];
  __syncthreads();
  const int p = threadIdx.x & 15, slot = threadIdx.x >> 4;
  const int blk_id = blockIdx.x * kFitSlots + slot;
  const bool live = blk_id < n;
  const long long blk = live ? blk_id : n - 1;  // a ragged tail repeats
  const unsigned half = threadIdx.x & 16u;     // this block's ballot bits
  FitScratch& sh = scratch[slot];
  float x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = v[blk * sb + p * sp + c * sc];
  sh.v[p] = pack4<C>(x);
  const long long lab = label ? label[blk * 16 + p] : 0;
  __syncwarp();
  for (int s = 0; s < n_sub; ++s) {
    const bool in = lab == s;
    const float m = in ? 1.0f : 0.0f;
    const unsigned bits = (__ballot_sync(0xffffffffu, in) >> half) & 0xffffu;
    float mean[C], cx[C], ax[C], lo[C], hi[C];
    block_mean<C, true>(sh, p, bits, fmaxf((float)__popc(bits), 1.0f), mean);
#pragma unroll
    for (int c = 0; c < C; ++c) cx[c] = __fmul_rn(__fsub_rn(x[c], mean[c]), m);
    sh.c[p] = pack4<C>(cx);
    __syncwarp();
    const float pr = principal<C>(sh, p, cx, 4, ax);
    float mn = in ? pr : 1e9f, mx = in ? pr : -1e9f;
#pragma unroll
    for (int o = 8; o; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      lo[c] = clamp255(__fmaf_rn(ax[c], mn, mean[c]));
      hi[c] = clamp255(__fmaf_rn(ax[c], mx, mean[c]));
    }
    rec_fused<C>(sh, lev, n_lev, p, lo, hi);
    int w;
    float err = level_search<C>(sh, p, x, n_lev, m, w);
    for (int it = 0; it < ls_iters; ++it) {
      float lo2[C], hi2[C];
      ls_solve<C, true>(sh, lev, p, w, m, lo, hi, lo2, hi2);
      rec_fused<C>(sh, lev, n_lev, p, lo2, hi2);
      int w2;
      const float err2 = level_search<C>(sh, p, x, n_lev, m, w2);
      if (err2 < err) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          lo[c] = lo2[c];
          hi[c] = hi2[c];
        }
        w = w2;
        err = err2;
      }
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (p == c) {
          lo_out[(blk * n_sub + s) * C + c] = lo[c];
          hi_out[(blk * n_sub + s) * C + c] = hi[c];
        }
    }
  }
}

// px: (n, 16, 4) at strides (sb, sp, sc), whole numbers 0..255; inv: the
// 256 codes (int64) of the endpoint values, unq: the n_unq unquantised
// values of the codes; lev: the n_lev weight levels. `_mode_trial` of comps
// C (2: the luma (r + g + b) * float32(1/3) and alpha; 3: RGB; 4: RGBA):
// err (n,), ep (n, 2C) codes [c0 lo, c0 hi, c1 lo, ...], w (n, 16) level
// indices.
template <int C>
__global__ void __launch_bounds__(kFitThreads)
mode_trial_kernel(const float* __restrict__ px, long long sb, long long sp,
                  long long sc, const long long* __restrict__ inv,
                  const float* __restrict__ unq, int n_unq,
                  const float* __restrict__ levels, int n_lev, int ls_iters,
                  float* __restrict__ err_out, int* __restrict__ ep_out,
                  int* __restrict__ w_out, int n) {
  __shared__ float lev[kMaxLevels];
  __shared__ int inv_s[256];
  __shared__ float unq_s[256];
  __shared__ FitScratch scratch[kFitSlots];
  for (int i = threadIdx.x; i < 256; i += kFitThreads) {
    inv_s[i] = (int)inv[i];
    if (i < n_unq) unq_s[i] = unq[i];
  }
  if ((int)threadIdx.x < n_lev) lev[threadIdx.x] = levels[threadIdx.x];
  __syncthreads();
  const int p = threadIdx.x & 15, slot = threadIdx.x >> 4;
  const int blk_id = blockIdx.x * kFitSlots + slot;
  const bool live = blk_id < n;
  const long long blk = live ? blk_id : n - 1;
  FitScratch& sh = scratch[slot];
  float rgba[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) rgba[c] = px[blk * sb + p * sp + c * sc];
  float x[C];
  if constexpr (C == 2) {
    x[0] = __fmul_rn(__fadd_rn(__fadd_rn(rgba[0], rgba[1]), rgba[2]), kThird);
    x[1] = rgba[3];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = rgba[c];
  }
  sh.v[p] = pack4<C>(x);
  __syncwarp();
  float mean[C], cx[C], ax[C];
  block_mean<C, false>(sh, p, 0xffffu, 16.0f, mean);
#pragma unroll
  for (int c = 0; c < C; ++c) cx[c] = __fsub_rn(x[c], mean[c]);
  sh.c[p] = pack4<C>(cx);
  __syncwarp();
  const float pr = principal<C>(sh, p, cx, 6, ax);
  float mn = pr, mx = pr;
#pragma unroll
  for (int o = 8; o; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  float lo_f[C], hi_f[C], lo_u[C], hi_u[C];
  int lo_c[C], hi_c[C];
  // the codes of float endpoints: rounded half to even, clipped, the LUT
  auto quant = [&](float f, int& code, float& u) {
    code = inv_s[(int)fminf(fmaxf(rintf(f), 0.0f), 255.0f)];
    u = unq_s[code];
  };
#pragma unroll
  for (int c = 0; c < C; ++c) {
    lo_f[c] = __fmaf_rn(ax[c], mn, mean[c]);
    hi_f[c] = __fmaf_rn(ax[c], mx, mean[c]);
    quant(lo_f[c], lo_c[c], lo_u[c]);
    quant(hi_f[c], hi_c[c], hi_u[c]);
  }
  rec_exact<C>(sh, lev, n_lev, p, lo_u, hi_u);
  int w;
  float err = level_search<C>(sh, p, x, n_lev, 1.0f, w);
  for (int it = 0; it < ls_iters; ++it) {
    float lo2[C], hi2[C], lo_u2[C], hi_u2[C];
    int lo_c2[C], hi_c2[C];
    ls_solve<C, false>(sh, lev, p, w, 1.0f, lo_f, hi_f, lo2, hi2);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      quant(lo2[c], lo_c2[c], lo_u2[c]);
      quant(hi2[c], hi_c2[c], hi_u2[c]);
    }
    rec_exact<C>(sh, lev, n_lev, p, lo_u2, hi_u2);
    int w2;
    const float err2 = level_search<C>(sh, p, x, n_lev, 1.0f, w2);
    if (err2 < err) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        lo_c[c] = lo_c2[c];
        hi_c[c] = hi_c2[c];
        lo_u[c] = lo_u2[c];
        hi_u[c] = hi_u2[c];
      }
      w = w2;
      err = err2;
    }
  }
  // the full-pixel error: whole numbers, exact in any order
  if constexpr (C == 3) {
    const float d = __fsub_rn(rgba[3], 255.0f);
    err = __fadd_rn(err, exact_sum16(__fmul_rn(d, d)));
  } else if constexpr (C == 2) {
    const float wl = lev[w];
    const float l_rec = rec16(lo_u[0], hi_u[0], wl);
    const float a_rec = rec16(lo_u[1], hi_u[1], wl);
    float e_rgb = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = __fsub_rn(rgba[c], l_rec);
      e_rgb = c ? __fadd_rn(e_rgb, __fmul_rn(d, d)) : __fmul_rn(d, d);
    }
    const float da = __fsub_rn(rgba[3], a_rec);
    err = __fadd_rn(exact_sum16(e_rgb), exact_sum16(__fmul_rn(da, da)));
  }
  if (live) {
    if (p == 0) err_out[blk] = err;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (p == 2 * c) ep_out[blk * 2 * C + p] = lo_c[c];
      if (p == 2 * c + 1) ep_out[blk * 2 * C + p] = hi_c[c];
    }
    w_out[blk * 16 + p] = w;
  }
}

// ---------------------------------------------------------------------------
// host helpers
// ---------------------------------------------------------------------------

unsigned grid_for(long long n, int threads, int cap) {
  const long long blocks = (n + threads - 1) / threads;
  return (unsigned)(blocks < cap ? blocks : cap);
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

// The 32-bit layout, or false where an index or an offset (including the
// K-long axis at strides kst) would reach 2^31.
bool layout32_of(int nd, const long long* meta, long long n, int k_len,
                 const long long* kst, Layout32* m) {
  if (n >= INT_MAX) return false;
  m->nd = nd;
  for (int x = 0; x < 3; ++x) {
    long long reach = kst ? (k_len - 1) * kst[x] : 0;
    for (int d = 0; d < nd; ++d)
      reach += (meta[d] - 1) * meta[kMaxDims + x * kMaxDims + d];
    if (reach >= INT_MAX) return false;
  }
  for (int d = 0; d < kMaxDims; ++d) {
    m->div[d] = fast_div(d < nd ? (uint32_t)meta[d] : 1u);
    for (int x = 0; x < 3; ++x)
      m->st[x][d] = d < nd ? (int32_t)meta[kMaxDims + x * kMaxDims + d] : 0;
  }
  return true;
}

template <int C>
cudaError_t launch_line_fit(const float* v, long long sb, long long sp,
                            long long sc, const long long* label, int n_sub,
                            const float* levels, int n_lev, int ls_iters,
                            float* lo, float* hi, int n, cudaStream_t s) {
  line_fit_kernel<C><<<(n + kFitSlots - 1) / kFitSlots, kFitThreads, 0, s>>>(
      v, sb, sp, sc, label, n_sub, levels, n_lev, ls_iters, lo, hi, n);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_mode_trial(const float* px, long long sb, long long sp,
                              long long sc, const long long* inv,
                              const float* unq, int n_unq,
                              const float* levels, int n_lev,
                              int ls_iters, float* err, int* ep, int* w, int n,
                              cudaStream_t s) {
  mode_trial_kernel<C><<<(n + kFitSlots - 1) / kFitSlots, kFitThreads, 0,
                         s>>>(px, sb, sp, sc, inv, unq, n_unq, levels, n_lev,
                              ls_iters, err, ep, w, n);
  return cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  Layout32 m32;
  if (!layout32_of(nd, meta, n, 1, nullptr, &m32)) {
    xla_fma_kernel64<<<grid_for(n, kThreads, 132 * 64), kThreads, 0, s>>>(
        a, b, c, av, bv, cv, out, n, layout_of(nd, meta));
    return (int)cudaGetLastError();
  }
  // rows of a multiple of 4: every operand contiguous along the row (and
  // 16-byte aligned at each row start) or broadcast along it
  const long long w = meta[nd - 1];
  bool rows = nd <= 2 && w % 4 == 0 && ((uintptr_t)out & 15) == 0;
  const float* ops[3] = {a, b, c};
  Rows r{};
  for (int x = 0; x < 3 && rows; ++x) {
    if (!ops[x]) continue;
    const long long inner = meta[kMaxDims + x * kMaxDims + nd - 1];
    const long long outer = nd == 2 ? meta[kMaxDims + x * kMaxDims] : 0;
    r.inner[x] = (int32_t)inner;
    r.outer[x] = (int32_t)outer;
    if (inner == 1)
      rows = ((uintptr_t)ops[x] & 15) == 0 && outer % 4 == 0;
    else
      rows = inner == 0;
  }
  if (rows) {
    const long long n4 = n / 4;
    xla_fma_kernel_rows<<<grid_for(n4, kThreads, 132 * 64), kThreads, 0, s>>>(
        a, b, c, av, bv, cv, out, (int)n4, fast_div((uint32_t)(w / 4)), r);
  } else {
    xla_fma_kernel32<<<grid_for(n, kThreads, 132 * 64), kThreads, 0, s>>>(
        a, b, c, av, bv, cv, out, (int)n, m32);
  }
  return (int)cudaGetLastError();
}

// order: 0 `_sum` (b unused), 1 `_dot`, 2 `_dot_mm`, 3 `_dot_vec16` (k_len
// 16); ka / kb the operands' strides along the summed axis.
int xla_reduce(const float* a, const float* b, float* out, long long n,
               int k_len, long long ka, long long kb, int order, int nd,
               const long long* meta, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nd < 1 || nd > kMaxDims || k_len < 1 || ka < 0 || kb < 0 ||
      (order == kDotVec16 && k_len != 16) || order < kSum ||
      order > kDotVec16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long kst[3] = {ka, kb, 0};
  Layout32 m32;
  if (layout32_of(nd, meta, n, k_len, kst, &m32)) {
    const unsigned g = grid_for(n, kReduceThreads, 132 * 16);
    const int ni = (int)n, ka32 = (int)ka, kb32 = (int)kb;
    switch (order) {
      case kSum:
        xla_reduce_kernel32<kSum><<<g, kReduceThreads, 0, s>>>(
            a, b, out, ni, k_len, ka32, kb32, m32);
        break;
      case kDot:
        xla_reduce_kernel32<kDot><<<g, kReduceThreads, 0, s>>>(
            a, b, out, ni, k_len, ka32, kb32, m32);
        break;
      case kDotMm:
        xla_reduce_kernel32<kDotMm><<<g, kReduceThreads, 0, s>>>(
            a, b, out, ni, k_len, ka32, kb32, m32);
        break;
      default:
        xla_reduce_kernel32<kDotVec16><<<g, kReduceThreads, 0, s>>>(
            a, b, out, ni, k_len, ka32, kb32, m32);
    }
    return (int)cudaGetLastError();
  }
  const Layout m = layout_of(nd, meta);
  const unsigned g = grid_for(n, kThreads, 132 * 64);
  switch (order) {
    case kSum:
      xla_reduce_kernel64<kSum><<<g, kThreads, 0, s>>>(a, b, out, n, k_len, ka,
                                                       kb, m);
      break;
    case kDot:
      xla_reduce_kernel64<kDot><<<g, kThreads, 0, s>>>(a, b, out, n, k_len, ka,
                                                       kb, m);
      break;
    case kDotMm:
      xla_reduce_kernel64<kDotMm><<<g, kThreads, 0, s>>>(a, b, out, n, k_len,
                                                         ka, kb, m);
      break;
    default:
      xla_reduce_kernel64<kDotVec16><<<g, kThreads, 0, s>>>(a, b, out, n,
                                                            k_len, ka, kb, m);
  }
  return (int)cudaGetLastError();
}

// v: (n, 16, C) at strides (sb, sp, sc), C in 1..4; label: (n, 16) int64
// contiguous, values 0..n_sub - 1 (null: all 0), n_sub in 1..3; levels: the
// n_lev (1..32) weight levels; lo, hi: (n, n_sub, C) out.
int uastc_line_fit(const float* v, long long sb, long long sp, long long sc,
                   const long long* label, int n_sub, const float* levels,
                   int n_lev, int ls_iters, float* lo, float* hi, int n,
                   int n_ch, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_sub < 1 || n_sub > 3 || n_lev < 1 || n_lev > kMaxLevels ||
      ls_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_ch) {
    case 1: return (int)launch_line_fit<1>(v, sb, sp, sc, label, n_sub, levels,
                                           n_lev, ls_iters, lo, hi, n, s);
    case 2: return (int)launch_line_fit<2>(v, sb, sp, sc, label, n_sub, levels,
                                           n_lev, ls_iters, lo, hi, n, s);
    case 3: return (int)launch_line_fit<3>(v, sb, sp, sc, label, n_sub, levels,
                                           n_lev, ls_iters, lo, hi, n, s);
    case 4: return (int)launch_line_fit<4>(v, sb, sp, sc, label, n_sub, levels,
                                           n_lev, ls_iters, lo, hi, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// px: (n, 16, 4) at strides (sb, sp, sc); inv: 256 int64 codes; unq: the
// n_unq (1..256) float32 values of the codes; levels: n_lev (1..32) weight
// levels; comps 2..4; err (n,), ep (n, 2 comps) int32, w (n, 16) int32 out.
int uastc_mode_trial(const float* px, long long sb, long long sp,
                     long long sc, const long long* inv, const float* unq,
                     int n_unq, const float* levels, int n_lev, int comps,
                     int ls_iters, float* err, int* ep, int* w, int n,
                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_unq < 1 || n_unq > 256 || n_lev < 1 || n_lev > kMaxLevels ||
      ls_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (comps) {
    case 2: return (int)launch_mode_trial<2>(px, sb, sp, sc, inv, unq, n_unq,
                                             levels, n_lev, ls_iters, err, ep,
                                             w, n, s);
    case 3: return (int)launch_mode_trial<3>(px, sb, sp, sc, inv, unq, n_unq,
                                             levels, n_lev, ls_iters, err, ep,
                                             w, n, s);
    case 4: return (int)launch_mode_trial<4>(px, sb, sp, sc, inv, unq, n_unq,
                                             levels, n_lev, ls_iters, err, ep,
                                             w, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

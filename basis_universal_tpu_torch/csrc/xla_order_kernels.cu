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
//   (`mode_trial_reference`): the fit of the block's 16 pixels with the
//   endpoints quantised through the mode's tables, and the full-pixel
//   error;
// - uastc_subset_trial<C, S>: a whole 2- or 3-subset mode trial
//   (`subset_trial_reference`): the ideal luma split, the shortlist of the
//   mode's partition patterns, each candidate's masked fits (uastc_line_fit's
//   code), codes, weights and error, the winner and its full-pixel error;
// - uastc_dualplane_trial<N, kLA>: a whole dual-plane mode trial
//   (`dualplane_trial_reference`): every plane-1 channel in turn, its two
//   plane fits, codes, weights and error, the winner (or mode 17's luma
//   and alpha planes).
//
// No Pallas kernel stands behind the UASTC kernels: they replace the
// reference's jitted search (`basis_universal_tpu/codecs/uastc/encode.py`
// `_mode_trial` :56, `_fit_line_masked` :155, `_mode_trial_2subset` :215,
// `_mode_trial_3subset` :328, the dual-plane trials :408, :462, :515),
// which XLA compiles into one program; the port's plain versions are
// chains of hundreds of operators.
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
// each thread runs its chain from there. The line-fit kernel runs a lane
// per pixel (below), so at the search's 24,576 blocks it holds 393k
// threads; a warp issues the ordered chains and the power iteration once
// for its two blocks, and that serial part, not the per-pixel search, sets
// its time (fitting a partition's subsets side by side, each pixel
// searching once, measured slower at every register budget tried). The
// trials give each fit's serial work a lane of its own instead, and the
// per-pixel work a lane per pixel (below): the multi-subset and dual-plane
// trials run a block's fits side by side, the single-subset trial a warp's
// blocks. Their bound is operations (`chip_smoke.py`'s `_line_fit_ops` and
// the trials' counts); they are latency-bound below it.
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
// uastc_line_fit: the UASTC search's masked line fits
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
// moments, whole multiples of 1/4096, are exact in any order and are summed
// by shuffles.

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

// A pixel (its channels x) against the n_lev levels of table t, the
// squared differences added over the channels in order: the first index of
// the least (strict <, from INFINITY), and the least in best.
template <int C>
__device__ __forceinline__ int table_min(const float4* t, int n_lev,
                                         const float (&x)[C], float& best) {
  best = INFINITY;
  int arg = 0;
#pragma unroll 4
  for (int l = 0; l < n_lev; ++l) {
    const float4 r = t[l];
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
  return arg;
}

// This lane's pixel against every level of sh.rec (`table_min`); returns
// the block's error, the minima times m added in pixel order.
template <int C>
__device__ __forceinline__ float level_search(FitScratch& sh, int p,
                                              const float (&x)[C], int n_lev,
                                              float m, int& w) {
  float best;
  w = table_min<C>(sh.rec, n_lev, x, best);
  sh.e[p] = __fmul_rn(best, m);
  __syncwarp();
  const float err = pixel_sum(sh);
  __syncwarp();
  return err;
}

// One least-squares step (`ls_step_reference`): the weights a = (64 - w) /
// 64, b = w / 64 times the mask m, their moments, the P and Q chains over
// the pixels of sh.v (lane k < C runs P_k, lane C + k Q_k), the 2x2 solve;
// where it is singular lo / hi; clamped.
template <int C>
__device__ __forceinline__ void ls_solve(FitScratch& sh, const float* lev,
                                         int p, int w, float m,
                                         const float (&lo)[C],
                                         const float (&hi)[C],
                                         float (&lo2)[C], float (&hi2)[C]) {
  const float wl = lev[w];
  const float a = __fmul_rn(__fmul_rn(__fsub_rn(64.0f, wl), kInv64), m);
  const float b = __fmul_rn(__fmul_rn(wl, kInv64), m);
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

// The block's mean of sh.v over the pixels of `bits`: lane c < C adds
// channel c in pixel order (each term times its 0 / 1 mask), then divides
// by the count; on every lane.
template <int C>
__device__ __forceinline__ void block_mean(FitScratch& sh, int p,
                                           unsigned bits, float cnt,
                                           float (&mean)[C]) {
  if (p < C) {
    float acc = chan(sh.v[0], p);
    acc = __fmul_rn(acc, (bits & 1u) ? 1.0f : 0.0f);
#pragma unroll
    for (int q = 1; q < 16; ++q) {
      float t = chan(sh.v[q], p);
      t = __fmul_rn(t, (bits >> q) & 1u ? 1.0f : 0.0f);
      acc = __fadd_rn(acc, t);
    }
    sh.red[p] = __fdiv_rn(acc, cnt);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < C; ++c) mean[c] = sh.red[c];
  __syncwarp();
}

// `_fit_line_masked` of one subset, uastc_line_fit's body: the pixels sh.v (this lane's own in x), the mask
// `in` (this lane's pixel belongs to the subset); the endpoints (lo, hi),
// the same on every lane of the block. Every lane of the warp calls it
// (ballots and shuffles), and it ends past a __syncwarp, after its last
// read of sh.v.
template <int C>
__device__ __forceinline__ void fit_subset(FitScratch& sh, const float* lev,
                                           int n_lev, int ls_iters, int p,
                                           const float (&x)[C], bool in,
                                           float (&lo)[C], float (&hi)[C]) {
  const unsigned half = threadIdx.x & 16u;  // this block's ballot bits
  const float m = in ? 1.0f : 0.0f;
  const unsigned bits = (__ballot_sync(0xffffffffu, in) >> half) & 0xffffu;
  float mean[C], cx[C], ax[C];
  block_mean<C>(sh, p, bits, fmaxf((float)__popc(bits), 1.0f), mean);
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
    ls_solve<C>(sh, lev, p, w, m, lo, hi, lo2, hi2);
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
  FitScratch& sh = scratch[slot];
  float x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = v[blk * sb + p * sp + c * sc];
  sh.v[p] = pack4<C>(x);
  const long long lab = label ? label[blk * 16 + p] : 0;
  __syncwarp();
  for (int s = 0; s < n_sub; ++s) {
    float lo[C], hi[C];
    fit_subset<C>(sh, lev, n_lev, ls_iters, p, x, lab == s, lo, hi);
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

// The code of a float endpoint (`_quant`): rounded half to even, clipped.
template <class T>
__device__ __forceinline__ int quant_code(const T* inv_s, float f) {
  return inv_s[(int)fminf(fmaxf(rintf(f), 0.0f), 255.0f)];
}

// The sum of (px_alpha - 255)^2 over the block (`_alpha_err`), exact.
__device__ __forceinline__ float alpha_err(float a) {
  const float d = __fsub_rn(a, 255.0f);
  return exact_sum16(__fmul_rn(d, d));
}

// ---------------------------------------------------------------------------
// uastc_subset_trial, uastc_dualplane_trial: the multi-subset and dual-plane
// mode trials, each whole trial in one launch
// ---------------------------------------------------------------------------
//
// A trial's fits (top-k candidates x S subsets; the dual-plane trials' N
// channel choices x 2 planes) are independent until the winner is picked,
// so a warp runs the fits of nb blocks side by side (nb up to 32 / fits a
// block, `trial_blocks_per_warp`): a lane per fit for each fit's serial
// work, a lane per pixel for the per-pixel work (two blocks a pass), the
// phases handing over through the warp's slice of shared memory (ordered
// by __syncwarp; the CTA meets once, after the mode's tables are loaded).
//
// - The luma split and the shortlist keep the plain version's order, two
//   blocks a pass; a k-means round's centres are one chain a lane (lanes p
//   mod 2, or 3, each add one cluster), exchanged by shuffles, and the
//   top-k are repeated maxima of unique keys (score * 64 + 63 - pattern).
// - A fit's lane runs everything that is once per fit: the C mean chains
//   and the C (C + 1) / 2 distinct covariance chains over the block's 16
//   pixels in pixel order (each term times its 0 / 1 mask, as
//   `fit_subset`), the divides, the 4 power-iteration rounds, the extremes
//   of the projections over its pixels, the endpoints and their
//   reconstruction at each weight level (a table in shared memory); after
//   each weight search its error chain in pixel order, and per
//   least-squares step the weights' moments (exact), the 2C P / Q chains,
//   the 2x2 solve and the select. So a warp issues a fit's scalar work
//   once for up to 32 fits, where `fit_subset` issues it once for two.
// - A pixel's lane searches the levels of its own subset's fit only (a
//   masked-out pixel's term in another subset's fit is 0: it adds nothing
//   to that fit's error, and its weight is multiplied by 0 in the moments),
//   once per candidate where `fit_subset` searches once per subset.
// - Every rounding is `fit_subset`'s, term for term, so the trials give
//   uastc_line_fit's bits. The dual-plane trials' one-channel plane fits
//   run in the same lanes as their (N - 1)-channel fits, padded with
//   channels that are 0: a zero channel adds +0 to every chain and product
//   that reaches the real channel's result (whose partial sums are never
//   -0), so the real channel's endpoints keep their bits; their pixels
//   search on the one channel.
//
// Error sums: a squared difference of whole-numbered pixels and
// reconstructions is a whole number, and a block's error over at most 4
// channels is at most 16 x 4 x 255^2 = 4,161,600 < 2^24, so every partial
// sum is exact and any order gives the same bits: four partial sums
// (`sum16`). Only the LA subset trial's luma (mode 16) and the LA plane
// fits are fractional: their sums stay chains in pixel order. A fit's
// weights' moments are multiples of 1/4096 up to 16, exact in any order
// too; the extremes of the projections are exact in any order.

constexpr int kMaxPatterns = 32;
constexpr int kMaxTopk = 8;
constexpr int kMaxCodes = 18;  // 2 x subsets x channels: 3 x 3 for mode 3
constexpr int kTrialWarps = 4;     // warps per CTA (fewer where a warp's
                                   // shared memory is large)
constexpr int kMaxWarpBlocks = 8;  // 4x4 blocks per warp
constexpr int kPix = 6;            // a pixel's slots: r, g, b, a, luma, 0
constexpr int kZeroCh = 5;         // the slot that is 0 (a padded channel)
constexpr int kBlockWords = 100;   // 16 pixels + 4: 8 blocks on 8 banks
constexpr int kItemWords = 17;     // a group's 16 pixel terms, + 1 (banks)
constexpr int kItemBytes = 20;     // a group's 16 weight indices, + 4

// The trials' per-step split (`chip_smoke.py`, measurement only): an
// instance with kStop < kStopAll runs its trial up to that step and writes
// a sum of what it computed to err; the paths' instances run to kStopAll.
enum TrialStop {
  kStopSplit = 1,   // the luma split and the shortlist (dual-plane: loads)
  kStopChains = 2,  // + each fit's mean and covariance chains
  kStopPower = 3,   // + the power iteration and the endpoints
  kStopSearch = 4,  // + the first weight-level search
  kStopSolve = 5,   // + the least-squares steps (solves and searches)
  kStopAll = 6      // + codes, re-chosen weights, the winner and its error
};

// One fit: its pixels (mask), block (in the warp), group (the set of fits
// that share the block's pixels: a candidate, or a dual-plane fit), the
// weight buffer of its current best, its C channels (a slot each, a byte
// each).
struct FitRec {
  uint32_t mask;
  int blk, grp, cur;
  uint32_t ch;
};

// A warp's slice of shared memory, nb blocks of F fits and G groups each,
// L weight levels (`trial_layout`).
struct TrialWarp {
  float4* table;   // [nf][L + 1] each fit's reconstruction per level
  float* pix;      // [nb][kBlockWords] the pixels' kPix slots
  FitRec* fit;     // [nf]
  float* best;     // [nb * G][kItemWords] a pixel's least error per group
  uint8_t* wl0;    // [nb * G][kItemBytes] its level: two buffers (by
  uint8_t* wl1;    // name, so that R stays in registers)
  uint8_t* code;   // [nf][8] endpoint codes
  float* gerr;     // [nb * G] each group's error
  int* cand;       // [nb][kMaxTopk] the shortlist
  int nb, nf, G, L;
};

// The slice's byte offsets (each 16-byte aligned) and its size; with base,
// the pointers of R.
__host__ __device__ inline int trial_layout(int nb, int F, int G, int L,
                                            char* base, TrialWarp* R) {
  const int nf = nb * F;
  const int n_tab = nf * (L + 1) > nb * 16 ? nf * (L + 1) : nb * 16;
  int off = 0;
  int o[9];
  const int bytes[9] = {n_tab * 16,
                         nb * kBlockWords * 4,
                         nf * (int)sizeof(FitRec),
                         nb * G * kItemWords * 4,
                         nb * G * kItemBytes,
                         nb * G * kItemBytes,
                         nf * 8,
                         nb * G * 4,
                         nb * kMaxTopk * 4};
  for (int i = 0; i < 9; ++i) {
    o[i] = off;
    off += (bytes[i] + 15) & ~15;
  }
  if (R) {
    R->table = reinterpret_cast<float4*>(base + o[0]);
    R->pix = reinterpret_cast<float*>(base + o[1]);
    R->fit = reinterpret_cast<FitRec*>(base + o[2]);
    R->best = reinterpret_cast<float*>(base + o[3]);
    R->wl0 = reinterpret_cast<uint8_t*>(base + o[4]);
    R->wl1 = reinterpret_cast<uint8_t*>(base + o[5]);
    R->code = reinterpret_cast<uint8_t*>(base + o[6]);
    R->gerr = reinterpret_cast<float*>(base + o[7]);
    R->cand = reinterpret_cast<int*>(base + o[8]);
    R->nb = nb;
    R->nf = nf;
    R->G = G;
    R->L = L;
  }
  return off;
}

__device__ __forceinline__ uint8_t* weight_buf(const TrialWarp& R, int i) {
  return i ? R.wl1 : R.wl0;
}

// This warp's nb blocks (from blk0; past n the last repeats) into R.pix.
__device__ __forceinline__ void load_pixels(const TrialWarp& R,
                                            const float* px, long long sb,
                                            long long sp, long long sc,
                                            long long blk0, int n, int lane) {
  for (int i = lane; i < R.nb * 16; i += 32) {
    const int b = i >> 4, q = i & 15;
    const long long blk = blk0 + b < n ? blk0 + b : n - 1;
    float* d = R.pix + b * kBlockWords + q * kPix;
    float rgba[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      rgba[c] = px[blk * sb + q * sp + c * sc];
      d[c] = rgba[c];
    }
    // the luma: `_la`'s (r + g + b) * float32(1/3), or `_mean3`'s (the same
    // bits: a sum of three whole numbers is exact)
    d[4] = __fmul_rn(__fadd_rn(__fadd_rn(rgba[0], rgba[1]), rgba[2]), kThird);
    d[kZeroCh] = 0.0f;
  }
}

template <int C>
__device__ __forceinline__ void fit_channels(const FitRec& fr, int (&ch)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) ch[c] = (fr.ch >> (8 * c)) & 255u;
}

// The reconstruction of float endpoints at each level (`rec_fused`'s) into
// fit f's table.
template <int C>
__device__ __forceinline__ void fit_table(const TrialWarp& R, const float* lev,
                                          int f, const float (&lo)[C],
                                          const float (&hi)[C]) {
  float4* t = R.table + f * (R.L + 1);
#pragma unroll 2
  for (int l = 0; l < R.L; ++l) {
    const float w = lev[l], w0 = __fsub_rn(64.0f, w);
    float r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float acc = __fmaf_rn(w0, lo[c], __fmul_rn(hi[c], w));
      r[c] = floorf(__fmul_rn(__fmaf_rn(acc, 257.0f, 32.0f), kInv16384));
    }
    t[l] = pack4<C>(r);
  }
}

// `iters` rounds of the power iteration (`principal`'s, term for term) on
// the distinct covariance entries cv (i <= j, row by row; fma is symmetric
// in its two factors, so entry (j, i) is entry (i, j)): the product chain,
// the rounded sum of squares, the correctly rounded root, + 1e-6 and the
// divide.
template <int C>
__device__ __forceinline__ void power_axis(const float (&cv)[C * (C + 1) / 2],
                                           int iters, float (&ax)[C]) {
  auto cov = [&](int i, int j) {
    const int a = i < j ? i : j, b = i < j ? j : i;
    return cv[a * C - a * (a - 1) / 2 + (b - a)];
  };
#pragma unroll
  for (int i = 0; i < C; ++i) ax[i] = 1.0f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float w[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      float s = __fmul_rn(cov(i, 0), ax[0]);
#pragma unroll
      for (int j = 1; j < C; ++j) s = __fmaf_rn(cov(i, j), ax[j], s);
      w[i] = s;
    }
    float sq = __fmul_rn(w[0], w[0]);
#pragma unroll
    for (int i = 1; i < C; ++i) sq = __fadd_rn(sq, __fmul_rn(w[i], w[i]));
    const float den = __fadd_rn(__fsqrt_rn(sq), 1e-6f);
#pragma unroll
    for (int i = 0; i < C; ++i) ax[i] = __fdiv_rn(w[i], den);
  }
}

// A fit's lane, the first part of `fit_subset`: the masked mean, the
// covariance chains, 4 power-iteration rounds, the extremes of the
// projections over its pixels, the endpoints (lo, hi) and their table.
// Below kStopAll it returns a sum of what it computed at its stop.
template <int C, int kStop>
__device__ __forceinline__ float fit_begin(const TrialWarp& R,
                                           const float* lev, int f,
                                           float (&lo)[C], float (&hi)[C]) {
  const FitRec& fr = R.fit[f];
  const float* px = R.pix + fr.blk * kBlockWords;
  const unsigned bits = fr.mask;
  int ch[C];
  fit_channels<C>(fr, ch);
  float mean[C];
  {
    float acc[C];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float m = (bits >> q) & 1u ? 1.0f : 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float t = __fmul_rn(px[q * kPix + ch[c]], m);
        acc[c] = q ? __fadd_rn(acc[c], t) : t;
      }
    }
    const float cnt = fmaxf((float)__popc(bits), 1.0f);
#pragma unroll
    for (int c = 0; c < C; ++c) mean[c] = __fdiv_rn(acc[c], cnt);
  }
  // the distinct covariance entries (i <= j; fma is symmetric in i, j)
  constexpr int kCov = C * (C + 1) / 2;
  float cv[kCov];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float m = (bits >> q) & 1u ? 1.0f : 0.0f;
    float cx[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      cx[c] = __fmul_rn(__fsub_rn(px[q * kPix + ch[c]], mean[c]), m);
    int k = 0;
#pragma unroll
    for (int i = 0; i < C; ++i)
#pragma unroll
      for (int j = i; j < C; ++j, ++k)
        cv[k] = q ? __fmaf_rn(cx[i], cx[j], cv[k]) : __fmul_rn(cx[i], cx[j]);
  }
  if constexpr (kStop == kStopChains) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kCov; ++k) s = __fadd_rn(s, cv[k]);
#pragma unroll
    for (int c = 0; c < C; ++c) s = __fadd_rn(s, mean[c]);
    return s;
  }
  float ax[C];
  power_axis<C>(cv, 4, ax);
  float mn4[4] = {1e9f, 1e9f, 1e9f, 1e9f};
  float mx4[4] = {-1e9f, -1e9f, -1e9f, -1e9f};
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    if ((bits >> q) & 1u) {
      float pr = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float cx = __fsub_rn(px[q * kPix + ch[c]], mean[c]);
        pr = c ? __fmaf_rn(cx, ax[c], pr) : __fmul_rn(cx, ax[c]);
      }
      mn4[q & 3] = fminf(mn4[q & 3], pr);
      mx4[q & 3] = fmaxf(mx4[q & 3], pr);
    }
  }
  const float mn = fminf(fminf(mn4[0], mn4[1]), fminf(mn4[2], mn4[3]));
  const float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
#pragma unroll
  for (int c = 0; c < C; ++c) {
    lo[c] = clamp255(__fmaf_rn(ax[c], mn, mean[c]));
    hi[c] = clamp255(__fmaf_rn(ax[c], mx, mean[c]));
  }
  if constexpr (kStop == kStopPower) {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) s = __fadd_rn(s, __fadd_rn(lo[c], hi[c]));
    return s;
  }
  fit_table<C>(R, lev, f, lo, hi);
  return 0.0f;
}

// The sum of 16 terms e[q] (those of `bits`; 0 for the others): kWhole,
// whole numbers whose every partial sum is exact, in four partial sums (the
// same bits as any order); otherwise in pixel order, as `pixel_sum`.
template <bool kWhole>
__device__ __forceinline__ float sum16(const float* e, unsigned bits) {
  if constexpr (kWhole) {
    float s[4];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float t = (bits >> q) & 1u ? e[q] : 0.0f;
      s[q & 3] = q < 4 ? t : __fadd_rn(s[q & 3], t);
    }
    return __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
  } else {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float t = (bits >> q) & 1u ? e[q] : 0.0f;
      acc = q ? __fadd_rn(acc, t) : t;
    }
    return acc;
  }
}

// A fit's error after a search: its pixels' least errors (0 for the
// others), as `level_search`'s pixel_sum.
template <bool kWhole>
__device__ __forceinline__ float fit_error(const TrialWarp& R,
                                           const FitRec& fr) {
  return sum16<kWhole>(R.best + (fr.blk * R.G + fr.grp) * kItemWords,
                       fr.mask);
}

// The 2x2 least-squares solve of a step (`ls_solve`'s) from the weights'
// moments and the P and Q chains: where it is singular lo / hi; clamped.
template <int C>
__device__ __forceinline__ void solve_endpoints(
    float sa, float sab, float sb2, const float (&P)[C], const float (&Q)[C],
    const float (&lo)[C], const float (&hi)[C], float (&lo2)[C],
    float (&hi2)[C]) {
  const float det = __fmaf_rn(sa, sb2, -__fmul_rn(sab, sab));
  const bool ok = fabsf(det) > 1e-6f;
  const float dd = ok ? det : 1.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float ln = __fdiv_rn(__fmaf_rn(sb2, P[c], -__fmul_rn(sab, Q[c])), dd);
    const float hn = __fdiv_rn(__fmaf_rn(sa, Q[c], -__fmul_rn(sab, P[c])), dd);
    lo2[c] = clamp255(ok ? ln : lo[c]);
    hi2[c] = clamp255(ok ? hn : hi[c]);
  }
}

// A fit's lane, one least-squares step (`ls_solve`'s): the weights of its
// current best (0 outside its pixels), their moments, the P and Q chains in
// pixel order, the 2x2 solve; where it is singular lo / hi; clamped.
template <int C>
__device__ __forceinline__ void fit_solve(const TrialWarp& R,
                                          const float* lev, const FitRec& fr,
                                          const float (&lo)[C],
                                          const float (&hi)[C],
                                          float (&lo2)[C], float (&hi2)[C]) {
  const float* px = R.pix + fr.blk * kBlockWords;
  const uint8_t* wv =
      weight_buf(R, fr.cur) + (fr.blk * R.G + fr.grp) * kItemBytes;
  int ch[C];
  fit_channels<C>(fr, ch);
  // the moments: multiples of 1/4096 up to 16, exact in any order (two
  // partial sums each)
  float sa2[2] = {0.0f, 0.0f}, sab2[2] = {0.0f, 0.0f}, sb22[2] = {0.0f, 0.0f};
  float P[C], Q[C];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float m = (fr.mask >> q) & 1u ? 1.0f : 0.0f;
    const float wl = lev[wv[q]];
    const float a = __fmul_rn(__fmul_rn(__fsub_rn(64.0f, wl), kInv64), m);
    const float b = __fmul_rn(__fmul_rn(wl, kInv64), m);
    sa2[q & 1] = __fadd_rn(sa2[q & 1], __fmul_rn(a, a));
    sab2[q & 1] = __fadd_rn(sab2[q & 1], __fmul_rn(a, b));
    sb22[q & 1] = __fadd_rn(sb22[q & 1], __fmul_rn(b, b));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float v = px[q * kPix + ch[c]];
      P[c] = q ? __fmaf_rn(a, v, P[c]) : __fmul_rn(a, v);
      Q[c] = q ? __fmaf_rn(b, v, Q[c]) : __fmul_rn(b, v);
    }
  }
  solve_endpoints<C>(__fadd_rn(sa2[0], sa2[1]), __fadd_rn(sab2[0], sab2[1]),
                     __fadd_rn(sb22[0], sb22[1]), P, Q, lo, hi, lo2, hi2);
}

// Pixel q of block b (its channels x) against the levels of fit f's
// table (`table_min`); into R.best and weight buffer buf (buf < 0: the one
// after the fit's current best) at the block's group g.
template <int C>
__device__ __forceinline__ void search_table(const TrialWarp& R, int b,
                                             int g, int q, int f,
                                             const float (&x)[C], int buf) {
  float best;
  const int arg = table_min<C>(R.table + f * (R.L + 1), R.L, x, best);
  const int item = b * R.G + g;
  R.best[item * kItemWords + q] = best;
  weight_buf(R, buf < 0 ? 1 - R.fit[f].cur : buf)[item * kItemBytes + q] =
      (uint8_t)arg;
}

// The subset trials' pixel lanes: each pixel (C channels: RGB(A), or LA's
// luma and alpha) against its subset's fit in each candidate
// (fit_of(b, k, q)).
template <int C, class FitOf>
__device__ __forceinline__ void search_subsets(const TrialWarp& R, int lane,
                                               int buf, FitOf fit_of) {
  for (int base = 0; base < R.nb; base += 2) {
    const int b = base + (lane >> 4), q = lane & 15;
    if (b >= R.nb) continue;
    const float* px = R.pix + b * kBlockWords + q * kPix;
    float x[C];
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = px[C == 2 ? 4 - c : c];
    for (int k = 0; k < R.G; ++k)
      search_table<C>(R, b, k, q, fit_of(b, k, q), x, buf);
  }
}

// The dual-plane trials' pixel lanes: each pixel against each choice's
// plane-0 fit (the other channels) and plane-1 fit (its one channel; LA
// the luma and the alpha), fit b kF + group.
template <int N, bool kLA>
__device__ __forceinline__ void search_planes(const TrialWarp& R, int lane,
                                              int buf) {
  constexpr int kF = kLA ? 2 : 2 * N;
  for (int base = 0; base < R.nb; base += 2) {
    const int b = base + (lane >> 4), q = lane & 15;
    if (b >= R.nb) continue;
    const float* px = R.pix + b * kBlockWords + q * kPix;
    if constexpr (kLA) {
      const float xl[1] = {px[4]}, xa[1] = {px[3]};
      search_table<1>(R, b, 0, q, b * kF, xl, buf);
      search_table<1>(R, b, 1, q, b * kF + 1, xa, buf);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float xo[N - 1];
#pragma unroll
        for (int c = 0; c < N - 1; ++c) xo[c] = px[c < j ? c : c + 1];
        const float x1[1] = {px[j]};
        search_table<N - 1>(R, b, j, q, b * kF + j, xo, buf);
        search_table<1>(R, b, N + j, q, b * kF + N + j, x1, buf);
      }
    }
  }
}

// Every fit of the warp (the fits' FitRecs set, lane f < nf fit f), each
// `fit_subset` of its pixels: ls_iters least-squares steps after the first
// search (search(buf): the pixel lanes' search into weight buffer buf); its
// endpoints (lo, hi) on its lane. Every lane of the warp calls it. Below
// kStopAll it stops at its step and returns a sum of what the
// lane computed there (0 on the lanes that have no fit).
template <int C, int kStop, bool kWhole, class Search>
__device__ __forceinline__ float fit_all(const TrialWarp& R, const float* lev,
                                         int ls_iters, int lane, Search search,
                                         float (&lo)[C], float (&hi)[C]) {
  const bool has_fit = lane < R.nf;
  float err = 0.0f, sink = 0.0f;
  if (has_fit) sink = fit_begin<C, kStop>(R, lev, lane, lo, hi);
  if constexpr (kStop < kStopSearch) return sink;
  __syncwarp();
  search(0);
  __syncwarp();
  if (has_fit) err = fit_error<kWhole>(R, R.fit[lane]);
  if constexpr (kStop == kStopSearch) return err;
  for (int it = 0; it < ls_iters; ++it) {
    float lo2[C], hi2[C];
    if (has_fit) {
      fit_solve<C>(R, lev, R.fit[lane], lo, hi, lo2, hi2);
      fit_table<C>(R, lev, lane, lo2, hi2);
    }
    __syncwarp();
    search(-1);
    __syncwarp();
    if (has_fit) {
      FitRec& fr = R.fit[lane];
      const float err2 = fit_error<kWhole>(R, fr);
      if (err2 < err) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          lo[c] = lo2[c];
          hi[c] = hi2[c];
        }
        err = err2;
        fr.cur = 1 - fr.cur;
      }
    }
  }
  if (has_fit) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      sink = __fadd_rn(sink, __fadd_rn(lo[c], hi[c]));
  }
  __syncwarp();
  return sink;
}

// The decoder's reconstruction (`rec16`) of quantised endpoints at each
// level into table t.
template <int C>
__device__ __forceinline__ void exact_table(float4* t, const float* lev,
                                            int n_lev, const float (&lo_u)[C],
                                            const float (&hi_u)[C]) {
#pragma unroll 2
  for (int l = 0; l < n_lev; ++l) {
    float r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = rec16(lo_u[c], hi_u[c], lev[l]);
    t[l] = pack4<C>(r);
  }
}

// The block's pixels' luma whose bit is set in `bits`, added in pixel order
// from pixel 0 (`_sum16` of luma times a 0 / 1 mask).
__device__ __forceinline__ float luma_chain(const float* px, unsigned bits) {
  float acc = (bits & 1u) ? px[4] : 0.0f;
#pragma unroll
  for (int i = 1; i < 16; ++i)
    acc = __fadd_rn(acc, (bits >> i) & 1u ? px[i * kPix + 4] : 0.0f);
  return acc;
}

// The first index of the least of n errors (strict <, from INFINITY).
__device__ __forceinline__ int first_min(const float* e, int n) {
  float best = INFINITY;
  int arg = 0;
  for (int k = 0; k < n; ++k)
    if (e[k] < best) {
      best = e[k];
      arg = k;
    }
  return arg;
}

// The mode's tables into shared memory (load_mode_tables', the codes as
// bytes: there are at most 256) for a CTA of any size.
__device__ __forceinline__ void load_trial_tables(
    const long long* inv, const float* unq, int n_unq, const float* levels,
    int n_lev, uint8_t* inv_s, float* unq_s, float* lev) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    inv_s[i] = (uint8_t)inv[i];
    if (i < n_unq) unq_s[i] = unq[i];
    if (i < n_lev) lev[i] = levels[i];
  }
}

// px: (n, 16, 4) at strides (sb, sp, sc), whole numbers 0..255; pats: the
// n_pat (<= 32) partition patterns of the mode, (n_pat, 16) int64 subsets;
// inv, unq, levels as mode_trial_kernel's. `subset_trial_reference` of C
// comps (2: LA, 3: RGB, 4: RGBA) and S subsets (2 or 3) with a shortlist of
// topk (<= 8, <= n_pat) patterns: err (n,), ep (n, 2 S C) codes [subset 0:
// c0 lo, c0 hi, c1 lo, ..., subset 1: ...], w (n, 16) level indices, pat
// (n,) the winning pattern. A warp takes nb blocks (trial_blocks_per_warp
// of topk x S fits at most), its slice of the dynamic shared memory
// trial_layout's.
template <int C, int S, int kStop>
__global__ void __launch_bounds__(kTrialWarps * 32)
subset_trial_kernel(const float* __restrict__ px, long long sb, long long sp,
                    long long sc, const long long* __restrict__ pats,
                    int n_pat, const long long* __restrict__ inv,
                    const float* __restrict__ unq, int n_unq,
                    const float* __restrict__ levels, int n_lev, int ls_iters,
                    int topk, float* __restrict__ err_out,
                    int* __restrict__ ep_out, int* __restrict__ w_out,
                    int* __restrict__ pat_out, int n, int nb) {
  constexpr int kCodes = 2 * S * C;
  static_assert(kCodes <= kMaxCodes, "endpoint codes");
  __shared__ float lev[kMaxLevels];
  __shared__ uint8_t inv_s[256];
  __shared__ float unq_s[256];
  __shared__ unsigned pmask[kMaxPatterns][2];  // the pixels of subsets 1, 2
  extern __shared__ __align__(16) uint8_t trial_smem[];
  load_trial_tables(inv, unq, n_unq, levels, n_lev, inv_s, unq_s, lev);
  if ((int)threadIdx.x < n_pat) {
    unsigned m1 = 0, m2 = 0;
    for (int i = 0; i < 16; ++i) {
      const long long s = pats[threadIdx.x * 16 + i];
      m1 |= (s == 1 ? 1u : 0u) << i;
      m2 |= (s == 2 ? 1u : 0u) << i;
    }
    pmask[threadIdx.x][0] = m1;
    pmask[threadIdx.x][1] = m2;
  }
  __syncthreads();
  const int F = topk * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  TrialWarp R;
  const int bytes = trial_layout(nb, F, topk, n_lev, nullptr, nullptr);
  trial_layout(nb, F, topk, n_lev, (char*)trial_smem + warp * bytes, &R);
  const long long blk0 =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * nb;
  if (blk0 >= n) return;  // a warp past the last block
  load_pixels(R, px, sb, sp, sc, blk0, n, lane);
  __syncwarp();

  // 1. each block's ideal split of the luma: 2-means (3 rounds from the
  //    extremes) or 3-means (from the extremes and the mean); ideal[k]: the
  //    pixels of cluster k (S 2: ideal[0], the pixels nearer c1); then each
  //    pattern's agreement with the split (whole numbers), and the
  //    shortlist: the topk highest, equal scores by ascending index (the
  //    stable descending sort of `_shortlist_desc`). Two blocks a pass.
  const unsigned half = lane & 16u;
  for (int base = 0; base < nb; base += 2) {
    const int b_raw = base + (lane >> 4), p = lane & 15;
    const int b = b_raw < nb ? b_raw : nb - 1;
    const float* bpx = R.pix + b * kBlockWords;
    const float luma = bpx[p * kPix + 4];
    float lmin = luma, lmax = luma;
#pragma unroll
    for (int o = 8; o; o >>= 1) {
      lmin = fminf(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
    }
    unsigned ideal[3] = {0u, 0u, 0u};
    if constexpr (S == 2) {
      float c0 = lmin, c1 = lmax;
      for (int r = 0; r <= 3; ++r) {
        const bool side =
            fabsf(__fsub_rn(luma, c1)) < fabsf(__fsub_rn(luma, c0));
        const unsigned b1 =
            (__ballot_sync(0xffffffffu, side) >> half) & 0xffffu;
        if (r == 3) {
          ideal[0] = b1;
          break;
        }
        // the centres, a chain each: c1 of the pixels nearer c1 on the odd
        // lanes, c0 of the others on the even ones, then exchanged
        const unsigned bits = p & 1 ? b1 : ~b1 & 0xffffu;
        const float cp = __fdiv_rn(luma_chain(bpx, bits),
                                   fmaxf((float)__popc(bits), 1.0f));
        c0 = __shfl_sync(0xffffffffu, cp, half);
        c1 = __shfl_sync(0xffffffffu, cp, half | 1u);
      }
    } else {
      float c[3] = {lmin, __fdiv_rn(luma_chain(bpx, 0xffffu), 16.0f), lmax};
      for (int r = 0; r < 3; ++r) {
        const float d0 = fabsf(__fsub_rn(luma, c[0]));
        const float d1 = fabsf(__fsub_rn(luma, c[1]));
        const float d2 = fabsf(__fsub_rn(luma, c[2]));
        int lab = 0;
        float best = d0;
        if (d1 < best) {
          lab = 1;
          best = d1;
        }
        if (d2 < best) lab = 2;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          ideal[k] = (__ballot_sync(0xffffffffu, lab == k) >> half) & 0xffffu;
        // the labels of the last round are the split; its centres unused;
        // centre k's chain on the lanes p = k mod 3, then exchanged
        if (r < 2) {
          const int k = p % 3;
          const unsigned bits = k == 0 ? ideal[0] : k == 1 ? ideal[1]
                                                           : ideal[2];
          const float cp = __fdiv_rn(luma_chain(bpx, bits),
                                     fmaxf((float)__popc(bits), 1.0f));
#pragma unroll
          for (int j = 0; j < 3; ++j)
            c[j] = __shfl_sync(0xffffffffu, cp, half | (unsigned)j);
        }
      }
    }
    // each pattern's key, score * 64 + 63 - pattern (unique: the highest
    // first, equal scores by ascending index), two a lane; the topk highest
    // by repeated maxima over the block's 16 lanes
    int kq[2] = {-1, -1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = p + 16 * i;
      if (q < n_pat) {
        const unsigned m1 = pmask[q][0], m2 = pmask[q][1];
        int score;
        if constexpr (S == 2) {
          const int agree = 16 - __popc(ideal[0] ^ m1);
          score = max(agree, 16 - agree);
        } else {
          const unsigned pm[3] = {~(m1 | m2) & 0xffffu, m1, m2};
          int conf[3][3];
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int j = 0; j < 3; ++j) conf[k][j] = __popc(ideal[k] & pm[j]);
          score = max(max(conf[0][0] + conf[1][1] + conf[2][2],
                          conf[0][0] + conf[1][2] + conf[2][1]),
                      max(max(conf[0][1] + conf[1][0] + conf[2][2],
                              conf[0][1] + conf[1][2] + conf[2][0]),
                          max(conf[0][2] + conf[1][0] + conf[2][1],
                              conf[0][2] + conf[1][1] + conf[2][0])));
        }
        kq[i] = score * 64 + 63 - q;
      }
    }
    for (int k = 0; k < topk; ++k) {
      int m = max(kq[0], kq[1]);
#pragma unroll
      for (int o = 8; o; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (p == 0 && b_raw < nb) R.cand[b * kMaxTopk + k] = 63 - (m & 63);
      if (kq[0] == m) kq[0] = -1;
      if (kq[1] == m) kq[1] = -1;
    }
  }
  __syncwarp();
  if constexpr (kStop == kStopSplit) {
    if (lane < nb && blk0 + lane < n)
      err_out[blk0 + lane] = (float)R.cand[lane * kMaxTopk + topk - 1];
    return;
  }
  // 2. the fits: fit (b, k, s) on lane (b topk + k) S + s, the pixels of
  //    subset s of candidate k
  const int nf = R.nf;
  if (lane < nf) {
    const int b = lane / F, k = (lane % F) / S, s = lane % S;
    const int q = R.cand[b * kMaxTopk + k];
    const unsigned m1 = pmask[q][0], m2 = pmask[q][1];
    FitRec& fr = R.fit[lane];
    fr.mask = s == 0 ? ~(m1 | m2) & 0xffffu : s == 1 ? m1 : m2;
    fr.blk = b;
    fr.grp = k;
    fr.cur = 0;
    fr.ch = C == 2 ? 4u | 3u << 8 : 0u | 1u << 8 | 2u << 16 | 3u << 24;
  }
  // each pixel's fit in candidate k: its subset's
  auto fit_of = [&](int b, int k, int q) {
    const int pat = R.cand[b * kMaxTopk + k];
    const int lab = (int)((pmask[pat][0] >> q) & 1u) +
                    2 * (int)((pmask[pat][1] >> q) & 1u);
    return (b * topk + k) * S + lab;
  };
  float lo[C], hi[C];
  {
    const float sink = fit_all<C, kStop, C != 2>(
        R, lev, ls_iters, lane,
        [&](int buf) { search_subsets<C>(R, lane, buf, fit_of); }, lo, hi);
    if constexpr (kStop < kStopAll) {
      const long long blk = blk0 + lane / F;
      if (lane < nf && blk < n) err_out[blk] = sink;
      return;
    }
  }

  // 3. each fit's codes and the reconstruction of its quantised endpoints
  if (lane < nf) {
    float lo_u[C], hi_u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int lc = quant_code(inv_s, lo[c]), hc = quant_code(inv_s, hi[c]);
      R.code[lane * 8 + 2 * c] = (uint8_t)lc;
      R.code[lane * 8 + 2 * c + 1] = (uint8_t)hc;
      lo_u[c] = unq_s[lc];
      hi_u[c] = unq_s[hc];
    }
    exact_table<C>(R.table + lane * (n_lev + 1), lev, n_lev, lo_u, hi_u);
  }
  __syncwarp();
  // 4. each pixel's weights re-chosen through the quantised endpoints of
  //    its subset (`_subset_rec_err`), per candidate; each candidate's
  //    error in pixel order
  search_subsets<C>(R, lane, 0, fit_of);
  __syncwarp();
  for (int i = lane; i < nb * topk; i += 32)
    R.gerr[i] = sum16<C != 2>(R.best + i * kItemWords, 0xffffu);
  __syncwarp();

  // 5. the winner by strict <, in shortlist order, and its full-pixel
  //    error: RGB adds the alpha's; LA re-expresses the winner in
  //    full-pixel units, each operation rounded, the 48 RGB terms and the
  //    16 alpha terms two chains in (pixel, channel) order
  for (int base = 0; base < nb; base += 2) {
    const int b_raw = base + (lane >> 4), p = lane & 15;
    const int b = b_raw < nb ? b_raw : nb - 1;
    const long long blk = blk0 + b_raw;
    const bool live = b_raw < nb && blk < n;
    const float* rgba = R.pix + b * kBlockWords + p * kPix;
    const int kw = first_min(R.gerr + b * topk, topk);
    const int item = b * topk + kw;
    float best_err = R.gerr[item];
    const int best_w = R.wl0[item * kItemBytes + p];
    if constexpr (C == 3) {
      best_err = __fadd_rn(best_err, alpha_err(rgba[3]));
    } else if constexpr (C == 2) {
      const int f = fit_of(b, kw, p);
      const float wl = lev[best_w], wl0 = __fsub_rn(64.0f, wl);
      float ch[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lu = unq_s[R.code[f * 8 + 2 * c]];
        const float hu = unq_s[R.code[f * 8 + 2 * c + 1]];
        ch[c] = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(lu, wl0),
                                              __fmul_rn(hu, wl)),
                                    32.0f),
                          kInv64);
      }
      float4* t4 = R.table + b * 16;  // past the last use of the tables
      float t[4];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float d = __fsub_rn(rgba[c], ch[0]);
        t[c] = __fmul_rn(d, d);
      }
      const float da = __fsub_rn(rgba[3], ch[1]);
      t[3] = __fmul_rn(da, da);
      __syncwarp();
      if (b_raw < nb) t4[p] = make_float4(t[0], t[1], t[2], t[3]);
      __syncwarp();
      float acc_rgb = 0.0f, acc_a = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 q = t4[i];
        acc_rgb = i ? __fadd_rn(acc_rgb, q.x) : q.x;
        acc_rgb = __fadd_rn(acc_rgb, q.y);
        acc_rgb = __fadd_rn(acc_rgb, q.z);
        acc_a = i ? __fadd_rn(acc_a, q.w) : q.w;
      }
      best_err = __fadd_rn(acc_rgb, acc_a);
    }
    if (live) {
      if (p == 0) {
        err_out[blk] = best_err;
        pat_out[blk] = R.cand[b * kMaxTopk + kw];
      }
      for (int j = p; j < kCodes; j += 16)
        ep_out[blk * kCodes + j] =
            R.code[((b * topk + kw) * S + j / (2 * C)) * 8 + j % (2 * C)];
      w_out[blk * 16 + p] = best_w;
    }
  }
}

// px, inv, unq, levels as mode_trial_kernel's. `dualplane_trial_reference`:
// N 3 (mode 6, RGB, plus the alpha's error) or 4 (modes 11 and 13, RGBA),
// each channel in turn (ccs) on plane 1 and the others on plane 0; or kLA
// (N 2, mode 17): the luma on plane 0, scored against R, G and B, the
// alpha on plane 1. err (n,), ep (n, 2N) codes [c0 lo, c0 hi, c1 lo, ...]
// (LA: [luma lo, luma hi, alpha lo, alpha hi]), w (n, 32) the two planes'
// level indices interleaved, ccs (n,) (not written for LA). The fits of a
// block: plane 0 of each ccs (N - 1 channels), then plane 1 of each (one
// channel, padded to N - 1 with zero channels); LA the luma, then the
// alpha. A warp takes nb blocks (trial_blocks_per_warp of 2N fits at
// most).
template <int N, bool kLA, int kStop>
__global__ void __launch_bounds__(kTrialWarps * 32)
dualplane_trial_kernel(const float* __restrict__ px, long long sb,
                       long long sp, long long sc,
                       const long long* __restrict__ inv,
                       const float* __restrict__ unq, int n_unq,
                       const float* __restrict__ levels, int n_lev,
                       int ls_iters, float* __restrict__ err_out,
                       int* __restrict__ ep_out, int* __restrict__ w_out,
                       int* __restrict__ ccs_out, int n, int nb) {
  constexpr int kC = kLA ? 1 : N - 1;    // the fits' channels
  constexpr int kF = kLA ? 2 : 2 * N;    // fits per block
  constexpr int kChoices = kLA ? 1 : N;  // ccs choices per block
  __shared__ float lev[kMaxLevels];
  __shared__ uint8_t inv_s[256];
  __shared__ float unq_s[256];
  extern __shared__ __align__(16) uint8_t trial_smem[];
  load_trial_tables(inv, unq, n_unq, levels, n_lev, inv_s, unq_s, lev);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  TrialWarp R;
  const int bytes = trial_layout(nb, kF, kF, n_lev, nullptr, nullptr);
  trial_layout(nb, kF, kF, n_lev, (char*)trial_smem + warp * bytes, &R);
  const long long blk0 =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * nb;
  if (blk0 >= n) return;  // a warp past the last block
  load_pixels(R, px, sb, sp, sc, blk0, n, lane);
  if (lane < R.nf) {
    const int b = lane / kF, j = lane % kF;
    FitRec& fr = R.fit[lane];
    fr.mask = 0xffffu;
    fr.blk = b;
    fr.grp = j;
    fr.cur = 0;
    uint32_t ch = 0;
    if constexpr (kLA) {
      ch = j == 0 ? 4u : 3u;
    } else if (j < N) {
      for (int c = 0; c < N - 1; ++c)
        ch |= (uint32_t)(c < j ? c : c + 1) << (8 * c);
    } else {
      ch = (uint32_t)(j - N);
      for (int c = 1; c < N - 1; ++c) ch |= (uint32_t)kZeroCh << (8 * c);
    }
    fr.ch = ch;
  }
  __syncwarp();
  if constexpr (kStop == kStopSplit) {
    if (lane < nb && blk0 + lane < n)
      err_out[blk0 + lane] = R.pix[lane * kBlockWords];
    return;
  }
  // the fits' endpoints, [fit][lo 4, hi 4], in the terms' place once the
  // fits are done
  float* lohi = R.best;
  {
    float lo[kC], hi[kC];
    const float sink = fit_all<kC, kStop, !kLA>(
        R, lev, ls_iters, lane,
        [&](int buf) { search_planes<N, kLA>(R, lane, buf); }, lo, hi);
    if constexpr (kStop < kStopAll) {
      const long long blk = blk0 + lane / kF;
      if (lane < R.nf && blk < n) err_out[blk] = sink;
      return;
    }
    if (lane < R.nf) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        lohi[lane * 8 + c] = lo[c];
        lohi[lane * 8 + 4 + c] = hi[c];
      }
    }
    __syncwarp();
  }

  // each channel choice's codes (channel c: plane 1's endpoint, or the
  // others' c-th, c-1-th past ccs) and the reconstruction of its quantised
  // endpoints
  for (int i = lane; i < nb * kChoices; i += 32) {
    const int b = i / kChoices, ccs = i % kChoices;
    constexpr int kN = kLA ? 2 : N;
    float lo_u[kN], hi_u[kN];
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      int f, k;
      if constexpr (kLA) {
        f = b * kF + c;
        k = 0;
      } else {
        f = b * kF + (c == ccs ? N + ccs : ccs);
        k = c == ccs ? 0 : c < ccs ? c : c - 1;
      }
      const int lc = quant_code(inv_s, lohi[f * 8 + k]);
      const int hc = quant_code(inv_s, lohi[f * 8 + 4 + k]);
      R.code[i * 8 + 2 * c] = (uint8_t)lc;
      R.code[i * 8 + 2 * c + 1] = (uint8_t)hc;
      lo_u[c] = unq_s[lc];
      hi_u[c] = unq_s[hc];
    }
    exact_table<kN>(R.table + i * (n_lev + 1), lev, n_lev, lo_u, hi_u);
  }
  __syncwarp();
  // each pixel's least error on each plane per choice, and its levels
  for (int base = 0; base < nb; base += 2) {
    const int b = base + (lane >> 4), p = lane & 15;
    if (b >= nb) continue;
    const float* rgba = R.pix + b * kBlockWords + p * kPix;
    for (int ccs = 0; ccs < kChoices; ++ccs) {
      const float4* t = R.table + (b * kChoices + ccs) * (n_lev + 1);
      float e0_min = INFINITY, e1_min = INFINITY;
      int w0 = 0, w1 = 0;
#pragma unroll 4
      for (int l = 0; l < n_lev; ++l) {
        const float4 r = t[l];
        float e0 = 0.0f, e1;
        if constexpr (kLA) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float d = __fsub_rn(rgba[c], r.x);
            e0 = c ? __fadd_rn(e0, __fmul_rn(d, d)) : __fmul_rn(d, d);
          }
          const float d = __fsub_rn(rgba[3], r.y);
          e1 = __fmul_rn(d, d);
        } else {
          e1 = 0.0f;
#pragma unroll
          for (int c = 0; c < N; ++c) {
            const float d = __fsub_rn(rgba[c], chan(r, c));
            const float dd = __fmul_rn(d, d);
            if (c == ccs)
              e1 = dd;
            else
              e0 = __fadd_rn(e0, dd);
          }
        }
        if (e0 < e0_min) {
          e0_min = e0;
          w0 = l;
        }
        if (e1 < e1_min) {
          e1_min = e1;
          w1 = l;
        }
      }
      const int i0 = b * kF + ccs, i1 = b * kF + kChoices + ccs;
      R.best[i0 * kItemWords + p] = e0_min;
      R.best[i1 * kItemWords + p] = e1_min;
      R.wl0[i0 * kItemBytes + p] = (uint8_t)w0;
      R.wl0[i1 * kItemBytes + p] = (uint8_t)w1;
    }
  }
  __syncwarp();
  // each choice's error: the two planes' sums (exact), added
  for (int i = lane; i < nb * kChoices; i += 32) {
    const int b = i / kChoices, ccs = i % kChoices;
    const float* e0 = R.best + (b * kF + ccs) * kItemWords;
    const float* e1 = R.best + (b * kF + kChoices + ccs) * kItemWords;
    R.gerr[i] = __fadd_rn(sum16<true>(e0, 0xffffu), sum16<true>(e1, 0xffffu));
  }
  __syncwarp();
  // the winner: the first choice by strict <
  for (int base = 0; base < nb; base += 2) {
    const int b_raw = base + (lane >> 4), p = lane & 15;
    const int b = b_raw < nb ? b_raw : nb - 1;
    const long long blk = blk0 + b_raw;
    const float* rgba = R.pix + b * kBlockWords + p * kPix;
    const int ccs = first_min(R.gerr + b * kChoices, kChoices);
    float best_err = R.gerr[b * kChoices + ccs];
    if constexpr (N == 3) best_err = __fadd_rn(best_err, alpha_err(rgba[3]));
    if (b_raw < nb && blk < n) {
      if (p == 0) {
        err_out[blk] = best_err;
        if (!kLA) ccs_out[blk] = ccs;
      }
      if (p < 2 * N) ep_out[blk * 2 * N + p] = R.code[(b * kChoices + ccs) * 8 + p];
      const int i0 = b * kF + ccs, i1 = b * kF + kChoices + ccs;
      w_out[blk * 32 + 2 * p] = R.wl0[i0 * kItemBytes + p];
      w_out[blk * 32 + 2 * p + 1] = R.wl0[i1 * kItemBytes + p];
    }
  }
}

// ---------------------------------------------------------------------------
// uastc_mode_trial: the single-subset single-plane mode trials
// ---------------------------------------------------------------------------
//
// A trial fits each block once, so a warp takes nb blocks (up to 16, at
// the search's sizes; fewer in small launches, `mode_blocks_per_warp`)
// and gives each a lane for its serial work: the C mean chains and the
// C (C + 1) / 2 distinct covariance chains over the block's 16 pixels in
// pixel order, the 6 power-iteration rounds, the extremes of the
// projections, the endpoints and their codes, after each weight search the
// error chain in pixel order, and per least-squares step the weights'
// moments (exact), the 2C P / Q chains, the 2x2 solve, the codes and the
// select; RGB's alpha error too. The per-pixel work runs a lane per pixel,
// two blocks a pass: the reconstruction of the block's quantised endpoints
// at each level (a level a lane), the search over the levels, and LA's
// full-pixel error (whole numbers, exact in any order: shuffles). The two
// hand over through the warp's slice of the dynamic shared memory, ordered
// by __syncwarp; the CTA meets once, after the mode's tables and the
// pixels are loaded.
//
// The searches of RGB and RGBA run in integers: a pixel's channels x and
// a reconstruction's r are whole numbers 0..255, so each squared
// difference and their sum e over 3 or 4 channels (below 2^24) are exact
// in float32 and equal to the integers'. e = x.x - 2 x.r + r.r, and x.x is
// the pixel's own, so the table holds each level's r as four bytes and
// 64 r.r + l, and a level's key, 64 (r.r - 2 x.r) + l = 64 (e - x.x) + l,
// is one dp4a of the bytes and one multiply-add: the least key is the
// least error at its first level. A level costs a load, dp4a, a
// multiply-add and a minimum, where the float search takes a subtract, a
// multiply and an add a channel and a compare and two selects.
// LA's luma is fractional: its search stays in float (`table_min`).
//
// Every rounding is `_mode_trial`'s as the plain version spells it
// (`mode_trial_reference`), not a masked fit's: no mask products, the mean
// divided by 16, 6 power-iteration rounds, the endpoints unclamped until
// the codes (the least-squares fallback takes them so). Shared with the
// other trials, each the same operations in the same order: `power_axis`,
// `solve_endpoints` (`ls_solve`'s solve), `table_min` (`level_search`'s
// and the other trials' search), `sum16` (a block's error: LA's fractional
// luma in pixel order, whole numbers in four partial sums), `rec16`,
// `quant_code` and `load_trial_tables`.

constexpr int kModeWarps = 4;       // warps per CTA at most
constexpr int kModeMaxBlocks = 16;  // 4x4 blocks per warp: a lane each
constexpr int kPixStride = 17;      // float4s per block's pixels, + 1 (banks)

// The mode trial's per-step split (`chip_smoke.py`, measurement only): an
// instance with kStop < kModeAll runs the trial up to that step and writes
// a sum of what it computed to err; the paths' instance runs to kModeAll.
enum ModeStop {
  kModeChains = 1,  // each block's mean and covariance chains
  kModePower = 2,   // + the power iteration
  kModeQuant = 3,   // + the projections' extremes, the endpoints, codes
  kModeSearch = 4,  // + the reconstruction tables and the first search
  kModeSolve = 5,   // + the least-squares steps (solves and searches)
  kModeAll = 6      // + the full-pixel error and the outputs
};

// A block's record, written by its lane: the quantised endpoints' values
// (the current trial's, which the tables are built from; at the end, for
// LA, the best's), the best's codes (a byte each: c0 lo, c0 hi, c1 lo, ...), its
// error and weight buffer. 48 bytes: 8 lanes' records on distinct banks.
struct alignas(16) ModeRec {
  float4 lo_u, hi_u;
  uint32_t code[2];
  float err;
  int cur;
};

// A warp's slice of shared memory, nb blocks of C channels at L weight
// levels (`mode_layout`).
struct ModeWarp {
  float4* x;      // [nb][kPixStride] each pixel's fitted channels (LA: the
                  // luma and the alpha)
  float4* rgba;   // [nb][kPixStride] each pixel (LA; otherwise x)
  float4* table;  // [nb][L + 1] the reconstruction at each level
  ModeRec* rec;   // [nb]
  float* best;    // [nb][kItemWords] each pixel's least error
  uint8_t* wl;    // [2][nb][kItemBytes] its level: two buffers
  int nb, L;
};

// The slice's byte offsets (each 16-byte aligned) and its size; with base,
// the pointers of W.
__host__ __device__ inline int mode_layout(int C, int nb, int L, char* base,
                                           ModeWarp* W) {
  const int px_bytes = nb * kPixStride * 16;
  const int bytes[6] = {px_bytes,
                        C == 2 ? px_bytes : 0,
                        nb * (L + 1) * 16,
                        nb * (int)sizeof(ModeRec),
                        nb * kItemWords * 4,
                        2 * nb * kItemBytes};
  int off = 0, o[6];
  for (int i = 0; i < 6; ++i) {
    o[i] = off;
    off += (bytes[i] + 15) & ~15;
  }
  if (W) {
    W->x = reinterpret_cast<float4*>(base + o[0]);
    W->rgba = C == 2 ? reinterpret_cast<float4*>(base + o[1]) : W->x;
    W->table = reinterpret_cast<float4*>(base + o[2]);
    W->rec = reinterpret_cast<ModeRec*>(base + o[3]);
    W->best = reinterpret_cast<float*>(base + o[4]);
    W->wl = reinterpret_cast<uint8_t*>(base + o[5]);
    W->nb = nb;
    W->L = L;
  }
  return off;
}

__device__ __forceinline__ uint8_t* mode_weights(const ModeWarp& W, int buf,
                                                 int b) {
  return W.wl + (buf * W.nb + b) * kItemBytes;
}

// This warp's nb blocks (from blk0; past n the last repeats) into W: a
// pixel a lane, one 16-byte load where the pixels' four channels are
// contiguous and aligned.
template <int C>
__device__ __forceinline__ void mode_load(const ModeWarp& W, const float* px,
                                          long long sb, long long sp,
                                          long long sc, long long blk0, int n,
                                          int lane) {
  const bool vec = sc == 1 && sp == 4 && (sb & 3) == 0 &&
                   ((uintptr_t)px & 15) == 0;
  for (int i = lane; i < W.nb * 16; i += 32) {
    const int b = i >> 4, q = i & 15;
    const long long blk = blk0 + b < n ? blk0 + b : n - 1;
    const float* p = px + blk * sb + q * sp;
    const float4 v = vec ? *reinterpret_cast<const float4*>(p)
                         : make_float4(p[0], p[sc], p[2 * sc], p[3 * sc]);
    const int at = b * kPixStride + q;
    if constexpr (C == 2) {
      W.rgba[at] = v;
      // `_la`: (r + g + b) * float32(1/3), and the alpha
      W.x[at] = make_float4(
          __fmul_rn(__fadd_rn(__fadd_rn(v.x, v.y), v.z), kThird), v.w, 0.0f,
          0.0f);
    } else {
      W.x[at] = v;
    }
  }
}

// The least key 64 (r.r - 2 x.r) + l over the levels of table t (each
// level: r's bytes, 64 r.r + l) for a pixel's channels as bytes x: kL
// levels unrolled, or n_lev. The dot products are exact (bytes, sums
// below 2^19), the keys above -2^26.
template <int kL>
__device__ __forceinline__ int key_min(const int2* t, int n_lev, unsigned x) {
  auto key = [&](int l) {
    const int2 e = t[l];
    return e.y - 128 * (int)__dp4a((unsigned)e.x, x, 0u);
  };
  int best = INT_MAX;
  if constexpr (kL > 0) {
#pragma unroll
    for (int l = 0; l < kL; ++l) best = min(best, key(l));
  } else {
#pragma unroll 4
    for (int l = 0; l < n_lev; ++l) best = min(best, key(l));
  }
  return best;
}

__device__ __forceinline__ int key_search(const int2* t, int n_lev,
                                          unsigned x) {
  switch (n_lev) {
    case 4: return key_min<4>(t, n_lev, x);
    case 8: return key_min<8>(t, n_lev, x);
    case 16: return key_min<16>(t, n_lev, x);
    case 32: return key_min<32>(t, n_lev, x);
    default: return key_min<0>(t, n_lev, x);
  }
}

// Whole-numbered channels 0..255 as bytes (the unused ones 0), and the
// sum of their squares.
template <int C>
__device__ __forceinline__ unsigned pack_bytes(const float (&v)[C],
                                               int& sq) {
  unsigned packed = 0u;
  sq = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = (int)v[c];
    packed |= (unsigned)b << (8 * c);
    sq += b * b;
  }
  return packed;
}

// The codes of float endpoints (`_quant`) and their values.
template <int C>
__device__ __forceinline__ void mode_quant(const uint8_t* inv_s,
                                           const float* unq_s,
                                           const float (&lo)[C],
                                           const float (&hi)[C],
                                           int (&lo_c)[C], int (&hi_c)[C],
                                           float (&lo_u)[C],
                                           float (&hi_u)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    lo_c[c] = quant_code(inv_s, lo[c]);
    hi_c[c] = quant_code(inv_s, hi[c]);
    lo_u[c] = unq_s[lo_c[c]];
    hi_u[c] = unq_s[hi_c[c]];
  }
}

// Block b's lane, the fit: the mean chains (divided by 16), the covariance
// chains of the centred pixels, 6 power-iteration rounds, the extremes of
// the projections, the endpoints (lo_f, hi_f; unclamped) and their codes
// and values; RGB also the alpha's error (`_alpha_err`: whole numbers,
// four partial sums). Below kModeSearch it returns a sum of what it
// computed at its stop.
template <int C, int kStop>
__device__ __forceinline__ float mode_fit(const ModeWarp& W,
                                          const uint8_t* inv_s,
                                          const float* unq_s, int b,
                                          float (&lo_f)[C], float (&hi_f)[C],
                                          int (&lo_c)[C], int (&hi_c)[C],
                                          float (&lo_u)[C], float (&hi_u)[C],
                                          float& alpha) {
  const float4* xb = W.x + b * kPixStride;
  float mean[C];
  {
    float acc[C], a4[4];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float4 v = xb[q];
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[c] = q ? __fadd_rn(acc[c], chan(v, c)) : chan(v, c);
      if constexpr (C == 3) {
        const float d = __fsub_rn(v.w, 255.0f), t = __fmul_rn(d, d);
        a4[q & 3] = q < 4 ? t : __fadd_rn(a4[q & 3], t);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) mean[c] = __fdiv_rn(acc[c], 16.0f);
    if constexpr (C == 3)
      alpha = __fadd_rn(__fadd_rn(a4[0], a4[1]), __fadd_rn(a4[2], a4[3]));
  }
  constexpr int kCov = C * (C + 1) / 2;
  float cv[kCov];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float4 v = xb[q];
    float cx[C];
#pragma unroll
    for (int c = 0; c < C; ++c) cx[c] = __fsub_rn(chan(v, c), mean[c]);
    int k = 0;
#pragma unroll
    for (int i = 0; i < C; ++i)
#pragma unroll
      for (int j = i; j < C; ++j, ++k)
        cv[k] = q ? __fmaf_rn(cx[i], cx[j], cv[k]) : __fmul_rn(cx[i], cx[j]);
  }
  if constexpr (kStop == kModeChains) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kCov; ++k) s = __fadd_rn(s, cv[k]);
#pragma unroll
    for (int c = 0; c < C; ++c) s = __fadd_rn(s, mean[c]);
    return s;
  }
  float ax[C];
  power_axis<C>(cv, 6, ax);
  if constexpr (kStop == kModePower) {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) s = __fadd_rn(s, ax[c]);
    return s;
  }
  // the extremes of the projections (exact in any order: four of each)
  float mn4[4], mx4[4];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float4 v = xb[q];
    float pr = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float cx = __fsub_rn(chan(v, c), mean[c]);
      pr = c ? __fmaf_rn(cx, ax[c], pr) : __fmul_rn(cx, ax[c]);
    }
    mn4[q & 3] = q < 4 ? pr : fminf(mn4[q & 3], pr);
    mx4[q & 3] = q < 4 ? pr : fmaxf(mx4[q & 3], pr);
  }
  const float mn = fminf(fminf(mn4[0], mn4[1]), fminf(mn4[2], mn4[3]));
  const float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
#pragma unroll
  for (int c = 0; c < C; ++c) {
    lo_f[c] = __fmaf_rn(ax[c], mn, mean[c]);
    hi_f[c] = __fmaf_rn(ax[c], mx, mean[c]);
  }
  mode_quant<C>(inv_s, unq_s, lo_f, hi_f, lo_c, hi_c, lo_u, hi_u);
  if constexpr (kStop == kModeQuant) {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      s = __fadd_rn(s, __fadd_rn((float)(lo_c[c] + hi_c[c]),
                                 __fadd_rn(lo_u[c], hi_u[c])));
    return s;
  }
  return 0.0f;
}

// Block b's lane, one least-squares step (`ls_step_reference`, no mask):
// the weights a = (64 - w) / 64, b = w / 64 of weight buffer buf, their
// moments (multiples of 1/4096 up to 16, exact in any order: two partial
// sums each), the P and Q chains in pixel order, the 2x2 solve.
template <int C>
__device__ __forceinline__ void mode_solve(const ModeWarp& W, const float* lev,
                                           int b, int buf,
                                           const float (&lo)[C],
                                           const float (&hi)[C],
                                           float (&lo2)[C], float (&hi2)[C]) {
  const float4* xb = W.x + b * kPixStride;
  const uint32_t* wv =
      reinterpret_cast<const uint32_t*>(mode_weights(W, buf, b));
  float sa2[2] = {0.0f, 0.0f}, sab2[2] = {0.0f, 0.0f}, sb22[2] = {0.0f, 0.0f};
  float P[C], Q[C];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float wl = lev[(wv[q >> 2] >> (8 * (q & 3))) & 255u];
    const float a = __fmul_rn(__fsub_rn(64.0f, wl), kInv64);
    const float bw = __fmul_rn(wl, kInv64);
    sa2[q & 1] = __fadd_rn(sa2[q & 1], __fmul_rn(a, a));
    sab2[q & 1] = __fadd_rn(sab2[q & 1], __fmul_rn(a, bw));
    sb22[q & 1] = __fadd_rn(sb22[q & 1], __fmul_rn(bw, bw));
    const float4 v = xb[q];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      P[c] = q ? __fmaf_rn(a, chan(v, c), P[c]) : __fmul_rn(a, chan(v, c));
      Q[c] = q ? __fmaf_rn(bw, chan(v, c), Q[c]) : __fmul_rn(bw, chan(v, c));
    }
  }
  solve_endpoints<C>(__fadd_rn(sa2[0], sa2[1]), __fadd_rn(sab2[0], sab2[1]),
                     __fadd_rn(sb22[0], sb22[1]), P, Q, lo, hi, lo2, hi2);
}

// The pixel lanes, two blocks a pass: each block's table from its record's
// endpoint values (`rec16`, a level a lane; RGB(A): bytes and 64 r.r + l),
// then each pixel against it (LA `table_min`, RGB(A) `key_search`) into
// W.best and weight buffer 0 (first) or the one after the block's best.
// Every lane of the warp calls it; it ends past a __syncwarp.
template <int C>
__device__ __forceinline__ void mode_search(const ModeWarp& W, const float* lev,
                                            int lane, bool first) {
  const int q = lane & 15;
  __syncwarp();
  for (int b = lane >> 4; b < W.nb; b += 2) {
    const ModeRec& r = W.rec[b];
    float4* t = W.table + b * (W.L + 1);
    for (int l = q; l < W.L; l += 16) {
      float rr[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        rr[c] = rec16(chan(r.lo_u, c), chan(r.hi_u, c), lev[l]);
      if constexpr (C == 2) {
        t[l] = pack4<C>(rr);
      } else {
        int sq;
        const unsigned bytes = pack_bytes<C>(rr, sq);
        reinterpret_cast<int2*>(t)[l] = make_int2((int)bytes, 64 * sq + l);
      }
    }
  }
  __syncwarp();
  for (int b = lane >> 4; b < W.nb; b += 2) {
    const float4 v = W.x[b * kPixStride + q];
    const float4* t = W.table + b * (W.L + 1);
    float best;
    int arg;
    if constexpr (C == 2) {
      const float x[2] = {v.x, v.y};
      arg = table_min<C>(t, W.L, x, best);
    } else {
      float x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = chan(v, c);
      int sq;
      const unsigned bytes = pack_bytes<C>(x, sq);
      const int key =
          key_search(reinterpret_cast<const int2*>(t), W.L, bytes);
      best = (float)(sq + (key >> 6));  // floor(key / 64) = e - x.x
      arg = key & 63;
    }
    W.best[b * kItemWords + q] = best;
    mode_weights(W, first ? 0 : 1 - W.rec[b].cur, b)[q] = (uint8_t)arg;
  }
  __syncwarp();
}

// px: (n, 16, 4) at strides (sb, sp, sc), whole numbers 0..255; inv: the
// 256 codes (int64) of the endpoint values, unq: the n_unq unquantised
// values of the codes; lev: the n_lev weight levels. `_mode_trial` of comps
// C (2: the luma (r + g + b) * float32(1/3) and alpha; 3: RGB; 4: RGBA):
// err (n,), ep (n, 2C) codes [c0 lo, c0 hi, c1 lo, ...], w (n, 16) level
// indices. A warp takes nb blocks, its slice of the dynamic shared memory
// mode_layout's.
template <int C, int kStop>
__global__ void __launch_bounds__(kModeWarps * 32)
mode_trial_kernel(const float* __restrict__ px, long long sb, long long sp,
                  long long sc, const long long* __restrict__ inv,
                  const float* __restrict__ unq, int n_unq,
                  const float* __restrict__ levels, int n_lev, int ls_iters,
                  float* __restrict__ err_out, int* __restrict__ ep_out,
                  int* __restrict__ w_out, int n, int nb) {
  __shared__ float lev[kMaxLevels];
  __shared__ uint8_t inv_s[256];
  __shared__ float unq_s[256];
  extern __shared__ __align__(16) uint8_t mode_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ModeWarp W;
  const int bytes = mode_layout(C, nb, n_lev, nullptr, nullptr);
  mode_layout(C, nb, n_lev, (char*)mode_smem + warp * bytes, &W);
  const long long blk0 =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * nb;
  // the pixels' loads and the tables' in flight together
  if (blk0 < n) mode_load<C>(W, px, sb, sp, sc, blk0, n, lane);
  load_trial_tables(inv, unq, n_unq, levels, n_lev, inv_s, unq_s, lev);
  __syncthreads();
  if (blk0 >= n) return;  // a warp past the last block

  // 1. the fits: block `lane` on this lane (a repeated block too)
  const bool fits = lane < nb;
  const bool live = fits && blk0 + lane < n;
  float lo_f[C], hi_f[C], lo_u[C], hi_u[C], alpha = 0.0f;
  int lo_c[C], hi_c[C];
  float err = 0.0f;
  if (fits) {
    err = mode_fit<C, kStop>(W, inv_s, unq_s, lane, lo_f, hi_f, lo_c, hi_c,
                             lo_u, hi_u, alpha);
    W.rec[lane].lo_u = pack4<C>(lo_u);
    W.rec[lane].hi_u = pack4<C>(hi_u);
    W.rec[lane].cur = 0;
  }
  if constexpr (kStop < kModeSearch) {
    if (live) err_out[blk0 + lane] = err;
    return;
  }
  // 2. the first weight search, and its error
  mode_search<C>(W, lev, lane, true);
  if (fits) err = sum16<C != 2>(W.best + lane * kItemWords, 0xffffu);
  if constexpr (kStop == kModeSearch) {
    if (live) err_out[blk0 + lane] = err;
    return;
  }
  // 3. the least-squares steps, each from the unquantised endpoints of the
  //    fit and the best's weights, kept where its error is strictly less
  for (int it = 0; it < ls_iters; ++it) {
    float lo_u2[C], hi_u2[C];
    int lo_c2[C], hi_c2[C];
    if (fits) {
      float lo2[C], hi2[C];
      mode_solve<C>(W, lev, lane, W.rec[lane].cur, lo_f, hi_f, lo2, hi2);
      mode_quant<C>(inv_s, unq_s, lo2, hi2, lo_c2, hi_c2, lo_u2, hi_u2);
      W.rec[lane].lo_u = pack4<C>(lo_u2);
      W.rec[lane].hi_u = pack4<C>(hi_u2);
    }
    mode_search<C>(W, lev, lane, false);
    if (fits) {
      const float err2 = sum16<C != 2>(W.best + lane * kItemWords, 0xffffu);
      if (err2 < err) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          lo_c[c] = lo_c2[c];
          hi_c[c] = hi_c2[c];
          lo_u[c] = lo_u2[c];
          hi_u[c] = hi_u2[c];
        }
        err = err2;
        W.rec[lane].cur = 1 - W.rec[lane].cur;
      }
    }
  }
  if (fits) {
    ModeRec& r = W.rec[lane];
    if constexpr (C == 2) {  // the best's values, for the full-pixel error
      r.lo_u = pack4<C>(lo_u);
      r.hi_u = pack4<C>(hi_u);
    }
    uint32_t code[2] = {0u, 0u};
#pragma unroll
    for (int c = 0; c < C; ++c)
      code[c >> 1] |= (uint32_t)lo_c[c] << (16 * (c & 1)) |
                      (uint32_t)hi_c[c] << (16 * (c & 1) + 8);
    r.code[0] = code[0];
    r.code[1] = code[1];
    // the full-pixel error: RGB adds the alpha's
    r.err = C == 3 ? __fadd_rn(err, alpha) : err;
  }
  if constexpr (kStop == kModeSolve) {
    if (live) err_out[blk0 + lane] = err;
    return;
  }
  __syncwarp();

  // 4. the outputs, two blocks a pass; LA's full-pixel error: its gray
  //    reconstruction against R, G and B and its alpha's against A (whole
  //    numbers, exact in any order)
  for (int base = 0; base < nb; base += 2) {
    const int b_raw = base + (lane >> 4), q = lane & 15;
    const int b = b_raw < nb ? b_raw : nb - 1;
    const long long blk = blk0 + b_raw;
    const ModeRec& r = W.rec[b];
    const int w = mode_weights(W, r.cur, b)[q];
    float e = r.err;
    if constexpr (C == 2) {
      const float4 p = W.rgba[b * kPixStride + q];
      const float wl = lev[w];
      const float l_rec = rec16(r.lo_u.x, r.hi_u.x, wl);
      const float a_rec = rec16(r.lo_u.y, r.hi_u.y, wl);
      float e_rgb = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float d = __fsub_rn(chan(p, c), l_rec);
        e_rgb = c ? __fadd_rn(e_rgb, __fmul_rn(d, d)) : __fmul_rn(d, d);
      }
      const float da = __fsub_rn(p.w, a_rec);
      e = __fadd_rn(exact_sum16(e_rgb), exact_sum16(__fmul_rn(da, da)));
    }
    if (b_raw < nb && blk < n) {
      if (q == 0) err_out[blk] = e;
      if (q < 2 * C)
        ep_out[blk * 2 * C + q] = (int)((r.code[q >> 2] >> (8 * (q & 3))) & 255u);
      w_out[blk * 16 + q] = w;
    }
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

// 4x4 blocks per warp for F fits a block, of n: every fit its own lane, an
// even count where the fits allow (a pass over the pixels takes two
// blocks), and fewer blocks a warp, down to two, where n would leave the
// card without kWarpsWanted warps (a small launch is latency-bound).
constexpr long long kWarpsWanted = 132 * 8;

int trial_blocks_per_warp(int F, int n) {
  int most = 32 / F < kMaxWarpBlocks ? 32 / F : kMaxWarpBlocks;
  if (most > 1) most &= ~1;
  const int least = most < 2 ? most : 2;
  const long long nb = n / kWarpsWanted;
  return nb > most ? most : nb < least ? least : (int)nb;
}

// Warps per trial CTA: up to `most`, fewer where their slices of shared
// memory would pass the 48 KB a CTA takes without an opt-in (the static
// tables take 1.7 KB of it).
constexpr int kSliceBytes = 48 * 1024 - 4096;

int trial_warps(int bytes, int most = kTrialWarps) {
  const int w = kSliceBytes / bytes;
  return w < 1 ? 1 : w > most ? most : w;
}

// 4x4 blocks per warp of a mode trial of n blocks: kModeBlocks (a lane
// each), fewer where n would leave the card without kWarpsWanted warps,
// down to two (a pass over the pixels takes two).
constexpr int kModeBlocks = 16;

int mode_blocks_per_warp(int n) {
  const long long nb = n / kWarpsWanted;
  return nb >= kModeBlocks ? kModeBlocks : nb < 2 ? 2 : (int)nb;
}

// nb, warps: 0 for the defaults (mode_blocks_per_warp, trial_warps); a
// count that does not fit is refused.
template <int C, int kStop>
cudaError_t launch_mode_trial(const float* px, long long sb, long long sp,
                              long long sc, const long long* inv,
                              const float* unq, int n_unq,
                              const float* levels, int n_lev, int ls_iters,
                              float* err, int* ep, int* w, int n, int nb,
                              int warps, cudaStream_t s) {
  if (nb == 0) nb = mode_blocks_per_warp(n);
  if (nb < 1 || nb > kModeMaxBlocks) return cudaErrorInvalidValue;
  const int bytes = mode_layout(C, nb, n_lev, nullptr, nullptr);
  if (warps == 0) warps = trial_warps(bytes, kModeWarps);
  if (warps < 1 || warps > kModeWarps || warps * bytes > kSliceBytes)
    return cudaErrorInvalidValue;
  const long long per_cta = (long long)warps * nb;
  const unsigned grid = (unsigned)((n + per_cta - 1) / per_cta);
  mode_trial_kernel<C, kStop><<<grid, 32 * warps, warps * bytes, s>>>(
      px, sb, sp, sc, inv, unq, n_unq, levels, n_lev, ls_iters, err, ep, w, n,
      nb);
  return cudaGetLastError();
}

template <int kStop>
int mode_trial_at(const float* px, long long sb, long long sp, long long sc,
                  const long long* inv, const float* unq, int n_unq,
                  const float* levels, int n_lev, int comps, int ls_iters,
                  float* err, int* ep, int* w, int n, int nb, int warps,
                  cudaStream_t s) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_unq < 1 || n_unq > 256 || n_lev < 1 || n_lev > kMaxLevels ||
      ls_iters < 0)
    return (int)cudaErrorInvalidValue;
  switch (comps) {
    case 2: return (int)launch_mode_trial<2, kStop>(
        px, sb, sp, sc, inv, unq, n_unq, levels, n_lev, ls_iters, err, ep, w,
        n, nb, warps, s);
    case 3: return (int)launch_mode_trial<3, kStop>(
        px, sb, sp, sc, inv, unq, n_unq, levels, n_lev, ls_iters, err, ep, w,
        n, nb, warps, s);
    case 4: return (int)launch_mode_trial<4, kStop>(
        px, sb, sp, sc, inv, unq, n_unq, levels, n_lev, ls_iters, err, ep, w,
        n, nb, warps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int C, int S, int kStop>
cudaError_t launch_subset_trial(const float* px, long long sb, long long sp,
                                long long sc, const long long* pats,
                                int n_pat, const long long* inv,
                                const float* unq, int n_unq,
                                const float* levels, int n_lev, int ls_iters,
                                int topk, float* err, int* ep, int* w,
                                int* pat, int n, cudaStream_t s) {
  const int F = topk * S, nb = trial_blocks_per_warp(F, n);
  const int bytes = trial_layout(nb, F, topk, n_lev, nullptr, nullptr);
  const int warps = trial_warps(bytes);
  const long long per_cta = (long long)warps * nb;
  const unsigned grid = (unsigned)((n + per_cta - 1) / per_cta);
  subset_trial_kernel<C, S, kStop><<<grid, 32 * warps, warps * bytes, s>>>(
      px, sb, sp, sc, pats, n_pat, inv, unq, n_unq, levels, n_lev, ls_iters,
      topk, err, ep, w, pat, n, nb);
  return cudaGetLastError();
}

template <int N, bool kLA, int kStop>
cudaError_t launch_dualplane_trial(const float* px, long long sb,
                                   long long sp, long long sc,
                                   const long long* inv, const float* unq,
                                   int n_unq, const float* levels, int n_lev,
                                   int ls_iters, float* err, int* ep, int* w,
                                   int* ccs, int n, cudaStream_t s) {
  constexpr int kF = kLA ? 2 : 2 * N;
  const int nb = trial_blocks_per_warp(kF, n);
  const int bytes = trial_layout(nb, kF, kF, n_lev, nullptr, nullptr);
  const int warps = trial_warps(bytes);
  const long long per_cta = (long long)warps * nb;
  const unsigned grid = (unsigned)((n + per_cta - 1) / per_cta);
  dualplane_trial_kernel<N, kLA, kStop><<<grid, 32 * warps, warps * bytes,
                                          s>>>(
      px, sb, sp, sc, inv, unq, n_unq, levels, n_lev, ls_iters, err, ep, w,
      ccs, n, nb);
  return cudaGetLastError();
}

template <int kStop>
int subset_trial_at(const float* px, long long sb, long long sp, long long sc,
                    const long long* pats, int n_pat, const long long* inv,
                    const float* unq, int n_unq, const float* levels,
                    int n_lev, int comps, int n_sub, int ls_iters, int topk,
                    float* err, int* ep, int* w, int* pat, int n,
                    cudaStream_t s) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_pat < 1 || n_pat > kMaxPatterns || topk < 1 || topk > kMaxTopk ||
      topk > n_pat || n_unq < 1 || n_unq > 256 || n_lev < 1 ||
      n_lev > kMaxLevels || ls_iters < 0)
    return (int)cudaErrorInvalidValue;
  switch (10 * comps + n_sub) {
    case 22: return (int)launch_subset_trial<2, 2, kStop>(
        px, sb, sp, sc, pats, n_pat, inv, unq, n_unq, levels, n_lev,
        ls_iters, topk, err, ep, w, pat, n, s);
    case 32: return (int)launch_subset_trial<3, 2, kStop>(
        px, sb, sp, sc, pats, n_pat, inv, unq, n_unq, levels, n_lev,
        ls_iters, topk, err, ep, w, pat, n, s);
    case 42: return (int)launch_subset_trial<4, 2, kStop>(
        px, sb, sp, sc, pats, n_pat, inv, unq, n_unq, levels, n_lev,
        ls_iters, topk, err, ep, w, pat, n, s);
    case 33: return (int)launch_subset_trial<3, 3, kStop>(
        px, sb, sp, sc, pats, n_pat, inv, unq, n_unq, levels, n_lev,
        ls_iters, topk, err, ep, w, pat, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int kStop>
int dualplane_trial_at(const float* px, long long sb, long long sp,
                       long long sc, const long long* inv, const float* unq,
                       int n_unq, const float* levels, int n_lev, int n_ch,
                       int ls_iters, float* err, int* ep, int* w, int* ccs,
                       int n, cudaStream_t s) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_unq < 1 || n_unq > 256 || n_lev < 1 || n_lev > kMaxLevels ||
      ls_iters < 0)
    return (int)cudaErrorInvalidValue;
  switch (n_ch) {
    case 2: return (int)launch_dualplane_trial<2, true, kStop>(
        px, sb, sp, sc, inv, unq, n_unq, levels, n_lev, ls_iters, err, ep, w,
        ccs, n, s);
    case 3: return (int)launch_dualplane_trial<3, false, kStop>(
        px, sb, sp, sc, inv, unq, n_unq, levels, n_lev, ls_iters, err, ep, w,
        ccs, n, s);
    case 4: return (int)launch_dualplane_trial<4, false, kStop>(
        px, sb, sp, sc, inv, unq, n_unq, levels, n_lev, ls_iters, err, ep, w,
        ccs, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  return mode_trial_at<kModeAll>(px, sb, sp, sc, inv, unq, n_unq, levels,
                                 n_lev, comps, ls_iters, err, ep, w, n, 0, 0,
                                 (cudaStream_t)stream);
}

// px: (n, 16, 4) at strides (sb, sp, sc); pats: (n_pat, 16) int64
// contiguous partition patterns, subsets 0..n_sub - 1, n_pat 1..32; inv,
// unq, levels as uastc_mode_trial's; (comps, n_sub) (2, 2), (3, 2), (4, 2)
// or (3, 3); topk 1..min(8, n_pat); err (n,), ep (n, 2 n_sub comps) int32,
// w (n, 16) int32, pat (n,) int32 out.
int uastc_subset_trial(const float* px, long long sb, long long sp,
                       long long sc, const long long* pats, int n_pat,
                       const long long* inv, const float* unq, int n_unq,
                       const float* levels, int n_lev, int comps, int n_sub,
                       int ls_iters, int topk, float* err, int* ep, int* w,
                       int* pat, int n, void* stream) {
  return subset_trial_at<kStopAll>(px, sb, sp, sc, pats, n_pat, inv, unq,
                                   n_unq, levels, n_lev, comps, n_sub,
                                   ls_iters, topk, err, ep, w, pat, n,
                                   (cudaStream_t)stream);
}

// px, inv, unq, levels as uastc_mode_trial's; n_ch 3 (mode 6), 4 (modes 11
// and 13) or 2 (the LA mode 17); err (n,), ep (n, 2 n_ch) int32, w (n, 32)
// int32, ccs (n,) int32 out (ccs unused for LA, may be null).
int uastc_dualplane_trial(const float* px, long long sb, long long sp,
                          long long sc, const long long* inv,
                          const float* unq, int n_unq, const float* levels,
                          int n_lev, int n_ch, int ls_iters, float* err,
                          int* ep, int* w, int* ccs, int n, void* stream) {
  return dualplane_trial_at<kStopAll>(px, sb, sp, sc, inv, unq, n_unq,
                                      levels, n_lev, n_ch, ls_iters, err, ep,
                                      w, ccs, n, (cudaStream_t)stream);
}

// The per-step split of the two trials (`chip_smoke.py`, measurement only):
// the same arguments, and stop (TrialStop, 1..6): the trial up to that step,
// writing only err (a sum of what the steps computed) below kStopAll.
int uastc_subset_trial_split(const float* px, long long sb, long long sp,
                             long long sc, const long long* pats, int n_pat,
                             const long long* inv, const float* unq,
                             int n_unq, const float* levels, int n_lev,
                             int comps, int n_sub, int ls_iters, int topk,
                             float* err, int* ep, int* w, int* pat, int n,
                             int stop, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SUBSET_AT(k)                                                         \
  case k: return subset_trial_at<k>(px, sb, sp, sc, pats, n_pat, inv, unq,  \
                                    n_unq, levels, n_lev, comps, n_sub,     \
                                    ls_iters, topk, err, ep, w, pat, n, s)
  switch (stop) {
    SUBSET_AT(kStopSplit);
    SUBSET_AT(kStopChains);
    SUBSET_AT(kStopPower);
    SUBSET_AT(kStopSearch);
    SUBSET_AT(kStopSolve);
    SUBSET_AT(kStopAll);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SUBSET_AT
}

// The mode trial's per-step split and its launch shape (`chip_smoke.py`,
// measurement only): uastc_mode_trial's arguments, stop (ModeStop, 1..6),
// blocks per warp nb (1..32) and warps per CTA (1..4), 0 for the defaults.
int uastc_mode_trial_split(const float* px, long long sb, long long sp,
                           long long sc, const long long* inv,
                           const float* unq, int n_unq, const float* levels,
                           int n_lev, int comps, int ls_iters, float* err,
                           int* ep, int* w, int n, int stop, int nb, int warps,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MODE_AT(k)                                                         \
  case k: return mode_trial_at<k>(px, sb, sp, sc, inv, unq, n_unq, levels, \
                                  n_lev, comps, ls_iters, err, ep, w, n,  \
                                  nb, warps, s)
  switch (stop) {
    MODE_AT(kModeChains);
    MODE_AT(kModePower);
    MODE_AT(kModeQuant);
    MODE_AT(kModeSearch);
    MODE_AT(kModeSolve);
    MODE_AT(kModeAll);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MODE_AT
}

int uastc_dualplane_trial_split(const float* px, long long sb, long long sp,
                                long long sc, const long long* inv,
                                const float* unq, int n_unq,
                                const float* levels, int n_lev, int n_ch,
                                int ls_iters, float* err, int* ep, int* w,
                                int* ccs, int n, int stop, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define DUAL_AT(k)                                                           \
  case k: return dualplane_trial_at<k>(px, sb, sp, sc, inv, unq, n_unq,     \
                                       levels, n_lev, n_ch, ls_iters, err,  \
                                       ep, w, ccs, n, s)
  switch (stop) {
    DUAL_AT(kStopSplit);
    DUAL_AT(kStopChains);
    DUAL_AT(kStopPower);
    DUAL_AT(kStopSearch);
    DUAL_AT(kStopSolve);
    DUAL_AT(kStopAll);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DUAL_AT
}

}  // extern "C"

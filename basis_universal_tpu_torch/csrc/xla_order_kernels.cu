// Hand-written Hopper (sm_90a) kernels for XLA-CPU's float32 orders.
//
// The JAX reference's results on the CPU are those of XLA's compiled code:
// a product feeding one add is a fused multiply-add, and a short
// contraction is summed in a fixed order. The port spells these orders out
// (basis_universal_tpu_torch/ops/xla_order.py) wherever a rounding decides
// a code. Its plain PyTorch versions emulate each fused multiply-add through
// float64, six operators and a float64 copy per operand; on the card these
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
// - xla_principal_axis<C>: the whole power iteration of a UASTC line fit
//   (`xla_order.principal_axis_reference`) for one block per thread: the
//   C x C covariance chain, `iters` rounds of (the product chain, the
//   rounded sum of squares, the correctly rounded square root, + 1e-6, the
//   divide) and the projection chain, in registers;
// - xla_ls_step<C, mask>: one least-squares step of the line fits
//   (`xla_order.ls_step_reference`): the weights' moments, the P and Q
//   chains, the 2x2 solve with its three fused multiply-adds, the divides,
//   the selects and the clamp, one block per thread.
//
// Every rounding is spelled out (__fmaf_rn, __fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so the card gives XLA's bits, the fused kernels
// the bits of the generic ones; the float64 emulation on the CPU rounds
// twice and may differ from a true fused multiply-add in the last bit when
// the float64 sum lands on a float32 midpoint (rare; the CPU tests hold the
// plain version to the reference).
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
// each thread runs its chain from there. The fused kernels stage a tile of
// blocks in shared memory (padded rows: no bank conflicts) and replace the
// ~25 launches of a principal axis and the ~10 of a least-squares step.
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
// xla_principal_axis
// ---------------------------------------------------------------------------

constexpr int kTile = 128;  // blocks (one thread each) per CTA

// c: (n, 16, C) contiguous centred pixels; axis: (n, C); proj: (n, 16).
template <int C>
__global__ void __launch_bounds__(kTile)
principal_axis_kernel(const float* __restrict__ c, float* __restrict__ axis,
                      float* __restrict__ proj, int n, int iters) {
  constexpr int kIn = 16 * C, kRow = kIn + 1, kOut = 17;
  __shared__ float tile[kTile * kRow];
  __shared__ float ptile[kTile * kOut];
  const int b0 = blockIdx.x * kTile;
  const int nb = min(kTile, n - b0);
  const float* src = c + (size_t)b0 * kIn;
  for (int j = threadIdx.x; j < nb * kIn; j += kTile)
    tile[(j / kIn) * kRow + j % kIn] = src[j];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < nb) {
    const float* x = tile + t * kRow;  // x[p * C + ch]
    float cov[C][C];
#pragma unroll
    for (int i = 0; i < C; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float s = __fmul_rn(x[i], x[j]);
#pragma unroll
        for (int p = 1; p < 16; ++p)
          s = __fmaf_rn(x[p * C + i], x[p * C + j], s);
        cov[i][j] = s;
      }
    float ax[C];
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
#pragma unroll
    for (int i = 0; i < C; ++i) axis[(size_t)(b0 + t) * C + i] = ax[i];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      float s = __fmul_rn(x[p * C], ax[0]);
#pragma unroll
      for (int j = 1; j < C; ++j) s = __fmaf_rn(x[p * C + j], ax[j], s);
      ptile[t * kOut + p] = s;
    }
  }
  __syncthreads();
  float* dst = proj + (size_t)b0 * 16;
  for (int j = threadIdx.x; j < nb * 16; j += kTile)
    dst[j] = ptile[(j / 16) * kOut + j % 16];
}

// ---------------------------------------------------------------------------
// xla_ls_step
// ---------------------------------------------------------------------------

constexpr int kLsTile = 64;

__device__ __forceinline__ float clamp255(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 255.0f);
}

// wl, mask: (n, 16) contiguous (mask may be null: all ones); v: (n, 16, C)
// at strides (sb, sp, sc); lo, hi: (n, C) contiguous; out: (n, C) each.
template <int C, bool kMask>
__global__ void __launch_bounds__(kLsTile)
ls_step_kernel(const float* __restrict__ wl, const float* __restrict__ mask,
               const float* __restrict__ v, int sb, int sp, int sc,
               const float* __restrict__ lo, const float* __restrict__ hi,
               float* __restrict__ lo_out, float* __restrict__ hi_out,
               int n) {
  constexpr int kIn = 16 * C, kRow = kIn + 1;
  __shared__ float vt[kLsTile * kRow];
  __shared__ float wt[kLsTile * 17];
  __shared__ float mt[kMask ? kLsTile * 17 : 1];
  const int b0 = blockIdx.x * kLsTile;
  const int nb = min(kLsTile, n - b0);
  for (int j = threadIdx.x; j < nb * kIn; j += kLsTile) {
    const int r = j / kIn, e = j % kIn, p = e / C, ch = e % C;
    vt[r * kRow + e] = v[(size_t)(b0 + r) * sb + p * sp + ch * sc];
  }
  for (int j = threadIdx.x; j < nb * 16; j += kLsTile) {
    wt[(j / 16) * 17 + j % 16] = wl[(size_t)b0 * 16 + j];
    if (kMask) mt[(j / 16) * 17 + j % 16] = mask[(size_t)b0 * 16 + j];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= nb) return;
  const float inv64 = 1.0f / 64.0f;
  const float* x = vt + t * kRow;
  float av[16], bv[16];
  float sa = 0.0f, sab = 0.0f, sb2 = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const float w = wt[t * 17 + p];
    float a = __fmul_rn(__fsub_rn(64.0f, w), inv64);
    float b = __fmul_rn(w, inv64);
    if (kMask) {
      const float mk = mt[t * 17 + p];
      a = __fmul_rn(a, mk);
      b = __fmul_rn(b, mk);
    }
    av[p] = a;
    bv[p] = b;
    // multiples of 1/4096 up to 16: exact in any order
    sa = __fadd_rn(sa, __fmul_rn(a, a));
    sab = __fadd_rn(sab, __fmul_rn(a, b));
    sb2 = __fadd_rn(sb2, __fmul_rn(b, b));
  }
  const float det = __fmaf_rn(sa, sb2, -__fmul_rn(sab, sab));
  const bool ok = fabsf(det) > 1e-6f;
  const float dd = ok ? det : 1.0f;
  const size_t o = (size_t)(b0 + t) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    float P = __fmul_rn(av[0], x[ch]);
    float Q = __fmul_rn(bv[0], x[ch]);
#pragma unroll
    for (int p = 1; p < 16; ++p) {
      P = __fmaf_rn(av[p], x[p * C + ch], P);
      Q = __fmaf_rn(bv[p], x[p * C + ch], Q);
    }
    const float ln = __fdiv_rn(__fmaf_rn(sb2, P, -__fmul_rn(sab, Q)), dd);
    const float hn = __fdiv_rn(__fmaf_rn(sa, Q, -__fmul_rn(sab, P)), dd);
    lo_out[o + ch] = clamp255(ok ? ln : lo[o + ch]);
    hi_out[o + ch] = clamp255(ok ? hn : hi[o + ch]);
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
cudaError_t launch_principal_axis(const float* c, float* axis, float* proj,
                                  int n, int iters, cudaStream_t s) {
  principal_axis_kernel<C><<<(n + kTile - 1) / kTile, kTile, 0, s>>>(
      c, axis, proj, n, iters);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_ls_step(const float* wl, const float* mask, const float* v,
                           int sb, int sp, int sc, const float* lo,
                           const float* hi, float* lo_out, float* hi_out,
                           int n, cudaStream_t s) {
  const unsigned g = (n + kLsTile - 1) / kLsTile;
  if (mask)
    ls_step_kernel<C, true><<<g, kLsTile, 0, s>>>(
        wl, mask, v, sb, sp, sc, lo, hi, lo_out, hi_out, n);
  else
    ls_step_kernel<C, false><<<g, kLsTile, 0, s>>>(
        wl, mask, v, sb, sp, sc, lo, hi, lo_out, hi_out, n);
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

// c: (n, 16, C) contiguous, C in 1..4; axis (n, C) and proj (n, 16) out.
int xla_principal_axis(const float* c, float* axis, float* proj, int n,
                       int n_ch, int iters, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_ch) {
    case 1: return (int)launch_principal_axis<1>(c, axis, proj, n, iters, s);
    case 2: return (int)launch_principal_axis<2>(c, axis, proj, n, iters, s);
    case 3: return (int)launch_principal_axis<3>(c, axis, proj, n, iters, s);
    case 4: return (int)launch_principal_axis<4>(c, axis, proj, n, iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// wl, mask (null: none): (n, 16) contiguous; v: (n, 16, C) at strides (sb,
// sp, sc), C in 1..4; lo, hi: (n, C) contiguous; lo_out, hi_out (n, C).
int xla_ls_step(const float* wl, const float* mask, const float* v, int sb,
                int sp, int sc, const float* lo, const float* hi,
                float* lo_out, float* hi_out, int n, int n_ch, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_ch) {
    case 1: return (int)launch_ls_step<1>(wl, mask, v, sb, sp, sc, lo, hi,
                                          lo_out, hi_out, n, s);
    case 2: return (int)launch_ls_step<2>(wl, mask, v, sb, sp, sc, lo, hi,
                                          lo_out, hi_out, n, s);
    case 3: return (int)launch_ls_step<3>(wl, mask, v, sb, sp, sc, lo, hi,
                                          lo_out, hi_out, n, s);
    case 4: return (int)launch_ls_step<4>(wl, mask, v, sb, sp, sc, lo, hi,
                                          lo_out, hi_out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

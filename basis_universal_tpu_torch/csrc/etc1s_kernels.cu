// Hand-written Hopper (sm_90a) kernels of the ETC1S encoder.
//
// Each scan, rescore and selector kernel replaces one Pallas kernel of
// basis_universal_tpu/ops/pallas_etc1s.py (all four are here); the cross6
// kernels replace the frontend's two XLA matrix products whose rounding
// decides its codebooks and cluster_scan_assemble its cluster scan's
// segment sums and assembly (both in etc1s_codebook.h), bisect_rows and
// bisect_round its bisecting init, min_k_kernel its ApproxTopK. Each
// computes the same function with the same
// float32 operation order per element; the plain PyTorch versions live
// beside the wrappers in basis_universal_tpu_torch/ops/cuda_etc1s.py.
//
// Every launcher takes raw device pointers, sizes and a cudaStream_t (the
// caller's current PyTorch stream), launches asynchronously, allocates and
// synchronises nothing, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "xla_cpu_sort.h"

namespace {

namespace cg = cooperative_groups;

// ETC1 intensity modifier tables (ops/etc1.py ETC1_INTEN_TABLES), selector
// 0..3 low to high.
__constant__ float kTabs[8][4] = {
    {-8.f, -2.f, 2.f, 8.f},       {-17.f, -5.f, 5.f, 17.f},
    {-29.f, -9.f, 9.f, 29.f},     {-42.f, -13.f, 13.f, 42.f},
    {-60.f, -18.f, 18.f, 60.f},   {-80.f, -24.f, 24.f, 80.f},
    {-106.f, -33.f, 33.f, 106.f}, {-183.f, -47.f, 47.f, 183.f},
};

// Midpoints between consecutive table values: the unclipped best selector
// of a gray-axis offset u is found by three threshold compares.
__constant__ float kMids[8][3] = {
    {-5.f, 0.f, 5.f},     {-11.f, 0.f, 11.f},   {-19.f, 0.f, 19.f},
    {-27.5f, 0.f, 27.5f}, {-39.f, 0.f, 39.f},   {-52.f, 0.f, 52.f},
    {-69.5f, 0.f, 69.5f}, {-115.f, 0.f, 115.f},
};

// Candidate 5-bit deltas around the base colour, ordered by L1 norm
// (ops/etc1s_encode.py _candidate_deltas) for radius 1 and radius 2.
__constant__ int kDeltasR1[27][3] = {
    {0,0,0},{-1,0,0},{0,-1,0},{0,0,-1},{0,0,1},{0,1,0},{1,0,0},{-1,-1,0},
    {-1,0,-1},{-1,0,1},{-1,1,0},{0,-1,-1},{0,-1,1},{0,1,-1},{0,1,1},{1,-1,0},
    {1,0,-1},{1,0,1},{1,1,0},{-1,-1,-1},{-1,-1,1},{-1,1,-1},{-1,1,1},
    {1,-1,-1},{1,-1,1},{1,1,-1},{1,1,1}};

__constant__ int kDeltasR2[125][3] = {
    {0,0,0},{-1,0,0},{0,-1,0},{0,0,-1},{0,0,1},{0,1,0},{1,0,0},{-2,0,0},
    {-1,-1,0},{-1,0,-1},{-1,0,1},{-1,1,0},{0,-2,0},{0,-1,-1},{0,-1,1},
    {0,0,-2},{0,0,2},{0,1,-1},{0,1,1},{0,2,0},{1,-1,0},{1,0,-1},{1,0,1},
    {1,1,0},{2,0,0},{-2,-1,0},{-2,0,-1},{-2,0,1},{-2,1,0},{-1,-2,0},
    {-1,-1,-1},{-1,-1,1},{-1,0,-2},{-1,0,2},{-1,1,-1},{-1,1,1},{-1,2,0},
    {0,-2,-1},{0,-2,1},{0,-1,-2},{0,-1,2},{0,1,-2},{0,1,2},{0,2,-1},{0,2,1},
    {1,-2,0},{1,-1,-1},{1,-1,1},{1,0,-2},{1,0,2},{1,1,-1},{1,1,1},{1,2,0},
    {2,-1,0},{2,0,-1},{2,0,1},{2,1,0},{-2,-2,0},{-2,-1,-1},{-2,-1,1},
    {-2,0,-2},{-2,0,2},{-2,1,-1},{-2,1,1},{-2,2,0},{-1,-2,-1},{-1,-2,1},
    {-1,-1,-2},{-1,-1,2},{-1,1,-2},{-1,1,2},{-1,2,-1},{-1,2,1},{0,-2,-2},
    {0,-2,2},{0,2,-2},{0,2,2},{1,-2,-1},{1,-2,1},{1,-1,-2},{1,-1,2},
    {1,1,-2},{1,1,2},{1,2,-1},{1,2,1},{2,-2,0},{2,-1,-1},{2,-1,1},{2,0,-2},
    {2,0,2},{2,1,-1},{2,1,1},{2,2,0},{-2,-2,-1},{-2,-2,1},{-2,-1,-2},
    {-2,-1,2},{-2,1,-2},{-2,1,2},{-2,2,-1},{-2,2,1},{-1,-2,-2},{-1,-2,2},
    {-1,2,-2},{-1,2,2},{1,-2,-2},{1,-2,2},{1,2,-2},{1,2,2},{2,-2,-1},
    {2,-2,1},{2,-1,-2},{2,-1,2},{2,1,-2},{2,1,2},{2,2,-1},{2,2,1},
    {-2,-2,-2},{-2,-2,2},{-2,2,-2},{-2,2,2},{2,-2,-2},{2,-2,2},{2,2,-2},
    {2,2,2}};

// Perceptual transform rows (ops/etc1s_encode.py PERC_P, float32 values),
// scaled so P @ (1,1,1) = (sqrt(3), 0, 0).
#define P00 0.378886104f
#define P01 1.21784818f
#define P02 0.135316476f
#define P10 0.609863102f
#define P11 -0.548876762f
#define P12 -0.0609863102f
#define P20 -0.0580048524f
#define P21 -0.186444178f
#define P22 0.244449019f
// P (1,1,1) in float32 (ops/etc1s_encode.py GVEC): sqrt(3) and two
// rounding residues, which the reference's luma products keep
#define G0 1.73205078f
#define G1 2.98023224e-08f
#define G2 -1.49011612e-08f
#define THIRD 0.333333343f
#define C31_255 0.121568628f

// One RGB row times P^T in XLA-CPU's order (ops/etc1s_encode.py
// _perc_rows): a row of its vector loop (vec) takes channels 0 and 1 as
// (r P_j0 + g P_j1) + b P_j2 from rounded products and channel 2 as the
// fused multiply-add chain; any other row the chain in all three.
__device__ __forceinline__ void perc_row(float r, float g, float b, bool vec,
                                         float& e0, float& e1, float& e2) {
  const float c0 = __fmaf_rn(b, P02, __fmaf_rn(g, P01, __fmul_rn(r, P00)));
  const float c1 = __fmaf_rn(b, P12, __fmaf_rn(g, P11, __fmul_rn(r, P10)));
  e2 = __fmaf_rn(b, P22, __fmaf_rn(g, P21, __fmul_rn(r, P20)));
  e0 = vec ? __fadd_rn(__fadd_rn(__fmul_rn(r, P00), __fmul_rn(g, P01)),
                       __fmul_rn(b, P02))
           : c0;
  e1 = vec ? __fadd_rn(__fadd_rn(__fmul_rn(r, P10), __fmul_rn(g, P11)),
                       __fmul_rn(b, P12))
           : c1;
}

// x . (G0, G1, G2), a fused multiply-add chain (the reference's luma).
__device__ __forceinline__ float perc_luma(float e0, float e1, float e2) {
  return __fmaf_rn(e2, G2, __fmaf_rn(e1, G1, __fmul_rn(e0, G0)));
}

__device__ __forceinline__ float clip31(float v) {
  return fminf(fmaxf(v, 0.f), 31.f);
}

__device__ __forceinline__ float clip255(float v) {
  return fminf(fmaxf(v, 0.f), 255.f);
}

__device__ __forceinline__ float expand5f(float c5) {
  return c5 * 8.f + floorf(c5 * 0.25f);
}

// ---------------------------------------------------------------------------
// factorized_scan and factorized_scan_shortlist: the unclipped ETC1S error of
// every block against D candidate base colours x 8 intensity tables,
//     err = q - su2/3 + 3 * sum_i min_k (t_k - u_i)^2 ,
// column d*8 + t for delta d (kDeltasR1 / kDeltasR2 order) and table t; D is
// 1, 27 or 125 (radius 0, 1, 2).
//
// Replaces _fscan_kernel / factorized_scan of basis_universal_tpu/ops/
// pallas_etc1s.py:249 / :343. The full variant writes the (B, D*8) float32
// gray-axis sums sum_i min_k (t_k - u_i)^2 of each column, row-major, which
// optimize_cluster_endpoints segment-sums to clusters (whole rows) before it
// adds each cluster's constant part, as the reference's formulation of the
// cluster scan does; the shortlist variant writes only the (B, k) int64
// columns of the k smallest errors per block (ascending, equal errors by
// ascending column: the order of lax.top_k and of a stable sort), so the
// errors never reach device memory and no sort runs after the scan.
//
// Bound at the main path's shape (B 24,576, D 27): the full variant moves
// 5.0 MB in (pixels and bases) and 21.2 MB out (7.8 us at 3.35 TB/s); the
// shortlist variant
// 4.7 MB in and 3.1 MB out (2.3 us). Both do B*D*8*16 = 85 M (pixel, table)
// steps of a compare, a select, a subtract and a multiply-add (~0.01 ms of
// issue over 132 SMs x 128 lanes), so both are bound by that arithmetic, not
// by bytes. The design keeps all but that arithmetic off the critical path:
// - A CTA stages its tile of blocks once (contiguous 192-byte blocks,
//   coalesced 16-byte loads into shared memory padded to 52 floats a block,
//   so a quarter-warp's 16-byte reads hit distinct banks), then one thread
//   per block computes the block's luma and moments once, in the same
//   sequential order over the 16 pixels as before, into shared memory (luma
//   transposed, [16][tile]). The CTA then loops over all D deltas: no grid
//   dimension over deltas, nothing recomputed per delta.
// - One comparison per intensity table. The tables are {-a, -b, b, a} and
//   kMids holds their exact midpoints {-m, 0, m}, so min_k (t_k - u)^2 is
//   (s - |u|)^2 with s = |u| > m ? a : b: the same square as the three
//   threshold compares give, bit for bit (negation is exact; at u = 0 both
//   give b^2; at u = -m, (a - m)^2 = (m - b)^2 exactly).
// - The rounding is XLA's CPU code's for the reference's scan, read from
//   its LLVM IR and spelled out with __fmaf_rn / __fmul_rn / __fadd_rn:
//   su2 and q - su2/3 as fused multiply-adds, the 16 squares summed as its
//   8-lane vector loop sums them (lane j = fma(d_{j+8}, d_{j+8}, d_j^2),
//   then lanes pairwise 4, 2, 1) and err = fma(sum, 3, q - su2/3). With
//   whole-numbered pixels the moments are exact, so every column is the
//   reference's, and equal errors (exact ties) order as its top_k orders
//   them.
// - D = 27 and 125: a warp owns a block and lane l owns deltas l, l + 32,
//   ...; the full variant's lanes store their 8 errors as two float4, so a
//   warp writes one contiguous row. D = 1: a thread owns a block (tile 128).
// - The shortlist variant keeps each lane's errors in registers as integer
//   keys that order as the floats do (-0.0 as +0.0, NaN last). A threshold
//   that at least k columns reach (the largest of the lanes' minima) is
//   lowered by bisection on the key, each step one count per lane and one
//   warp reduction, until at most 32 columns reach it; those are compacted
//   into shared memory as (key, column) words and each is ranked against
//   the others: rank r < k is written to place r. No step is a serial
//   chain of more than a few reductions. Ties are exact in saturated blocks
//   (clipped deltas coincide) and go to the lower column. D = 1 ranks its 8
//   columns in the thread.
// CTA shapes (ScanShape), from ptxas' registers and shared memory: D 27 has
// 8 warps on a 32-block tile (768 CTAs at B 24,576; 40-64 registers and
// 10-17 KB allow 4-5 CTAs, 40 warps, per SM, enough to hide the shortlist's
// shuffle and reduction chains, which 4-warp CTAs (~23 warps per SM) did
// not); D 125 has 4 warps on a 16-block tile (1,536 CTAs; 96-128 registers
// allow 4 CTAs per SM, and its shortlist buffers take 32 KB); D 1 has 128
// threads on a 128-block tile (192 CTAs; its 8 columns a block are cheap).
// ---------------------------------------------------------------------------
constexpr int kPxStride = 52;            // floats per staged block (48 + 4)

// CTA shape per D: warps, and blocks per tile (one per thread at D 1)
template <int kD>
struct ScanShape {
  static constexpr int kWarps = kD == 27 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTile = kD == 1 ? kThreads : (kD == 27 ? 32 : 16);
};

// One block's sufficient statistics and base colour (5-bit, as floats).
struct ScanMoments {
  float sum_l, sum_l2, s0, s1, s2, sum_x2, b5r, b5g, b5b;
};

// Moments of one block from its 48 staged floats (shared memory); writes
// the 16 luma values at stride luma_stride.
template <bool kExternalBase, bool kPerceptual>
__device__ __forceinline__ ScanMoments block_moments(
    const float* __restrict__ px, const float* __restrict__ base5, int b,
    float* __restrict__ luma_out, int luma_stride) {
  float v[48];
#pragma unroll
  for (int q = 0; q < 12; ++q) {
    const float4 f = reinterpret_cast<const float4*>(px)[q];
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
  }
  float x0[16], x1[16], x2[16];
  float sr = 0.f, sg = 0.f, sb = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float r = v[i * 3 + 0];
    const float g = v[i * 3 + 1];
    const float bl = v[i * 3 + 2];
    sr += r; sg += g; sb += bl;
    if (kPerceptual) {
      // the (16 B, 3) pixel rows: all in the reference's vector loop
      perc_row(r, g, bl, true, x0[i], x1[i], x2[i]);
    } else {
      x0[i] = r; x1[i] = g; x2[i] = bl;
    }
  }
  ScanMoments m;
  if (kPerceptual) {
    // each sum in the order of the reference's compiled moments: luma a
    // chain, sum_l and the channel sums pixel by pixel, sum_l2 a chain,
    // sum_x2 an 8-lane loop over the pixels (lane j: fma over pixel j's
    // channels, then pixel j + 8's), the lanes pairwise
    float sum_l = 0.f, sum_l2 = 0.f, s0 = x0[0], s1 = x1[0], s2 = x2[0];
    float lane[8];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float luma = perc_luma(x0[i], x1[i], x2[i]);
      luma_out[i * luma_stride] = luma;
      sum_l = i == 0 ? luma : __fadd_rn(sum_l, luma);
      sum_l2 = i == 0 ? __fmul_rn(luma, luma) : __fmaf_rn(luma, luma, sum_l2);
      if (i > 0) {
        s0 = __fadd_rn(s0, x0[i]);
        s1 = __fadd_rn(s1, x1[i]);
        s2 = __fadd_rn(s2, x2[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a = __fmul_rn(x0[j], x0[j]);
      a = __fmaf_rn(x1[j], x1[j], a);
      a = __fmaf_rn(x2[j], x2[j], a);
      a = __fmaf_rn(x0[j + 8], x0[j + 8], a);
      a = __fmaf_rn(x1[j + 8], x1[j + 8], a);
      lane[j] = __fmaf_rn(x2[j + 8], x2[j + 8], a);
    }
    const float h0 = __fadd_rn(lane[0], lane[4]);
    const float h1 = __fadd_rn(lane[1], lane[5]);
    const float h2 = __fadd_rn(lane[2], lane[6]);
    const float h3 = __fadd_rn(lane[3], lane[7]);
    m.sum_x2 = __fadd_rn(__fadd_rn(h0, h2), __fadd_rn(h1, h3));
    m.sum_l = sum_l; m.sum_l2 = sum_l2;
    m.s0 = s0; m.s1 = s1; m.s2 = s2;
  } else {
    // whole numbers: every sum exact
    float sum_l = 0.f, sum_l2 = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f;
    float sum_x2 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float luma = x0[i] + x1[i] + x2[i];
      luma_out[i * luma_stride] = luma;
      sum_l += luma;
      sum_l2 += luma * luma;
      s0 += x0[i]; s1 += x1[i]; s2 += x2[i];
      sum_x2 += x0[i] * x0[i] + x1[i] * x1[i] + x2[i] * x2[i];
    }
    m.sum_l = sum_l; m.sum_l2 = sum_l2;
    m.s0 = s0; m.s1 = s1; m.s2 = s2; m.sum_x2 = sum_x2;
  }
  if (kExternalBase) {
    m.b5r = base5[(size_t)b * 3 + 0];
    m.b5g = base5[(size_t)b * 3 + 1];
    m.b5b = base5[(size_t)b * 3 + 2];
  } else {
    m.b5r = clip31(rintf(sr / 16.f * C31_255));
    m.b5g = clip31(rintf(sg / 16.f * C31_255));
    m.b5b = clip31(rintf(sb / 16.f * C31_255));
  }
  return m;
}

// The 8 errors (one per intensity table) of one block against one delta,
// or with kMinterm their gray-axis sums alone (the full variant: the
// column's fma(sum, 3, constant) is then assembled per cluster): the one
// device function behind both scan variants, so their sums agree bit for
// bit per column.
template <bool kPerceptual, bool kMinterm>
__device__ __forceinline__ void scan_delta(const ScanMoments& m,
                                           const float (&luma)[16], int dr,
                                           int dg, int db, bool vec,
                                           const float* lb_in, float (&err)[8]) {
  const float c5r = clip31(m.b5r + (float)dr);
  const float c5g = clip31(m.b5g + (float)dg);
  const float c5b = clip31(m.b5b + (float)db);
  const float b8r = expand5f(c5r), b8g = expand5f(c5g), b8b = expand5f(c5b);
  float e0, e1, e2, lb;
  if (kPerceptual) {
    // the candidate base as its row of the reference's (D, B, 3) array
    perc_row(b8r, b8g, b8b, vec, e0, e1, e2);
    lb = perc_luma(e0, e1, e2);
  } else {
    e0 = b8r; e1 = b8g; e2 = b8b;
    lb = b8r + b8g + b8b;
  }
  // q = (sum_x2 - 2 e.s) + 16 e.e, the dot products fused multiply-add
  // chains (exact for whole numbers)
  const float es = __fmaf_rn(e2, m.s2, __fmaf_rn(e1, m.s1, __fmul_rn(e0, m.s0)));
  const float ee = __fmaf_rn(e2, e2, __fmaf_rn(e1, e1, __fmul_rn(e0, e0)));
  const float q = __fadd_rn(__fsub_rn(m.sum_x2, __fmul_rn(2.f, es)),
                            __fmul_rn(16.f, ee));
  // the assembly rounded as XLA's CPU code rounds the reference's scan,
  // each fused multiply-add and sum spelled out
  const float su2 =
      __fmaf_rn(lb, 16.f * lb, __fmaf_rn(-2.f * lb, m.sum_l, m.sum_l2));
  const float cst = __fmaf_rn(-su2, THIRD, q);
  // the cluster scan's gray-axis level: the block's cluster's (given)
  if (lb_in) lb = *lb_in;

  // u rounded before the subtraction, as the three-compare form computed
  // it: |t_k - u| = s - |u| exactly, so the squares are the same bits
  float a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = fabsf(__fmul_rn(luma[i] - lb, THIRD));
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    // the 16 squares in the order of XLA's 8-lane vector loop: lane j is
    // fma(d_{j+8}, d_{j+8}, d_j^2), then the lanes pairwise (4, 2, 1)
    float lane[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s0 = a[j] > kMids[t][2] ? kTabs[t][3] : kTabs[t][2];
      const float s8 = a[j + 8] > kMids[t][2] ? kTabs[t][3] : kTabs[t][2];
      const float d0 = __fsub_rn(s0, a[j]);
      const float d8 = __fsub_rn(s8, a[j + 8]);
      lane[j] = __fmaf_rn(d8, d8, __fmul_rn(d0, d0));
    }
    const float h0 = __fadd_rn(lane[0], lane[4]);
    const float h1 = __fadd_rn(lane[1], lane[5]);
    const float h2 = __fadd_rn(lane[2], lane[6]);
    const float h3 = __fadd_rn(lane[3], lane[7]);
    const float mt = __fadd_rn(__fadd_rn(h0, h2), __fadd_rn(h1, h3));
    err[t] = kMinterm ? mt : __fmaf_rn(mt, 3.f, cst);
  }
}

// An integer key that orders as the float does: -0.0 as +0.0, NaN after
// +inf (as a sort puts it).
__device__ __forceinline__ int order_key(float v) {
  int b = __float_as_int(v);
  if (v == 0.f) b = 0;
  if (v != v) b = 0x7fffffff;
  return b ^ ((b >> 31) & 0x7fffffff);
}

// The k smallest of one block's columns, held by a warp (lane l holds the
// keys of deltas l + 32 m; nothing past the last delta), written in order
// to out[0..k): ascending key, equal keys by ascending column. cand is the
// warp's shared-memory buffer of kD*8 words.
template <int kD>
__device__ __forceinline__ void warp_shortlist(const int (&key)[(kD + 31) / 32][8],
                                               int lane, int k,
                                               unsigned long long* cand,
                                               int64_t* __restrict__ out) {
  constexpr int kM = (kD + 31) / 32;
  const unsigned full = 0xffffffffu;
  // how many of the block's columns have a key <= x
  auto count = [&](int x) {
    int c = 0;
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int t = 0; t < 8; ++t)
        c += (lane + 32 * m < kD) && key[m][t] <= x;
    return c;
  };
  // 1. a threshold that at least k columns reach: the largest of the lanes'
  //    minima (each of the 27 or 32 lanes holds a column at or under it),
  //    and one that none reaches
  int lmin = 0x7fffffff;
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (lane + 32 * m < kD) lmin = min(lmin, key[m][t]);
  int hi = __reduce_max_sync(full, lane < kD ? lmin : (int)0x80000000);
  const int lo0 = __reduce_min_sync(full, lmin) - 1;
  // 2. lower it by bisection on the key while more than 32 columns reach
  //    it (about one step on the main path's blocks), down to the k-th
  //    smallest key itself (which ties may still make longer)
  int lo = lo0;
  int c = count(hi);                          // this lane's columns <= hi
  int n_cand = __reduce_add_sync(full, c);
  while (n_cand > 32 && (unsigned)hi - (unsigned)lo > 1u) {
    const int mid = lo + (int)(((unsigned)hi - (unsigned)lo) >> 1);
    const int cm = count(mid);
    const int n = __reduce_add_sync(full, cm);
    if (n >= k) {
      hi = mid;
      c = cm;
      n_cand = n;
    } else {
      lo = mid;
    }
  }
  // 3. compact the columns at or under it as (key, column) words that order
  //    as 64-bit integers: each lane's count, then an exclusive scan
  int pos = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(full, pos, off);
    if (lane >= off) pos += y;
  }
  pos -= c;
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if ((lane + 32 * m < kD) && key[m][t] <= hi)
        cand[pos++] =
            ((unsigned long long)((unsigned)key[m][t] ^ 0x80000000u) << 32) |
            (unsigned)((lane + 32 * m) * 8 + t);
  if (lane == 0 && (n_cand & 1)) cand[n_cand] = ~0ull;   // pad to pairs
  __syncwarp();
  // 4. each candidate's rank among the candidates (two words per load);
  //    the first k are written
  const ulonglong2* pairs = reinterpret_cast<const ulonglong2*>(cand);
  for (int i = lane; i < n_cand; i += 32) {
    const unsigned long long mine = cand[i];
    int rank = 0;
    for (int j = 0; j < (n_cand + 1) / 2; ++j) {
      const ulonglong2 w = pairs[j];
      rank += (w.x < mine) + (w.y < mine);
    }
    if (rank < k) out[rank] = (int64_t)(mine & 0xffffffffull);
  }
  __syncwarp();
}

template <int kD, bool kShortlist, bool kExternalBase, bool kPerceptual>
__global__ void __launch_bounds__(ScanShape<kD>::kThreads)
fscan_kernel(const float* __restrict__ pixels,
             const float* __restrict__ base5, const float* __restrict__ lb_in,
             float* __restrict__ err_out, int64_t* __restrict__ idx_out,
             int n_blocks, int k, int vec_rows) {
  constexpr int kThreads = ScanShape<kD>::kThreads;
  constexpr int kWarps = ScanShape<kD>::kWarps;
  constexpr int kTile = ScanShape<kD>::kTile;
  constexpr int kM = (kD + 31) / 32;
  constexpr bool kWarpSelect = kShortlist && kD > 1;
  __shared__ __align__(16) float px_s[kTile * kPxStride];
  __shared__ float luma_s[16][kTile];
  __shared__ ScanMoments mom_s[kTile];
  __shared__ __align__(16) unsigned long long cand_s
      [kWarpSelect ? kWarps : 1][kWarpSelect ? kD * 8 : 2];

  const int b0 = blockIdx.x * kTile;
  const int n_tile = min(kTile, n_blocks - b0);

  // stage the tile: 12 float4 per block, neighbouring threads on
  // neighbouring 16 bytes
  const float4* src = reinterpret_cast<const float4*>(pixels + (size_t)b0 * 48);
  for (int q = threadIdx.x; q < n_tile * 12; q += kThreads) {
    const int j = q / 12;
    *reinterpret_cast<float4*>(px_s + j * kPxStride + (q - 12 * j) * 4) =
        __ldg(src + q);
  }
  __syncthreads();
  if (threadIdx.x < n_tile) {
    const int j = threadIdx.x;
    mom_s[j] = block_moments<kExternalBase, kPerceptual>(
        px_s + j * kPxStride, base5, b0 + j, &luma_s[0][j], kTile);
  }
  __syncthreads();

  if constexpr (kD == 1) {
    const int j = threadIdx.x;
    if (j >= n_tile) return;
    float luma[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) luma[i] = luma_s[i][j];
    float e[8];
    const size_t b = (size_t)(b0 + j);
    scan_delta<kPerceptual, !kShortlist>(mom_s[j], luma, 0, 0, 0,
                                         (long long)b < vec_rows,
                                         lb_in ? lb_in + b : nullptr, e);
    if constexpr (!kShortlist) {
      float4* o = reinterpret_cast<float4*>(err_out + b * 8);
      o[0] = make_float4(e[0], e[1], e[2], e[3]);
      o[1] = make_float4(e[4], e[5], e[6], e[7]);
    } else {
      int key[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) key[t] = order_key(e[t]);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        int rank = 0;
#pragma unroll
        for (int j2 = 0; j2 < 8; ++j2)
          rank += j2 < t ? key[j2] <= key[t] : key[j2] < key[t];
        if (rank < k) idx_out[b * k + rank] = t;
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this lane's deltas, read once
  int dr[kM], dg[kM], db[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int d = lane + 32 * m;
    dr[m] = dg[m] = db[m] = 0;
    if (d < kD) {
      if (kD == 27) {
        dr[m] = kDeltasR1[d][0]; dg[m] = kDeltasR1[d][1]; db[m] = kDeltasR1[d][2];
      } else {
        dr[m] = kDeltasR2[d][0]; dg[m] = kDeltasR2[d][1]; db[m] = kDeltasR2[d][2];
      }
    }
  }
  for (int j = warp; j < n_tile; j += kWarps) {
    const ScanMoments mom = mom_s[j];
    float luma[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) luma[i] = luma_s[i][j];
    const size_t b = (size_t)(b0 + j);
    int key[kM][8];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int d = lane + 32 * m;
#pragma unroll
      for (int t = 0; t < 8; ++t) key[m][t] = 0x7fffffff;
      if (d < kD) {
        float e[8];
        scan_delta<kPerceptual, !kShortlist>(
            mom, luma, dr[m], dg[m], db[m],
            (long long)d * n_blocks + (long long)b < vec_rows,
            lb_in ? lb_in + b * kD + d : nullptr, e);
        if constexpr (!kShortlist) {
          float4* o = reinterpret_cast<float4*>(err_out + (b * kD + d) * 8);
          o[0] = make_float4(e[0], e[1], e[2], e[3]);
          o[1] = make_float4(e[4], e[5], e[6], e[7]);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) key[m][t] = order_key(e[t]);
        }
      }
    }
    if constexpr (kWarpSelect)
      warp_shortlist<kD>(key, lane, k, cand_s[warp], idx_out + b * k);
  }
}

// ---------------------------------------------------------------------------
// palette_errs_packed: exact gamut-clipped error of each block against K
// packed candidates r5 | g5<<5 | b5<<10 | inten<<15,
//     err[b,k] = sum_i min_sel || x_i - clip(expand5(c5) + t_sel) ||^2 .
//
// Replaces _rescore_kernel / palette_errs_packed of basis_universal_tpu/ops/
// pallas_etc1s.py:91 / :137. Bound: per output, 16 pixels x 4 selectors x
// (3 subtracts, a multiply, 2 multiply-adds, a min) in float32, which must
// keep this operation order to give the same bits: ~0.006 ms of issue for
// the 393 k outputs of K 16 at B 24,576 (4.7 MB of pixels and 1.6 MB of
// candidates in, 1.6 MB out: 2.4 us). So the kernel is bound by that
// arithmetic, and the design spends as little else as it can:
// - a 2-D CTA: threadIdx.x is the candidate, threadIdx.y the block of the
//   tile (256 / K blocks, at most 64), so no thread divides an index;
// - the tile's pixels are staged once in shared memory as (r, g, b, 0)
//   float4, neighbouring threads loading neighbouring pixels; a candidate
//   reads each pixel with one 16-byte load that its block's K threads share
//   (a broadcast);
// - the palette is rebuilt in registers from the packed word, as before.
// At K 16 the grid is 1,536 CTAs of 256 threads, ~11.6 per SM, taken up as
// SMs free: the last CTAs leave at most one CTA's time (~1/12 of the run)
// of imbalance, which a persistent loop (two barriers per tile) would not
// repay.
// ---------------------------------------------------------------------------
constexpr int kRescoreThreads = 256;
constexpr int kRescoreMaxRows = 64;
constexpr int kPercTailBit = 1 << 18;  // ops/etc1s_encode.py PERC_TAIL_BIT

template <bool kPerceptual>
__global__ void __launch_bounds__(kRescoreThreads)
rescore_kernel(const float* __restrict__ pixels,
               const int32_t* __restrict__ packed, float* __restrict__ out,
               int n_blocks, int n_cand) {
  __shared__ float4 px_s[kRescoreMaxRows][16];
  const int rows = blockDim.y;
  const int b0 = blockIdx.x * rows;
  const int n_tile = min(rows, n_blocks - b0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const float* src = pixels + (size_t)b0 * 48;
  for (int q = tid; q < n_tile * 16; q += n_threads) {
    const float r = __ldg(src + q * 3), g = __ldg(src + q * 3 + 1),
                bl = __ldg(src + q * 3 + 2);
    if (kPerceptual) {
      // the pixels transformed apart from the palettes, as the reference's
      // (16 B, 3) rows (all in its vector loop)
      float x0, x1, x2;
      perc_row(r, g, bl, true, x0, x1, x2);
      px_s[q >> 4][q & 15] = make_float4(x0, x1, x2, 0.f);
    } else {
      px_s[q >> 4][q & 15] = make_float4(r, g, bl, 0.f);
    }
  }
  __syncthreads();
  const int j = threadIdx.y;
  if (j >= n_tile) return;

  const size_t o = (size_t)(b0 + j) * n_cand + threadIdx.x;
  const int v = __ldg(packed + o);
  const float r5 = (float)(v & 31);
  const float g5 = (float)((v >> 5) & 31);
  const float b5 = (float)((v >> 10) & 31);
  const int tt = (v >> 15) & 7;
  const float b8r = expand5f(r5), b8g = expand5f(g5), b8b = expand5f(b5);
  float pr[4], pg[4], pb[4];
  // a palette flagged kPercTailBit is transformed as the reference's rows
  // past its vector loop (the refine's last codebook palette at odd C)
  const bool vec = (v & kPercTailBit) == 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float tsel = kTabs[tt][s];
    pr[s] = clip255(b8r + tsel);
    pg[s] = clip255(b8g + tsel);
    pb[s] = clip255(b8b + tsel);
    if (kPerceptual) perc_row(pr[s], pg[s], pb[s], vec, pr[s], pg[s], pb[s]);
  }
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float4 p = px_s[j][i];
    const float r = p.x, g = p.y, bl = p.z;
    float best = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float dist;
      if (kPerceptual) {
        // the reference's order: the squares a fused multiply-add chain
        // over the channels, the minima added pixel by pixel
        const float d0 = __fsub_rn(pr[s], r), d1 = __fsub_rn(pg[s], g),
                    d2 = __fsub_rn(pb[s], bl);
        dist = __fmaf_rn(d2, d2, __fmaf_rn(d1, d1, __fmul_rn(d0, d0)));
      } else {
        const float dr = r - pr[s], dg = g - pg[s], db = bl - pb[s];
        dist = dr * dr + dg * dg + db * db;     // whole numbers: exact
      }
      best = s == 0 ? dist : fminf(best, dist);
    }
    total = kPerceptual ? __fadd_rn(total, best) : total + best;
  }
  out[o] = total;
}

// ---------------------------------------------------------------------------
// palette_errs: the same error against K explicit palettes (B, K, 4, 3),
//     err[b,k] = sum_i min_sel || x_i - pal[b,k,sel] ||^2 .
// One thread per (block, candidate) reads its palette's 12 floats (48
// contiguous bytes) instead of unpacking a word; no clip, no table.
// ---------------------------------------------------------------------------
__global__ void errs_kernel(const float* __restrict__ pixels,
                            const float* __restrict__ palettes,
                            float* __restrict__ out, int n_blocks,
                            int n_cand) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)n_blocks * n_cand) return;
  const int b = (int)(gid / n_cand);
  const float* pal = palettes + (size_t)gid * 12;
  float pr[4], pg[4], pb[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    pr[s] = __ldg(pal + s * 3 + 0);
    pg[s] = __ldg(pal + s * 3 + 1);
    pb[s] = __ldg(pal + s * 3 + 2);
  }
  const float* px = pixels + (size_t)b * 48;
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float r = __ldg(px + i * 3 + 0);
    const float g = __ldg(px + i * 3 + 1);
    const float bl = __ldg(px + i * 3 + 2);
    float best = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float dr = pr[s] - r, dg = pg[s] - g, db = pb[s] - bl;
      const float dist = dr * dr + dg * dg + db * db;
      best = s == 0 ? dist : fminf(best, dist);
    }
    total += best;
  }
  out[gid] = total;
}

// ---------------------------------------------------------------------------
// find_best_selector_patterns: argmin_s sum_i bf16(d[b,i,pat_s[i]]) with
// float32 accumulation, never materialising the (B, S) error matrix.
//
// Replaces _selbest_kernel / find_best_selector_patterns of
// basis_universal_tpu/ops/pallas_etc1s.py:173 / :207, which runs the error as
// a (T, 64) x (64, S_chunk) one-hot product on the MXU fused with a running
// argmin. The same product runs here on Hopper's warpgroup tensor-core
// instruction:
//     err (B x S) = D_bf16 (B x 64) . Onehot (S x 64)^T, fp32 accumulate,
// as wgmma.mma_async m64nNk16 (bf16 in, fp32 out), the four k-steps of K = 64
// chained into one accumulator in pixel order (k 0-15, 16-31, 32-47, 48-63).
// Every product is exact (a bf16 distance times 1 or 0); only the tensor
// core's fp32 accumulation can differ from a sequential sum, by ulps.
//
// Bound at the main path's shape (B 24,576 blocks, S 2,731 patterns):
// 2*B*S*64 = 8.6 GFLOP of bf16 products, 8.7 us at 989 TFLOP/s, against
// 6.7 MB of traffic (2 us): the tensor cores, and beside them the argmin,
// which must look at each of the B*S errors once. The design:
// - A CTA of four warpgroups takes kSelRows = 192 rows: three consumer
//   warpgroups of 64 rows and one producer (24,576 rows are 128 CTAs, one
//   wave on 132 SMs). Each consumer loads its rows' distances once, rounds
//   them to bf16 (RNE, as .to(torch.bfloat16)) and keeps them for the whole
//   loop as wgmma's A operand in registers (16 a thread).
// - B, the one-hot tile of kSelN patterns x 64, lies in shared memory in
//   wgmma's K-major layout with the 128-byte swizzle: pattern n's 128-byte
//   row at n * 128, its 16-byte chunk c (pixels 2c and 2c + 1) at chunk
//   c ^ (n & 7). The producer warpgroup builds it from the (S, 16) int32
//   patterns (four threads a pattern, 16 bytes each, loaded a tile ahead,
//   two chunks each; bf16 NaN at every k for the padding past S) into a
//   ring of kSelStages tiles guarded by mbarriers (full: the producer's 128
//   threads; empty: the consumers' 12 warps), so the next tiles are built
//   while tile j is multiplied. Each SM builds the one-hot once for its
//   three consumers; no one-hot is read from or written to device memory
//   and nothing is prepared before the launch.
// - Each consumer issues tile j's four wgmmas, waits for them, releases the
//   tile and folds the accumulators into a running (value, index) per row
//   it owns, while the other consumers' products run on the tensor cores.
//   The fold takes each row's least value over the thread's columns, two
//   values an instruction where the warp's distances are all +0 or more
//   (`sel_row_min`), then over the row's quad, and looks for its first
//   column only where the warp has a row whose value beats the running
//   one (strict '<', columns in increasing order): ties go to the lowest
//   pattern index, as in the Pallas kernel. A padded column's error is NaN
//   and never wins; a row whose errors are all +inf/NaN returns pattern 0
//   and +inf.
// Measured on the H100 (PERF.md): the products and barriers alone take
// 1.5x the tensor bound at S 2,731 (1.1x at 16,128); the search for a row's
// column is the largest step after them. Double-buffered accumulators
// (64-pattern tiles), 192-pattern tiles and tiles built by all three
// warpgroups were each slower.
// One launch per call; the result is deterministic.
// ---------------------------------------------------------------------------
constexpr int kSelN = 128;                       // patterns a tile
constexpr int kSelConsumers = 3;                 // warpgroups of 64 rows
constexpr int kSelRows = 64 * kSelConsumers;
constexpr int kSelThreads = 128 * (kSelConsumers + 1);
constexpr int kSelStages = 4;
constexpr int kSelTileBytes = kSelN * 128;       // 64 bf16 a pattern
// the ring, and room to align it to 1,024 bytes (the swizzle's atom)
constexpr int kSelSmem = kSelStages * kSelTileBytes + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// The same, by lane 0 of the warp alone: a predicated arrive, no branch.
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.eq.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// Waits until the barrier's phase of the given parity has completed, the
// loop inside one asm block (no branch of the compiler's to diverge). A
// phase error would hang the card; after 10 s (%globaltimer, ns) the kernel
// traps instead, so the launch fails.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra LAB_DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, 10000000000;\n"
      "@p bra LAB_WAIT;\n"
      "trap;\n"
      "LAB_DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t x,
                                             uint32_t y, uint32_t z,
                                             uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(x), "r"(y), "r"(z), "r"(w)
               : "memory");
}

// The bf16 one-hot of pixel i's selector u (its low 2 bits) at k = 4i ..
// 4i + 3, as the two words of k = 4i, 4i + 1 and 4i + 2, 4i + 3: 1.0
// (0x3F80) shifted by 16u bits in 64.
__device__ __forceinline__ uint2 onehot_pixel(uint32_t u) {
  const uint64_t w = (uint64_t)0x3F80u << ((u & 3u) << 4);
  return make_uint2((uint32_t)w, (uint32_t)(w >> 32));
}

// wgmma's shared-memory descriptor of a K-major bf16 tile with the 128-byte
// swizzle: the start address >> 4 (bits 0-13), a leading byte offset that
// this layout does not use (1), the stride byte offset 1,024 >> 4 between
// groups of 8 patterns (bits 32-45), layout type 1, the 128-byte swizzle
// (bits 62-63). A k-step of 16 bf16 starts 32 bytes further (+2).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of a wgmma operand's
// registers across the asynchronous product (it sees the asm change them).
template <int kLen>
__device__ __forceinline__ void fence_regs(float (&d)[kLen]) {
#pragma unroll
  for (int i = 0; i < kLen; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// D (64 x N, fp32, registers) = A (64 x 16, bf16, registers) . B (16 x N,
// bf16, shared memory, K-major) + (scale_d ? D : 0), for the warpgroup.
// Accumulator register 4i + 2r + e of thread (warp w, g = lane / 4, t =
// lane % 4) is row 16w + g + 8r, column 8i + 2t + e; A register r + 2c is
// row 16w + g + 8r, columns 2t + 8c and + 1 (lower column, lower half).
__device__ __forceinline__ void wgmma_tile(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Issues tile j's four wgmmas into acc (one commit group), once the
// producer has filled its stage.
__device__ __forceinline__ void sel_issue(float (&acc)[kSelN / 2],
                                          uint32_t (&a)[4][4], int j,
                                          uint32_t ring, uint32_t full0) {
  const int s = j % kSelStages;
  mbar_wait(full0 + 8 * s, (uint32_t)(j / kSelStages) & 1u);
  __syncwarp();
  const uint64_t desc = sw128_desc(ring + s * kSelTileBytes);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) fence_regs(a[ks]);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_tile(acc, a[ks], desc + 2 * ks, ks);
  wgmma_commit();
}

// Row r's least error over the thread's columns. Without a negative
// distance in the warp's rows (sign bits clear), every error is +0 or more,
// or NaN, and the order of such floats is that of their bits as unsigned
// integers, NaN above +inf: Hopper's three-way integer minimum (DPX,
// __vimin3_u32) takes two values an instruction (the kernel ran 10-12%
// faster so than with fminf chains, PERF.md). Otherwise two fminf chains,
// which skip NaN. Either way a padded (NaN) column never wins, and m is NaN
// only where every column is.
__device__ __forceinline__ float sel_row_min(const float (&acc)[kSelN / 2],
                                             int r, bool nonneg) {
  if (nonneg) {
    uint32_t u[2] = {min(__float_as_uint(acc[2 * r]),
                         __float_as_uint(acc[2 * r + 1])),
                     min(__float_as_uint(acc[4 + 2 * r]),
                         __float_as_uint(acc[4 + 2 * r + 1]))};
#pragma unroll
    for (int i = 2; i < kSelN / 8; ++i)
      u[i & 1] = __vimin3_u32(u[i & 1], __float_as_uint(acc[4 * i + 2 * r]),
                              __float_as_uint(acc[4 * i + 2 * r + 1]));
    return __uint_as_float(min(u[0], u[1]));
  }
  float m2[2] = {fminf(acc[2 * r], acc[2 * r + 1]),
                 fminf(acc[4 + 2 * r], acc[4 + 2 * r + 1])};
#pragma unroll
  for (int i = 2; i < kSelN / 8; ++i)
    m2[i & 1] = fminf(m2[i & 1], fminf(acc[4 * i + 2 * r],
                                       acc[4 * i + 2 * r + 1]));
  return fminf(m2[0], m2[1]);
}

// Folds tile j's errors (acc, after its products) into the running (value,
// index) of the thread's two rows, which the 4 threads of its quad share:
// the row's least value over the quad's columns (two shuffles), and where
// it beats the running one (strict '<': ties keep the lower index), its
// first column, the least over the quad of each thread's first column
// 8i + 2t + e holding it. Tracking rows rather than each thread's columns
// makes a warp search less often (PERF.md).
__device__ __forceinline__ void sel_fold(const float (&acc)[kSelN / 2],
                                         int base, int t, bool nonneg,
                                         float (&bv)[2], int (&bi)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the row's least value over the quad's columns
    float m = sel_row_min(acc, r, nonneg);
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const bool better = m < bv[r];
    if (__any_sync(0xffffffffu, better)) {
      // the warp searches together, each thread's result predicated
      int c = 1 << 20;                     // past any column: no match
#pragma unroll
      for (int i = kSelN / 8 - 1; i >= 0; --i)
#pragma unroll
        for (int e = 1; e >= 0; --e)
          c = acc[4 * i + 2 * r + e] == m ? 8 * i + e : c;
      c += 2 * t;
      c = min(c, __shfl_xor_sync(0xffffffffu, c, 1));
      c = min(c, __shfl_xor_sync(0xffffffffu, c, 2));
      bv[r] = better ? m : bv[r];
      bi[r] = better ? base + c : bi[r];
    }
  }
}

__global__ void __launch_bounds__(kSelThreads, 1)
selbest_wgmma_kernel(const float* __restrict__ dists,
                     const int32_t* __restrict__ patterns,
                     int32_t* __restrict__ best_out,
                     float* __restrict__ val_out, int n_blocks,
                     int n_patterns) {
  extern __shared__ uint8_t sel_smem[];
  __shared__ uint64_t full_bar[kSelStages], empty_bar[kSelStages];

  const uint32_t ring = (smem_u32(sel_smem) + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;
  const int n_tiles = (n_patterns + kSelN - 1) / kSelN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSelStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 128);
      mbar_init(smem_u32(&empty_bar[s]), 4 * kSelConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kSelConsumers) {
    // -- producer: tile j of the one-hot into stage j % kSelStages, once
    //    the consumers have released that stage's previous tile. Thread p
    //    takes the quarter q = p & 3 (pixels 4q .. 4q + 3, 16 bytes) of
    //    patterns (p >> 2) + 32h of each tile, loaded into registers a tile
    //    ahead, and stores their two chunks.
    const int p = threadIdx.x & 127;
    const int q = p & 3;
    constexpr int kPer = kSelN / 32;   // patterns a thread, per tile
    uint4 next[kPer];
    auto load = [&](int j) {
#pragma unroll
      for (int h = 0; h < kPer; ++h) {
        const int n = j * kSelN + (p >> 2) + 32 * h;
        next[h] = j < n_tiles && n < n_patterns
            ? __ldg(reinterpret_cast<const uint4*>(patterns + (size_t)n * 16) + q)
            : make_uint4(0, 0, 0, 0);
      }
    };
    load(0);
    for (int j = 0; j < n_tiles; ++j) {
      uint4 v[kPer];
#pragma unroll
      for (int h = 0; h < kPer; ++h) v[h] = next[h];
      load(j + 1);
      const int s = j % kSelStages;
      mbar_wait(smem_u32(&empty_bar[s]), ((uint32_t)(j / kSelStages) & 1u) ^ 1u);
      const uint32_t tile = ring + s * kSelTileBytes;
#pragma unroll
      for (int h = 0; h < kPer; ++h) {
        const int r = (p >> 2) + 32 * h;
        uint2 a0 = onehot_pixel(v[h].x), a1 = onehot_pixel(v[h].y);
        uint2 a2 = onehot_pixel(v[h].z), a3 = onehot_pixel(v[h].w);
        if (j * kSelN + r >= n_patterns) {
          // past S: bf16 NaN at every k, so the column's error is NaN,
          // which no fold takes
          a0 = a1 = a2 = a3 = make_uint2(0x7FC07FC0u, 0x7FC07FC0u);
        }
        const uint32_t row = tile + r * 128;
        const int sw = r & 7;
        st_shared_v4(row + (((2 * q) ^ sw) << 4), a0.x, a0.y, a1.x, a1.y);
        st_shared_v4(row + (((2 * q + 1) ^ sw) << 4), a2.x, a2.y, a3.x,
                     a3.y);
      }
      // the stores are read by the tensor cores (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(smem_u32(&full_bar[s]));
    }
    return;
  }

  // -- consumers: 64 rows each, all of S
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kSelRows + wg * 64 + warp * 16;

  // A, k-step ks: register r + 2c holds row g + 8r, columns ks*16 + 2t + 8c
  // and + 1
  uint32_t a[4][4];
  uint32_t sign = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool valid = row < n_blocks;
    const float2* src = reinterpret_cast<const float2*>(
        dists + (size_t)(valid ? row : 0) * 64);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float2 v = valid ? __ldg(src + ks * 8 + t + 4 * c)
                               : make_float2(0.f, 0.f);
        sign |= __float_as_uint(v.x) | __float_as_uint(v.y);
        const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
        a[ks][r + 2 * c] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
  }
  // no distance of the warp's rows has its sign bit set (a row's 64 are
  // spread over its quad): see sel_row_min
  const bool nonneg = !__any_sync(0xffffffffu, sign >> 31);

  const float inf = __int_as_float(0x7f800000);
  float bv[2] = {inf, inf};
  int bi[2] = {0x7fffffff, 0x7fffffff};
  float acc[kSelN / 2];
#pragma unroll
  for (int i = 0; i < kSelN / 2; ++i) acc[i] = 0.f;
  const uint32_t full0 = smem_u32(full_bar), empty0 = smem_u32(empty_bar);
  for (int j = 0; j < n_tiles; ++j) {
    sel_issue(acc, a, j, ring, full0);
    wgmma_wait_all();
    fence_regs(acc);
    // the tile's products are done: the producer may refill the stage
    mbar_arrive_lane0(empty0 + 8 * (j % kSelStages), lane);
    sel_fold(acc, j * kSelN, t, nonneg, bv, bi);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (t == 0 && row < n_blocks) {
      // no pattern had a finite error (all +inf/NaN): pattern 0, as an
      // argmin over such a row would
      best_out[row] = bi[r] == 0x7fffffff ? 0 : bi[r];
      val_out[row] = bv[r];
    }
  }
}

inline cudaError_t selbest_attrs() {
  static std::mutex mu;
  static std::map<int, bool> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count(dev)) return cudaSuccess;
  e = cudaFuncSetAttribute(selbest_wgmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSelSmem);
  if (e != cudaSuccess) return e;
  done[dev] = true;
  return cudaSuccess;
}

// How many leading rows of an (m, 3) product with P^T XLA-CPU computes in
// its vector loop (ops/etc1s_encode.py _perc_vector_rows).
long long perc_vector_rows(long long m) {
  if (m < 16 || (m >= 20 && m < 24) || (m >= 28 && m < 32)) return 0;
  return m - m % 8;
}

template <int kD, bool kShortlist>
int launch_fscan(const float* pixels, const float* base5, const float* lb,
                 float* err, int64_t* idx, int n_blocks, int perceptual,
                 int k, cudaStream_t s) {
  constexpr int kTile = ScanShape<kD>::kTile;
  constexpr int kThreads = ScanShape<kD>::kThreads;
  const dim3 grid((n_blocks + kTile - 1) / kTile);
  const bool ext = base5 != nullptr;
  // the candidate bases' rows of the reference's (D, B, 3) array
  const long long rows = perc_vector_rows((long long)kD * n_blocks);
  const int vec_rows = (int)(rows < INT_MAX ? rows : INT_MAX);
  if (ext && perceptual)
    fscan_kernel<kD, kShortlist, true, true><<<grid, kThreads, 0, s>>>(
        pixels, base5, lb, err, idx, n_blocks, k, vec_rows);
  else if (ext)
    fscan_kernel<kD, kShortlist, true, false><<<grid, kThreads, 0, s>>>(
        pixels, base5, lb, err, idx, n_blocks, k, vec_rows);
  else if (perceptual)
    fscan_kernel<kD, kShortlist, false, true><<<grid, kThreads, 0, s>>>(
        pixels, base5, lb, err, idx, n_blocks, k, vec_rows);
  else
    fscan_kernel<kD, kShortlist, false, false><<<grid, kThreads, 0, s>>>(
        pixels, base5, lb, err, idx, n_blocks, k, vec_rows);
  return (int)cudaGetLastError();
}

template <bool kShortlist>
int launch_fscan_radius(const float* pixels, const float* base5,
                        const float* lb, float* err, int64_t* idx,
                        int n_blocks, int radius, int perceptual, int k,
                        cudaStream_t s) {
  if (radius == 0)
    return launch_fscan<1, kShortlist>(pixels, base5, lb, err, idx, n_blocks,
                                       perceptual, k, s);
  if (radius == 1)
    return launch_fscan<27, kShortlist>(pixels, base5, lb, err, idx,
                                        n_blocks, perceptual, k, s);
  if (radius == 2)
    return launch_fscan<125, kShortlist>(pixels, base5, lb, err, idx,
                                         n_blocks, perceptual, k, s);
  return (int)cudaErrorInvalidValue;
}

// The k-means and refine distances (cross6_argmin, cross6_distances) and
// the cluster scan's segment sums and assembly (cluster_scan_assemble).
#include "etc1s_codebook.h"

// Asynchronous 16-byte copies from global to shared memory (cp.async, which
// waits on no register: completion is counted per commit group).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the argmin kernels' shared-memory limit, raised once per device
inline cudaError_t cross6_argmin_attrs() {
  static std::mutex mu;
  static std::map<int, bool> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count(dev)) return cudaSuccess;
  for (auto fn : {cross6_argmin_kernel<true>, cross6_argmin_kernel<false>}) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kASmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  done[dev] = true;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bisect_rows and bisect_round: the frontend's bisecting init
// (basis_universal_tpu/ops/etc1s_encode.py:375-434), one launch per
// bisecting round (`round_body`, :403) after one that lays out the rows.
//
// The reference splits every cluster in each round by the sign of each
// member's projection on the cluster's principal axis, from the cluster's
// moment sums: a segment sum of the 43 columns w, v w and (v_f v_g) w over
// the rows (XLA-CPU adds each column of each cluster in row order, and the
// codebook's bytes depend on that order), the mean and covariance, four
// power iterations, the threshold mean . axis. Here the members of every
// cluster are kept contiguous and in ascending row order, cluster after
// cluster (`starts`, C + 1 offsets), as member rows of 32 bytes (kBisectM
// floats: v, w, 0). A round then needs no sort, gather or segment
// reduction: for each cluster it
//   1. sums the 28 distinct moment columns (w, the 6 v_f w, the 21 (v_f
//      v_g) w with f <= g, each formed as the reference rounds it: the
//      coordinates' product, then by the weight; (v_g v_f) w has the same
//      bits) over the members, each column one chain of float32 adds from 0
//      in ascending row order (lane l of the cluster's first warp adds
//      column l), the order of the reference's sum;
//   2. forms the mean m_f / max(cnt, 1e-9) (correctly rounded), the
//      covariance fma(-(cnt mean_f), mean_g, M2_fg) and runs the four power
//      iterations of the reference's compiled loop (w = cov v: the first
//      product rounded, then fused multiply-adds in index order; v = w /
//      (sqrt(sum w_f w_f) + 1e-9): the squares rounded, added in index
//      order, the root and the division correctly rounded), then the
//      threshold: the products mean_f axis_f rounded and added in index
//      order;
//   3. projects each member, v . axis (the first product rounded, then
//      fused multiply-adds) minus the threshold, and partitions the members
//      stably into child 2s (projection <= 0) and 2s + 1 (> 0): the next
//      round's member rows and offsets, each child's members again in row
//      order.
// With kLast the kernel then sums w and v w over both children in the same
// order and writes each leaf's count and mean. Each step's arithmetic is
// that of the port's plain version (`bisect_round_reference`, today's
// composition of segment_sum, _fma, the power iteration, _sum and _dot),
// spelled out here with __fadd_rn, __fmul_rn, __fmaf_rn, __fdiv_rn.
//
// What bounds it on the card: neither bytes (a round reads and writes each
// 32-byte member row: 1.6 MB, 0.5 us at the main path's 24,576 rows) nor
// operations, but the chain of dependent adds of the largest cluster: each
// add waits for the one before (4 cycles), so a round takes at least 4
// cycles per member of its largest cluster (round 0: all 24,576, 50 us).
// The design gives the summing warp little to do but its adds. A warp that
// loads its own rows waits on memory at every step, even with 64 loads in
// flight (the card tracks a warp's outstanding loads on a few scoreboards,
// so an add waits on loads issued just before it), and one that also
// issues its own cp.async copies stalls its adds behind them. So S
// producer warps take the cluster's stages of 32 members in turn (producer
// p stages p, p + S, ...): each copies its stage's member rows a lap ahead
// into shared memory (cp.async, which no barrier waits for), forms each
// member's 28 moment columns into its slot of a ring in shared memory
// (kBisectSlot: a column's 32 rows together, padded so that the stores and
// the summing warp's 16-byte reads are free of bank conflicts), and
// signals the summing warp through a pair of named barriers per slot
// (full, empty); the summing warp reads stage k + 1 into registers before
// it adds stage k, with no branch between (one there held the adds up).
// The partition reads each member row four chunks of 32 members ahead of
// its ballots and writes whole 32-byte rows (half rows wrote slower), its
// members split among all the warps (each counts its segment's
// zero bits, then places its members after the zeros and ones of the
// warps before it). The first rounds (8 clusters or fewer) give each
// cluster a thread block cluster of 8 CTAs of 16 warps, so its partition
// draws on 8 SMs' bandwidth; the next ones (fewer than 128) a CTA of 16
// warps with 6 producers; the rest a CTA of 4 warps with 3 producers.
constexpr int kBisectM = 8;       // floats per member row: v, w, 0

// index of the moment (v_f v_g) w among a cluster's sums (not recursive,
// so an unrolled loop folds it to a constant)
__host__ __device__ constexpr int bisect_pair_col_le(int f, int g) {
  return 7 + f * 6 - f * (f - 1) / 2 + (g - f);   // f <= g
}
__host__ __device__ constexpr int bisect_pair_col(int f, int g) {
  return f <= g ? bisect_pair_col_le(f, g) : bisect_pair_col_le(g, f);
}

__global__ void bisect_rows_kernel(const float* __restrict__ vecs,
                                   const float* __restrict__ w,
                                   float* __restrict__ members,
                                   int* __restrict__ starts, int n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) {
    starts[0] = 0;
    starts[1] = n;
  }
  if (t >= (long long)n * kBisectM) return;
  const int i = (int)(t / kBisectM), m = (int)(t - (long long)i * kBisectM);
  members[t] = m < 6 ? vecs[(size_t)i * 6 + m] : (m == 6 ? w[i] : 0.f);
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A ring slot: stage k's 28 moment columns of its 32 members, column c of
// member r at c * kBisectCol + r (a column's 32 rows and 4 floats of
// padding, so both the producer's stores and the summing warp's 16-byte
// reads are free of bank conflicts).
constexpr int kBisectCol = 36;
constexpr int kBisectSlot = 32 * kBisectCol;

// The sums of the 28 moment columns over members 0 .. len - 1 of `mem`, each
// one chain of adds from 0 in member order: the first warp returns column
// `lane`'s sum (lanes 28-31 hold nothing of use), every other warp 0. Warps
// 1 .. S produce (see above): `ring` is S slots of kBisectSlot floats,
// `staging` S x 2 x 32 x 8. Slot p's barriers are 1 + p (full) and 1 + S + p
// (empty), for the first warp and producer p; each is used in balanced
// pairs, so the next call can use them again.
template <int S>
__device__ float bisect_sums(const float* mem, int len, float* ring,
                             float* staging, int warp, int lane) {
  const int n_st = (len + 31) >> 5;
  if (warp == 0) {
    float acc = 0.f;
    if (n_st == 0) return acc;
    auto fetch = [&](float (&v)[32], int k) {
      named_bar_sync(1 + k % S, 64);
      const float4* s4 = reinterpret_cast<const float4*>(
          ring + (k % S) * kBisectSlot + lane * kBisectCol);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 t = s4[q];
        v[4 * q] = t.x;
        v[4 * q + 1] = t.y;
        v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
      }
    };
    // the slot is free once its values are added; its producer waits for
    // that only where it has a stage for it
    auto release = [&](int k) {
      if (k + S < n_st) named_bar_arrive(1 + S + k % S, 64);
    };
    auto add = [&](const float (&v)[32], int rows) {
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (r < rows) acc = __fadd_rn(acc, v[r]);
    };
    auto add_all = [&](const float (&v)[32]) {
#pragma unroll
      for (int r = 0; r < 32; ++r) acc = __fadd_rn(acc, v[r]);
    };
    float x[32], y[32];
    fetch(x, 0);
    // whole stages, two at a time, with no branch between a stage's reads
    // and the adds after them
    int k = 0;
    for (; k + 2 < n_st; k += 2) {
      fetch(y, k + 1);
      add_all(x);
      release(k);
      fetch(x, k + 2);
      add_all(y);
      release(k + 1);
    }
    // the last one or two stages
    if (k + 1 < n_st) {
      fetch(y, k + 1);
      add_all(x);
      release(k);
      add(y, len - (k + 1) * 32);
    } else {
      add(x, len - k * 32);
    }
    return acc;
  }
  if (warp > S) return 0.f;
  // producer p: lane r forms member r's 28 columns of each of its stages
  const int p = warp - 1;
  float* col = ring + p * kBisectSlot + lane;
  // the member row of stage j into one of this producer's two staging
  // buffers, by cp.async (a barrier does not wait for it, as it would for
  // a load into registers); each lane reads back only its own row
  auto stage_row = [&](int j, int buf) {
    const int i = j * 32 + lane;
    if (j < n_st && i < len) {
      float* dst = staging + (2 * p + buf) * 256 + lane * 8;
      cp_async16(dst, mem + (size_t)i * kBisectM);
      cp_async16(dst + 4, mem + (size_t)i * kBisectM + 4);
    }
    cp_async_commit();
  };
  stage_row(p, 0);
  stage_row(p + S, 1);
  for (int j = p, t = 0; j < n_st; j += S, t ^= 1) {
    cp_async_wait<1>();
    const float4* st = reinterpret_cast<const float4*>(
        staging + (2 * p + t) * 256 + lane * 8);
    const float4 a = st[0], b = st[1];
    const float v[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
    const float w = b.z;
    if (j >= S) named_bar_sync(1 + S + p, 64);
    col[0] = w;
#pragma unroll
    for (int f = 0; f < 6; ++f) col[(1 + f) * kBisectCol] = __fmul_rn(v[f], w);
#pragma unroll
    for (int f = 0; f < 6; ++f)
#pragma unroll
      for (int g = f; g < 6; ++g)
        col[bisect_pair_col(f, g) * kBisectCol] =
            __fmul_rn(__fmul_rn(v[f], v[g]), w);
    named_bar_arrive(1 + p, 64);
    stage_row(j + 2 * S, t);
  }
  cp_async_wait<0>();
  return 0.f;
}

// axis[0..5] and axis[6] = the threshold, from the cluster's 28 moment sums
// m (m[0] the count, m[1 + f] the sums of v_f w, m[bisect_pair_col(f, g)]).
__device__ __forceinline__ void bisect_axis_of(const float (&m)[28],
                                               float (&axis)[7]) {
  const float cnt = m[0];
  const float den = fmaxf(cnt, 1e-9f);
  float mean[6];
#pragma unroll
  for (int f = 0; f < 6; ++f) mean[f] = __fdiv_rn(m[1 + f], den);
  float cov[36];
#pragma unroll
  for (int f = 0; f < 6; ++f)
#pragma unroll
    for (int g = 0; g < 6; ++g)
      cov[f * 6 + g] = __fmaf_rn(-__fmul_rn(cnt, mean[f]), mean[g],
                                 m[bisect_pair_col(f, g)]);
  float v[6] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    float wv[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      float acc = __fmul_rn(cov[f * 6], v[0]);
#pragma unroll
      for (int g = 1; g < 6; ++g) acc = __fmaf_rn(cov[f * 6 + g], v[g], acc);
      wv[f] = acc;
    }
    float s = __fmul_rn(wv[0], wv[0]);
#pragma unroll
    for (int f = 1; f < 6; ++f) s = __fadd_rn(s, __fmul_rn(wv[f], wv[f]));
    const float d = __fadd_rn(__fsqrt_rn(s), 1e-9f);
#pragma unroll
    for (int f = 0; f < 6; ++f) v[f] = __fdiv_rn(wv[f], d);
  }
  float thr = __fmul_rn(mean[0], v[0]);
#pragma unroll
  for (int f = 1; f < 6; ++f) thr = __fadd_rn(thr, __fmul_rn(mean[f], v[f]));
#pragma unroll
  for (int f = 0; f < 6; ++f) axis[f] = v[f];
  axis[6] = thr;
}

// whether a member with v (v0..v3 in a, v4..v5 in b.x, b.y) goes to child
// 2s + 1
__device__ __forceinline__ bool bisect_bit(float4 a, float4 b,
                                           const float (&axis)[7]) {
  float p = __fmul_rn(a.x, axis[0]);
  p = __fmaf_rn(a.y, axis[1], p);
  p = __fmaf_rn(a.z, axis[2], p);
  p = __fmaf_rn(a.w, axis[3], p);
  p = __fmaf_rn(b.x, axis[4], p);
  p = __fmaf_rn(b.y, axis[5], p);
  return __fsub_rn(p, axis[6]) > 0.f;
}

constexpr int kBisectBatch = 4;   // chunks of 32 members a partition step reads

// a barrier of the CTA, or with CS > 1 of the thread block cluster
template <int CS>
__device__ __forceinline__ void bisect_sync() {
  if constexpr (CS > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// p in rank r's shared memory (its own where CS is 1)
template <int CS, typename T>
__device__ __forceinline__ T* bisect_remote(T* p, int r) {
  if constexpr (CS > 1)
    return cg::this_cluster().map_shared_rank(p, r);
  else
    return p;
}

// One round: cluster s of the round is taken by CS CTAs of W warps (a
// thread block cluster where CS > 1), rank 0 of which sums and finds the
// axis; all CS x W warps partition.
template <int W, int S, int CS, bool kLast>
__global__ void __launch_bounds__(W * 32)
bisect_round_kernel(const float* __restrict__ in, float* out,
                    const int* __restrict__ starts, int* __restrict__ starts_out,
                    float* __restrict__ leaves, int n_c) {
  static_assert(W > S && 2 * S < 16, "a summing warp, S producers, 2S barriers");
  static_assert(W * 256 <= S * kBisectSlot, "the partition's rows fit the ring");
  static_assert(CS * W <= 32 * 8, "a lane sums at most 8 warps' counts");
  __shared__ __align__(16) float ring[S * kBisectSlot];
  __shared__ __align__(16) float staging[S * 512];
  __shared__ float s_axis[7];
  __shared__ int s_zeros[W];
  const int s = blockIdx.x / CS, rank = blockIdx.x % CS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  const int off = starts[s], len = starts[s + 1] - off;

  // 1-2: the moment sums, the axis and the threshold
  if (rank == 0) {
    const float sum = bisect_sums<S>(in + (size_t)off * kBisectM, len, ring,
                                     staging, warp, lane);
    if (warp == 0) {
      float m[28];
#pragma unroll
      for (int k = 0; k < 28; ++k) m[k] = __shfl_sync(full, sum, k);
      float ax[7];
      bisect_axis_of(m, ax);
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < 7; ++f) s_axis[f] = ax[f];
      }
    }
  }
  bisect_sync<CS>();
  float axis[7];
  const float* ax0 = bisect_remote<CS>(s_axis, 0);
#pragma unroll
  for (int f = 0; f < 7; ++f) axis[f] = ax0[f];

  // 3: the stable partition; warp gw of the CS x W takes members s0 .. s1 - 1
  const int gw = rank * W + warp;
  const int seg = (len + CS * W * 32 - 1) / (CS * W * 32) * 32;
  const int s0 = min(len, gw * seg), s1 = min(len, s0 + seg);
  const float4* src = reinterpret_cast<const float4*>(in + (size_t)off * kBisectM);
  constexpr int B = kBisectBatch;
  int zeros = 0;
  for (int b = s0; b < s1; b += 32 * B) {
    float4 va[B], vb[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = b + 32 * u + lane;
      if (i < s1) {
        va[u] = src[2 * i];
        vb[u] = src[2 * i + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const bool valid = b + 32 * u + lane < s1;
      const bool bit = valid && bisect_bit(va[u], vb[u], axis);
      zeros += __popc(__ballot_sync(full, valid && !bit));
    }
  }
  if (lane == 0) s_zeros[warp] = zeros;
  bisect_sync<CS>();
  // the zero bits of the warps before this one, and of all
  int before = 0, all = 0;
#pragma unroll
  for (int e = lane; e < CS * W; e += 32) {
    const int z = bisect_remote<CS>(s_zeros, e / W)[e % W];
    before += e < gw ? z : 0;
    all += z;
  }
  int zb = __reduce_add_sync(full, before);
  const int total = __reduce_add_sync(full, all);
  // no CTA of the cluster may leave while another reads its counts
  if constexpr (CS > 1) bisect_sync<CS>();
  int ob = s0 - zb;
  if (rank == 0 && threadIdx.x == 0) {
    starts_out[2 * s] = off;
    starts_out[2 * s + 1] = off + total;
    if (s == n_c - 1) starts_out[2 * n_c] = off + len;
  }
  const unsigned lt = (1u << lane) - 1u;
  float4* dst = reinterpret_cast<float4*>(out + (size_t)off * kBisectM);
  // a chunk's members are placed in this warp's 32 rows of the (now idle)
  // ring, its zeros then its ones, and written from there two lanes a row,
  // so each 32-byte row is one store
  float4* wst = reinterpret_cast<float4*>(ring) + warp * 64;
  for (int b = s0; b < s1; b += 32 * B) {
    float4 va[B], vb[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = b + 32 * u + lane;
      if (i < s1) {
        va[u] = src[2 * i];
        vb[u] = src[2 * i + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const bool valid = b + 32 * u + lane < s1;
      const bool bit = valid && bisect_bit(va[u], vb[u], axis);
      const unsigned m0 = __ballot_sync(full, valid && !bit);
      const unsigned m1 = __ballot_sync(full, bit);
      const int nz = __popc(m0), no = __popc(m1);
      if (valid) {
        const int i = bit ? nz + __popc(m1 & lt) : __popc(m0 & lt);
        wst[2 * i] = va[u];
        wst[2 * i + 1] = vb[u];
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = h * 16 + (lane >> 1);
        if (i < nz + no) {
          const int to = i < nz ? zb + i : total + ob + (i - nz);
          dst[2 * to + (lane & 1)] = wst[2 * i + (lane & 1)];
        }
      }
      __syncwarp();
      zb += nz;
      ob += no;
    }
  }

  // the leaves: both children's count and mean (after the last round)
  if (kLast) {
    bisect_sync<CS>();
    if (rank == 0) {
      const float* kids = out + (size_t)off * kBisectM;
#pragma unroll
      for (int child = 0; child < 2; ++child) {
        const float sum_c = bisect_sums<S>(
            kids + (child ? (size_t)total * kBisectM : 0),
            child ? len - total : total, ring, staging, warp, lane);
        if (warp == 0) {
          const float cnt = __shfl_sync(full, sum_c, 0);
          if (lane < 7)
            leaves[(size_t)(2 * s + child) * 7 + lane] =
                lane == 0 ? sum_c : __fdiv_rn(sum_c, fmaxf(cnt, 1e-9f));
        }
        __syncthreads();
      }
    }
  }
}

template <int W, int S, int CS>
cudaError_t launch_bisect_round(const float* in, float* out, const int* starts,
                                int* starts_out, float* leaves, int n_c,
                                cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_c * CS);
  cfg.blockDim = dim3(W * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  return leaves ? cudaLaunchKernelEx(&cfg, bisect_round_kernel<W, S, CS, true>,
                                     in, out, starts, starts_out, leaves, n_c)
                : cudaLaunchKernelEx(&cfg, bisect_round_kernel<W, S, CS, false>,
                                     in, out, starts, starts_out, leaves, n_c);
}

// ---------------------------------------------------------------------------
// min_k_kernel: the refine's shortlist in XLA-CPU's tie order.
//
// The columns of each row's k smallest distances in the order the
// reference's `approx_min_k` gives them on the CPU (the first k of
// libstdc++'s `std::sort` of the row's (value, column) pairs by value):
// xla_cpu_sort.h's `sort_first_k`, whose sequential form the host library
// runs (host_sort.cpp, the plain version). It replaces no Pallas kernel: in
// the reference it is XLA's ApproxTopK on the distances of `d6`
// (basis_universal_tpu/ops/etc1s_encode.py:457).
//
// Equal values order as the introsort leaves them, which depends on the
// whole row, so every step of the sort is kept. One warp sorts one row. The
// introsort's control flow (`xla_cpu_sort::introsort_first_k`: the parts,
// the depth limit, the pruning past k) runs alike in every lane; lane 0 the
// median of three and the heap fallback, short and rare; the whole warp
// each Hoare partition (`warp_partition`, most of the work) and the final
// insertion sort, as each entry's stable rank (`warp_stable_first_k`).
// xla_cpu_sort.h's `sort_first_k_pairs` is this algorithm sequentially
// (host mode "pairs", held to std::sort by the CPU tests).
//
// Bound at the main path's shape: the sort reads its 237 MB once (71 us at
// 3.35 TB/s), and its compares are ~2n a row (the partitions' visits). It
// is latency-bound: each partition is a chain of shared-memory reads,
// ballots, shuffles and counts, so the more rows an SM holds, the better
// their chains overlap. So a row takes little shared memory: values as
// float, columns and swap pairs as 16 bits (n <= kMinKSmemN), each 32-entry
// chunk's stops as two masks (19.9 KB a row at n 2,416); the CTA is sized
// from the SM's shared memory and registers (`make_min_k_plan`: the fewest
// warps that come within 10% of the most rows per SM, since a CTA holds its
// memory until its slowest row is done; made once per device and n); a
// partition reads the values once and works from the masks after that
// (`warp_partition`). Computing the distances in the kernel instead of
// reading them was slower on the H100: the staged codebook (68 KB at n
// 2,416) leaves room for 9 rows per SM instead of 11 (PERF.md).
// One thread per row, the first form of this kernel, took 7.06 ms on the
// H100 at 24,576 x 2,416, and a warp per row with (value, column) pairs
// in 24 KB of shared memory, four reads of the values per partition and
// lane 0's insertion sort 0.82-0.93 (PERF.md).
constexpr int kMinKSmemN = 8192;     // longest row sorted in shared memory
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }

__host__ __device__ inline int min_k_chunks(int n) { return (n + 31) / 32; }

// A row's buffers: its values, then (the "aux" part) its columns, a
// partition's swap pairs (L_t, R_t as two positions; a partition of m
// entries swaps at most m / 2) and its chunks' masks, each 16-byte aligned;
// positions of type Idx.
__host__ __device__ inline size_t min_k_val_bytes(int n) {
  return round16((size_t)n * 4);
}

template <class Idx>
__host__ __device__ inline size_t min_k_pair_bytes(int n) {
  return round16((size_t)(n / 2 + 1) * 2 * sizeof(Idx));
}

template <class Idx>
__host__ __device__ inline size_t min_k_aux_bytes(int n) {
  return round16((size_t)n * sizeof(Idx)) + min_k_pair_bytes<Idx>(n)
         + round16((size_t)min_k_chunks(n) * 8);
}

template <class Idx>
struct WarpRow {
  float* v;        // values
  Idx* c;          // columns
  Idx* pairs;      // L_0, R_0, L_1, R_1, ... of a partition
  uint32_t* ge;    // per chunk: the left stops, !(v < p)
  uint32_t* le;    // per chunk: the right stops, !(p < v)

  __device__ static WarpRow at(float* v, unsigned char* aux, int n) {
    WarpRow w;
    w.v = v;
    w.c = (Idx*)aux;
    w.pairs = (Idx*)(aux + round16((size_t)n * sizeof(Idx)));
    w.ge = (uint32_t*)((unsigned char*)w.pairs + min_k_pair_bytes<Idx>(n));
    w.le = w.ge + min_k_chunks(n);
    return w;
  }
};

// a partition's t-th swap pair (L_t, R_t), as one load
__device__ __forceinline__ void load_pair(const uint16_t* pairs, int t,
                                          int& x, int& y) {
  const uint32_t xy = reinterpret_cast<const uint32_t*>(pairs)[t];
  x = (int)(xy & 0xffffu);
  y = (int)(xy >> 16);
}

__device__ __forceinline__ void load_pair(const int* pairs, int t, int& x,
                                          int& y) {
  const int2 xy = reinterpret_cast<const int2*>(pairs)[t];
  x = xy.x;
  y = xy.y;
}

// bits of a mask at or below bit b
__device__ __forceinline__ unsigned upto(int b) { return (2u << b) - 1u; }

// The t-th left stop at bit b of a chunk (n_ge, n_le: the stops before the
// chunk) lies at or right of R_t: no more than t right stops right of it.
__device__ __forceinline__ bool pair_fails(int total_le, int n_ge, int n_le,
                                           unsigned gm, unsigned lm, int b) {
  const int t = n_ge + __popc(gm & (upto(b) >> 1));
  return total_le - (n_le + __popc(lm & upto(b))) < t + 1;
}

// Inclusive prefix sums of x over the warp's lanes.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// The first t_star stops of `mask` (one word per 32-entry chunk from lo),
// counted from the left, or from the right (kFromRight), into out[0],
// out[2], ...: lane j counts chunk j of a group of 32 chunks, a
// scan gives each chunk's first rank, then the group's chunks that hold
// ranks below t_star are taken one after another, the lanes as the chunk's
// 32 bits (no step waits on the one before).
template <bool kFromRight, class Idx>
__device__ __forceinline__ void list_stops(const uint32_t* __restrict__ mask,
                                           Idx* __restrict__ out, int lo,
                                           int n_chunks, int t_star,
                                           int lane) {
  const unsigned side = kFromRight ? ~upto(lane) : (1u << lane) - 1u;
  int done = 0;
  for (int g = 0; g < n_chunks && done < t_star; g += 32) {
    const int c = kFromRight ? n_chunks - 1 - g - lane : g + lane;
    const unsigned mine = c >= 0 && c < n_chunks ? mask[c] : 0u;
    const int incl = warp_scan(__popc(mine), lane);
    const int start = done + incl - __popc(mine);
    const int used = 32 - __clz(__ballot_sync(kFull, start < t_star && mine));
#pragma unroll 4
    for (int j = 0; j < used; ++j) {
      const unsigned m = __shfl_sync(kFull, mine, j);
      const int s = __shfl_sync(kFull, start, j) + __popc(m & side);
      if (((m >> lane) & 1u) && s < t_star)
        out[2 * s] = (Idx)(lo + ((kFromRight ? n_chunks - 1 - g - j : g + j)
                                 << 5) + lane);
    }
    done += __shfl_sync(kFull, incl, 31);
  }
}

// libstdc++'s __unguarded_partition(lo, hi, pivot lo - 1) by one warp, as
// its swap pairs (xla_cpu_sort::pair_partition, whose comment gives the
// steps); returns the cut, and leaves every entry where the sequential loop
// leaves it. The steps take the chunks 32 at a time, a chunk per lane for
// the counts; (A) reads the values eight chunks at a time, (C) lists the
// pairs (`list_stops`) and (D) swaps them by rank, 32 a round, the reads of
// four rounds before their writes (the pairs are disjoint), so a warp's
// shared-memory reads go out back to back.
template <class Idx>
__device__ int warp_partition(float* __restrict__ v, Idx* __restrict__ cc,
                              Idx* __restrict__ pairs,
                              uint32_t* __restrict__ ge,
                              uint32_t* __restrict__ le, int lo, int hi,
                              int lane) {
  const float p = v[lo - 1];
  const int n_chunks = (hi - lo + 31) >> 5;
  // (A) one read of the values: each chunk's stops as masks, lane j keeping
  // those of chunk c0 + j; eight chunks' reads before their ballots
  int total_le = 0;
  for (int c0 = 0; c0 < n_chunks; c0 += 32) {
    const int nc = min(32, n_chunks - c0);
    unsigned my_g = 0, my_l = 0;
    for (int j0 = 0; j0 < nc; j0 += 8) {
      float val[8];
      bool in[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int x = lo + ((c0 + j0 + u) << 5) + lane;
        in[u] = j0 + u < nc && x < hi;
        val[u] = in[u] ? v[x] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const unsigned gm = __ballot_sync(kFull, in[u] && !(val[u] < p));
        const unsigned lm = __ballot_sync(kFull, in[u] && !(p < val[u]));
        if (lane == j0 + u) {
          my_g = gm;
          my_l = lm;
        }
        total_le += __popc(lm);
      }
    }
    if (lane < nc) {
      ge[c0 + lane] = my_g;
      le[c0 + lane] = my_l;
    }
  }
  __syncwarp();
  // (B) t* and L_t*: the first chunk whose last left stop fails, then the
  // first failing left stop in it
  int n_ge = 0, n_le = 0, t_star = -1, l_star = hi;
  for (int c0 = 0; c0 < n_chunks; c0 += 32) {
    const int c = c0 + lane;
    const unsigned gm = c < n_chunks ? ge[c] : 0u;
    const unsigned lm = c < n_chunks ? le[c] : 0u;
    const int gx = warp_scan(__popc(gm), lane);
    const int lx = warp_scan(__popc(lm), lane);
    const int ge0 = n_ge + gx - __popc(gm), le0 = n_le + lx - __popc(lm);
    const unsigned fails = __ballot_sync(
        kFull, gm && pair_fails(total_le, ge0, le0, gm, lm, 31 - __clz(gm)));
    if (fails) {
      const int f = __ffs(fails) - 1;
      const unsigned fgm = __shfl_sync(kFull, gm, f);
      const unsigned flm = __shfl_sync(kFull, lm, f);
      const int fge = __shfl_sync(kFull, ge0, f);
      const int fle = __shfl_sync(kFull, le0, f);
      const unsigned bits = __ballot_sync(
          kFull, ((fgm >> lane) & 1u)
                     && pair_fails(total_le, fge, fle, fgm, flm, lane));
      const int b = __ffs(bits) - 1;
      t_star = fge + __popc(fgm & ((1u << b) - 1u));
      l_star = lo + ((c0 + f) << 5) + b;
      break;
    }
    n_ge += __shfl_sync(kFull, gx, 31);
    n_le += __shfl_sync(kFull, lx, 31);
  }
  if (t_star < 0) t_star = n_ge;
  // (C) L_0 .. L_t*-1 from the left, R_0 .. R_t*-1 from the right
  list_stops<false>(ge, pairs, lo, n_chunks, t_star, lane);
  list_stops<true>(le, pairs + 1, lo, n_chunks, t_star, lane);
  __syncwarp();
  int cut = l_star;
  if (t_star > 0 && (int)pairs[2 * t_star - 1] < cut)
    cut = pairs[2 * t_star - 1];
  // (D) L_t swapped with R_t for every t < t*, 32 pairs a round, the reads
  // of four rounds before their writes
  for (int t0 = 0; t0 < t_star; t0 += 128) {
    int x[4], y[4];
    float vx[4], vy[4];
    Idx cx[4], cy[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + (u << 5) + lane;
      x[u] = -1;
      if (t < t_star) {
        load_pair(pairs, t, x[u], y[u]);
        vx[u] = v[x[u]];
        vy[u] = v[y[u]];
        cx[u] = cc[x[u]];
        cy[u] = cc[y[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (x[u] >= 0) {
        v[x[u]] = vy[u];
        v[y[u]] = vx[u];
        cc[x[u]] = cy[u];
        cc[y[u]] = cx[u];
      }
    }
  }
  __syncwarp();
  return cut;
}

// The columns of the first k entries of the stable sort of [0, limit) by
// value, which the final insertion sort leaves there
// (xla_cpu_sort::stable_first_k): lane l ranks entry base + l against every
// entry (a broadcast read each) until all 32 ranks reach k, and the chunks
// stop once k columns are out. limit is ~k + 16 but where the heap fallback
// ran; any limit works.
template <class Idx>
__device__ void warp_stable_first_k(const WarpRow<Idx>& w, int limit, int k,
                                    int64_t* out, int lane) {
  int found = 0;
  for (int base = 0; base < limit && found < k; base += 32) {
    const int i = base + lane;
    const bool in = i < limit;
    const float v = in ? w.v[i] : 0.f;
    int rank = in ? 0 : k;
    for (int j0 = 0; j0 < limit; j0 += 32) {
      const int jn = min(32, limit - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float u = w.v[j0 + jj];
        rank += (u < v) | ((u == v) & (j0 + jj < i));
      }
      if (__all_sync(kFull, rank >= k)) break;
    }
    if (rank < k) out[rank] = w.c[i];
    found += __popc(__ballot_sync(kFull, rank < k));
  }
}

// The introsort's steps as the warp takes them (xla_cpu_sort::SeqSteps on
// the host)
template <class Idx>
struct WarpSteps {
  WarpRow<Idx> w;
  int lane;
  __host__ __device__ void heap(int first, int last) {
#ifdef __CUDA_ARCH__
    if (lane == 0)
      xla_cpu_sort::heap_sort(xla_cpu_sort::SoaRow<Idx>{w.v, w.c}, first,
                              last);
    __syncwarp();
#endif
  }
  __host__ __device__ void median(int first, int last) {
#ifdef __CUDA_ARCH__
    // lanes 0-2 read the three candidates at once
    const int a = first + 1, b = first + (last - first) / 2, c = last - 1;
    const float val = w.v[lane == 0 ? a : lane == 1 ? b : c];
    const int m = (int)xla_cpu_sort::median_pick(
        __shfl_sync(kFull, val, 0), __shfl_sync(kFull, val, 1),
        __shfl_sync(kFull, val, 2), a, b, c);
    if (lane == 0)
      xla_cpu_sort::iter_swap(xla_cpu_sort::SoaRow<Idx>{w.v, w.c}, first, m);
    __syncwarp();
#endif
  }
  __host__ __device__ int partition(int first, int last) {
#ifdef __CUDA_ARCH__
    return warp_partition(w.v, w.c, w.pairs, w.ge, w.le, first + 1, last,
                          lane);
#else
    return 0;
#endif
  }
};

// Sorts the row (values and columns in place) and writes its first k
// columns. stage < 2 stops early, for measurement only: 0 after the load,
// 1 after the partitions (the first k columns as they stand then).
template <class Idx>
__device__ void min_k_sort_row(const WarpRow<Idx>& w, int n, int k, int cap,
                               int stage, int64_t* out, int lane) {
  int limit = k;
  if (stage >= 1) {
    WarpSteps<Idx> steps{w, lane};
    limit = xla_cpu_sort::introsort_first_k<int>(n, k, cap, steps);
  }
  if (stage >= 2) {
    warp_stable_first_k(w, limit, k, out, lane);
  } else {
    for (int j = lane; j < k; j += 32) out[j] = w.c[j];
  }
}

template <class Idx>
__device__ void min_k_columns(Idx* c, int n, int lane) {
  for (int i = lane; i < n; i += 32) c[i] = (Idx)i;
}

// xla_cpu_min_k: rows from device memory. kShared: the CTA's warps' rows in
// shared memory (all values, then all aux parts); else each row's buffers
// in the caller's global scratch (min_k_val_bytes + min_k_aux_bytes<int>
// per row).
template <bool kShared>
__global__ void min_k_kernel(const float* __restrict__ d,
                             unsigned char* scratch, int64_t* __restrict__ out,
                             int rows, int n, int k, int cap, int stage) {
  extern __shared__ __align__(16) unsigned char min_k_smem[];
  using Idx = typename std::conditional<kShared, uint16_t, int>::type;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int r = blockIdx.x * warps + warp;
  if (r >= rows) return;  // the whole warp
  float* v;
  unsigned char* aux;
  if (kShared) {
    v = (float*)(min_k_smem + warp * min_k_val_bytes(n));
    aux = min_k_smem + warps * min_k_val_bytes(n)
          + warp * min_k_aux_bytes<Idx>(n);
  } else {
    v = (float*)(scratch
                 + (size_t)r * (min_k_val_bytes(n) + min_k_aux_bytes<Idx>(n)));
    aux = (unsigned char*)v + min_k_val_bytes(n);
  }
  const WarpRow<Idx> w = WarpRow<Idx>::at(v, aux, n);
  const float* src = d + (size_t)r * n;
  if ((((uintptr_t)src) & 15) == 0) {
    const int n4 = n >> 2;
#pragma unroll 8
    for (int i = lane; i < n4; i += 32)
      reinterpret_cast<float4*>(v)[i] = __ldcs(
          reinterpret_cast<const float4*>(src) + i);
    for (int i = 4 * n4 + lane; i < n; i += 32) v[i] = __ldcs(src + i);
  } else {
#pragma unroll 8
    for (int i = lane; i < n; i += 32) v[i] = __ldcs(src + i);
  }
  min_k_columns(w.c, n, lane);
  __syncwarp();
  min_k_sort_row(w, n, k, cap, stage, out + (size_t)r * k, lane);
}

// How min_k_kernel<true> is launched for rows of n: warps per CTA and
// bytes of dynamic shared memory (0 warps where no row fits).
struct MinKPlan {
  int warps, smem;
};

// The fewest warps per CTA whose rows per SM come within 10% of the most (a
// CTA holds its memory until its slowest row is done), from the device's
// shared memory and the kernel's registers.
inline MinKPlan make_min_k_plan(int dev, int n) {
  int per_sm = 0, per_block = 0, reserved = 0;
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                         dev);
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, min_k_kernel<true>) != cudaSuccess)
    return MinKPlan{0, 0};
  const int max_warps = min(32, attr.maxThreadsPerBlock / 32);
  const int regs = max(attr.numRegs, 1);
  const size_t per_warp = min_k_val_bytes(n) + min_k_aux_bytes<uint16_t>(n);
  auto fits = [&](int w) {
    return w <= max_warps && w * per_warp <= (size_t)per_block;
  };
  auto resident = [&](int w) {
    const int by_smem = (int)(per_sm / (w * per_warp + reserved));
    const int by_regs = 65536 / (regs * 32 * w);
    return min(min(by_smem, by_regs), min(32, 64 / w)) * w;
  };
  int most = 0;
  for (int w = 1; fits(w); ++w) most = max(most, resident(w));
  for (int w = 1; fits(w); ++w)
    if (10 * resident(w) >= 9 * most) return MinKPlan{w, (int)(w * per_warp)};
  return MinKPlan{0, 0};
}

// The plan for rows of n on the current device, made once per (device, n),
// with the kernel's shared-memory attributes set where it needs more than
// the device's plans before it (the limit only rises, so each of them stays
// valid).
inline cudaError_t min_k_plan(int n, MinKPlan* plan) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, MinKPlan> plans;
  static std::map<int, int> smem_set;  // per device, the limit set so far
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  const auto found = plans.find({dev, n});
  if (found != plans.end()) {
    *plan = found->second;
    return cudaSuccess;
  }
  const MinKPlan p = make_min_k_plan(dev, n);
  const auto set = smem_set.find(dev);
  if (p.warps > 0 && (set == smem_set.end() || p.smem > set->second)) {
    e = cudaFuncSetAttribute(min_k_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(min_k_kernel<true>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set[dev] = p.smem;
  }
  plans[{dev, n}] = p;
  *plan = p;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// lb: null, or (n_blocks, D) gray-axis levels of the perceptual cluster
// scan (each block's cluster's), used in place of its own base's.
int etc1s_factorized_scan(const float* pixels, const float* base5,
                          const float* lb, float* out, int n_blocks,
                          int radius, int perceptual, void* stream) {
  if (n_blocks <= 0) return (int)cudaSuccess;
  return launch_fscan_radius<false>(pixels, base5, lb, out, nullptr,
                                    n_blocks, radius, perceptual, 0,
                                    (cudaStream_t)stream);
}

int etc1s_factorized_scan_shortlist(const float* pixels, const float* base5,
                                    int64_t* out, int n_blocks, int radius,
                                    int perceptual, int k, void* stream) {
  if (n_blocks <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 16 || (radius == 0 && k > 8))
    return (int)cudaErrorInvalidValue;
  return launch_fscan_radius<true>(pixels, base5, nullptr, nullptr, out,
                                   n_blocks, radius, perceptual, k,
                                   (cudaStream_t)stream);
}

int etc1s_palette_errs_packed(const float* pixels, const int32_t* packed,
                              float* out, int n_blocks, int n_cand,
                              int perceptual, void* stream) {
  if (n_blocks <= 0 || n_cand <= 0) return (int)cudaSuccess;
  if (n_cand > kRescoreThreads) return (int)cudaErrorInvalidValue;
  const int rows = max(1, min(kRescoreMaxRows, kRescoreThreads / n_cand));
  const dim3 block(n_cand, rows);
  const dim3 grid((n_blocks + rows - 1) / rows);
  cudaStream_t s = (cudaStream_t)stream;
  if (perceptual)
    rescore_kernel<true><<<grid, block, 0, s>>>(pixels, packed, out, n_blocks, n_cand);
  else
    rescore_kernel<false><<<grid, block, 0, s>>>(pixels, packed, out, n_blocks, n_cand);
  return (int)cudaGetLastError();
}

int etc1s_palette_errs(const float* pixels, const float* palettes, float* out,
                       int n_blocks, int n_cand, void* stream) {
  const long long total = (long long)n_blocks * n_cand;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned grid = (unsigned)((total + threads - 1) / threads);
  errs_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(pixels, palettes, out,
                                                          n_blocks, n_cand);
  return (int)cudaGetLastError();
}

int etc1s_find_best_selector_patterns(const float* dists,
                                      const int32_t* patterns, int32_t* best,
                                      float* best_err, int n_blocks,
                                      int n_patterns, void* stream) {
  if (n_blocks <= 0) return (int)cudaSuccess;
  const cudaError_t e = selbest_attrs();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_blocks + kSelRows - 1) / kSelRows);
  selbest_wgmma_kernel<<<grid, kSelThreads, kSelSmem, (cudaStream_t)stream>>>(
      dists, patterns, best, best_err, n_blocks, n_patterns);
  return (int)cudaGetLastError();
}

// a (n, 6), c (n_c, 6) float32; out (n,) int64. The centroids' squared
// norms and, at kCross6Bf16Clusters or more, the bf16 operands are the
// kernel's own.
int etc1s_cross6_argmin(const float* a, const float* c, int64_t* out, int n,
                        int n_c, void* stream) {
  const cudaError_t e = cross6_argmin_attrs();
  if (e != cudaSuccess) return (int)e;
  return launch_cross6_argmin(a, c, out, n, n_c, (cudaStream_t)stream);
}

// a (n, 6), c (n_c, 6) float32; out (n, n_c) float32.
int etc1s_cross6_distances(const float* a, const float* c, float* out, int n,
                           int n_c, void* stream) {
  return launch_cross6_distances(a, c, out, n, n_c, (cudaStream_t)stream);
}

// The cluster scan (launch_cluster_scan_assemble): mt (n_b, n_d * 8),
// order (n_b,) and offsets (n_c + 1,) int64, base8 (n_d, n_c, 3); px
// (n_b, 16, 3) without the perceptual metric, else sum_x (n_b, 3), sum_x2,
// sum_l, sum_l2 (n_b,) and lb (n_d, n_c); out (n_c, n_d * 8) float32.
int etc1s_cluster_scan_assemble(const float* mt, const int64_t* order,
                                const int64_t* offsets, const float* px,
                                const float* sum_x, const float* sum_x2,
                                const float* sum_l, const float* sum_l2,
                                const float* base8, const float* lb,
                                float* out, int n_c, int n_d, void* stream) {
  return launch_cluster_scan_assemble(mt, order, offsets, px, sum_x, sum_x2,
                                      sum_l, sum_l2, base8, lb, out, n_c, n_d,
                                      (cudaStream_t)stream);
}

// members: (n, kBisectM) float32 out (v, w, 0); starts: 2 int32 out (0, n).
int etc1s_bisect_rows(const float* vecs, const float* w, float* members,
                      int* starts, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * kBisectM;
  const int threads = 256;
  bisect_rows_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                       (cudaStream_t)stream>>>(vecs, w, members, starts, n);
  return (int)cudaGetLastError();
}

// One bisecting round over n_c clusters: in / out (n, kBisectM) member
// rows, starts (n_c + 1) and starts_out (2 n_c + 1) int32 offsets, leaves
// null or (2 n_c, 7) float32 (count, mean) of the children.
int etc1s_bisect_round(const float* in, float* out, const int* starts,
                       int* starts_out, float* leaves, int n_c, void* stream) {
  if (n_c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the few large clusters of the first rounds: a cluster of 8 CTAs each,
  // which spreads the partition's traffic over 8 SMs
  if (n_c <= 8)
    return (int)launch_bisect_round<16, 6, 8>(in, out, starts, starts_out,
                                              leaves, n_c, s);
  if (n_c < 128)
    return (int)launch_bisect_round<16, 6, 1>(in, out, starts, starts_out,
                                              leaves, n_c, s);
  return (int)launch_bisect_round<4, 3, 1>(in, out, starts, starts_out, leaves,
                                           n_c, s);
}

// out: (rows, k) int64. scratch: for rows longer than kMinKSmemN,
// etc1s_min_k_scratch_bytes(n) bytes per row, else unused. cap: the depth
// limit (xla_cpu_sort::depth_limit; -1 for libstdc++'s). stage: 2, or for
// measurement 0 / 1 (min_k_sort_row).
int etc1s_xla_cpu_min_k(const float* d, void* scratch, int64_t* out, int rows,
                        int n, int k, int cap, int stage, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (n < 1 || k < 1 || k > n || cap < -1 || cap > 62 || stage < 0 ||
      stage > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= kMinKSmemN) {
    MinKPlan p;
    const cudaError_t e = min_k_plan(n, &p);
    if (e != cudaSuccess) return (int)e;
    if (p.warps == 0) return (int)cudaErrorInvalidValue;
    min_k_kernel<true><<<(rows + p.warps - 1) / p.warps, 32 * p.warps,
                         p.smem, s>>>(d, nullptr, out, rows, n, k, cap, stage);
  } else {
    if (!scratch) return (int)cudaErrorInvalidValue;
    min_k_kernel<false><<<(rows + 3) / 4, 128, 0, s>>>(
        d, (unsigned char*)scratch, out, rows, n, k, cap, stage);
  }
  return (int)cudaGetLastError();
}

long long etc1s_min_k_scratch_bytes(int n) {
  return (long long)(min_k_val_bytes(n) + min_k_aux_bytes<int>(n));
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels of the ETC1S encoder.
//
// Each kernel replaces one Pallas kernel of basis_universal_tpu/ops/
// pallas_etc1s.py (all four are here) and computes the same function with
// the same float32 operation order per element; the plain PyTorch versions
// live beside the wrappers in basis_universal_tpu_torch/ops/cuda_etc1s.py.
//
// Every launcher takes raw device pointers, sizes and a cudaStream_t (the
// caller's current PyTorch stream), launches asynchronously, allocates and
// synchronises nothing, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
#define SQRT3 1.73205078f
#define THIRD 0.333333343f
#define C31_255 0.121568628f

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
// factorized_scan: unclipped ETC1S error of every block against D candidate
// base colours x 8 intensity tables,
//     err = q - su2/3 + 3 * sum_i min_k (t_k - u_i)^2 .
// One thread per (block, delta): threadIdx.x walks blocks, blockIdx.y picks
// the delta, so a warp reads one delta from constant memory (broadcast) and
// stores 8 rows of the (D*8, B) output at 32 neighbouring addresses.
// ---------------------------------------------------------------------------
template <bool kExternalBase, bool kPerceptual>
__global__ void fscan_kernel(const float* __restrict__ pixels,
                             const float* __restrict__ base5,
                             float* __restrict__ out, int n_blocks,
                             int radius) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int d = blockIdx.y;
  if (b >= n_blocks) return;

  const float* px = pixels + (size_t)b * 48;
  float x0[16], x1[16], x2[16];
  float sr = 0.f, sg = 0.f, sb = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float r = __ldg(px + i * 3 + 0);
    const float g = __ldg(px + i * 3 + 1);
    const float bl = __ldg(px + i * 3 + 2);
    sr += r; sg += g; sb += bl;
    if (kPerceptual) {
      x0[i] = P00 * r + P01 * g + P02 * bl;
      x1[i] = P10 * r + P11 * g + P12 * bl;
      x2[i] = P20 * r + P21 * g + P22 * bl;
    } else {
      x0[i] = r; x1[i] = g; x2[i] = bl;
    }
  }
  float luma[16];
  float sum_l = 0.f, sum_l2 = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sum_x2 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    luma[i] = kPerceptual ? SQRT3 * x0[i] : x0[i] + x1[i] + x2[i];
    sum_l += luma[i];
    sum_l2 += luma[i] * luma[i];
    s0 += x0[i]; s1 += x1[i]; s2 += x2[i];
    sum_x2 += x0[i] * x0[i] + x1[i] * x1[i] + x2[i] * x2[i];
  }

  float b5r, b5g, b5b;
  if (kExternalBase) {
    b5r = base5[(size_t)b * 3 + 0];
    b5g = base5[(size_t)b * 3 + 1];
    b5b = base5[(size_t)b * 3 + 2];
  } else {
    b5r = clip31(rintf(sr / 16.f * C31_255));
    b5g = clip31(rintf(sg / 16.f * C31_255));
    b5b = clip31(rintf(sb / 16.f * C31_255));
  }

  int dr, dg, db;
  if (radius == 0) {
    dr = dg = db = 0;
  } else if (radius == 1) {
    dr = kDeltasR1[d][0]; dg = kDeltasR1[d][1]; db = kDeltasR1[d][2];
  } else {
    dr = kDeltasR2[d][0]; dg = kDeltasR2[d][1]; db = kDeltasR2[d][2];
  }
  const float c5r = clip31(b5r + (float)dr);
  const float c5g = clip31(b5g + (float)dg);
  const float c5b = clip31(b5b + (float)db);
  const float b8r = expand5f(c5r), b8g = expand5f(c5g), b8b = expand5f(c5b);
  float e0, e1, e2, lb;
  if (kPerceptual) {
    e0 = P00 * b8r + P01 * b8g + P02 * b8b;
    e1 = P10 * b8r + P11 * b8g + P12 * b8b;
    e2 = P20 * b8r + P21 * b8g + P22 * b8b;
    lb = SQRT3 * e0;
  } else {
    e0 = b8r; e1 = b8g; e2 = b8b;
    lb = b8r + b8g + b8b;
  }
  const float q = sum_x2 - 2.f * (e0 * s0 + e1 * s1 + e2 * s2) +
                  16.f * (e0 * e0 + e1 * e1 + e2 * e2);
  const float su2 = sum_l2 - 2.f * lb * sum_l + 16.f * lb * lb;
  const float cst = q - su2 * THIRD;

  float acc[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) acc[t] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float u = (luma[i] - lb) * THIRD;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int k = (u > kMids[t][0]) + (u > kMids[t][1]) + (u > kMids[t][2]);
      const float tk = k == 0 ? kTabs[t][0]
                     : (k == 1 ? kTabs[t][1] : (k == 2 ? kTabs[t][2] : kTabs[t][3]));
      const float dv = tk - u;
      acc[t] = acc[t] + dv * dv;
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
    out[(size_t)(d * 8 + t) * n_blocks + b] = cst + 3.f * acc[t];
}

// ---------------------------------------------------------------------------
// palette_errs_packed: exact gamut-clipped error of each block against K
// packed candidates r5 | g5<<5 | b5<<10 | inten<<15,
//     err[b,k] = sum_i min_sel || x_i - clip(expand5(c5) + t_sel) ||^2 .
// One thread per (block, candidate); the palette is built in registers.
// ---------------------------------------------------------------------------
template <bool kPerceptual>
__global__ void rescore_kernel(const float* __restrict__ pixels,
                               const int32_t* __restrict__ packed,
                               float* __restrict__ out, int n_blocks,
                               int n_cand) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)n_blocks * n_cand) return;
  const int b = (int)(gid / n_cand);
  const int v = packed[gid];
  const float r5 = (float)(v & 31);
  const float g5 = (float)((v >> 5) & 31);
  const float b5 = (float)((v >> 10) & 31);
  const int tt = (v >> 15) & 7;
  const float b8r = expand5f(r5), b8g = expand5f(g5), b8b = expand5f(b5);
  float pr[4], pg[4], pb[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float tsel = kTabs[tt][s];
    pr[s] = clip255(b8r + tsel);
    pg[s] = clip255(b8g + tsel);
    pb[s] = clip255(b8b + tsel);
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
      const float dr = r - pr[s], dg = g - pg[s], db = bl - pb[s];
      float dist;
      if (kPerceptual) {
        const float d0 = P00 * dr + P01 * dg + P02 * db;
        const float d1 = P10 * dr + P11 * dg + P12 * db;
        const float d2 = P20 * dr + P21 * dg + P22 * db;
        dist = d0 * d0 + d1 * d1 + d2 * d2;
      } else {
        dist = dr * dr + dg * dg + db * db;
      }
      best = s == 0 ? dist : fminf(best, dist);
    }
    total += best;
  }
  out[gid] = total;
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
// A CTA holds kSelBlocks blocks x kSelSplit pattern slices. Each thread keeps
// its block's 64 bf16-rounded distances in registers and scans the patterns
// s = slice, slice + kSelSplit, ... of each shared-memory chunk in increasing
// order with a strict '<'; the slices are then merged lowest index first, so
// ties resolve to the lowest pattern index exactly as in the Pallas kernel.
// Patterns arrive packed 2 bits per pixel in one uint32.
// ---------------------------------------------------------------------------
constexpr int kSelBlocks = 32;
constexpr int kSelSplit = 8;
constexpr int kSelChunk = 2048;

__global__ void __launch_bounds__(kSelBlocks * kSelSplit)
selbest_kernel(const float* __restrict__ dists,
               const uint32_t* __restrict__ patterns,
               int32_t* __restrict__ best_out, float* __restrict__ val_out,
               int n_blocks, int n_patterns) {
  __shared__ uint32_t pat_s[kSelChunk];
  __shared__ float val_s[kSelSplit][kSelBlocks];
  __shared__ int idx_s[kSelSplit][kSelBlocks];

  const int tx = threadIdx.x;            // block within the CTA
  const int ty = threadIdx.y;            // pattern slice
  const int tid = ty * kSelBlocks + tx;
  const int b = blockIdx.x * kSelBlocks + tx;
  const bool valid = b < n_blocks;

  float d[64];
  const float* row = dists + (size_t)(valid ? b : 0) * 64;
#pragma unroll
  for (int j = 0; j < 64; ++j)
    d[j] = __bfloat162float(__float2bfloat16_rn(__ldg(row + j)));

  float best_v = __int_as_float(0x7f800000);  // +inf
  int best_i = 0x7fffffff;
  for (int c0 = 0; c0 < n_patterns; c0 += kSelChunk) {
    const int cn = min(kSelChunk, n_patterns - c0);
    __syncthreads();
    for (int j = tid; j < cn; j += kSelBlocks * kSelSplit)
      pat_s[j] = patterns[c0 + j];
    __syncthreads();
    for (int j = ty; j < cn; j += kSelSplit) {
      const uint32_t p = pat_s[j];
      float e = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t s = (p >> (2 * i)) & 3u;
        const float v = s == 0 ? d[i * 4 + 0]
                      : (s == 1 ? d[i * 4 + 1]
                                : (s == 2 ? d[i * 4 + 2] : d[i * 4 + 3]));
        e += v;
      }
      if (e < best_v) {
        best_v = e;
        best_i = c0 + j;
      }
    }
  }
  val_s[ty][tx] = best_v;
  idx_s[ty][tx] = best_i;
  __syncthreads();
  if (ty == 0 && valid) {
#pragma unroll
    for (int k = 1; k < kSelSplit; ++k) {
      const float v = val_s[k][tx];
      const int ix = idx_s[k][tx];
      if (v < best_v || (v == best_v && ix < best_i)) {
        best_v = v;
        best_i = ix;
      }
    }
    // every slice saw no finite error only if all are +inf/NaN: fall back
    // to pattern 0, as an argmin over such a row would
    best_out[b] = best_i == 0x7fffffff ? 0 : best_i;
    val_out[b] = best_v;
  }
}

}  // namespace

extern "C" {

int etc1s_factorized_scan(const float* pixels, const float* base5, float* out,
                          int n_blocks, int radius, int perceptual,
                          void* stream) {
  if (n_blocks <= 0) return (int)cudaSuccess;
  const int n_deltas = radius == 0 ? 1 : (radius == 1 ? 27 : 125);
  const dim3 block(128);
  const dim3 grid((n_blocks + 127) / 128, n_deltas);
  cudaStream_t s = (cudaStream_t)stream;
  const bool ext = base5 != nullptr;
  if (ext && perceptual)
    fscan_kernel<true, true><<<grid, block, 0, s>>>(pixels, base5, out, n_blocks, radius);
  else if (ext)
    fscan_kernel<true, false><<<grid, block, 0, s>>>(pixels, base5, out, n_blocks, radius);
  else if (perceptual)
    fscan_kernel<false, true><<<grid, block, 0, s>>>(pixels, base5, out, n_blocks, radius);
  else
    fscan_kernel<false, false><<<grid, block, 0, s>>>(pixels, base5, out, n_blocks, radius);
  return (int)cudaGetLastError();
}

int etc1s_palette_errs_packed(const float* pixels, const int32_t* packed,
                              float* out, int n_blocks, int n_cand,
                              int perceptual, void* stream) {
  const long long total = (long long)n_blocks * n_cand;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned grid = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (perceptual)
    rescore_kernel<true><<<grid, threads, 0, s>>>(pixels, packed, out, n_blocks, n_cand);
  else
    rescore_kernel<false><<<grid, threads, 0, s>>>(pixels, packed, out, n_blocks, n_cand);
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
                                      const uint32_t* patterns, int32_t* best,
                                      float* best_err, int n_blocks,
                                      int n_patterns, void* stream) {
  if (n_blocks <= 0) return (int)cudaSuccess;
  const dim3 block(kSelBlocks, kSelSplit);
  const dim3 grid((n_blocks + kSelBlocks - 1) / kSelBlocks);
  selbest_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      dists, patterns, best, best_err, n_blocks, n_patterns);
  return (int)cudaGetLastError();
}

}  // extern "C"

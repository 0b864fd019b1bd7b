// The ETC1S frontend's codebook arithmetic on the card: the 6-D codebook
// distances of the k-means assignment (cross6_argmin) and of the refine's
// shortlist (cross6_distances), and the cluster scan's errors, its segment
// sums and their assembly (cluster_scan_assemble). Part of
// etc1s_kernels.cu, which includes
// it inside its anonymous namespace after <cuda_runtime.h>, <cuda_bf16.h>,
// <stdint.h> and its THIRD (float32 1/3). Its kernels meet only at
// __syncthreads and warp shuffles, so tests/test_torch_kernels.py also
// compiles this header for the host against tests/cuda_host_stub.h.
//
// Every launcher takes raw device pointers, sizes and a cudaStream_t,
// launches asynchronously and returns cudaGetLastError().

// ---------------------------------------------------------------------------
// cross6_argmin and cross6_distances: the 6-D codebook distances of the
// frontend's k-means assignment and of the refine's shortlist,
//     d[n, j] = (r[n] - 2 * x[n, j]) + q[j],   x[n, j] = sum_k a[n,k] c[j,k],
// with r = 0 for the k-means form q[j] - 2 x[n, j]. cross6_argmin returns
// each row's first index of least d (the order of torch.argmin and
// jnp.argmin); cross6_distances writes the (N, C) float32 matrix, row-major,
// which the refine shortlists (etc1s_encode._refine_shortlist).
//
// These replace no Pallas kernel: in the reference they are XLA's matrix
// products (basis_universal_tpu/ops/etc1s_encode.py:357, the k-means
// dot_general, and :452, the refine's blk_vec6 @ cb_vec6.T), whose CPU
// rounding decides the assignment and the shortlist, hence the codebook
// bytes. x is summed as XLA's CPU dot sums a 6-long contraction for C
// columns: two fused multiply-add chains over the even and the odd terms,
// added at the end, where C mod 64 is 1..32; one chain in index order
// otherwise (measured on an AVX-512 x86 host, `ops/xla_order._cross6`, which
// is this kernel's plain version and holds the rule's test). Every rounding
// is spelled out (__fmul_rn, __fmaf_rn, __fadd_rn, __fsub_rn), so the card
// gives the plain version's bits.
//
// The squared norms are computed where the operands are read: q[j] by the
// thread that stages centroid j in shared memory, r[n] from the row its warp
// holds. cross6_argmin's q is the reference's jnp.sum(c * c, -1) (the
// squares rounded, then added in index order) of the unrounded centroids;
// at kCross6Bf16Clusters centroids or more its cross term takes both
// operands rounded to bf16 (the reference's bf16 matmul with float32
// accumulation). cross6_distances' r and q are the reference's sums of
// squares as XLA-CPU contracts them: one fused multiply-add chain in index
// order (`xla_order._dot`).
constexpr int kXWarps = 8;
constexpr int kXRows = 8;       // rows per warp
constexpr int kXTile = 512;     // centroids staged per pass
constexpr int kCross6Bf16Clusters = 1024;

template <bool kTwoChains>
__device__ __forceinline__ float cross6(const float (&a)[6], float c0, float c1,
                                        float c2, float c3, float c4,
                                        float c5) {
  if (kTwoChains) {
    float e = __fmul_rn(a[0], c0);
    float o = __fmul_rn(a[1], c1);
    e = __fmaf_rn(a[2], c2, e);
    o = __fmaf_rn(a[3], c3, o);
    e = __fmaf_rn(a[4], c4, e);
    o = __fmaf_rn(a[5], c5, o);
    return __fadd_rn(e, o);
  }
  float x = __fmul_rn(a[0], c0);
  x = __fmaf_rn(a[1], c1, x);
  x = __fmaf_rn(a[2], c2, x);
  x = __fmaf_rn(a[3], c3, x);
  x = __fmaf_rn(a[4], c4, x);
  return __fmaf_rn(a[5], c5, x);
}

// v . v as one fused multiply-add chain in index order (`xla_order._dot`)
__device__ __forceinline__ float dot6_chain(const float (&v)[6]) {
  float x = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) x = __fmaf_rn(v[k], v[k], x);
  return x;
}

// v . v as rounded squares added in index order (`xla_order._sum(v * v)`)
__device__ __forceinline__ float dot6_sum(const float (&v)[6]) {
  float x = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) x = __fadd_rn(x, __fmul_rn(v[k], v[k]));
  return x;
}

// x rounded to bf16 (to nearest even, as .to(torch.bfloat16)) and back
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// cross6_distances. Bound at the main path's shape (N 24,576 blocks, C 2,416
// clusters): 59.4 M pairs x 9 instructions (6 products and fused
// multiply-adds, the scale, the subtract and the add), and 237 MB written
// (71 us at 3.35 TB/s): bound by its bytes. A CTA of 8 warps owns 64 rows (8
// per warp, held in registers with their r), and stages the codebook in
// tiles of 512 centroids, a thread a centroid (6 coordinates and its q, 7
// floats a centroid: an odd stride, so 32 lanes reading 32 consecutive
// centroids hit 32 distinct banks); lane l takes the tile's centroids l, l +
// 32, ..., so a warp's stores of one row are 128 contiguous bytes.
template <bool kTwoChains>
__global__ void __launch_bounds__(kXWarps * 32)
cross6_kernel(const float* __restrict__ a, const float* __restrict__ c,
              float* __restrict__ out, int n, int n_c) {
  __shared__ float cs[kXTile * 7];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kXWarps + warp) * kXRows;
  float av[kXRows][6], rv[kXRows];
#pragma unroll
  for (int i = 0; i < kXRows; ++i) {
    const int row = min(row0 + i, n - 1);
#pragma unroll
    for (int k = 0; k < 6; ++k) av[i][k] = a[(size_t)row * 6 + k];
    rv[i] = dot6_chain(av[i]);
  }
  for (int t0 = 0; t0 < n_c; t0 += kXTile) {
    const int tn = min(kXTile, n_c - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < tn; j += kXWarps * 32) {
      float v[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        v[k] = c[(size_t)(t0 + j) * 6 + k];
        cs[j * 7 + k] = v[k];
      }
      cs[j * 7 + 6] = dot6_chain(v);
    }
    __syncthreads();
    for (int j = lane; j < tn; j += 32) {
      const float* cj = cs + j * 7;
      const float qj = cj[6];
#pragma unroll
      for (int i = 0; i < kXRows; ++i) {
        const float x = cross6<kTwoChains>(av[i], cj[0], cj[1], cj[2], cj[3],
                                           cj[4], cj[5]);
        const float d = __fadd_rn(__fsub_rn(rv[i], __fmul_rn(2.f, x)), qj);
        if (row0 + i < n) out[(size_t)(row0 + i) * n_c + t0 + j] = d;
      }
    }
  }
}

// cross6_argmin, redesigned for Hopper. d = q - 2x is one fused multiply-add,
// fma(-2, x, q): -2x is exact (a power of two times a float32 far from
// overflow), so the fused form rounds once where q - 2x rounds once (signed
// zeros agree too: q is a sum of squares, never -0). Bound at the main
// path's shape: 59.4 M pairs x 9 instructions (6 products and fused
// multiply-adds, the fold, the compare and the select; + the chains' add
// where C mod 64 is 1..32), 16.0 us at the issue rate; its bytes are 0.7
// MB. So it is bound by its instructions, and the design keeps every
// instruction that is not one of those off the inner loop: a warp holds 16
// rows in registers (each lane all 16, rounded to bf16 on load where the
// rule says so), lane l takes the centroids l, l + 32, ... and reads each
// from shared memory as three float2 and q (4 loads and the loop's step per
// 16 pairs; a warp's reads are conflict-free); the running argmin is a
// compare and two selects per pair (the first index on ties: a lane walks
// its centroids in increasing order and keeps a strictly smaller value;
// lanes meet in (value, index) order). The CTA stages up to 2,432 centroids
// at once (68 KB: the main path's whole codebook), a thread a centroid that
// also sums its q and rounds its coordinates, read by 12 warps of 16 rows
// (the most that 168 registers a thread allow on an SM): 128 CTAs at the
// main path's shape, one an SM, so each SM stages the codebook once.
constexpr int kAWarps = 12;
constexpr int kARows = 16;      // rows per warp, all held by every lane
constexpr int kATile = 2432;    // centroids staged at once
constexpr int kASmem = kATile * 7 * 4;

template <bool kTwoChains>
__global__ void __launch_bounds__(kAWarps * 32, 1)
cross6_argmin_kernel(const float* __restrict__ a, const float* __restrict__ c,
                     int64_t* __restrict__ idx_out, int n, int n_c) {
  extern __shared__ float4 a_smem[];
  float* cs = reinterpret_cast<float*>(a_smem);    // (tile, 6)
  float* qs = cs + min(n_c, kATile) * 6;           // (tile,)
  const bool bf16 = n_c >= kCross6Bf16Clusters;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kAWarps + warp) * kARows;
  float av[kARows][6], best[kARows];
  int bidx[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int row = min(row0 + i, n - 1);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float v = a[(size_t)row * 6 + k];
      av[i][k] = bf16 ? bf16_round(v) : v;
    }
    best[i] = __int_as_float(0x7f800000);   // +inf
    bidx[i] = 0;
  }
  for (int t0 = 0; t0 < n_c; t0 += kATile) {
    const int tn = min(kATile, n_c - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < tn; j += kAWarps * 32) {
      float v[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] = c[(size_t)(t0 + j) * 6 + k];
      qs[j] = dot6_sum(v);
#pragma unroll
      for (int k = 0; k < 6; ++k) cs[j * 6 + k] = bf16 ? bf16_round(v[k]) : v[k];
    }
    __syncthreads();
#pragma unroll 2
    for (int j = lane; j < tn; j += 32) {
      const float2* cj = reinterpret_cast<const float2*>(cs + j * 6);
      const float2 c01 = cj[0], c23 = cj[1], c45 = cj[2];
      const float qj = qs[j];
      const int jj = t0 + j;
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const float x = cross6<kTwoChains>(av[i], c01.x, c01.y, c23.x, c23.y,
                                           c45.x, c45.y);
        const float d = __fmaf_rn(-2.f, x, qj);
        const bool lt = d < best[i];
        best[i] = lt ? d : best[i];
        bidx[i] = lt ? jj : bidx[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    float v = best[i];
    int ix = bidx[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
      if (ov < v || (ov == v && oi < ix)) {
        v = ov;
        ix = oi;
      }
    }
    if (lane == 0 && row0 + i < n) idx_out[row0 + i] = ix;
  }
}

// where C mod 64 is 1..32, XLA-CPU sums the 6 terms as two chains
inline bool cross6_two_chains(int n_c) {
  const int m64 = n_c % 64;
  return m64 >= 1 && m64 <= 32;
}

// The argmin of a (n, 6) against c (n_c, 6) into out (n,) int64; the
// caller has raised the kernels' dynamic shared-memory limit to kASmem.
inline int launch_cross6_argmin(const float* a, const float* c, int64_t* out,
                                int n, int n_c, cudaStream_t s) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_c <= 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (n + kAWarps * kARows - 1) / (kAWarps * kARows);
  const int smem = min(n_c, kATile) * 7 * 4;
  if (cross6_two_chains(n_c))
    cross6_argmin_kernel<true><<<grid, kAWarps * 32, smem, s>>>(a, c, out, n, n_c);
  else
    cross6_argmin_kernel<false><<<grid, kAWarps * 32, smem, s>>>(a, c, out, n, n_c);
  return (int)cudaGetLastError();
}

// The distances of a (n, 6) to c (n_c, 6) into out (n, n_c) float32.
inline int launch_cross6_distances(const float* a, const float* c, float* out,
                                   int n, int n_c, cudaStream_t s) {
  if (n <= 0 || n_c <= 0) return (int)cudaSuccess;
  const unsigned grid = (n + kXWarps * kXRows - 1) / (kXWarps * kXRows);
  if (cross6_two_chains(n_c))
    cross6_kernel<true><<<grid, kXWarps * 32, 0, s>>>(a, c, out, n, n_c);
  else
    cross6_kernel<false><<<grid, kXWarps * 32, 0, s>>>(a, c, out, n, n_c);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// cluster_scan_assemble: the unclipped ETC1S error of every (cluster, delta,
// table) from the members of each endpoint cluster, in one launch: the
// cluster scan of `etc1s_encode._cluster_scan` (the reference's
// basis_universal_tpu/ops/etc1s_encode.py:284-306, XLA code with no Pallas
// kernel): no copy, sort, gather or segment reduction of the rows outside
// it.
//
// The sums. The members of cluster c are the blocks order[offsets[c]] ..
// order[offsets[c + 1] - 1], in ascending row order (a stable order of the
// ids, which the refine pass builds once and shares with its other segment
// sums). Each column is summed as one chain of adds in that order, starting
// from +0.0: the order of `etc1s_encode.segment_sum` (torch.segment_reduce)
// and of the reference's jax.ops.segment_sum on the CPU. The columns are n
// (a 1 per member), sum_x (3), sum_x2, sum_l, sum_l2 and the D*8 gray-axis
// terms mt (B, D*8) of the cluster-base scan, read where they lie. Without
// the perceptual metric the block moments are computed here from the pixels
// (B, 16, 3), whole numbers in [0, 255]: each is exact in any order (sum_l2
// <= 16 * 765^2 < 2^24), so it equals `_block_moments`'. With the metric
// they are read from `_block_moments`' tensors (sum_x (B, 3), sum_x2, sum_l,
// sum_l2 (B,)), which round as XLA-CPU rounds the reference's.
//
// The assembly, `_cluster_scan`'s roundings operation for operation:
//     npix = 16 n                          (exact)
//     bb   = b . b,  bx = b . sum_x        (fused multiply-add chains)
//     q    = fma(npix, bb, sum_x2 - 2 bx)  (the subtract rounded apart)
//     lb   = given (perceptual), or (b0 + b1) + b2
//     su2  = fma(lb, npix lb, fma(-(2 sum_l), lb, sum_l2))
//     cst  = fma(-su2, 1/3, q)
//     err  = fma(mt, 3, cst)               (each of the 8 tables)
// with base8 (D, C, 3) the cluster bases, lb (D, C) their gray-axis levels
// under the perceptual metric, and out (C, D*8).
//
// The design: a CTA of 8 warps per cluster. Its columns are taken 32 at a
// time, a lane a column: chunk 0 the 7 moment columns, chunk k >= 1 the terms
// 32 (k - 1) .. 32 k - 1 (8 chunks at D 27, 33 at D 125; warp w takes chunks
// w, w + 8, ...), so a large cluster keeps all 8 warps of its CTA busy. A
// warp takes the members 32 at a time: lane l reads member l's row index
// (the next batch's are read ahead), then every lane loads its column of
// the 32 members (32 independent loads, each a warp's 128 contiguous bytes
// of one row) before its 32 dependent adds. Past the cluster's end a batch
// adds +0.0, which leaves a sum's bits alone (a chain that starts from +0.0
// is never -0.0). In chunk 0 lane l computes member l's moments (from its 12
// float4 of pixels, or its 6 moments) into shared memory and lanes 0..6 add
// down their column. The sums meet in shared memory, and the CTA writes the
// cluster's D*8 errors, a thread a column, each thread's first column's base
// (and level) read before the sums so that its load overlaps theirs. At 64
// registers (RGB; 80 perceptual) an SM holds 4 (3) CTAs. Two other forms
// were slower on the H100 and were not kept: 4 or 8 consecutive clusters a
// CTA, each warp's chains running on from one cluster into the next over
// 32 consecutive members a batch (2.7-3.2x slower at image 0's clusters),
// and register limits that hold 5, 6 or 8 CTAs an SM (spills).
//
// Bounds at the main path's shape (B 24,576, C 2,416, D 27): its bytes, mt
// 21.2 MB, the pixels 4.7 MB, the order 0.2 MB, the bases 0.8 MB and the
// errors 2.1 MB in and out, ~8.7 us at 3.35 TB/s; and the chain of adds,
// the largest cluster's member count times an add's latency.
constexpr int kCsWarps = 8;
constexpr int kCsBatch = 32;    // members a warp takes at once, a lane each
constexpr int kCsMoments = 7;   // n, sum_x (3), sum_x2, sum_l, sum_l2
constexpr int kCsMaxCols = 8 * 125;

// m = (1, sum_x, sum_x2, sum_l, sum_l2) of block `row`: from its pixels
// (whole numbers, every sum exact), or read from the moment tensors
template <bool kPerceptual>
__device__ __forceinline__ void cs_block_moments(
    int row, const float* __restrict__ px, const float* __restrict__ sum_x,
    const float* __restrict__ sum_x2, const float* __restrict__ sum_l,
    const float* __restrict__ sum_l2, float (&m)[kCsMoments]) {
  m[0] = 1.f;
  if (kPerceptual) {
    m[1] = __ldg(sum_x + (size_t)row * 3);
    m[2] = __ldg(sum_x + (size_t)row * 3 + 1);
    m[3] = __ldg(sum_x + (size_t)row * 3 + 2);
    m[4] = __ldg(sum_x2 + row);
    m[5] = __ldg(sum_l + row);
    m[6] = __ldg(sum_l2 + row);
    return;
  }
  const float4* p = reinterpret_cast<const float4*>(px + (size_t)row * 48);
  float f[48];
#pragma unroll
  for (int q = 0; q < 12; ++q) {
    const float4 v = __ldg(p + q);
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, sq = 0.f, sl = 0.f, sl2 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float r = f[3 * i], g = f[3 * i + 1], b = f[3 * i + 2];
    const float l = r + g + b;
    s0 += r;
    s1 += g;
    s2 += b;
    sq += r * r + g * g + b * b;
    sl += l;
    sl2 += l * l;
  }
  m[1] = s0;
  m[2] = s1;
  m[3] = s2;
  m[4] = sq;
  m[5] = sl;
  m[6] = sl2;
}

// the assembly's operands of column col of cluster c: its base's three
// coordinates and, with the perceptual metric, its level
template <bool kPerceptual>
__device__ __forceinline__ void cs_base(const float* __restrict__ base8,
                                        const float* __restrict__ lb, int c,
                                        int n_c, int col, float (&b)[4]) {
  const size_t at = (size_t)(col >> 3) * n_c + c;
  b[0] = __ldg(base8 + at * 3);
  b[1] = __ldg(base8 + at * 3 + 1);
  b[2] = __ldg(base8 + at * 3 + 2);
  b[3] = kPerceptual ? __ldg(lb + at) : 0.f;
}

template <bool kPerceptual>
__global__ void __launch_bounds__(kCsWarps * 32, kPerceptual ? 3 : 4)
cluster_scan_assemble_kernel(
    const float* __restrict__ mt, const int64_t* __restrict__ order,
    const int64_t* __restrict__ offsets, const float* __restrict__ px,
    const float* __restrict__ sum_x, const float* __restrict__ sum_x2,
    const float* __restrict__ sum_l, const float* __restrict__ sum_l2,
    const float* __restrict__ base8, const float* __restrict__ lb,
    float* __restrict__ out, int n_c, int n_d) {
  extern __shared__ float cs_sums[];              // (7 + D*8,)
  __shared__ float cs_mom[kCsBatch][kCsMoments + 1];
  const int c = blockIdx.x, cols = n_d * 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long beg = offsets[c], end = offsets[c + 1];
  const int n_chunks = 1 + (cols + 31) / 32;
  // the operands of this thread's first column, read ahead of the sums
  float first[4] = {};
  if ((int)threadIdx.x < cols)
    cs_base<kPerceptual>(base8, lb, c, n_c, threadIdx.x, first);
  for (int k = warp; k < n_chunks; k += kCsWarps) {
    const int col = (k - 1) * 32 + lane;          // chunk k >= 1's term
    const bool live = k == 0 ? lane < kCsMoments : col < cols;
    float acc = 0.f;
    int next = beg + lane < end ? (int)order[beg + lane] : 0;
    for (long long i = beg; i < end; i += kCsBatch) {
      const int cnt = end - i < kCsBatch ? (int)(end - i) : kCsBatch;
      const int row = next;
      next = i + kCsBatch + lane < end ? (int)order[i + kCsBatch + lane] : 0;
      if (k == 0) {
        float m[kCsMoments] = {};
        if (lane < cnt)
          cs_block_moments<kPerceptual>(row, px, sum_x, sum_x2, sum_l, sum_l2,
                                        m);
#pragma unroll
        for (int j = 0; j < kCsMoments; ++j) cs_mom[lane][j] = m[j];
        __syncwarp();
        if (live)
          for (int u = 0; u < kCsBatch; ++u)
            acc = __fadd_rn(acc, cs_mom[u][lane]);
        __syncwarp();
      } else {
        float v[kCsBatch];
#pragma unroll
        for (int u = 0; u < kCsBatch; ++u) {
          const int r = __shfl_sync(0xffffffffu, row, u);
          v[u] = live && u < cnt ? __ldg(mt + (size_t)r * cols + col) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kCsBatch; ++u) acc = __fadd_rn(acc, v[u]);
      }
    }
    if (live) cs_sums[k == 0 ? lane : kCsMoments + col] = acc;
  }
  __syncthreads();

  const float npix = __fmul_rn(16.f, cs_sums[0]);
  const float sx0 = cs_sums[1], sx1 = cs_sums[2], sx2 = cs_sums[3];
  const float sxx = cs_sums[4], sl = cs_sums[5], sll = cs_sums[6];
  for (int col = threadIdx.x; col < cols; col += kCsWarps * 32) {
    float b[4] = {first[0], first[1], first[2], first[3]};
    if (col != (int)threadIdx.x)
      cs_base<kPerceptual>(base8, lb, c, n_c, col, b);
    const float b0 = b[0], b1 = b[1], b2 = b[2];
    const float bb = __fmaf_rn(b2, b2, __fmaf_rn(b1, b1, __fmul_rn(b0, b0)));
    const float bx =
        __fmaf_rn(b2, sx2, __fmaf_rn(b1, sx1, __fmul_rn(b0, sx0)));
    const float q = __fmaf_rn(npix, bb, __fsub_rn(sxx, __fmul_rn(2.f, bx)));
    const float l = kPerceptual ? b[3] : __fadd_rn(__fadd_rn(b0, b1), b2);
    const float su2 = __fmaf_rn(l, __fmul_rn(npix, l),
                                __fmaf_rn(-__fmul_rn(2.f, sl), l, sll));
    const float cst = __fmaf_rn(-su2, THIRD, q);
    out[(size_t)c * cols + col] =
        __fmaf_rn(cs_sums[kCsMoments + col], 3.f, cst);
  }
}

// mt (n_b, n_d * 8), order (n_b,) int64 (the blocks in a stable order of
// their cluster ids), offsets (n_c + 1,) int64 (each cluster's first place
// in it), base8 (n_d, n_c, 3), out (n_c, n_d * 8). Without the perceptual
// metric px (n_b, 16, 3), 16-byte aligned, and sum_x ... lb null; with it
// px null and sum_x (n_b, 3), sum_x2, sum_l, sum_l2 (n_b,) and lb (n_d, n_c).
inline int launch_cluster_scan_assemble(
    const float* mt, const int64_t* order, const int64_t* offsets,
    const float* px, const float* sum_x, const float* sum_x2,
    const float* sum_l, const float* sum_l2, const float* base8,
    const float* lb, float* out, int n_c, int n_d, cudaStream_t s) {
  if (n_c <= 0) return (int)cudaSuccess;
  if (n_d <= 0 || n_d * 8 > kCsMaxCols) return (int)cudaErrorInvalidValue;
  const bool perceptual = sum_x != nullptr;
  if (perceptual ? (px || !sum_x2 || !sum_l || !sum_l2 || !lb)
                 : (!px || sum_x2 || sum_l || sum_l2 || lb))
    return (int)cudaErrorInvalidValue;
  const int smem = (kCsMoments + n_d * 8) * 4;
  if (perceptual)
    cluster_scan_assemble_kernel<true><<<n_c, kCsWarps * 32, smem, s>>>(
        mt, order, offsets, px, sum_x, sum_x2, sum_l, sum_l2, base8, lb, out,
        n_c, n_d);
  else
    cluster_scan_assemble_kernel<false><<<n_c, kCsWarps * 32, smem, s>>>(
        mt, order, offsets, px, sum_x, sum_x2, sum_l, sum_l2, base8, lb, out,
        n_c, n_d);
  return (int)cudaGetLastError();
}

// Hand-written Hopper (sm_90a) kernel of the UASTC LDR 4x4 block packing.
//
// uastc_pack writes the (B, 16) UASTC blocks from the mode search's (B, 59)
// uint8 winner buffer [slot | endpoint codes (24) | weights (32) | aux |
// ETC1 intensity], the bytes of `_pack_from_compact` (the numpy packers of
// `codecs/uastc/pack.py`, copies of the reference's host code in
// `basis_universal_tpu/codecs/uastc/encode.py`; no TPU kernel stood behind
// them). Its plain version is `pack.pack_reference`. Per block, in order:
// the mode's Huffman code; for the solid colour its RGBA and the ETC1 hint
// of the LUT search (`_solid_hints`: the first of the 32 (intensity,
// selector) combinations of least summed squared error); for any other mode
// the hint fields, the pattern index or the ccs, the anchor flips (a subset
// or plane whose anchor weight has its top bit set has its weights inverted
// and its endpoint pairs swapped, subset after subset), the endpoints as
// trit / quint bundles (the last one truncated) followed by every value's
// raw bits, and the weights, an anchor's one bit narrower. Every field is
// masked to its width, as `_wr` masks it; a field may cross bit 64.
//
// The tables come from `pack.pack_tables`, one int32 buffer per slot list:
// a header, 16 words per slot, 3 per partition pattern, then the 32 x 256
// solid-colour LUT. Nothing of them is retyped here.
//
// What bounds it on the H100: its bytes, 59 + 4 in and 16 out a block (1.5
// MB at the 24,576 blocks of a 768x512 image, under a microsecond at the
// card's memory rate), so at that size the launch. The work is a few
// hundred integer operations a block, one thread each. The design: a CTA of
// 256 threads stages its 256 rows (15,104 bytes, a multiple of 16) in
// shared memory with 16-byte loads, and the tables before the LUT beside
// them; each thread flips its own row there in place, builds its block in
// two 64-bit registers and stores it as one 16-byte write. The LUT (32 KB)
// is read through the read-only cache: only solid blocks read it, and in
// shared memory it would halve the CTAs an SM holds. Threads of a warp on
// different slots take different branches (the slot decides the fields);
// that divergence is accepted.
//
// The launcher takes raw device pointers and a cudaStream_t; it launches
// asynchronously and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 59;                  // bytes of a winner-buffer row
constexpr int kMaxPrefixWords = 1024;     // pack.MAX_PREFIX_WORDS
constexpr int kLutWords = 32 * 256;       // pack.LUT_WORDS

// the table layout of pack.py
constexpr int kHeaderSlots = 0, kHeaderSlotOfs = 1, kHeaderLutOfs = 2;
constexpr int kSlotWords = 16, kPatternWords = 3;
enum { S_KIND, S_MODE, S_WB, S_RANGE, S_EP_BITS, S_TRITS, S_QUINTS, S_COMPS,
       S_CODE, S_CODE_SIZE, S_FLAGS, S_PAT_OFS, S_PAT_COUNT, S_AUX_BITS,
       S_CCS, S_SUBSETS };
constexpr int kKindSolid = 1, kKindDual = 2;  // pack.KIND_*; 0: subsets
constexpr int kHint0 = 1, kHint1 = 2, kBias = 4, kAlpha = 8;

// row columns
constexpr int kEp = 1, kW = 25, kAux = 57, kInten = 58;

struct Bits {
  uint64_t lo = 0, hi = 0;
  int ofs = 0;

  // n (0..8) low bits of v at the running offset (`_wr`)
  __device__ __forceinline__ void put(uint32_t v, int n) {
    if (n <= 0) return;
    const uint64_t x = (uint64_t)(v & ((1u << n) - 1u));
    if (ofs < 64) {
      lo |= x << ofs;
      if (ofs + n > 64) hi |= x >> (64 - ofs);
    } else if (ofs < 128) {
      hi |= x << (ofs - 64);
    }
    ofs += n;
  }
};

__device__ __forceinline__ void swap_pair(uint8_t* row, int col) {
  const uint8_t t = row[col];
  row[col] = row[col + 1];
  row[col + 1] = t;
}

// bits of a trit (quint) bundle of 0..5 (0..3) values
__device__ __forceinline__ int bundle_bits(bool trits, int cnt) {
  if (trits) return cnt == 5 ? 8 : (cnt == 4 ? 7 : (cnt == 3 ? 5 : 2 * cnt));
  return cnt == 3 ? 7 : (cnt == 2 ? 5 : (cnt == 1 ? 3 : 0));
}

__device__ void pack_solid(Bits& out, const uint8_t* row, int alpha,
                           const int* __restrict__ lut) {
  const int r = row[kEp], g = row[kEp + 1], b = row[kEp + 2];
  int best = 0, best_e = 0x7FFFFFFF;
  for (int k = 0; k < 32; ++k) {
    const int er = __ldg(lut + k * 256 + r) & 0xFFFF;
    const int eg = __ldg(lut + k * 256 + g) & 0xFFFF;
    const int eb = __ldg(lut + k * 256 + b) & 0xFFFF;
    const int e = er * er + eg * eg + eb * eb;
    if (e < best_e) {                     // the first minimum
      best_e = e;
      best = k;
    }
  }
  out.put(r, 8);
  out.put(g, 8);
  out.put(b, 8);
  out.put((uint32_t)alpha, 8);
  out.put(1, 1);                          // ETC1 diff
  out.put(best >> 2, 3);
  out.put(best & 3, 2);
  out.put(__ldg(lut + best * 256 + r) >> 16, 5);
  out.put(__ldg(lut + best * 256 + g) >> 16, 5);
  out.put(__ldg(lut + best * 256 + b) >> 16, 5);
}

__device__ void pack_mode(Bits& out, uint8_t* row, const int* slot,
                          const int* tab) {
  const int flags = slot[S_FLAGS], inten = row[kInten], aux = row[kAux];
  if (flags & kHint0) out.put(0, 1);
  if (flags & kHint1) out.put(0, 1);
  out.put(0, 1);                          // flip
  out.put(1, 1);                          // diff
  out.put(inten, 3);
  out.put(inten, 3);
  if (flags & kBias) out.put(0, 5);
  if (flags & kAlpha) out.put(0x10, 8);   // EAC multiplier 1, table 0
  out.put(aux, slot[S_AUX_BITS]);

  const int count = slot[S_PAT_COUNT];
  const int* pat = tab + slot[S_PAT_OFS]
                   + kPatternWords * (aux < count ? aux : count - 1);
  const uint32_t labels = (uint32_t)pat[0], anchor_mask = (uint32_t)pat[1];
  const int anchors = pat[2];
  const int wb = slot[S_WB], comps = slot[S_COMPS];
  const int wmax = (1 << wb) - 1, top = wb > 0 ? wb - 1 : 0;
  uint8_t* w = row + kW;
  const bool dual = slot[S_KIND] == kKindDual;
  if (!dual) {
    for (int s = 0; s < slot[S_SUBSETS]; ++s) {
      if (!((w[(anchors >> (4 * s)) & 15] >> top) & 1)) continue;
      for (int i = 0; i < 16; ++i)
        if ((int)((labels >> (2 * i)) & 3) == s) w[i] = (uint8_t)(wmax - w[i]);
      for (int c = 0; c < comps; ++c) swap_pair(row, kEp + s * comps * 2 + 2 * c);
    }
  } else {
    const int ccs = slot[S_CCS] >= 0 ? slot[S_CCS] : aux;
    for (int plane = 0; plane < 2; ++plane) {
      if (!((w[plane] >> top) & 1)) continue;
      for (int i = plane; i < 32; i += 2) w[i] = (uint8_t)(wmax - w[i]);
      for (int c = 0; c < comps; ++c)
        if ((ccs == c) == (plane == 1)) swap_pair(row, kEp + 2 * c);
    }
  }

  // endpoints: the trit / quint bundles, then the raw bits
  const uint8_t* ep = row + kEp;
  const int n_values = slot[S_SUBSETS] * comps * 2;
  const int ep_bits = slot[S_EP_BITS];
  const bool trits = slot[S_TRITS] != 0, quints = slot[S_QUINTS] != 0;
  if (trits || quints) {
    const int bundle = trits ? 5 : 3, mul = trits ? 3 : 5;
    for (int i = 0; i < n_values; i += bundle) {
      const int cnt = n_values - i < bundle ? n_values - i : bundle;
      uint32_t accum = 0, m = 1;
      for (int k = 0; k < cnt; ++k) {
        accum += (uint32_t)(ep[i + k] >> ep_bits) * m;
        m *= mul;
      }
      out.put(accum, bundle_bits(trits, cnt));
    }
  }
  for (int i = 0; i < n_values; ++i) out.put(ep[i], ep_bits);

  // weights: 16, or 32 interleaved; anchors one bit narrower
  const int n_weights = dual ? 32 : 16;
  for (int i = 0; i < n_weights; ++i)
    out.put(w[i], wb - (int)((anchor_mask >> i) & 1));
}

__global__ void __launch_bounds__(kThreads)
uastc_pack_kernel(const uint8_t* __restrict__ compact,
                  const int* __restrict__ alpha0,
                  const int* __restrict__ tables, int n_prefix,
                  uint8_t* __restrict__ out, long long n) {
  __shared__ int s_tab[kMaxPrefixWords];
  __shared__ __align__(16) uint8_t s_rows[kThreads * kRow];

  const long long first = (long long)blockIdx.x * kThreads;
  const int rows = n - first < kThreads ? (int)(n - first) : kThreads;
  for (int i = threadIdx.x; i < n_prefix; i += kThreads)
    s_tab[i] = __ldg(tables + i);
  const uint8_t* src = compact + first * kRow;
  const int n_bytes = rows * kRow;
  if (((uintptr_t)src & 15) == 0) {
    const int n16 = n_bytes >> 4;
    for (int i = threadIdx.x; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(s_rows)[i] =
          __ldg(reinterpret_cast<const uint4*>(src) + i);
    for (int i = (n16 << 4) + threadIdx.x; i < n_bytes; i += kThreads)
      s_rows[i] = __ldg(src + i);
  } else {
    for (int i = threadIdx.x; i < n_bytes; i += kThreads)
      s_rows[i] = __ldg(src + i);
  }
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;

  uint8_t* row = s_rows + threadIdx.x * kRow;
  const long long blk = first + threadIdx.x;
  Bits bits;
  const int slot_id = row[0];
  if (slot_id < s_tab[kHeaderSlots]) {
    const int* slot = s_tab + s_tab[kHeaderSlotOfs] + kSlotWords * slot_id;
    bits.put(slot[S_CODE], slot[S_CODE_SIZE]);
    if (slot[S_KIND] == kKindSolid)
      pack_solid(bits, row, __ldg(alpha0 + blk),
                 tables + s_tab[kHeaderLutOfs]);
    else
      pack_mode(bits, row, slot, s_tab);
  }
  reinterpret_cast<uint4*>(out)[blk] =
      make_uint4((uint32_t)bits.lo, (uint32_t)(bits.lo >> 32),
                 (uint32_t)bits.hi, (uint32_t)(bits.hi >> 32));
}

}  // namespace

extern "C" {

// compact (n, 59) uint8, alpha0 (n,) int32, tables pack_tables' n_words
// int32 (the LUT its last kLutWords), out (n, 16) uint8, 16-byte aligned.
int uastc_pack(const uint8_t* compact, const int* alpha0, const int* tables,
               int n_words, uint8_t* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int n_prefix = n_words - kLutWords;
  if (n_prefix < 4 || n_prefix > kMaxPrefixWords || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long grid = (n + kThreads - 1) / kThreads;
  uastc_pack_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      compact, alpha0, tables, n_prefix, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// masked to its width, as `_wr` masks it; a field may cross bit 64, and bits
// past 128 are dropped.
//
// The tables come from `pack.pack_tables`, one int32 buffer per slot list:
// a header, 16 words per slot, 3 per partition pattern, then the 32 x 256
// solid-colour LUT. Nothing of them is retyped here; they are read through
// the read-only cache.
//
// What bounds it on the H100: its bytes, 59 + 4 in and 16 out a block (1.9
// MB at the 24,576 blocks of a 768x512 image, ~0.6 us at the card's memory
// rate), and a block's ~75 fields, each a few integer operations. Every
// field's place is a closed form of the slot's widths
// (the bundles' bits, ep_bits a value, wb a weight less one for each anchor
// before it), so a block's fields are shared by a group of G lanes: lane 0
// the code and the header, lane j the bundles j, j + G, ..., the endpoint
// values j, j + G, ... and the weights j, j + G, ...; each lane builds its
// own 128 bits and the group ORs them by xor shuffles. A solid block's LUT
// search takes the combinations j, j + G, ... in lane j, and the group
// keeps the first least (error, combination); a warp runs it only where
// its ballot finds a solid block. G is 8, or 4 from 16,384 blocks on: on
// the H100 4 lanes were faster at 24,576 blocks (the lanes' shared work,
// the table reads and the flips, counts twice as often with 8) and 8 at
// 4,096 and 1,001 (a block's path is shorter). A CTA takes 32 blocks: it
// stages the tables before the LUT (at most 4 KB) and its 1,888 bytes of
// rows in shared memory together, by 4-byte loads (byte loads for a buffer
// that is not 4-byte aligned), and several CTAs on an SM overlap one's
// staging with the others' packing (768 CTAs at 24,576 blocks, 32 at
// 1,001). Blocks of 8 a CTA (3,072 CTAs at 24,576) and the tables read
// through the read-only cache were no faster.
//
// uastc_pack_split runs the kernel up to a step, for measurement and the
// tests only (kStop 1: staging, the code and the store; 2: + the header
// fields and the solid blocks; 3: + the anchor flips; 4: + the endpoints;
// 5: + the weights, the whole kernel that uastc_pack launches), with either
// G.
//
// The launchers take raw device pointers and a cudaStream_t; they launch
// asynchronously and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCtaBlocks = 32;            // blocks a CTA
// lanes a block: 8, or 4 from kNarrowFrom blocks on
constexpr long long kNarrowFrom = 16384;
constexpr int kRow = 59;                  // bytes of a winner-buffer row
constexpr int kMaxPrefixWords = 1024;     // pack.MAX_PREFIX_WORDS
constexpr int kLutWords = 32 * 256;       // pack.LUT_WORDS
constexpr int kFull = 5;                  // the last step: the whole kernel

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

  // the n (0..8) low bits of v at bit pos (`_wr`'s field)
  __device__ __forceinline__ void put(uint32_t v, int n, int pos) {
    if (n <= 0 || pos >= 128) return;
    const uint64_t x = (uint64_t)(v & ((1u << n) - 1u));
    if (pos < 64) {
      lo |= x << pos;
      if (pos + n > 64) hi |= x >> (64 - pos);
    } else {
      hi |= x << (pos - 64);
    }
  }
};

// bits of a trit (quint) bundle of 0..5 (0..3) values
__device__ __forceinline__ int bundle_bits(bool trits, int cnt) {
  if (trits) return cnt == 5 ? 8 : (cnt == 4 ? 7 : (cnt == 3 ? 5 : 2 * cnt));
  return cnt == 3 ? 7 : (cnt == 2 ? 5 : (cnt == 1 ? 3 : 0));
}

// The solid colour's ETC1 hint: the first (intensity, selector) combination
// of least error, lanes j of a group taking j, j + 8, j + 16, j + 24. Every
// lane of the warp calls it (its shuffles); only a solid block reads the LUT.
template <int kGroup>
__device__ __forceinline__ int solid_best(bool solid, int r, int g, int b,
                                          const int* __restrict__ lut, int j) {
  int best = 0, best_e = 0x7FFFFFFF;
  if (solid) {
#pragma unroll
    for (int t = 0; t < 32 / kGroup; ++t) {
      const int k = j + kGroup * t;
      const int er = __ldg(lut + k * 256 + r) & 0xFFFF;
      const int eg = __ldg(lut + k * 256 + g) & 0xFFFF;
      const int eb = __ldg(lut + k * 256 + b) & 0xFFFF;
      const int e = er * er + eg * eg + eb * eb;
      if (e < best_e) {                   // the first minimum of the lane
        best_e = e;
        best = k;
      }
    }
  }
#pragma unroll
  for (int m = 1; m < kGroup; m <<= 1) {
    const int oe = __shfl_xor_sync(0xffffffffu, best_e, m);
    const int ok = __shfl_xor_sync(0xffffffffu, best, m);
    if (oe < best_e || (oe == best_e && ok < best)) {
      best_e = oe;
      best = ok;
    }
  }
  return best;
}

template <int kGroup, int kStop>
__device__ __forceinline__ void pack_mode(Bits& out, const uint8_t* row,
                                          const int* slot, const int* tab,
                                          int pos, int j) {
  const int flags = slot[S_FLAGS], inten = row[kInten];
  const int aux = row[kAux], aux_bits = slot[S_AUX_BITS];
  // the header: hints, flip, diff, the intensities twice, bias, EAC, aux
  pos += ((flags & kHint0) != 0) + ((flags & kHint1) != 0) + 1;
  if (j == 0) {
    out.put(1, 1, pos);                   // diff
    out.put(inten, 3, pos + 1);
    out.put(inten, 3, pos + 4);
  }
  pos += 7 + ((flags & kBias) ? 5 : 0);
  if (flags & kAlpha) {
    if (j == 0) out.put(0x10, 8, pos);    // EAC multiplier 1, table 0
    pos += 8;
  }
  if (j == 0) out.put(aux, aux_bits, pos);
  pos += aux_bits;
  if (kStop < 3) return;

  const int count = slot[S_PAT_COUNT];
  const int* pat = tab + slot[S_PAT_OFS]
                   + kPatternWords * (aux < count ? aux : count - 1);
  const uint32_t labels = (uint32_t)pat[0];
  const uint32_t anchor_mask = (uint32_t)pat[1];
  const int anchors = pat[2];
  const int wb = slot[S_WB], comps = slot[S_COMPS];
  const int subsets = slot[S_SUBSETS];
  const int wmax = (1 << wb) - 1, top = wb > 0 ? wb - 1 : 0;
  const uint8_t* w = row + kW;
  const bool dual = slot[S_KIND] == kKindDual;
  // the flips, subset after subset (plane after plane): bit s of `flips`
  int flips = 0, ccs = 0;
  if (!dual) {
    for (int s = 0; s < subsets; ++s) {
      const int a = (anchors >> (4 * s)) & 15;
      const int la = (int)((labels >> (2 * a)) & 3);
      const uint8_t wa = (la < s && ((flips >> la) & 1))
                             ? (uint8_t)(wmax - w[a]) : w[a];
      flips |= ((wa >> top) & 1) << s;
    }
  } else {
    ccs = slot[S_CCS] >= 0 ? slot[S_CCS] : aux;
    flips = ((w[0] >> top) & 1) | (((w[1] >> top) & 1) << 1);
  }
  if (kStop == 3) {
    out.lo ^= (uint64_t)flips << (8 * j);
    return;
  }

  // the endpoints: the trit / quint bundles, then the raw bits, each value
  // taken from its pair's other end where its subset (plane) flipped
  const int n_values = subsets * comps * 2;
  const int ep_bits = slot[S_EP_BITS];
  const bool trits = slot[S_TRITS] != 0;
  const bool quints = slot[S_QUINTS] != 0;
  auto ep = [&](int i) -> uint32_t {
    // value i's subset: i / (2 comps), of at most 3
    const bool swap = dual ? (flips >> ((i >> 1) == ccs ? 1 : 0)) & 1
                           : (flips >> ((i >= 2 * comps) + (i >= 4 * comps)))
                                 & 1;
    return row[kEp + (swap ? i ^ 1 : i)];
  };
  if (trits || quints) {
    const int bundle = trits ? 5 : 3, mul = trits ? 3 : 5;
    const int full = bundle_bits(trits, bundle);
    for (int b = j; b * bundle < n_values; b += kGroup) {
      const int first = b * bundle;
      const int cnt = n_values - first < bundle ? n_values - first : bundle;
      uint32_t accum = 0, m = 1;
      for (int k = 0; k < cnt; ++k) {
        accum += (ep(first + k) >> ep_bits) * m;
        m *= mul;
      }
      out.put(accum, bundle_bits(trits, cnt), pos + b * full);
    }
    pos += (n_values / bundle) * full + bundle_bits(trits, n_values % bundle);
  }
#pragma unroll
  for (int t = 0; t < 24 / kGroup; ++t) {
    const int i = j + kGroup * t;
    if (i < n_values) out.put(ep(i), ep_bits, pos + i * ep_bits);
  }
  if (kStop < 5) return;

  // the weights: 16, or 32 interleaved; anchors one bit narrower
  pos += n_values * ep_bits;
  const int n_weights = dual ? 32 : 16;
#pragma unroll
  for (int t = 0; t < 32 / kGroup; ++t) {
    const int i = j + kGroup * t;
    if (i < n_weights) {
      const bool flip = dual ? (flips >> (i & 1)) & 1
                             : (flips >> ((labels >> (2 * i)) & 3)) & 1;
      const uint8_t v = flip ? (uint8_t)(wmax - w[i]) : w[i];
      const int before = __popc(anchor_mask & ((1u << i) - 1u));
      out.put(v, wb - (int)((anchor_mask >> i) & 1), pos + i * wb - before);
    }
  }
}

template <int kGroup, int kStop>
__global__ void __launch_bounds__(kGroup * kCtaBlocks)
uastc_pack_kernel(const uint8_t* __restrict__ compact,
                  const int* __restrict__ alpha0,
                  const int* __restrict__ tables, int n_prefix,
                  uint8_t* __restrict__ out, long long n) {
  constexpr int kThreads = kGroup * kCtaBlocks;
  __shared__ int s_tab[kMaxPrefixWords];
  __shared__ __align__(16) uint8_t s_rows[kCtaBlocks * kRow];

  // the tables before the LUT and the CTA's rows, staged together
  for (int i = threadIdx.x; i < n_prefix; i += kThreads)
    s_tab[i] = __ldg(tables + i);
  const long long first = (long long)blockIdx.x * kCtaBlocks;
  const int rows = n - first < kCtaBlocks ? (int)(n - first) : kCtaBlocks;
  const uint8_t* src = compact + first * kRow;
  const int n_bytes = rows * kRow;
  if (((uintptr_t)src & 3) == 0) {
    const int n4 = n_bytes >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      reinterpret_cast<uint32_t*>(s_rows)[i] =
          __ldg(reinterpret_cast<const uint32_t*>(src) + i);
    for (int i = (n4 << 2) + threadIdx.x; i < n_bytes; i += kThreads)
      s_rows[i] = __ldg(src + i);
  } else {
    for (int i = threadIdx.x; i < n_bytes; i += kThreads)
      s_rows[i] = __ldg(src + i);
  }
  __syncthreads();

  const int g = threadIdx.x / kGroup, j = threadIdx.x % kGroup;
  const bool live = g < rows;
  const long long blk = first + g;
  const uint8_t* row = s_rows + g * kRow;
  const int slot_id = live ? row[0] : 0x7FFFFFFF;
  const bool known = slot_id < s_tab[kHeaderSlots];
  const int* slot = s_tab + s_tab[kHeaderSlotOfs]
                    + kSlotWords * (known ? slot_id : 0);
  const bool solid = known && slot[S_KIND] == kKindSolid;
  Bits bits;
  const int code_size = known ? slot[S_CODE_SIZE] : 0;
  if (known && j == 0) bits.put(slot[S_CODE], code_size, 0);

  if (kStop >= 2) {
    if (__ballot_sync(0xffffffffu, solid)) {
      const int r = row[kEp], gr = row[kEp + 1], b = row[kEp + 2];
      const int* lut = tables + s_tab[kHeaderLutOfs];
      const int best = solid_best<kGroup>(solid, r, gr, b, lut, j);
      if (solid && j == 0) {
        int pos = code_size;
        bits.put(r, 8, pos);
        bits.put(gr, 8, pos + 8);
        bits.put(b, 8, pos + 16);
        bits.put((uint32_t)__ldg(alpha0 + blk), 8, pos + 24);
        bits.put(1, 1, pos + 32);         // ETC1 diff
        bits.put(best >> 2, 3, pos + 33);
        bits.put(best & 3, 2, pos + 36);
        bits.put(__ldg(lut + best * 256 + r) >> 16, 5, pos + 38);
        bits.put(__ldg(lut + best * 256 + gr) >> 16, 5, pos + 43);
        bits.put(__ldg(lut + best * 256 + b) >> 16, 5, pos + 48);
      }
    }
    if (known && !solid)
      pack_mode<kGroup, kStop>(bits, row, slot, s_tab, code_size, j);
  }

#pragma unroll
  for (int m = 1; m < kGroup; m <<= 1) {
    bits.lo |= __shfl_xor_sync(0xffffffffu, bits.lo, m);
    bits.hi |= __shfl_xor_sync(0xffffffffu, bits.hi, m);
  }
  if (live && j == 0)
    reinterpret_cast<uint4*>(out)[blk] =
        make_uint4((uint32_t)bits.lo, (uint32_t)(bits.lo >> 32),
                   (uint32_t)bits.hi, (uint32_t)(bits.hi >> 32));
}

template <int kGroup, int kStop>
int launch_pack(const uint8_t* compact, const int* alpha0, const int* tables,
                int n_words, uint8_t* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int n_prefix = n_words - kLutWords;
  if (n_prefix < 4 || n_prefix > kMaxPrefixWords || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long grid = (n + kCtaBlocks - 1) / kCtaBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int kThreads = kGroup * kCtaBlocks;
  uastc_pack_kernel<kGroup, kStop><<<(unsigned)grid, kThreads, 0, s>>>(
      compact, alpha0, tables, n_prefix, out, n);
  return (int)cudaGetLastError();
}

// group: the lanes a block, 4 or 8 (0: by n, as uastc_pack takes them)
template <int kStop>
int launch_stop(const uint8_t* compact, const int* alpha0, const int* tables,
                int n_words, uint8_t* out, long long n, int group,
                void* stream) {
  if (group == 0) group = n >= kNarrowFrom ? 4 : 8;
  if (group == 4)
    return launch_pack<4, kStop>(compact, alpha0, tables, n_words, out, n,
                                 stream);
  if (group == 8)
    return launch_pack<8, kStop>(compact, alpha0, tables, n_words, out, n,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// compact (n, 59) uint8, alpha0 (n,) int32, tables pack_tables' n_words
// int32 (the LUT its last kLutWords), out (n, 16) uint8, 16-byte aligned.
int uastc_pack(const uint8_t* compact, const int* alpha0, const int* tables,
               int n_words, uint8_t* out, long long n, void* stream) {
  return launch_stop<kFull>(compact, alpha0, tables, n_words, out, n, 0,
                            stream);
}

// The kernel up to step `stop` (1..5, see above) with `group` lanes a block
// (4 or 8; 0: uastc_pack's choice), for measurement and the tests only: the
// blocks it writes are the whole kernel's at stop 5 only.
int uastc_pack_split(const uint8_t* compact, const int* alpha0,
                     const int* tables, int n_words, uint8_t* out, long long n,
                     int stop, int group, void* stream) {
  switch (stop) {
    case 1:
      return launch_stop<1>(compact, alpha0, tables, n_words, out, n, group,
                            stream);
    case 2:
      return launch_stop<2>(compact, alpha0, tables, n_words, out, n, group,
                            stream);
    case 3:
      return launch_stop<3>(compact, alpha0, tables, n_words, out, n, group,
                            stream);
    case 4:
      return launch_stop<4>(compact, alpha0, tables, n_words, out, n, group,
                            stream);
    case 5:
      return launch_stop<5>(compact, alpha0, tables, n_words, out, n, group,
                            stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

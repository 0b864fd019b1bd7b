// The refine shortlist's tie order: the k smallest entries of a row in the
// order the JAX reference's `jax.lax.approx_min_k` gives them on the CPU.
// Shared by the host library (host_sort.cpp, g++) and the card's kernels
// (etc1s_kernels.cu, `min_k_kernel`, nvcc): one source, one order.
//
// On the CPU `approx_min_k` lowers to XLA's ApproxTopK custom call with
// is_fallback = true, which XLA-CPU runs as a full, unstable sort of each
// row: the row's (value, column) pairs through `std::sort` with a comparator
// that looks at the value alone (`a.v < b.v`, so -0.0 and +0.0 are equal),
// then the first k columns. Equal values come out in the order libstdc++'s
// introsort leaves them in, which depends on the whole row.
//
// `sort_first_k` is that introsort, step for step as libstdc++'s
// `std::__sort` (bits/stl_algo.h: `__introsort_loop` with a depth limit of
// 2 lg n, median-of-three pivot `__move_median_to_first`, Hoare partition
// `__unguarded_partition`, ranges of at most 16 left to the final insertion
// sort, `__partial_sort` where the depth limit runs out, with the heap of
// bits/stl_heap.h), except that it does not descend into a right part that
// starts at or past position k. A partition leaves every element of its left
// part no greater than every element of its right part, and the final
// insertion sort moves an element left only past strictly greater ones, so
// nothing of such a part reaches the first k places and what happens inside
// it does not change them: the first k entries are those of the full sort,
// for about 2n comparisons a row instead of 2n lg n. The parts still to do
// wait on a small stack instead of the call stack (parts are disjoint, so
// the order they are done in does not matter).
//
// `sort_first_k_pairs` is the same sort in the form the card's warp runs it
// (`min_k_kernel`), sequentially: each Hoare partition as its swap pairs
// found from counts of 32-entry chunks (`pair_partition`), and the final
// insertion sort as the stable rank of each entry (`stable_first_k`). The
// host library runs it as its own mode, so that the CPU tests hold the
// warp's algorithm to `std::sort`.
//
// A row is reached through an accessor (`get`, `set`, `val` by position), so
// that one source serves the host's array of pairs (`PairRow`) and the
// card's arrays of values and columns (`SoaRow`).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define XCS_FN __host__ __device__ inline
#else
#define XCS_FN inline
#endif

namespace xla_cpu_sort {

struct Entry {
  float v;
  int32_t col;
};

// an array of (value, column) pairs
struct PairRow {
  Entry* p;
  XCS_FN Entry get(int64_t i) const { return p[i]; }
  XCS_FN void set(int64_t i, const Entry& e) const { p[i] = e; }
  XCS_FN float val(int64_t i) const { return p[i].v; }
};

// values and columns in arrays of their own (columns as Idx)
template <class Idx>
struct SoaRow {
  float* v;
  Idx* c;
  XCS_FN Entry get(int64_t i) const { return Entry{v[i], (int32_t)c[i]}; }
  XCS_FN void set(int64_t i, const Entry& e) const {
    v[i] = e.v;
    c[i] = (Idx)e.col;
  }
  XCS_FN float val(int64_t i) const { return v[i]; }
};

constexpr int64_t kThreshold = 16;  // libstdc++'s _S_threshold

XCS_FN bool less(const Entry& a, const Entry& b) { return a.v < b.v; }

template <class Row>
XCS_FN void iter_swap(const Row& r, int64_t a, int64_t b) {
  const Entry t = r.get(a);
  r.set(a, r.get(b));
  r.set(b, t);
}

XCS_FN int64_t lg(int64_t n) {
#ifdef __CUDA_ARCH__
  return 63 - __clzll((long long)n);
#else
  return 63 - __builtin_clzll((unsigned long long)n);
#endif
}

// bits/stl_heap.h, over the range starting at `first`
template <class Row>
XCS_FN void push_heap(const Row& r, int64_t first, int64_t hole, int64_t top,
                      Entry value) {
  int64_t parent = (hole - 1) / 2;
  while (hole > top && less(r.get(first + parent), value)) {
    r.set(first + hole, r.get(first + parent));
    hole = parent;
    parent = (hole - 1) / 2;
  }
  r.set(first + hole, value);
}

template <class Row>
XCS_FN void adjust_heap(const Row& r, int64_t first, int64_t hole,
                        int64_t len, Entry value) {
  const int64_t top = hole;
  int64_t child = hole;
  while (child < (len - 1) / 2) {
    child = 2 * (child + 1);
    if (less(r.get(first + child), r.get(first + child - 1))) child--;
    r.set(first + hole, r.get(first + child));
    hole = child;
  }
  if ((len & 1) == 0 && child == (len - 2) / 2) {
    child = 2 * (child + 1);
    r.set(first + hole, r.get(first + child - 1));
    hole = child - 1;
  }
  push_heap(r, first, hole, top, value);
}

// std::__partial_sort(first, last, last): __heap_select over the whole
// range is __make_heap, then __sort_heap
template <class Row>
XCS_FN void heap_sort(const Row& r, int64_t first, int64_t last) {
  const int64_t len = last - first;
  if (len >= 2) {
    for (int64_t parent = (len - 2) / 2;; --parent) {
      adjust_heap(r, first, parent, len, r.get(first + parent));
      if (parent == 0) break;
    }
  }
  while (last - first > 1) {
    --last;
    const Entry value = r.get(last);
    r.set(last, r.get(first));
    adjust_heap(r, first, 0, last - first, value);
  }
}

// bits/stl_algo.h: the one of a, b, c (holding va, vb, vc) that
// __move_median_to_first swaps into its result
XCS_FN int64_t median_pick(float va, float vb, float vc, int64_t a, int64_t b,
                           int64_t c) {
  if (va < vb) {
    if (vb < vc) return b;
    if (va < vc) return c;
    return a;
  }
  if (va < vc) return a;
  if (vb < vc) return c;
  return b;
}

template <class Row>
XCS_FN void move_median_to_first(const Row& r, int64_t result, int64_t a,
                                 int64_t b, int64_t c) {
  iter_swap(r, result, median_pick(r.val(a), r.val(b), r.val(c), a, b, c));
}

template <class Row>
XCS_FN int64_t unguarded_partition(const Row& r, int64_t first, int64_t last,
                                   int64_t pivot) {
  const float p = r.val(pivot);
  while (true) {
    while (r.val(first) < p) ++first;
    --last;
    while (p < r.val(last)) --last;
    if (!(first < last)) return first;
    iter_swap(r, first, last);
    ++first;
  }
}

template <class Row>
XCS_FN void unguarded_linear_insert(const Row& r, int64_t last) {
  const Entry val = r.get(last);
  int64_t next = last - 1;
  while (less(val, r.get(next))) {
    r.set(last, r.get(next));
    last = next;
    --next;
  }
  r.set(last, val);
}

template <class Row>
XCS_FN void insertion_sort(const Row& r, int64_t first, int64_t last) {
  if (first == last) return;
  for (int64_t i = first + 1; i != last; ++i) {
    if (less(r.get(i), r.get(first))) {
      const Entry val = r.get(i);
      for (int64_t p = i; p != first; --p) r.set(p, r.get(p - 1));
      r.set(first, val);
    } else {
      unguarded_linear_insert(r, i);
    }
  }
}

// std::__final_insertion_sort(first, last): a stable sort of the range by
// value, given (as the introsort leaves it) that no entry of the range is
// less than the least of its first kThreshold entries
template <class Row>
XCS_FN void final_insertion_sort(const Row& r, int64_t first, int64_t last) {
  if (last - first > kThreshold) {
    insertion_sort(r, first, first + kThreshold);
    for (int64_t i = first + kThreshold; i != last; ++i)
      unguarded_linear_insert(r, i);
  } else {
    insertion_sort(r, first, last);
  }
}

// The introsort's depth limit: libstdc++'s 2 lg n, or `cap` where it is
// >= 0 (only to reach the heap fallback in tests).
XCS_FN int64_t depth_limit(int64_t n, int64_t cap) {
  return cap >= 0 ? cap : lg(n) * 2;
}

template <class I>
struct Part {
  I first, last, depth;
};

// The introsort's control flow, pruned past k, over a row of n
// (0 < k <= n), with positions of type I and its steps taken by `steps`:
// median(first, last) moves the median of three to first,
// partition(first, last) runs one Hoare partition of [first + 1, last)
// around the entry at first and returns its cut, heap(first, last) sorts a
// part whose depth limit ran out. Returns the end of the range that the
// final insertion sort takes.
template <class I, class Steps>
XCS_FN I introsort_first_k(I n, I k, I cap, Steps& steps) {
  // depths on the stack fall strictly from bottom to top, so it never holds
  // more than 2 lg n + 1 <= 61 parts (n < 2^31; a cap is at most 62)
  Part<I> stack[64];
  int top = 0;
  stack[top++] = Part<I>{0, n, (I)depth_limit(n, cap)};
  I limit = n;  // the lowest start of a right part left undone
  while (top > 0) {
    Part<I> p = stack[--top];
    while (p.last - p.first > kThreshold) {
      if (p.depth == 0) {
        steps.heap(p.first, p.last);
        break;
      }
      --p.depth;
      steps.median(p.first, p.last);
      const I cut = steps.partition(p.first, p.last);
      if (cut < k)
        stack[top++] = Part<I>{cut, p.last, p.depth};
      else if (cut < limit)
        limit = cut;
      p.last = cut;
    }
  }
  return limit;
}

// libstdc++'s steps, one after another, on a row
template <class Row>
struct SeqSteps {
  Row r;
  XCS_FN void heap(int64_t first, int64_t last) { heap_sort(r, first, last); }
  XCS_FN void median(int64_t first, int64_t last) {
    move_median_to_first(r, first, first + 1, first + (last - first) / 2,
                         last - 1);
  }
  XCS_FN int64_t partition(int64_t first, int64_t last) {
    return unguarded_partition(r, first + 1, last, first);
  }
};

// The first k entries of std::sort(row, row + n, less), in place (0 < k
// <= n); `cap` as in depth_limit.
template <class Row>
XCS_FN void sort_first_k(const Row& r, int64_t n, int64_t k,
                         int64_t cap = -1) {
  SeqSteps<Row> steps{r};
  const int64_t limit = introsort_first_k<int64_t>(n, k, cap, steps);
  // the final insertion sort over the part that was sorted
  final_insertion_sort(r, 0, limit);
}

// ---------------------------------------------------------------------------
// The card's form, sequentially.

constexpr int kChunk = 32;  // entries per chunk: a warp's lanes

XCS_FN int popc(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// the highest set bit of m != 0
XCS_FN int hibit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(m);
#else
  return 31 - __builtin_clz(m);
#endif
}

// bits of m below bit b
XCS_FN uint32_t below(int b) { return (1u << b) - 1u; }

// __unguarded_partition(lo, hi, pivot lo - 1) as its swap pairs. The loop
// stops its left finger at the left stops (!(a < p)) and its right finger
// at the right stops (!(p < a)) and swaps the t-th left stop with the t-th
// right stop from the right, in original values, for as long as the former
// lies left of the latter: fingers never pass a swapped place before they
// cross. So with L_t, R_t the t-th left stop from the left and right stop
// from the right (in [lo, hi)), it swaps L_t with R_t for every t < t*, the
// first t with L_t >= R_t, and returns min(L_t*, R_t*-1) (the left finger's
// last stop: at the latest the swapped R_t*-1). L_t < R_t holds iff more
// than t right stops lie right of L_t, which is monotone in t.
//
// Steps, as the warp takes them: (A) one read of the values records each
// 32-entry chunk's left and right stops as bit masks (ge, le); (B) from the
// masks' counts, the first chunk whose last left stop fails L_t < R_t, then
// the first failing left stop in it: t*, L_t*; (C) L_0 .. L_t*-1 listed
// from the left and R_0 .. R_t*-1 from the right; (D) each L_t swapped
// with its R_t. The pairs are disjoint, and no step reads a place an
// earlier one swapped. Scratch: pairs, 2 ((hi - lo) / 2 + 1) entries (L_t
// at 2t, R_t at 2t + 1); ge, le, one mask per chunk.
template <class Row, class Idx>
XCS_FN int64_t pair_partition(const Row& r, int64_t lo, int64_t hi,
                              Idx* pairs, uint32_t* ge, uint32_t* le) {
  const float p = r.val(lo - 1);
  const int64_t n_chunks = (hi - lo + kChunk - 1) / kChunk;
  int64_t total_le = 0;
  for (int64_t c = 0; c < n_chunks; ++c) {  // (A)
    uint32_t gm = 0, lm = 0;
    for (int b = 0; b < kChunk; ++b) {
      const int64_t x = lo + c * kChunk + b;
      if (x >= hi) break;
      const float v = r.val(x);
      gm |= (uint32_t)!(v < p) << b;
      lm |= (uint32_t)!(p < v) << b;
    }
    ge[c] = gm;
    le[c] = lm;
    total_le += popc(lm);
  }
  // (B) the condition at the left stop at bit b of chunk c, with n_ge and
  // n_le the stops before the chunk: fewer than t + 1 right stops right of it
  auto fails = [&](int64_t n_ge, int64_t n_le, uint32_t gm, uint32_t lm,
                   int b) {
    const int64_t t = n_ge + popc(gm & below(b));
    const int64_t le_incl = n_le + popc(lm & (b == 31 ? ~0u : below(b + 1)));
    return total_le - le_incl < t + 1;
  };
  int64_t n_ge = 0, n_le = 0, t_star = -1, l_star = hi;
  for (int64_t c = 0; c < n_chunks && t_star < 0; ++c) {
    const uint32_t gm = ge[c], lm = le[c];
    if (gm && fails(n_ge, n_le, gm, lm, hibit(gm))) {
      for (int b = 0; b < kChunk; ++b) {
        if (((gm >> b) & 1u) && fails(n_ge, n_le, gm, lm, b)) {
          t_star = n_ge + popc(gm & below(b));
          l_star = lo + c * kChunk + b;
          break;
        }
      }
    }
    n_ge += popc(gm);
    n_le += popc(lm);
  }
  if (t_star < 0) t_star = n_ge;
  // (C)
  int64_t n_l = 0, n_r = 0;
  for (int64_t c = 0; c < n_chunks && n_l < t_star; ++c) {
    for (int b = 0; b < kChunk && n_l < t_star; ++b) {
      if ((ge[c] >> b) & 1u) pairs[2 * n_l++] = (Idx)(lo + c * kChunk + b);
    }
  }
  for (int64_t c = n_chunks - 1; c >= 0 && n_r < t_star; --c) {
    for (int b = kChunk - 1; b >= 0 && n_r < t_star; --b) {
      if ((le[c] >> b) & 1u) pairs[2 * n_r++ + 1] = (Idx)(lo + c * kChunk + b);
    }
  }
  int64_t cut = l_star;
  if (t_star > 0 && (int64_t)pairs[2 * t_star - 1] < cut)
    cut = pairs[2 * t_star - 1];
  // (D)
  for (int64_t t = 0; t < t_star; ++t)
    iter_swap(r, (int64_t)pairs[2 * t], (int64_t)pairs[2 * t + 1]);
  return cut;
}

// The columns of the first k entries of the stable sort of [0, limit) by
// value (what the final insertion sort leaves there), into out: the rank of
// entry i is the number of entries less than it plus the number equal to it
// at lower positions. An entry's count stops once it reaches k (it is not
// among the first k); the warp stops a chunk's counts once all its entries'
// have.
template <class Row, class Out>
XCS_FN void stable_first_k(const Row& r, int64_t limit, int64_t k, Out* out) {
  for (int64_t i = 0; i < limit; ++i) {
    const float v = r.val(i);
    int64_t rank = 0;
    for (int64_t j = 0; j < limit && rank < k; ++j) {
      const float w = r.val(j);
      rank += (w < v) || (w == v && j < i);
    }
    if (rank < k) out[rank] = (Out)r.get(i).col;
  }
}

// The card's steps, sequentially: the partition as its swap pairs
template <class Row, class Idx>
struct PairSteps : SeqSteps<Row> {
  Idx* pairs;
  uint32_t* ge;
  uint32_t* le;
  XCS_FN int64_t partition(int64_t first, int64_t last) {
    return pair_partition(this->r, first + 1, last, pairs, ge, le);
  }
};

// The first k columns of std::sort(row, row + n, less) by the card's
// algorithm, into out; pairs (2 (n / 2 + 1) entries), ge and le ((n + 31) /
// 32 masks each) are scratch. `cap` as in depth_limit.
template <class Row, class Idx, class Out>
XCS_FN void sort_first_k_pairs(const Row& r, int64_t n, int64_t k,
                               int64_t cap, Idx* pairs, uint32_t* ge,
                               uint32_t* le, Out* out) {
  PairSteps<Row, Idx> steps{{r}, pairs, ge, le};
  const int64_t limit = introsort_first_k<int64_t>(n, k, cap, steps);
  stable_first_k(r, limit, k, out);
}

}  // namespace xla_cpu_sort

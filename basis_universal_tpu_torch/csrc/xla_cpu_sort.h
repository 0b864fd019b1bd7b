// The refine shortlist's tie order: the k smallest entries of a row in the
// order the JAX reference's `jax.lax.approx_min_k` gives them on the CPU.
// Shared by the host library (host_sort.cpp, g++) and the card's kernel
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

constexpr int64_t kThreshold = 16;  // libstdc++'s _S_threshold

XCS_FN bool less(const Entry& a, const Entry& b) { return a.v < b.v; }

XCS_FN void iter_swap(Entry* a, Entry* b) {
  Entry t = *a;
  *a = *b;
  *b = t;
}

XCS_FN int64_t lg(int64_t n) {
#ifdef __CUDA_ARCH__
  return 63 - __clzll((long long)n);
#else
  return 63 - __builtin_clzll((unsigned long long)n);
#endif
}

// bits/stl_heap.h
XCS_FN void push_heap(Entry* first, int64_t hole, int64_t top, Entry value) {
  int64_t parent = (hole - 1) / 2;
  while (hole > top && less(first[parent], value)) {
    first[hole] = first[parent];
    hole = parent;
    parent = (hole - 1) / 2;
  }
  first[hole] = value;
}

XCS_FN void adjust_heap(Entry* first, int64_t hole, int64_t len,
                        Entry value) {
  const int64_t top = hole;
  int64_t child = hole;
  while (child < (len - 1) / 2) {
    child = 2 * (child + 1);
    if (less(first[child], first[child - 1])) child--;
    first[hole] = first[child];
    hole = child;
  }
  if ((len & 1) == 0 && child == (len - 2) / 2) {
    child = 2 * (child + 1);
    first[hole] = first[child - 1];
    hole = child - 1;
  }
  push_heap(first, hole, top, value);
}

// std::__partial_sort(first, last, last): __heap_select over the whole
// range is __make_heap, then __sort_heap
XCS_FN void heap_sort(Entry* first, Entry* last) {
  const int64_t len = last - first;
  if (len >= 2) {
    for (int64_t parent = (len - 2) / 2;; --parent) {
      adjust_heap(first, parent, len, first[parent]);
      if (parent == 0) break;
    }
  }
  while (last - first > 1) {
    --last;
    Entry value = *last;
    *last = *first;
    adjust_heap(first, 0, last - first, value);
  }
}

// bits/stl_algo.h
XCS_FN void move_median_to_first(Entry* result, Entry* a, Entry* b,
                                 Entry* c) {
  if (less(*a, *b)) {
    if (less(*b, *c))
      iter_swap(result, b);
    else if (less(*a, *c))
      iter_swap(result, c);
    else
      iter_swap(result, a);
  } else if (less(*a, *c)) {
    iter_swap(result, a);
  } else if (less(*b, *c)) {
    iter_swap(result, c);
  } else {
    iter_swap(result, b);
  }
}

XCS_FN Entry* unguarded_partition(Entry* first, Entry* last,
                                  const Entry* pivot) {
  while (true) {
    while (less(*first, *pivot)) ++first;
    --last;
    while (less(*pivot, *last)) --last;
    if (!(first < last)) return first;
    iter_swap(first, last);
    ++first;
  }
}

XCS_FN void unguarded_linear_insert(Entry* last) {
  Entry val = *last;
  Entry* next = last - 1;
  while (less(val, *next)) {
    *last = *next;
    last = next;
    --next;
  }
  *last = val;
}

XCS_FN void insertion_sort(Entry* first, Entry* last) {
  if (first == last) return;
  for (Entry* i = first + 1; i != last; ++i) {
    if (less(*i, *first)) {
      Entry val = *i;
      for (Entry* p = i; p != first; --p) *p = *(p - 1);
      *first = val;
    } else {
      unguarded_linear_insert(i);
    }
  }
}

// std::__final_insertion_sort(first, last)
XCS_FN void final_insertion_sort(Entry* first, Entry* last) {
  if (last - first > kThreshold) {
    insertion_sort(first, first + kThreshold);
    for (Entry* i = first + kThreshold; i != last; ++i)
      unguarded_linear_insert(i);
  } else {
    insertion_sort(first, last);
  }
}

// The introsort's depth limit: libstdc++'s 2 lg n, or `cap` where it is
// >= 0 (only to reach the heap fallback in tests).
XCS_FN int64_t depth_limit(int64_t n, int64_t cap) {
  return cap >= 0 ? cap : lg(n) * 2;
}

// The first k entries of std::sort(first, last, less), in place
// (0 < k <= last - first); `cap` as in depth_limit.
XCS_FN void sort_first_k(Entry* first, Entry* last, int64_t k,
                         int64_t cap = -1) {
  struct Part {
    Entry* first;
    Entry* last;
    int64_t depth;
  };
  // depths on the stack fall strictly from bottom to top, so it never holds
  // more than 2 lg n + 1 <= 61 parts (n < 2^31; a cap is at most 62)
  Part stack[64];
  int top = 0;
  stack[top++] = Part{first, last, depth_limit(last - first, cap)};
  const Entry* keep = first + k;
  Entry* limit = last;  // the lowest start of a right part left undone
  while (top > 0) {
    Part p = stack[--top];
    while (p.last - p.first > kThreshold) {
      if (p.depth == 0) {
        heap_sort(p.first, p.last);
        break;
      }
      --p.depth;
      Entry* mid = p.first + (p.last - p.first) / 2;
      move_median_to_first(p.first, p.first + 1, mid, p.last - 1);
      Entry* cut = unguarded_partition(p.first + 1, p.last, p.first);
      if (cut < keep)
        stack[top++] = Part{cut, p.last, p.depth};
      else if (cut < limit)
        limit = cut;
      p.last = cut;
    }
  }
  // the final insertion sort over the part that was sorted
  final_insertion_sort(first, limit);
}

}  // namespace xla_cpu_sort

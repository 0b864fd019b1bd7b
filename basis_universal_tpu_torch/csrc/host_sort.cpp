// The refine shortlist in the tie order of the JAX reference's
// `jax.lax.approx_min_k` on the CPU, on the host: the plain version of the
// card's `min_k_kernel` (etc1s_kernels.cu), and the port's route on the CPU.
// The sort itself is xla_cpu_sort.h, shared with the kernel; this file
// only runs it over rows, and also offers libstdc++'s own functions so that
// tests can hold the shared code to them:
// - mode 0: `sort_first_k`, the introsort pruned to the first k places;
// - mode 1: `std::sort` of the whole row, then its first k (the definition);
// - mode 2: `heap_sort` of the whole row, the shared code's heap (the
//   introsort's fallback where its depth limit runs out);
// - mode 3: `std::partial_sort(first, last, last)` of the whole row, what
//   mode 2 must equal.
// `tests/test_torch_etc1s_encode.py` holds them to each other and to
// `jax.lax.approx_min_k` on tie-heavy rows.
//
// Built with g++ at first use by `native.get_host_sort()` into
// build/native/; a plain C interface for ctypes. Rows are split over a few
// threads (each row is sorted on its own, so the result does not depend on
// the thread count).

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

#include "xla_cpu_sort.h"

namespace {

using xla_cpu_sort::Entry;

void sort_rows(const float* d, int64_t n, int k, int64_t* out, int64_t r0,
               int64_t r1, int mode, int cap) {
  std::vector<Entry> row(n);
  for (int64_t r = r0; r < r1; ++r) {
    const float* src = d + r * n;
    for (int64_t i = 0; i < n; ++i) row[i] = Entry{src[i], (int32_t)i};
    Entry* first = row.data();
    Entry* last = first + n;
    if (mode == 1)
      std::sort(first, last, xla_cpu_sort::less);
    else if (mode == 2)
      xla_cpu_sort::heap_sort(first, last);
    else if (mode == 3)
      std::partial_sort(first, last, last, xla_cpu_sort::less);
    else
      xla_cpu_sort::sort_first_k(first, last, k, cap);
    for (int j = 0; j < k; ++j) out[r * k + j] = row[j].col;
  }
}

}  // namespace

extern "C" {

// d: (rows, n) float32, row-major; out: (rows, k) int64, the columns of each
// row's k smallest values in approx_min_k's order on XLA-CPU (modes 0 and 1;
// modes 2 and 3 give a heap sort's first k, see above). cap: mode 0's depth
// limit (xla_cpu_sort::depth_limit; -1 for libstdc++'s). Returns 0, or -1
// on bad sizes, mode or cap.
int xla_cpu_min_k_rows(const float* d, int64_t rows, int64_t n, int k,
                       int64_t* out, int mode, int cap) {
  if (rows < 0 || n < 1 || n > INT32_MAX || k < 1 || k > n || mode < 0 ||
      mode > 3 || cap < -1 || cap > 62)
    return -1;
  if (rows == 0) return 0;
  // one thread per core; a few rows are cheaper on the calling thread than
  // a thread start
  int64_t t = (int64_t)std::thread::hardware_concurrency();
  t = std::max<int64_t>(1, std::min<int64_t>({t, rows / 64, 64}));
  if (t == 1) {
    sort_rows(d, n, k, out, 0, rows, mode, cap);
    return 0;
  }
  std::vector<std::thread> pool;
  const int64_t per = (rows + t - 1) / t;
  for (int64_t r0 = 0; r0 < rows; r0 += per)
    pool.emplace_back(sort_rows, d, n, k, out, r0, std::min(rows, r0 + per),
                      mode, cap);
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"

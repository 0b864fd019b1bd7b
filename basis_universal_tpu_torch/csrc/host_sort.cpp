// The refine shortlist in the tie order of the JAX reference's
// `jax.lax.approx_min_k` on the CPU, on the host: the plain version of the
// card's `min_k_kernel` (etc1s_kernels.cu), and the port's route on the CPU. The sort itself is xla_cpu_sort.h,
// shared with the kernels; this file only runs it over rows, and also
// offers libstdc++'s own functions so that tests can hold the shared code
// to them:
// - mode 0: `sort_first_k`, the introsort pruned to the first k places;
// - mode 1: `std::sort` of the whole row, then its first k (the definition);
// - mode 2: `heap_sort` of the whole row, the shared code's heap (the
//   introsort's fallback where its depth limit runs out);
// - mode 3: `std::partial_sort(first, last, last)` of the whole row, what
//   mode 2 must equal;
// - mode 4: `sort_first_k_pairs`, mode 0 in the card's form (each partition
//   as its swap pairs from chunk masks, the final step as stable ranks),
//   on the values and columns in arrays of their own, as on the card;
// - mode 5: `final_insertion_sort` of the whole row, which must be a stable
//   sort by value (the row's least value must lie in its first 16 places,
//   as the introsort leaves it; rows that break this are refused).
// `tests/test_torch_etc1s_encode.py` holds them to each other and to
// `jax.lax.approx_min_k` on tie-heavy rows.
//
// Built with g++ at first use by `native.get_host_sort()` into
// build/native/; a plain C interface for ctypes. Rows are split over a few
// threads (each row is sorted on its own, so the result does not depend on
// the thread count).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

#include "xla_cpu_sort.h"

namespace {

using xla_cpu_sort::Entry;
using xla_cpu_sort::PairRow;

// libstdc++'s steps, counting the entries the partitions visit
struct CountingSteps : xla_cpu_sort::SeqSteps<PairRow> {
  int64_t visits = 0;
  int64_t partition(int64_t first, int64_t last) {
    visits += last - first - 1;
    return SeqSteps::partition(first, last);
  }
};

// Returns false where mode 5 meets a row it refuses.
bool sort_rows(const float* d, int64_t n, int k, int64_t* out, int64_t r0,
               int64_t r1, int mode, int cap, int64_t* visits) {
  std::vector<Entry> row(n);
  std::vector<float> vals(n);
  std::vector<int32_t> cols(n), pairs(2 * (n / 2 + 1));
  std::vector<uint32_t> ge((n + 31) / 32), le((n + 31) / 32);
  for (int64_t r = r0; r < r1; ++r) {
    const float* src = d + r * n;
    int64_t* dst = out + r * k;
    if (mode == 4) {
      for (int64_t i = 0; i < n; ++i) {
        vals[i] = src[i];
        cols[i] = (int32_t)i;
      }
      xla_cpu_sort::sort_first_k_pairs(
          xla_cpu_sort::SoaRow<int32_t>{vals.data(), cols.data()}, n, k, cap,
          pairs.data(), ge.data(), le.data(), dst);
      continue;
    }
    for (int64_t i = 0; i < n; ++i) row[i] = Entry{src[i], (int32_t)i};
    Entry* first = row.data();
    Entry* last = first + n;
    const PairRow pr{first};
    if (mode == 1) {
      std::sort(first, last, xla_cpu_sort::less);
    } else if (mode == 2) {
      xla_cpu_sort::heap_sort(pr, 0, n);
    } else if (mode == 3) {
      std::partial_sort(first, last, last, xla_cpu_sort::less);
    } else if (mode == 5) {
      const float least = std::min_element(first, last, xla_cpu_sort::less)->v;
      const int64_t head = std::min<int64_t>(n, xla_cpu_sort::kThreshold);
      if (std::min_element(first, first + head, xla_cpu_sort::less)->v > least)
        return false;
      xla_cpu_sort::final_insertion_sort(pr, 0, n);
    } else {
      CountingSteps steps{{pr}};
      const int64_t limit =
          xla_cpu_sort::introsort_first_k<int64_t>(n, k, cap, steps);
      xla_cpu_sort::final_insertion_sort(pr, 0, limit);
      if (visits) visits[r] = steps.visits;
    }
    for (int j = 0; j < k; ++j) dst[j] = row[j].col;
  }
  return true;
}

}  // namespace

extern "C" {

// d: (rows, n) float32, row-major; out: (rows, k) int64, the columns of each
// row's k smallest values in approx_min_k's order on XLA-CPU (modes 0, 1
// and 4; modes 2 and 3 give a heap sort's first k, mode 5 a stable sort's,
// see above). cap: the depth limit of modes 0 and 4
// (xla_cpu_sort::depth_limit; -1 for libstdc++'s). visits: null, or (rows,)
// int64 that mode 0 fills with the number of entries each row's partitions
// visited. Returns 0, -1 on bad sizes, mode or cap, or -2 where mode 5 was
// given a row whose least value is not in its first 16 places.
int xla_cpu_min_k_rows(const float* d, int64_t rows, int64_t n, int k,
                       int64_t* out, int mode, int cap, int64_t* visits) {
  if (rows < 0 || n < 1 || n > INT32_MAX || k < 1 || k > n || mode < 0 ||
      mode > 5 || cap < -1 || cap > 62)
    return -1;
  if (rows == 0) return 0;
  // one thread per core; a few rows are cheaper on the calling thread than
  // a thread start
  int64_t t = (int64_t)std::thread::hardware_concurrency();
  t = std::max<int64_t>(1, std::min<int64_t>({t, rows / 64, 64}));
  if (t == 1) return sort_rows(d, n, k, out, 0, rows, mode, cap, visits) ? 0
                                                                         : -2;
  std::vector<std::thread> pool;
  std::atomic<bool> ok{true};
  const int64_t per = (rows + t - 1) / t;
  for (int64_t r0 = 0; r0 < rows; r0 += per)
    pool.emplace_back([=, &ok] {
      if (!sort_rows(d, n, k, out, r0, std::min(rows, r0 + per), mode, cap,
                     visits))
        ok = false;
    });
  for (auto& th : pool) th.join();
  return ok ? 0 : -2;
}

}  // extern "C"

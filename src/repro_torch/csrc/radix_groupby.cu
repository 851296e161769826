// Grouped aggregation over dense ids: float32 sums + counts (sm_90a).
//
// Replaces the TPU kernel repro/kernels/radix_groupby/kernel.py:
// _radix_groupby_kernel / radix_groupby_pallas, which swept every row tile
// once per 256-id partition and reduced each tile with a one-hot matmul
// carrying a [256, C+1] accumulator (the appended ones column yields the
// counts).  Here a small id space (Q4.1's 147 cells) is summed directly in
// one cooperative launch, and a large one is moved into partition order
// once and each partition's rows reduced in a fixed order: see
// grouped_sum.cuh for both routes, the bound (bytes) and the determinism
// argument.  Without a counts buffer (counts == nullptr) it sums the value
// columns alone: the wrapper takes the counts once, with the first batch
// of MAX_COLS columns.
#include "grouped_sum.cuh"

// values: row r at values + r * ldv; sums: row g at sums + g * lds
extern "C" int repro_radix_groupby(const void* ids, const void* values,
                                   int64_t ldv, int64_t n, int C,
                                   int n_groups, int64_t rows_per_block,
                                   int n_slices, void* iws, void* fws,
                                   void* sums, int64_t lds, void* counts,
                                   void* stream) {
  return (int)grouped_sum_launch(
      static_cast<const int32_t*>(ids), static_cast<const float*>(values),
      ldv, n, C, n_groups, /*with_counts=*/counts != nullptr, rows_per_block,
      n_slices, static_cast<int32_t*>(iws), static_cast<float*>(fws),
      static_cast<float*>(sums), lds, static_cast<float*>(counts),
      static_cast<cudaStream_t>(stream));
}

// Grouped aggregation over dense ids: float32 sums + counts (sm_90a).
//
// Replaces the TPU kernel repro/kernels/radix_groupby/kernel.py:
// _radix_groupby_kernel / radix_groupby_pallas, which swept every row tile
// once per 256-id partition and reduced each tile with a one-hot matmul
// carrying a [256, C+1] accumulator (the appended ones column yields the
// counts).  Here an id space whose partials fit shared memory (Q4.1's 147
// cells, the supplier shard's 4,000) is summed directly in one cooperative
// launch, and a larger one (the part and customer keys' 200,000 and
// 30,000 ids) is moved into partition order by one cooperative launch and
// each partition's rows reduced in a fixed order by a second: see
// grouped_sum.cuh for the routes, the bound (bytes) and the determinism
// argument.  Without a counts buffer (counts == nullptr) it sums the value
// columns alone: the wrapper takes the counts once, with the first batch of
// MAX_COLS columns.
#include "grouped_sum.cuh"

// values: row r at values + r * ldv; sums: row g at sums + g * lds
extern "C" int repro_radix_groupby(const void* ids, const void* values,
                                   int64_t ldv, int64_t n, int C,
                                   int n_groups, int64_t rows_per_block,
                                   int n_blocks, int n_slices, void* iws,
                                   void* fws, void* sums, int64_t lds,
                                   void* counts, void* stream) {
  return (int)grouped_sum_launch(
      static_cast<const int32_t*>(ids), static_cast<const float*>(values),
      ldv, n, C, n_groups, /*with_counts=*/counts != nullptr, rows_per_block,
      n_blocks, n_slices, static_cast<int32_t*>(iws), static_cast<float*>(fws),
      static_cast<float*>(sums), lds, static_cast<float*>(counts),
      static_cast<cudaStream_t>(stream));
}

// The most wide-route blocks the current device holds at once for C value
// columns, with_counts and n_groups ids (gs_wide_blocks), into *blocks
extern "C" int repro_radix_groupby_wide_blocks(int C, int with_counts,
                                               int n_groups, void* blocks) {
  return (int)gs_wide_blocks(C, C + (with_counts ? 1 : 0), n_groups,
                             static_cast<int*>(blocks));
}

// Grouped float32 sums over segment ids (sm_90a).
//
// Replaces the TPU kernel repro/kernels/segment_sum/kernel.py:
// _segment_sum_kernel / segment_sum_pallas, which reduced each row tile
// with a one-hot [rows, n_groups] matmul into a VMEM accumulator carried
// across a sequential grid.  Here the same deterministic grouped sum as the
// radix groupby runs without the counts column: see grouped_sum.cuh for the
// routes, the bound (bytes) and the determinism argument.  The global
// aggregate (n_groups = 1) takes the direct route: each warp sums its
// 32-row batches over the lanes, the blocks' sums are added in a fixed
// order.
#include "grouped_sum.cuh"

// values: row r at values + r * ldv; out: row g at out + g * ldo
extern "C" int repro_segment_sum(const void* seg_ids, const void* values,
                                 int64_t ldv, int64_t n, int C, int n_groups,
                                 int64_t rows_per_block, int n_blocks,
                                 int n_slices, void* iws, void* fws,
                                 void* out, int64_t ldo, void* stream) {
  return (int)grouped_sum_launch(
      static_cast<const int32_t*>(seg_ids), static_cast<const float*>(values),
      ldv, n, C, n_groups, /*with_counts=*/0, rows_per_block, n_blocks,
      n_slices, static_cast<int32_t*>(iws), static_cast<float*>(fws),
      static_cast<float*>(out), ldo, nullptr,
      static_cast<cudaStream_t>(stream));
}

// The most wide-route blocks the current device holds at once for C value
// columns and n_groups ids (gs_wide_blocks), into *blocks
extern "C" int repro_segment_sum_wide_blocks(int C, int with_counts,
                                             int n_groups, void* blocks) {
  return (int)gs_wide_blocks(C, C, n_groups, static_cast<int*>(blocks));
}

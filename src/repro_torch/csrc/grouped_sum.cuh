// Deterministic grouped float32 sums over dense int32 group ids (sm_90a).
//
// Device code shared by radix_groupby.cu (sums + counts) and segment_sum.cu
// (sums only).  Every kernel lives in an anonymous namespace, so each
// translation unit that includes this header gets its own copy.
//
// Contract: ids[N] int32, a row with id outside [0, n_groups) is padding;
// values[N, C] float32 row-major.  out sums[g, c] = sum of values[r, c] over
// rows with ids[r] == g; counts[g] = number of such rows (float32).
//
// Reductions must give bit-identical sums from run to run (serial vs
// sharded and replay contracts rest on it), so no float atomics.  The id
// space is cut into partitions of kPartGroups ids (the id's high bits), as
// on the TPU, but rows are first moved into partition order:
//
//   1. gs_hist        per row block: rows per partition (integer atomics;
//                     integer sums are order-free)
//   2. gs_scan_blocks per partition: exclusive prefix over row blocks
//   3. gs_scan_parts  exclusive prefix over partitions (one block)
//   4. gs_scatter     one warp per row block walks its rows in order and
//                     writes each row's index to its partition's range: a
//                     stable counting sort, so row order within a
//                     partition is the input's row order
//   5. gs_accumulate  block (partition p, slice s): thread g sweeps the
//                     slice's rows in order and adds the rows whose local
//                     id is g into its own shared-memory accumulator
//   6. gs_finalize    sums the slice partials of each cell in slice order
//
// Every float addition happens in an order fixed by the input alone.
// A row block's partition counters (passes 1 and 4) sit in shared memory
// while they fit (n_parts <= kMaxSmemParts, 48 KB), else in the block's own
// row of the histogram in global memory, which no other block touches; so
// the id space has no limit but int32.
// Bound: bytes (each row's id and values are read once and each output
// written once; the work per row is a handful of integer operations).  The
// partition pass replaces the TPU's full row sweep per partition, which
// would cost partitions x rows on a GPU.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogPartGroups = 8;
constexpr int kPartGroups = 1 << kLogPartGroups;  // ids per partition
constexpr int kTile = 1024;                       // rows staged per sweep
constexpr int kMaxSmemParts = 12288;              // int32 counters in 48 KB

__host__ __device__ __forceinline__ bool counters_in_smem(int n_parts) {
  return n_parts <= kMaxSmemParts;
}

__device__ __forceinline__ int partition_of(int32_t id, int n_groups) {
  return (id >= 0 && id < n_groups) ? (id >> kLogPartGroups) : -1;
}

__global__ void gs_hist(const int32_t* __restrict__ ids, int64_t n,
                        int n_groups, int n_parts, int64_t rows_per_block,
                        int32_t* __restrict__ hist) {
  extern __shared__ int32_t smem_cnt[];
  int32_t* row = hist + (int64_t)blockIdx.x * n_parts;
  const bool in_smem = counters_in_smem(n_parts);
  int32_t* cnt = in_smem ? smem_cnt : row;
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) cnt[p] = 0;
  __syncthreads();
  const int64_t lo = (int64_t)blockIdx.x * rows_per_block;
  const int64_t hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  for (int64_t r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const int p = partition_of(ids[r], n_groups);
    if (p >= 0) atomicAdd(&cnt[p], 1);
  }
  if (!in_smem) return;
  __syncthreads();
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) row[p] = cnt[p];
}

__global__ void gs_scan_blocks(int32_t* __restrict__ hist, int n_blocks,
                               int n_parts, int32_t* __restrict__ totals) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_parts) return;
  int32_t run = 0;
  for (int b = 0; b < n_blocks; ++b) {
    const int64_t k = (int64_t)b * n_parts + p;
    const int32_t c = hist[k];
    hist[k] = run;
    run += c;
  }
  totals[p] = run;
}

// one block of 1024 threads: exclusive scan of base[0, n_parts) in place,
// base[n_parts] = total
__global__ void gs_scan_parts(int32_t* __restrict__ base, int n_parts) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n_parts; t0 += 1024) {
    const int i = t0 + tid;
    const int32_t v = i < n_parts ? base[i] : 0;
    int32_t x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int32_t excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < n_parts) base[i] = excl;
    __syncthreads();
    if (tid == 1023) carry = excl + v;
    __syncthreads();
  }
  if (tid == 0) base[n_parts] = carry;
}

// one warp per row block; rows are taken 32 at a time in order, and lanes
// of one partition are ranked by lane, so the scatter is stable.  The
// block's counters start at its offsets (its row of block_off) and advance
// as its rows are placed; the row itself serves when they are not in shared
// memory (the histogram has no later reader)
__global__ void gs_scatter(const int32_t* __restrict__ ids, int64_t n,
                           int n_groups, int n_parts, int64_t rows_per_block,
                           int32_t* __restrict__ block_off,
                           const int32_t* __restrict__ base,
                           int32_t* __restrict__ perm,
                           int32_t* __restrict__ local_id) {
  extern __shared__ int32_t smem_cnt[];
  const int lane = threadIdx.x;
  int32_t* row = block_off + (int64_t)blockIdx.x * n_parts;
  const bool in_smem = counters_in_smem(n_parts);
  volatile int32_t* cnt = in_smem ? smem_cnt : row;
  if (in_smem)
    for (int p = lane; p < n_parts; p += 32) cnt[p] = row[p];
  __syncwarp();
  const int64_t lo = (int64_t)blockIdx.x * rows_per_block;
  const int64_t hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  for (int64_t r0 = lo; r0 < hi; r0 += 32) {
    const int64_t r = r0 + lane;
    const int32_t id = r < hi ? ids[r] : -1;
    const int p = partition_of(id, n_groups);
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    const int leader = __ffs(peers) - 1;
    if (p >= 0) {
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int32_t pos = base[p] + cnt[p] + rank;
      perm[pos] = (int32_t)r;
      local_id[pos] = id & (kPartGroups - 1);
    }
    __syncwarp();
    if (p >= 0 && lane == leader) cnt[p] += __popc(peers);
    __syncwarp();
  }
}

// grid (partition, slice), kPartGroups threads; dynamic shared memory:
// acc[n_cols][kPartGroups] floats, then two kTile int32 staging arrays
__global__ void gs_accumulate(const int32_t* __restrict__ perm,
                              const int32_t* __restrict__ local_id,
                              const int32_t* __restrict__ base,
                              const float* __restrict__ values, int C,
                              int with_counts, int n_slices, int64_t g_pad,
                              float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int n_cols = C + with_counts;
  float* acc = smem;
  int32_t* tile_lid = reinterpret_cast<int32_t*>(acc + n_cols * kPartGroups);
  int32_t* tile_row = tile_lid + kTile;
  const int p = blockIdx.x, s = blockIdx.y, g = threadIdx.x;
  for (int c = 0; c < n_cols; ++c) acc[c * kPartGroups + g] = 0.0f;
  const int64_t s0 = base[p], len = (int64_t)base[p + 1] - s0;
  const int64_t per = (len + n_slices - 1) / n_slices;
  const int64_t a = (int64_t)s * per, b = (int64_t)(s + 1) * per;
  const int64_t lo = s0 + (a < len ? a : len), hi = s0 + (b < len ? b : len);
  for (int64_t t0 = lo; t0 < hi; t0 += kTile) {
    const int m = (int)(hi - t0 < kTile ? hi - t0 : kTile);
    __syncthreads();  // the previous tile is consumed
    for (int j = g; j < m; j += kPartGroups) {
      tile_lid[j] = local_id[t0 + j];
      tile_row[j] = perm[t0 + j];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      if (tile_lid[j] == g) {
        const float* row = values + (int64_t)tile_row[j] * C;
        for (int c = 0; c < C; ++c) acc[c * kPartGroups + g] += row[c];
        if (with_counts) acc[C * kPartGroups + g] += 1.0f;
      }
    }
  }
  float* out = partials + ((int64_t)s * g_pad + (int64_t)p * kPartGroups + g) * n_cols;
  for (int c = 0; c < n_cols; ++c) out[c] = acc[c * kPartGroups + g];
}

__global__ void gs_finalize(const float* __restrict__ partials, int n_slices,
                            int64_t g_pad, int n_groups, int C,
                            int with_counts, float* __restrict__ sums,
                            float* __restrict__ counts) {
  const int n_cols = C + with_counts;
  const int64_t total = (int64_t)n_groups * n_cols;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < total;
       k += stride) {
    const int64_t g = k / n_cols;
    const int c = (int)(k % n_cols);
    float v = 0.0f;
    for (int s = 0; s < n_slices; ++s)
      v += partials[((int64_t)s * g_pad + g) * n_cols + c];
    if (c < C)
      sums[g * C + c] = v;
    else
      counts[g] = v;
  }
}

// Workspace (allocated by the caller, sizes from the same plan):
//   iws int32: hist[n_blocks * n_parts], base[n_parts + 1], perm[n],
//              local_id[n]
//   fws float: partials[n_slices * g_pad * (C + with_counts)]
inline cudaError_t grouped_sum_launch(const int32_t* ids, const float* values,
                                      int64_t n, int C, int n_groups,
                                      int with_counts, int64_t rows_per_block,
                                      int n_slices, int32_t* iws, float* fws,
                                      float* sums, float* counts,
                                      cudaStream_t stream) {
  if (n_groups <= 0) return cudaGetLastError();
  const int n_parts = (n_groups + kPartGroups - 1) / kPartGroups;
  const int64_t g_pad = (int64_t)n_parts * kPartGroups;
  int64_t n_blocks = (n + rows_per_block - 1) / rows_per_block;
  if (n_blocks < 1) n_blocks = 1;
  int32_t* hist = iws;
  int32_t* base = hist + n_blocks * n_parts;
  int32_t* perm = base + n_parts + 1;
  int32_t* local_id = perm + n;
  const size_t cnt_bytes =
      counters_in_smem(n_parts) ? (size_t)n_parts * sizeof(int32_t) : 0;
  gs_hist<<<(unsigned)n_blocks, 256, cnt_bytes, stream>>>(
      ids, n, n_groups, n_parts, rows_per_block, hist);
  gs_scan_blocks<<<(n_parts + 255) / 256, 256, 0, stream>>>(
      hist, (int)n_blocks, n_parts, base);
  gs_scan_parts<<<1, 1024, 0, stream>>>(base, n_parts);
  gs_scatter<<<(unsigned)n_blocks, 32, cnt_bytes, stream>>>(
      ids, n, n_groups, n_parts, rows_per_block, hist, base, perm, local_id);
  const int n_cols = C + with_counts;
  const size_t acc_bytes =
      (size_t)n_cols * kPartGroups * sizeof(float) + 2 * kTile * sizeof(int32_t);
  gs_accumulate<<<dim3(n_parts, n_slices), kPartGroups, acc_bytes, stream>>>(
      perm, local_id, base, values, C, with_counts, n_slices, g_pad, fws);
  const int64_t cells = (int64_t)n_groups * n_cols;
  int64_t fin_blocks = (cells + 255) / 256;
  if (fin_blocks < 1) fin_blocks = 1;
  if (fin_blocks > 65535LL * 8) fin_blocks = 65535LL * 8;
  gs_finalize<<<(unsigned)fin_blocks, 256, 0, stream>>>(
      fws, n_slices, g_pad, n_groups, C, with_counts, sums, counts);
  return cudaGetLastError();
}

}  // namespace

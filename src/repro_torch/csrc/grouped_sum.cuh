// Deterministic grouped float32 sums over dense int32 group ids (sm_90a).
//
// Device code shared by radix_groupby.cu (sums + counts) and segment_sum.cu
// (sums only).  Every kernel lives in an anonymous namespace, so each
// translation unit that includes this header gets its own copy.
//
// Contract: ids[N] int32, a row with id outside [0, n_groups) is padding;
// values[N, C] float32, row r at values + r * ldv, 0 <= C <= 32 and
// ldv >= C.  out sums[g, c] (row g at sums + g * lds) = sum of values[r, c]
// over rows with ids[r] == g; counts[g] = number of such rows (float32).
// cols = C + (1 if counts).  The row strides let a caller sum a slice of
// the columns of a wider matrix into a slice of a wider output in place.
//
// Reductions must give bit-identical sums from run to run (serial vs
// sharded and replay contracts rest on it), so there are no float atomics:
// every float addition happens in an order fixed by (n, n_groups, C) and the
// input alone.  Integer atomics (the partition histogram) are order-free.
//
// Two routes, chosen from the shapes alone (direct_route):
//
// Direct route, when a warp's partial [n_groups, cols] fits kDirectFloats
// (8 warps in 48 KB): no sort, one cooperative launch, gs_direct.
//   - Block b takes rows [b R, (b + 1) R), R from n alone (the plan: about
//     two blocks per SM of 132, never more than kDirectMaxBlocks, so the
//     grid is co-resident); warp w a contiguous eighth of them.
//   - A warp takes 32 rows at a time, lane j row j (coalesced loads).
//     __match_any_sync groups the lanes by id.  A batch of one id sums over
//     the lanes in a fixed butterfly and lane 0 adds the result; otherwise
//     the rows of each id add into the warp's shared partial one per round,
//     in lane (row) order, and a round's lanes hold distinct ids, so no two
//     touch one cell.
//   - The block sums its 8 warp partials in warp order into its column of
//     the block partials [cells, blocks]; after a grid-wide barrier, one
//     warp per cell sums the cell's row in a fixed order (lane l the blocks
//     l, l + 32, ..., then a butterfly over the lanes).
//   This replaces the TPU's one-hot matmul with fp32 adds in a fixed order.
//   At the SSB shapes (about 0.2 us of bytes) launches and latency are the
//   limit, so the route spends one launch and keeps every row's work off a
//   serial chain: a warp's 32 rows take one load and a few rounds.
//
// Partitioned route, for larger id spaces: the id space is cut into
// partitions of kPartGroups ids (the id's high bits), as on the TPU, and
// rows are first moved into partition order:
//   1. gs_hist        per row block: rows per partition (integer atomics)
//   2. gs_scan_blocks one warp per partition: exclusive prefix over row
//                     blocks, 32 blocks a step
//   3. gs_scan_parts  exclusive prefix over partitions (one block)
//   4. gs_scatter     one warp per row block walks its rows in order and
//                     writes each row's index to its partition's range: a
//                     stable counting sort, so row order within a
//                     partition is the input's row order
//   5. gs_accumulate  block (partition p, slice s): the block gathers a
//                     tile of the slice's rows into shared memory, then
//                     thread g sweeps it in order and adds the rows whose
//                     local id is g into its own accumulator
//   6. gs_finalize    sums the slice partials of each cell in slice order
// A row block's partition counters (passes 1 and 4) sit in shared memory
// while they fit (n_parts <= kMaxSmemParts, 48 KB), else in the block's own
// row of the histogram in global memory, which no other block touches; so
// the id space has no limit but int32.
//
// Bound: bytes (each row's id and values are read once and each output
// written once; the work per row is a handful of operations).  The
// partition pass replaces the TPU's full row sweep per partition, which
// would cost partitions x rows on a GPU.
#pragma once
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogPartGroups = 8;
constexpr int kPartGroups = 1 << kLogPartGroups;  // ids per partition
constexpr int kTile = 1024;                       // rows staged per sweep
constexpr int kTileFloats = 2048;                 // their values, at most
constexpr int kScatterBatches = 8;                // id loads in flight
constexpr int kMaxSmemParts = 12288;              // int32 counters in 48 KB
constexpr int kDirectWarps = 8;
// floats of shared memory a warp of the direct route may hold (48 KB over
// kDirectWarps): its partial of n_groups x cols
constexpr int kDirectFloats = 12288 / kDirectWarps;
// __launch_bounds__ fits kDirectMinBlocks direct-route blocks on an SM (at
// most 85 registers a thread; 48 KB of shared memory a block at most), so
// the plan's largest grid, kDirectMaxBlocks (TARGET_BLOCKS), is co-resident,
// as a cooperative launch needs, on any card of 88 SMs or more
constexpr int kDirectMinBlocks = 3;
constexpr int kDirectMaxBlocks = 264;

__host__ __device__ __forceinline__ bool direct_route(int n_groups, int cols) {
  return (int64_t)n_groups * cols <= kDirectFloats;
}

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

// one warp per partition: exclusive prefix of hist[:, p] over the row
// blocks, in place, 32 blocks a step with the carry in a register;
// totals[p] = the partition's rows
__global__ void gs_scan_blocks(int32_t* __restrict__ hist, int n_blocks,
                               int n_parts, int32_t* __restrict__ totals) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= n_parts) return;  // the whole warp
  int32_t carry = 0;
  for (int b0 = 0; b0 < n_blocks; b0 += 32) {
    const int b = b0 + lane;
    const int64_t k = (int64_t)b * n_parts + p;
    const int32_t v = b < n_blocks ? hist[k] : 0;
    int32_t x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (b < n_blocks) hist[k] = carry + x - v;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) totals[p] = carry;
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
  for (int64_t r1 = lo; r1 < hi; r1 += 32 * kScatterBatches) {
    // the ids of kScatterBatches batches load together, so the walk waits
    // on memory once per kScatterBatches batches
    int32_t batch_id[kScatterBatches];
#pragma unroll
    for (int u = 0; u < kScatterBatches; ++u) {
      const int64_t r = r1 + 32 * u + lane;
      batch_id[u] = r < hi ? ids[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < kScatterBatches; ++u) {
      const int64_t r = r1 + 32 * u + lane;
      const int32_t id = batch_id[u];
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
}

// grid (partition, slice), kPartGroups threads; dynamic shared memory:
// acc[n_cols][kPartGroups] floats, then the tile's local ids (kTile int32)
// and values (kTileFloats floats).  A tile's rows are gathered by all
// threads at once, so the walk over them waits on shared memory only
__global__ void gs_accumulate(const int32_t* __restrict__ perm,
                              const int32_t* __restrict__ local_id,
                              const int32_t* __restrict__ base,
                              const float* __restrict__ values, int64_t ldv,
                              int C, int with_counts, int n_slices,
                              int64_t g_pad,
                              float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int n_cols = C + with_counts;
  float* acc = smem;
  int32_t* tile_lid = reinterpret_cast<int32_t*>(acc + n_cols * kPartGroups);
  float* tile_val = reinterpret_cast<float*>(tile_lid + kTile);
  const int tile_rows = C > 0 && kTileFloats / C < kTile ? kTileFloats / C
                                                          : kTile;
  const int p = blockIdx.x, s = blockIdx.y, g = threadIdx.x;
  for (int c = 0; c < n_cols; ++c) acc[c * kPartGroups + g] = 0.0f;
  const int64_t s0 = base[p], len = (int64_t)base[p + 1] - s0;
  const int64_t per = (len + n_slices - 1) / n_slices;
  const int64_t a = (int64_t)s * per, b = (int64_t)(s + 1) * per;
  const int64_t lo = s0 + (a < len ? a : len), hi = s0 + (b < len ? b : len);
  for (int64_t t0 = lo; t0 < hi; t0 += tile_rows) {
    const int m = (int)(hi - t0 < tile_rows ? hi - t0 : tile_rows);
    __syncthreads();  // the previous tile is consumed
    for (int j = g; j < m; j += kPartGroups) tile_lid[j] = local_id[t0 + j];
    for (int k = g; k < m * C; k += kPartGroups) {
      const int j = k / C;
      tile_val[k] = values[(int64_t)perm[t0 + j] * ldv + (k - j * C)];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      if (tile_lid[j] == g) {
        for (int c = 0; c < C; ++c)
          acc[c * kPartGroups + g] += tile_val[j * C + c];
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
                            int64_t lds, float* __restrict__ counts) {
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
      sums[g * lds + c] = v;
    else
      counts[g] = v;
  }
}

// cell k = g * cols + c of the output: sums[g, c] or, for c == C, counts[g]
__device__ __forceinline__ void store_cell(int k, int C, int cols, float v,
                                           float* __restrict__ sums,
                                           int64_t lds,
                                           float* __restrict__ counts) {
  const int g = k / cols, c = k - g * cols;
  if (c < C)
    sums[(int64_t)g * lds + c] = v;
  else
    counts[g] = v;
}

// Direct route: lane j takes row r0 + j of a batch of 32, its id (-1 for
// padding and past hi) and its C values
__device__ __forceinline__ int32_t load_row(const int32_t* __restrict__ ids,
                                            const float* __restrict__ values,
                                            int64_t ldv, int64_t r,
                                            int64_t hi, int C,
                                            int n_groups, float (&x)[32]) {
  int32_t g = r < hi ? ids[r] : -1;
  if (g >= n_groups) g = -1;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (c >= C) break;
    x[c] = g >= 0 ? values[r * ldv + c] : 0.0f;
  }
  return g;
}

// Direct route: add a batch's rows into the warp's partial, each cell's
// rows in lane (row) order.  A batch of one group reduces over the lanes
// first, in a fixed butterfly.
__device__ __forceinline__ void add_batch(float* __restrict__ part, int cols,
                                          int C, int with_counts, int lane,
                                          int32_t g, float (&x)[32]) {
  const unsigned peers = __match_any_sync(0xffffffffu, g);
  if (peers == 0xffffffffu) {  // the same in every lane
    if (g < 0) return;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      if (c >= C) break;
      for (int o = 16; o > 0; o >>= 1)
        x[c] += __shfl_xor_sync(0xffffffffu, x[c], o);
    }
    if (lane == 0) {
      float* cell = part + g * cols;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        if (c >= C) break;
        cell[c] += x[c];
      }
      if (with_counts) cell[C] += 32.0f;
    }
    __syncwarp();  // the next batch's lanes see lane 0's adds
    return;
  }
  // one row of each group a round, in lane order: a round's lanes hold
  // distinct groups, so no two touch the same cell
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int rounds = (int)__reduce_max_sync(0xffffffffu, __popc(peers));
  for (int k = 0; k < rounds; ++k) {
    if (rank == k && g >= 0) {
      float* cell = part + g * cols;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        if (c >= C) break;
        cell[c] += x[c];
      }
      if (with_counts) cell[C] += 1.0f;
    }
    __syncwarp();
  }
}

// Direct route: one cooperative launch.  Dynamic shared memory:
// kDirectWarps partials of n_groups * cols floats.  Pass 1: each warp adds
// its rows into its partial; the block sums its warps' partials in warp
// order into its column of block_part [cells, blocks] (or, as the only
// block, into the output).  Pass 2, after a grid-wide barrier: one warp per
// cell sums the cell's row in a fixed order (lane l the blocks l, l + 32,
// ... in turn, then a butterfly over the lanes).  kDirectMinBlocks blocks
// fit an SM, so the plan's grid (at most kDirectMaxBlocks) is co-resident.
__global__ void __launch_bounds__(kDirectWarps * 32, kDirectMinBlocks)
    gs_direct(const int32_t* __restrict__ ids, const float* __restrict__ values,
              int64_t ldv, int64_t n, int C, int n_groups, int with_counts,
              int64_t rows_per_block, float* __restrict__ block_part,
              float* __restrict__ sums, int64_t lds,
              float* __restrict__ counts) {
  extern __shared__ float smem[];
  const int cols = C + with_counts;
  const int cells = n_groups * cols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* part = smem + warp * cells;
  for (int k = lane; k < cells; k += 32) part[k] = 0.0f;
  __syncwarp();
  const int64_t per_warp = rows_per_block / kDirectWarps;
  const int64_t lo = (int64_t)blockIdx.x * rows_per_block + warp * per_warp;
  const int64_t hi = lo + per_warp < n ? lo + per_warp : n;
  for (int64_t r0 = lo; r0 < hi; r0 += 32) {
    float x[32];
    const int32_t g = load_row(ids, values, ldv, r0 + lane, hi, C, n_groups, x);
    add_batch(part, cols, C, with_counts, lane, g, x);
  }
  __syncthreads();
  const bool single = gridDim.x == 1;
  for (int k = threadIdx.x; k < cells; k += kDirectWarps * 32) {
    float v = smem[k];
    for (int w = 1; w < kDirectWarps; ++w) v += smem[w * cells + k];
    if (single)
      store_cell(k, C, cols, v, sums, lds, counts);
    else
      block_part[(int64_t)k * gridDim.x + blockIdx.x] = v;
  }
  if (single) return;
  __threadfence();
  cooperative_groups::this_grid().sync();
  const int n_blocks = gridDim.x;
  for (int k = blockIdx.x * kDirectWarps + warp; k < cells;
       k += n_blocks * kDirectWarps) {
    const float* cell = block_part + (int64_t)k * n_blocks;
    float v = 0.0f;
    for (int b = lane; b < n_blocks; b += 32) v += cell[b];
    // every lane ends with the same sum: each step adds the same two values
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) store_cell(k, C, cols, v, sums, lds, counts);
  }
}

// rows_per_block and n_slices come from the caller's plan
// (kernels/_grouped_sum.py), which makes the same route choice.  Workspace
// (allocated by the caller, sizes from the same plan):
//   direct route: fws float: block partials[n_groups * cols, n_blocks]
//                 when n_blocks > 1 (n_blocks <= kDirectMaxBlocks); iws
//                 unused
//   partitioned:  iws int32: hist[n_blocks * n_parts], base[n_parts + 1],
//                            perm[n], local_id[n]
//                 fws float: partials[n_slices * g_pad * cols]
inline cudaError_t grouped_sum_launch(const int32_t* ids, const float* values,
                                      int64_t ldv, int64_t n, int C,
                                      int n_groups, int with_counts,
                                      int64_t rows_per_block, int n_slices,
                                      int32_t* iws, float* fws, float* sums,
                                      int64_t lds, float* counts,
                                      cudaStream_t stream) {
  if (n_groups <= 0) return cudaGetLastError();
  if (ldv < C || lds < C) return cudaErrorInvalidValue;
  const int n_cols = C + with_counts;
  int64_t n_blocks = (n + rows_per_block - 1) / rows_per_block;
  if (n_blocks < 1) n_blocks = 1;
  if (direct_route(n_groups, n_cols)) {
    if (n_blocks > kDirectMaxBlocks) return cudaErrorInvalidValue;
    const size_t smem =
        (size_t)kDirectWarps * n_groups * n_cols * sizeof(float);
    float* block_part = fws;
    void* args[] = {&ids,       &values,      &ldv,
                    &n,         &C,           &n_groups,
                    &with_counts, &rows_per_block, &block_part,
                    &sums,      &lds,         &counts};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gs_direct),
                                       dim3((unsigned)n_blocks),
                                       dim3(kDirectWarps * 32), args, smem,
                                       stream);
  }
  const int n_parts = (n_groups + kPartGroups - 1) / kPartGroups;
  const int64_t g_pad = (int64_t)n_parts * kPartGroups;
  int32_t* hist = iws;
  int32_t* base = hist + n_blocks * n_parts;
  int32_t* perm = base + n_parts + 1;
  int32_t* local_id = perm + n;
  const size_t cnt_bytes =
      counters_in_smem(n_parts) ? (size_t)n_parts * sizeof(int32_t) : 0;
  gs_hist<<<(unsigned)n_blocks, 256, cnt_bytes, stream>>>(
      ids, n, n_groups, n_parts, rows_per_block, hist);
  gs_scan_blocks<<<(n_parts + 7) / 8, 256, 0, stream>>>(
      hist, (int)n_blocks, n_parts, base);
  gs_scan_parts<<<1, 1024, 0, stream>>>(base, n_parts);
  gs_scatter<<<(unsigned)n_blocks, 32, cnt_bytes, stream>>>(
      ids, n, n_groups, n_parts, rows_per_block, hist, base, perm, local_id);
  const size_t acc_bytes = (size_t)n_cols * kPartGroups * sizeof(float) +
                           kTile * sizeof(int32_t) +
                           kTileFloats * sizeof(float);
  gs_accumulate<<<dim3(n_parts, n_slices), kPartGroups, acc_bytes, stream>>>(
      perm, local_id, base, values, ldv, C, with_counts, n_slices, g_pad,
      fws);
  const int64_t cells = (int64_t)n_groups * n_cols;
  int64_t fin_blocks = (cells + 255) / 256;
  if (fin_blocks < 1) fin_blocks = 1;
  if (fin_blocks > 65535LL * 8) fin_blocks = 65535LL * 8;
  gs_finalize<<<(unsigned)fin_blocks, 256, 0, stream>>>(
      fws, n_slices, g_pad, n_groups, C, with_counts, sums, lds, counts);
  return cudaGetLastError();
}

}  // namespace

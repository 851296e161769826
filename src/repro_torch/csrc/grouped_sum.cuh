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
// Three routes, chosen from the shapes alone (direct_route, wide_route):
//
// Direct route, when a warp's partial [n_groups, cols] fits kWideFloats:
// no sort, one cooperative launch, gs_direct.
//   - Block b takes rows [b R, (b + 1) R); warp w a contiguous eighth of
//     them.  Narrow (a partial within kDirectFloats, 8 warps in 48 KB): R
//     from n alone (the plan: about two blocks per SM of 132, never more
//     than kDirectMaxBlocks, so the grid is co-resident).  Wide (within
//     kWideFloats, 8 warps in up to 224 KB of Hopper's opt-in dynamic
//     shared memory): R from n and the grid, one block an SM (the wrapper
//     takes the SMs within the blocks the card holds at once at that
//     shared memory: the occupancy API times the SMs, gs_wide_blocks).  With
//     only 8 warps an SM left to hide the loads' latency, a wide-route
//     warp loads kWideBatches batches of 32 rows before it adds the first.
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
//   serial chain: a warp's 32 rows take one load and a few rounds.  The
//   wide route takes the supplier shard (2,000 ids with counts, 4,000
//   cells) and the supplier combiner (2,000 cells) in one launch, where the
//   partitioned route spends two and moves every row once more.
//
// Partitioned route, for id spaces beyond kWideFloats: the id space is cut
// into partitions of 2^log_w ids (the id's high bits), as on the TPU;
// log_w from the shapes (part_log_width: about kPartTarget partitions,
// within a warp partial of kWideFloats).  Two cooperative launches of 8
// warps a block, each grid what the card holds at once (the occupancy API
// times the SMs); the result depends on neither grid.
//   1. gs_partition, a stable counting sort of the rows by partition that
//      moves each row's payload (its local id and its C values, one record
//      of 1 + C words) into its partition's range:
//      a. every block counts its own contiguous rows a partition (shared
//         memory, integer atomics) into its histogram row;
//      b. grid barrier; each partition's column of the histogram is
//         prefixed over the blocks (a warp a partition); its total;
//      c. grid barrier; every block scans the totals (the partitions'
//         starts; block 0 writes them) into its counters;
//      d. every block sorts its rows `tile` at a time in shared memory:
//         warp w counts the tile's w-th eighth a partition, the counts are
//         prefixed over partitions and warps, then each warp walks its rows
//         again, grouping a batch of 32 by partition (a bit mask a
//         partition, mask_peers), and a row's slot is its warp's counter
//         plus the lanes of its partition below it; the tile's runs, one a
//         partition, go out whole to the
//         block's place in each partition's range.  So rows keep their
//         input order within a partition (lane, batch, warp, tile, block),
//         and the records are written as runs, not one sector a row.
//      Where the block's 18 n_parts counters leave no room for a tile of
//      kTileMin rows, each warp's rows count into a row of the histogram
//      in global memory (the plan's GLOBAL_HIST entries at most, so fewer
//      warps take rows) and records go straight to rec.
//   2. gs_accumulate, over (partition, slice) items, a block an item at a
//      time: the item's rows are contiguous records in row order; warp w
//      takes the w-th contiguous run of them, 32 rows at a time, into its
//      own shared partial of 2^log_w ids x cols (add_batch, as the direct
//      route); the block sums its warps in warp order.  With one slice a
//      partition (the plan's n_slices, from the shapes: more only where
//      partitions are few and long) the block writes the output; otherwise
//      it writes the slice's partial and, after a grid barrier, each output
//      cell is the sum of its slices in slice order.  Every output cell is
//      written, empty ones as 0.
// The order of every float addition depends on the rows' order within a
// partition (the input's), log_w, n_slices and kPartWarps (the shapes),
// never on the grids.  No float atomics; integer atomics only count (1a,
// 1d).  One and two value columns have instances of their own (their
// column loops compiled out).
//
// Bound: bytes.  Each row's id and values are read once and each output
// written once; the route reads the ids twice more and writes and reads
// each record once (about 12 + 12 (1 + C) bytes a row beside the bound's
// 4 + 4 C).  It is held back by instructions and latency a batch of 32
// rows (the partition and warp-partial counters, __match_any_sync), not
// by bytes (PERF.md).  It replaces the TPU's sweep of every row per
// partition, which would cost partitions x rows on a GPU.
#pragma once
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <initializer_list>
#include <mutex>

namespace {

constexpr int kDirectWarps = 8;
// floats of shared memory a warp of the narrow direct route may hold (48 KB
// over kDirectWarps): its partial of n_groups x cols
constexpr int kDirectFloats = 12288 / kDirectWarps;
// __launch_bounds__ fits kDirectMinBlocks narrow blocks on an SM (at most
// 85 registers a thread; 48 KB of shared memory a block at most), so the
// plan's largest grid, kDirectMaxBlocks (TARGET_BLOCKS), is co-resident,
// as a cooperative launch needs, on any card of 88 SMs or more
constexpr int kDirectMinBlocks = 3;
constexpr int kDirectMaxBlocks = 264;
// floats a warp of the wide route may hold: 8 warps in 224 KB of the
// 227 KB a block may opt into on Hopper (WIDE_FLOATS)
constexpr int kWideFloats = 7168;
// batches of 32 rows a wide-route warp loads before it adds
constexpr int kWideBatches = 8;
// cells a warp sums at a time after the grid barrier
constexpr int kFinalCells = 8;
// value columns a wide-route instance keeps kWideBatches batches of in
// registers; more columns take the instance of 2 batches of 32 columns
constexpr int kWideFewCols = 4;
// the partitioned route: warps a block of both kernels (PART_WARPS); an
// accumulate block's warps fix the order of its float additions
constexpr int kPartWarps = 8;
constexpr int kPartThreads = kPartWarps * 32;
// a partition block's dynamic shared memory at most: 216 KB, beside its
// 4 KB of static shared memory within Hopper's 227 KB (PART_SMEM_BYTES);
// and the most that leaves room for a second block on an SM, which a tile
// of kTileTwo rows or more takes (PART_SMEM_TWO, TILE_TWO)
constexpr int kPartSmemBytes = 221184;
constexpr int kPartSmemTwo = 110592;
constexpr int kTileTwo = 2048;
// rows a partition block sorts in shared memory at a time: at most, and
// at least where its counters leave room (else counters in global memory)
constexpr int kTileMax = 4096;
constexpr int kTileMin = 1024;
// partitions a block scans at a time after the second grid barrier
constexpr int kScanChunk = 4 * kPartThreads;
// histogram entries a lane loads at once in the scan over the blocks
constexpr int kScanLoads = 8;
// batches of 32 ids a partition-pass warp loads before it counts them
constexpr int kHistBatches = 8;
// a partition block's rows at least (8 batches a warp), so small inputs
// take few blocks
constexpr int kPartMinRows = 8 * kPartThreads;
// log2 of a partition's ids: 4,096 at most, 32 at least (part_log_width)
constexpr int kPartLogMax = 12;
constexpr int kPartLogMin = 5;
// partitions the width aims for at most (PART_TARGET)
constexpr int kPartTarget = 256;

// one cooperative launch (the narrow or the wide route)
__host__ __device__ __forceinline__ bool direct_route(int n_groups, int cols) {
  return (int64_t)n_groups * cols <= kWideFloats;
}

// the direct route's partials past 48 KB of shared memory
__host__ __device__ __forceinline__ bool wide_route(int n_groups, int cols) {
  return direct_route(n_groups, cols) &&
         (int64_t)n_groups * cols > kDirectFloats;
}

// rows a partition block sorts at a time in shared memory (part_tile):
// the most, a multiple of 256 up to kTileMax, whose records of 1 + C words
// and slots fit beside the block's 18 n_parts + 1 counters and masks in
// kPartSmemTwo (two blocks an SM) where that leaves kTileTwo rows, else in
// kPartSmemBytes; 0 (counters in global memory) below kTileMin
__host__ __device__ __forceinline__ int part_tile_in(int n_parts, int C,
                                                     int64_t bytes) {
  const int64_t free_bytes =
      bytes - (18 * (int64_t)n_parts + 1) * (int64_t)sizeof(int32_t);
  int64_t t = free_bytes > 0 ? free_bytes / ((2 + C) * sizeof(int32_t)) : 0;
  t = t / 256 * 256;
  return (int)(t > kTileMax ? kTileMax : t);
}
__host__ __device__ __forceinline__ int part_tile(int n_parts, int C) {
  const int two = part_tile_in(n_parts, C, kPartSmemTwo);
  if (two >= kTileTwo) return two;
  const int one = part_tile_in(n_parts, C, kPartSmemBytes);
  return one >= kTileMin ? one : 0;
}

// log2 of the ids a partition holds (part_width): the fewest, a power of
// two of 32 or more, that cut n_groups ids into kPartTarget partitions at
// most, within the most whose warp partial of ids x cols floats fits
// kWideFloats (4,096 at one column, 2,048 at two or three, 128 at 33).
// Fewer partitions cut the partition pass's work a partition; narrower
// ones the accumulate pass's partials
__host__ __device__ __forceinline__ int part_log_width(int n_groups,
                                                       int cols) {
  int top = kPartLogMax;
  while (top > kPartLogMin && (1 << top) * cols > kWideFloats) --top;
  int l = kPartLogMin;
  while (l < top && ((int64_t)n_groups + (1 << l) - 1) >> l > kPartTarget)
    ++l;
  return l;
}

__device__ __forceinline__ int partition_of(int32_t id, int n_groups,
                                            int log_w) {
  return (id >= 0 && id < n_groups) ? (id >> log_w) : -1;
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

// Direct route and partition pass: lane j takes row r of a batch of 32,
// its id (-1 for padding and past hi) and its C <= MC values.  The values
// load beside the id, not after it: a padding row's are read and never
// added or moved
template <int MC>
__device__ __forceinline__ int32_t load_row(const int32_t* __restrict__ ids,
                                            const float* __restrict__ values,
                                            int64_t ldv, int64_t r,
                                            int64_t hi, int C,
                                            int n_groups, float (&x)[MC]) {
  int32_t g = r < hi ? ids[r] : -1;
#pragma unroll
  for (int c = 0; c < MC; ++c) {
    if (c >= C) break;
    x[c] = r < hi ? values[r * ldv + c] : 0.0f;
  }
  return g < n_groups ? g : -1;
}

// Direct route: add a batch's rows into the warp's partial, each cell's
// rows in lane (row) order.  A batch of one group reduces over the lanes
// first, in a fixed butterfly.
template <int MC>
__device__ __forceinline__ void add_batch(float* __restrict__ part, int cols,
                                          int C, int with_counts, int lane,
                                          int32_t g, float (&x)[MC]) {
  const unsigned peers = __match_any_sync(0xffffffffu, g);
  if (peers == 0xffffffffu) {  // the same in every lane
    if (g < 0) return;
#pragma unroll
    for (int c = 0; c < MC; ++c) {
      if (c >= C) break;
      for (int o = 16; o > 0; o >>= 1)
        x[c] += __shfl_xor_sync(0xffffffffu, x[c], o);
    }
    if (lane == 0) {
      float* cell = part + g * cols;
#pragma unroll
      for (int c = 0; c < MC; ++c) {
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
      for (int c = 0; c < MC; ++c) {
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
// its rows into its partial, kBatches batches of 32 rows loaded at a time
// (C <= MC value columns); the block sums its warps' partials in warp
// order into its column of block_part [cells, blocks] (or, as the only
// block, into the output).  Pass 2, after a grid-wide barrier: one warp per
// cell sums the cell's row in a fixed order (lane l the blocks l, l + 32,
// ... in turn, then a butterfly over the lanes).  The narrow instance
// fits kDirectMinBlocks blocks on an SM, so the plan's grid (at most
// kDirectMaxBlocks) is co-resident; the wide ones take the grid the card
// holds (gs_wide_blocks), and the cooperative launch refuses any more.
template <int MC, int kBatches, int kMinBlocks>
__global__ void __launch_bounds__(kDirectWarps * 32, kMinBlocks)
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
  for (int64_t r1 = lo; r1 < hi; r1 += 32 * kBatches) {
    float x[kBatches][MC];
    int32_t g[kBatches];
#pragma unroll
    for (int u = 0; u < kBatches; ++u)
      g[u] = load_row<MC>(ids, values, ldv, r1 + 32 * u + lane, hi, C,
                          n_groups, x[u]);
#pragma unroll
    for (int u = 0; u < kBatches; ++u)
      if (r1 + 32 * u < hi)  // the whole warp
        add_batch<MC>(part, cols, C, with_counts, lane, g[u], x[u]);
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
  // kFinalCells cells a warp at a time, so their loads are in flight
  // together (a small grid leaves each warp many cells)
  const int n_blocks = gridDim.x;
  const int stride = n_blocks * kDirectWarps;
  for (int k0 = blockIdx.x * kDirectWarps + warp; k0 < cells;
       k0 += kFinalCells * stride) {
    float v[kFinalCells];
#pragma unroll
    for (int j = 0; j < kFinalCells; ++j) v[j] = 0.0f;
    // lane l adds the blocks l, l + 32, ... of each cell in turn
    for (int b = lane; b < n_blocks; b += 32) {
#pragma unroll
      for (int j = 0; j < kFinalCells; ++j) {
        const int k = k0 + j * stride;
        if (k < cells) v[j] += block_part[(int64_t)k * n_blocks + b];
      }
    }
#pragma unroll
    for (int j = 0; j < kFinalCells; ++j) {
      const int k = k0 + j * stride;
      if (k >= cells) break;  // the whole warp
      // every lane ends with the same sum: each step adds the same two
      // values
      for (int o = 16; o > 0; o >>= 1)
        v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
      if (lane == 0) store_cell(k, C, cols, v[j], sums, lds, counts);
    }
  }
}

// ---------------------------------------------------------------------------
// Partitioned route
// ---------------------------------------------------------------------------

// rows [lo, hi) of unit u of `units` contiguous runs of whole 32-row batches
__device__ __forceinline__ void unit_rows(int64_t n, int64_t units, int64_t u,
                                          int64_t& lo, int64_t& hi) {
  int64_t per = (n + units - 1) / units;
  per = (per + 31) & ~int64_t(31);
  lo = u * per < n ? u * per : n;
  hi = lo + per < n ? lo + per : n;
}

// Counts the rows of [lo, hi) a partition into cnt (integer atomics): a
// warp loads kHistBatches batches of 32 rows at a time, the batches at lo +
// off0, then every `stride` rows.  A batch of one partition adds 32 from
// one lane (the sort route's ascending ids), else each lane adds 1
__device__ __forceinline__ void count_rows(const int32_t* __restrict__ ids,
                                           int64_t lo, int64_t hi, int off0,
                                           int stride, int n_groups,
                                           int log_w, int32_t* cnt,
                                           int lane) {
  const int64_t step = (int64_t)stride * kHistBatches;
  int32_t id[2][kHistBatches];
#pragma unroll
  for (int k = 0; k < kHistBatches; ++k) {
    const int64_t r = lo + off0 + (int64_t)k * stride + lane;
    id[0][k] = r < hi ? ids[r] : -1;
  }
  for (int64_t r1 = lo + off0; r1 < hi; r1 += step) {
    // the next batches' loads go out before this batch's atomics
#pragma unroll
    for (int k = 0; k < kHistBatches; ++k) {
      const int64_t r = r1 + step + (int64_t)k * stride + lane;
      id[1][k] = r < hi ? ids[r] : -1;
    }
#pragma unroll
    for (int k = 0; k < kHistBatches; ++k) {
      const int p = partition_of(id[0][k], n_groups, log_w);
      const int p0 = __shfl_sync(0xffffffffu, p, 0);
      if (__all_sync(0xffffffffu, p == p0)) {
        if (lane == 0 && p0 >= 0) atomicAdd(cnt + p0, 32);
      } else if (p >= 0) {
        atomicAdd(cnt + p, 1);
      }
      id[0][k] = id[1][k];
    }
  }
}

// The lanes of a batch in the same partition as this one (all of them, with
// no __match_any_sync, when the batch has one partition)
__device__ __forceinline__ unsigned partition_peers(int p) {
  const int p0 = __shfl_sync(0xffffffffu, p, 0);
  return __all_sync(0xffffffffu, p == p0) ? 0xffffffffu
                                          : __match_any_sync(0xffffffffu, p);
}

// The same from a warp's bit masks a partition in shared memory (all 0
// between batches): each lane ORs its bit into its partition's mask, reads
// it back, and the partition's lowest lane clears it.  A bitwise OR does
// not depend on the order the lanes' atomics land in; on an NVIDIA H100
// 80GB HBM3 at 700 W this took about a tenth off the partition pass
// against __match_any_sync (PERF.md)
__device__ __forceinline__ unsigned mask_peers(int p, int32_t* masks,
                                               int lane) {
  const int p0 = __shfl_sync(0xffffffffu, p, 0);
  if (__all_sync(0xffffffffu, p == p0)) return 0xffffffffu;
  if (p >= 0) atomicOr(reinterpret_cast<unsigned*>(masks) + p, 1u << lane);
  __syncwarp();
  const unsigned peers =
      p >= 0 ? reinterpret_cast<volatile unsigned*>(masks)[p] : 0u;
  __syncwarp();
  if (p >= 0 && (peers & ((1u << lane) - 1u)) == 0) masks[p] = 0;
  return peers;
}

// One warp's rows [lo, hi), in order, 32 at a time (kBatches batches of ids
// and their C <= MC values loaded together).  Each row's slot is its
// warp's counter for its partition, cnt[p], plus the lanes of its
// partition below it; cnt[p] then advances by the batch's rows of p, so
// rows keep their order within a partition.  The row's record (its local
// id, then its values) goes to slot j: with kStaged, to the block's
// staging area stage[j] (spos[j]: its place in rec, cnt_blk[p] + j -
// start[p]); else straight to rec[j]
template <int MC, int kBatches, bool kStaged>
__device__ __forceinline__ void scatter_rows(
    const int32_t* __restrict__ ids, const float* __restrict__ values,
    int64_t ldv, int64_t lo, int64_t hi, int C, int n_groups, int log_w,
    int32_t* counters, const int32_t* cnt_blk, const int32_t* start,
    int32_t* spos, int32_t* masks, float* __restrict__ out, int lane) {
  volatile int32_t* cnt = counters;
  const int R = 1 + C;
  const int64_t step = 32 * kBatches;
  int32_t id[2][kBatches];
  float x[2][kBatches][MC];
#pragma unroll
  for (int k = 0; k < kBatches; ++k)
    id[0][k] = load_row<MC>(ids, values, ldv, lo + 32 * k + lane, hi, C,
                            n_groups, x[0][k]);
  for (int64_t r1 = lo; r1 < hi; r1 += step) {
    // the next batches' loads go out before this batch's work
#pragma unroll
    for (int k = 0; k < kBatches; ++k)
      id[1][k] = load_row<MC>(ids, values, ldv, r1 + step + 32 * k + lane,
                              hi, C, n_groups, x[1][k]);
#pragma unroll
    for (int k = 0; k < kBatches; ++k) {
      if (r1 + 32 * k >= hi) break;  // the whole warp
      const int p = partition_of(id[0][k], n_groups, log_w);
      const unsigned peers = kStaged ? mask_peers(p, masks, lane)
                                     : partition_peers(p);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int32_t n_p = __popc(peers);
      int32_t first = 0;
      if (p >= 0) {
        first = cnt[p];
        const int32_t j = first + rank;
        float* rec = out + (int64_t)j * R;
        rec[0] = __int_as_float(id[0][k] & ((1 << log_w) - 1));
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          if (c >= C) break;
          rec[1 + c] = x[0][k][c];
        }
        if (kStaged) spos[j] = cnt_blk[p] + j - start[p];
      }
      __syncwarp();  // every lane has read its counter
      if (p >= 0 && rank == 0) cnt[p] = first + n_p;
      __syncwarp();  // the next batch reads the advanced counters
    }
#pragma unroll
    for (int k = 0; k < kBatches; ++k) {
      id[0][k] = id[1][k];
#pragma unroll
      for (int c = 0; c < MC; ++c) x[0][k][c] = x[1][k][c];
    }
  }
}

// Exclusive scan of load(0 .. n-1) by the whole block, kScanChunk values
// at a time (4 a thread, a warp shuffle scan, the warps' sums in order):
// emit(i, prefix) once for each i (a chunk's after its loads, so an
// in-place scan is safe).  Returns the total; ends with __syncthreads.
template <class Load, class Emit>
__device__ __forceinline__ int32_t block_scan(int n, Load load, Emit emit,
                                              int32_t* chunk_base,
                                              int32_t* warp_sum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t carry = 0;
  for (int c0 = 0; c0 < n; c0 += kScanChunk) {
    int32_t v[4], s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = c0 + 4 * (int)threadIdx.x + k;
      v[k] = i < n ? load(i) : 0;
      s += v[k];
    }
    int32_t incl = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int32_t before = 0, chunk = 0;
    for (int w = 0; w < kPartWarps; ++w) {
      const int32_t x = warp_sum[w];
      if (w < warp) before += x;
      chunk += x;
    }
    int32_t run = carry + before + incl - s;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      chunk_base[4 * threadIdx.x + k] = run;
      run += v[k];
    }
    __syncthreads();
    const int m = n - c0 < kScanChunk ? n - c0 : kScanChunk;
    for (int j = threadIdx.x; j < m; j += kPartThreads)
      emit(c0 + j, chunk_base[j]);
    carry += chunk;
    __syncthreads();  // chunk_base and warp_sum are rewritten
  }
  return carry;
}

// Pass 1: one cooperative launch of kPartWarps warps a block.
// Staged (units == 0; dynamic shared memory, int32: cnt_blk[n_parts],
// start[n_parts + 1], tc[kPartWarps][n_parts], masks[kPartWarps][n_parts],
// spos[tile], then stage [tile][1 + C] floats): block b takes the b-th of
// gridDim.x runs of rows, the histogram a row a block; its rows go out
// `tile` at a time, sorted by partition in shared memory and written as
// runs.  Global (units > 0): the
// histogram's `units` rows are the counters of as many runs of rows, in
// global memory, taken by the warps in turn, which write each record
// straight to rec.  Writes totals[n_parts] (scratch), base[n_parts + 1]
// (the partitions' starts, then the rows kept) and rec[rows kept][1 + C].
template <int MC, int kBatches, int kMinBlocks, bool kExact>
__global__ void __launch_bounds__(kPartThreads, kMinBlocks)
    gs_partition(const int32_t* __restrict__ ids,
                 const float* __restrict__ values, int64_t ldv, int64_t n,
                 int C, int n_groups, int log_w, int n_parts, int units,
                 int tile, int32_t* __restrict__ hist,
                 int32_t* __restrict__ totals, int32_t* __restrict__ base,
                 float* __restrict__ rec) {
  if (kExact) C = MC;  // the instance's column count, known to the compiler
  extern __shared__ int32_t smem_i[];
  __shared__ int32_t chunk_base[kScanChunk];
  __shared__ int32_t warp_sum[kPartWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool staged = units == 0;
  const int n_warps = gridDim.x * kPartWarps;
  const int gwarp = blockIdx.x * kPartWarps + warp;
  const int rows = staged ? (int)gridDim.x : units;  // histogram rows
  const int R = 1 + C;
  int32_t* cnt_blk = smem_i;
  int32_t* start = cnt_blk + n_parts;
  int32_t* tc = start + n_parts + 1;
  int32_t* masks = tc + kPartWarps * n_parts;
  int32_t* spos = masks + kPartWarps * n_parts;
  float* stage = reinterpret_cast<float*>(spos + tile);
  int64_t lo = 0, hi = 0;

  // 1a. counts a partition: the block's (its warps take turns at its
  // batches) to its histogram row; or a unit's in its histogram row
  if (staged) {
    for (int p = threadIdx.x; p < n_parts; p += kPartThreads) cnt_blk[p] = 0;
    for (int k = threadIdx.x; k < kPartWarps * n_parts; k += kPartThreads)
      masks[k] = 0;
    __syncthreads();
    unit_rows(n, gridDim.x, blockIdx.x, lo, hi);
    count_rows(ids, lo, hi, 32 * warp, kPartThreads, n_groups, log_w,
               cnt_blk, lane);
    __syncthreads();
    for (int p = threadIdx.x; p < n_parts; p += kPartThreads)
      hist[(int64_t)blockIdx.x * n_parts + p] = cnt_blk[p];
  } else {
    for (int u = gwarp; u < units; u += n_warps) {
      int32_t* cnt = hist + (int64_t)u * n_parts;
      for (int p = lane; p < n_parts; p += 32) cnt[p] = 0;
      __syncwarp();
      int64_t ulo, uhi;
      unit_rows(n, units, u, ulo, uhi);
      count_rows(ids, ulo, uhi, 0, 32, n_groups, log_w, cnt, lane);
    }
  }
  __threadfence();
  cooperative_groups::this_grid().sync();

  // Entries other blocks wrote before a grid barrier are read with __ldcg
  // (from L2): this SM's L1 may hold a sector of them from before it.
  // 1b. exclusive prefix of each partition's column over the histogram's
  // rows, in place: a warp a partition, lane l its l-th of 32 segments of
  // rows (the segment's sum, a shuffle scan over the lanes, then its
  // entries in order); lane 31 writes the partition's total
  {
    const int seg_len = (rows + 31) / 32;
    const int b0 = lane * seg_len < rows ? lane * seg_len : rows;
    const int b1 = b0 + seg_len < rows ? b0 + seg_len : rows;
    for (int p = gwarp; p < n_parts; p += n_warps) {
      // kScanLoads entries at a time, loaded before any is used or stored
      int32_t local = 0;
      for (int b = b0; b < b1; b += kScanLoads) {
        int32_t v[kScanLoads];
#pragma unroll
        for (int i = 0; i < kScanLoads; ++i)
          v[i] = b + i < b1 ? __ldcg(hist + (int64_t)(b + i) * n_parts + p)
                            : 0;
#pragma unroll
        for (int i = 0; i < kScanLoads; ++i) local += v[i];
      }
      int32_t incl = local;
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      int32_t run = incl - local;
      for (int b = b0; b < b1; b += kScanLoads) {
        int32_t v[kScanLoads];
#pragma unroll
        for (int i = 0; i < kScanLoads; ++i)
          v[i] = b + i < b1 ? __ldcg(hist + (int64_t)(b + i) * n_parts + p)
                            : 0;
#pragma unroll
        for (int i = 0; i < kScanLoads; ++i) {
          if (b + i >= b1) break;
          hist[(int64_t)(b + i) * n_parts + p] = run;
          run += v[i];
        }
      }
      if (lane == 31) totals[p] = incl;
    }
  }
  __threadfence();
  cooperative_groups::this_grid().sync();

  // 1c. every block: exclusive scan of the totals (the partitions'
  // starts; block 0 writes them) and its counters: a partition's start +
  // the block's (or a unit's) histogram entry
  const int32_t kept = block_scan(
      n_parts, [&](int p) { return __ldcg(totals + p); },
      [&](int p, int32_t at) {
        if (blockIdx.x == 0) base[p] = at;
        if (staged) {
          cnt_blk[p] = at + __ldcg(hist + (int64_t)blockIdx.x * n_parts + p);
        } else {
          for (int u = blockIdx.x * kPartWarps; u < units; u += n_warps)
            for (int w = 0; w < kPartWarps && u + w < units; ++w) {
              int32_t* e = hist + (int64_t)(u + w) * n_parts + p;
              *e = __ldcg(e) + at;
            }
        }
      },
      chunk_base, warp_sum);
  if (blockIdx.x == 0 && threadIdx.x == 0) base[n_parts] = kept;

  // 1d. the records, to their partitions' ranges in row order
  if (!staged) {
    for (int u = gwarp; u < units; u += n_warps) {
      unit_rows(n, units, u, lo, hi);
      scatter_rows<MC, kBatches, false>(
          ids, values, ldv, lo, hi, C, n_groups, log_w,
          hist + (int64_t)u * n_parts, nullptr, nullptr, nullptr, nullptr,
          rec, lane);
    }
    return;
  }
  // a tile at a time: warp w's rows are the tile's w-th eighth.  Its
  // counts a partition (tc[w]); the tile's partitions' starts (start) and
  // each warp's slot a partition in warp order; the rows to their slots in
  // stage; the tile's partition runs to rec, at the block's counters,
  // which then advance
  for (int64_t t0 = lo; t0 < hi; t0 += tile) {
    const int64_t t1 = t0 + tile < hi ? t0 + tile : hi;
    int64_t sub = (t1 - t0 + kPartWarps - 1) / kPartWarps;
    sub = (sub + 31) & ~int64_t(31);
    const int64_t wlo = t0 + warp * sub < t1 ? t0 + warp * sub : t1;
    const int64_t whi = wlo + sub < t1 ? wlo + sub : t1;
    for (int k = threadIdx.x; k < kPartWarps * n_parts; k += kPartThreads)
      tc[k] = 0;
    __syncthreads();
    count_rows(ids, wlo, whi, 0, 32, n_groups, log_w, tc + warp * n_parts,
               lane);
    __syncthreads();
    for (int p = threadIdx.x; p < n_parts; p += kPartThreads) {
      int32_t run = 0;
      for (int w = 0; w < kPartWarps; ++w) {
        const int32_t c = tc[w * n_parts + p];
        tc[w * n_parts + p] = run;
        run += c;
      }
      start[p] = run;
    }
    __syncthreads();
    const int32_t m = block_scan(
        n_parts, [&](int p) { return start[p]; },
        [&](int p, int32_t at) { start[p] = at; }, chunk_base, warp_sum);
    if (threadIdx.x == 0) start[n_parts] = m;
    for (int p = threadIdx.x; p < n_parts; p += kPartThreads)
      for (int w = 0; w < kPartWarps; ++w) tc[w * n_parts + p] += start[p];
    __syncthreads();
    scatter_rows<MC, kBatches, true>(ids, values, ldv, wlo, whi, C,
                                     n_groups, log_w,
                                     tc + warp * n_parts, cnt_blk, start,
                                     spos, masks + warp * n_parts, stage,
                                     lane);
    __syncthreads();
    // each partition's run of the tile is contiguous in stage and in rec,
    // so a warp's 32 consecutive words are few runs
    for (int k = threadIdx.x; k < m * R; k += kPartThreads) {
      const int j = k / R;
      rec[(int64_t)spos[j] * R + (k - j * R)] = stage[k];
    }
    for (int p = threadIdx.x; p < n_parts; p += kPartThreads)
      cnt_blk[p] += start[p + 1] - start[p];
    __syncthreads();
  }
}

// Accumulate pass: lane j takes record r of a batch of 32 (of R = 1 + C
// words), its local id (-1 past hi) and its C <= MC values
template <int MC>
__device__ __forceinline__ int32_t load_record(const float* __restrict__ rec,
                                               int R, int64_t r, int64_t hi,
                                               int C, float (&x)[MC]) {
#pragma unroll
  for (int c = 0; c < MC; ++c) {
    if (c >= C) break;
    x[c] = r < hi ? rec[r * R + 1 + c] : 0.0f;
  }
  return r < hi ? __float_as_int(rec[r * R]) : -1;
}

// Pass 2: one cooperative launch of kPartWarps warps a block; dynamic shared
// memory: a partial of 2^log_w ids x cols floats a warp (at most
// kWideFloats, 224 KB a block).
// Block b takes the items b, b + gridDim.x, ... of n_parts x n_slices:
// item (p, s) is slice s of partition p's records (base[p] to base[p + 1],
// cut into n_slices equal runs), warp w the w-th of kPartWarps runs of the
// slice (whole 32-row batches).  The block sums its warps' partials in
// warp order into the output (n_slices == 1) or the slice's partials
// [n_slices][n_parts x 2^log_w x cols], summed after a grid barrier in
// slice order a cell a thread.
template <int MC, int kBatches, int kMinBlocks, bool kExact>
__global__ void __launch_bounds__(kPartThreads, kMinBlocks)
    gs_accumulate(const float* __restrict__ rec,
                  const int32_t* __restrict__ base, int n_parts, int C,
                  int with_counts, int n_groups, int log_w, int n_slices,
                  float* __restrict__ partials, float* __restrict__ sums,
                  int64_t lds, float* __restrict__ counts) {
  if (kExact) C = MC;  // the instance's column count, known to the compiler
  extern __shared__ float smem[];
  const int cols = C + with_counts, R = 1 + C;
  const int cells = cols << log_w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* part = smem + warp * cells;
  const int64_t slice_cells = (int64_t)n_parts * cells;
  const int items = n_parts * n_slices;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int p = item / n_slices, s = item - p * n_slices;
    {
      for (int k = lane; k < cells; k += 32) part[k] = 0.0f;
      __syncwarp();
      const int64_t p0 = base[p], len = (int64_t)base[p + 1] - p0;
      const int64_t per = (len + n_slices - 1) / n_slices;
      const int64_t a = s * per < len ? s * per : len;
      const int64_t end = p0 + (a + per < len ? a + per : len);
      int64_t q = (end - p0 - a + kPartWarps - 1) / kPartWarps;
      q = (q + 31) & ~int64_t(31);
      const int64_t lo = p0 + a + warp * q < end ? p0 + a + warp * q : end;
      const int64_t hi = lo + q < end ? lo + q : end;
      const int64_t step = 32 * kBatches;
      float x[2][kBatches][MC];
      int32_t g[2][kBatches];
#pragma unroll
      for (int k = 0; k < kBatches; ++k)
        g[0][k] = load_record<MC>(rec, R, lo + 32 * k + lane, hi, C, x[0][k]);
      for (int64_t r1 = lo; r1 < hi; r1 += step) {
        // the next batches' loads go out before this batch's adds
#pragma unroll
        for (int k = 0; k < kBatches; ++k)
          g[1][k] = load_record<MC>(rec, R, r1 + step + 32 * k + lane, hi, C,
                                    x[1][k]);
#pragma unroll
        for (int k = 0; k < kBatches; ++k)
          if (r1 + 32 * k < hi)  // the whole warp
            add_batch<MC>(part, cols, C, with_counts, lane, g[0][k],
                          x[0][k]);
#pragma unroll
        for (int k = 0; k < kBatches; ++k) {
          g[0][k] = g[1][k];
#pragma unroll
          for (int c = 0; c < MC; ++c) x[0][k][c] = x[1][k][c];
        }
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < cells; k += kPartThreads) {
      float v = smem[k];
      for (int w = 1; w < kPartWarps; ++w) v += smem[w * cells + k];
      if (n_slices > 1) {
        partials[s * slice_cells + (int64_t)p * cells + k] = v;
        continue;
      }
      const int64_t g = ((int64_t)p << log_w) + k / cols;
      const int c = k % cols;
      if (g >= n_groups) continue;  // the last partition's padding ids
      if (c < C)
        sums[g * lds + c] = v;
      else
        counts[g] = v;
    }
    __syncthreads();  // the partials are zeroed for the next item
  }
  if (n_slices == 1) return;
  __threadfence();
  cooperative_groups::this_grid().sync();
  const int64_t total = (int64_t)n_groups * cols;
  const int64_t stride = (int64_t)gridDim.x * kPartThreads;
  for (int64_t k = (int64_t)blockIdx.x * kPartThreads + threadIdx.x; k < total;
       k += stride) {
    float v = __ldcg(partials + k);
#pragma unroll 8
    for (int s = 1; s < n_slices; ++s)
      v += __ldcg(partials + s * slice_cells + k);
    const int64_t g = k / cols;
    const int c = (int)(k - g * cols);
    if (c < C)
      sums[g * lds + c] = v;
    else
      counts[g] = v;
  }
}

// the direct route's instances: narrow; wide with few columns (several
// batches in flight); wide with up to 32 columns
inline const void* narrow_kernel() {
  return reinterpret_cast<const void*>(gs_direct<32, 1, kDirectMinBlocks>);
}
inline const void* wide_kernel(int C) {
  return C <= kWideFewCols
             ? reinterpret_cast<const void*>(
                   gs_direct<kWideFewCols, kWideBatches, 1>)
             : reinterpret_cast<const void*>(gs_direct<32, 2, 1>);
}
// the partitioned route's instances: exactly 1 or 2 value columns (the
// column loops compiled out), up to kWideFewCols and up to 32; few
// columns keep 4 batches of values in flight (two partition blocks an SM
// at most 128 registers, three accumulate blocks at 85), more one batch
// (one block an SM)
#define GS_PARTITIONED_INSTANCE(kernel, min_few, C)                          \
  (C == 1   ? reinterpret_cast<const void*>(kernel<1, 4, min_few, true>)    \
   : C == 2 ? reinterpret_cast<const void*>(kernel<2, 4, min_few, true>)    \
   : C <= kWideFewCols                                                      \
       ? reinterpret_cast<const void*>(kernel<kWideFewCols, 4, min_few,     \
                                              false>)                       \
       : reinterpret_cast<const void*>(kernel<32, 1, 1, false>))
inline const void* partition_kernel(int C) {
  return GS_PARTITIONED_INSTANCE(gs_partition, 2, C);
}
inline const void* accumulate_kernel(int C) {
  return GS_PARTITIONED_INSTANCE(gs_accumulate, 3, C);
}
#undef GS_PARTITIONED_INSTANCE

// Opens the shared memory past 48 KB that the wide direct route and the
// partitioned route use (the most each instance takes) on the current
// device, once a device: the attribute call costs more than a small launch,
// so it is not made a launch
inline cudaError_t open_smem() {
  constexpr int kMaxDevices = 64;
  static bool opened[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && opened[dev])) return err;
  const int wide = kDirectWarps * kWideFloats * (int)sizeof(float);
  const struct { const void* fn; int bytes; } opt_in[] = {
      {wide_kernel(1), wide}, {wide_kernel(kWideFewCols + 1), wide}};
  for (const auto& k : opt_in) {
    err = cudaFuncSetAttribute(
        k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.bytes);
    if (err != cudaSuccess) return err;
  }
  for (int C : {1, 2, kWideFewCols, kWideFewCols + 1}) {
    err = cudaFuncSetAttribute(accumulate_kernel(C),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wide);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(partition_kernel(C),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kPartSmemBytes);
    if (err != cudaSuccess) return err;
  }
  if (dev < kMaxDevices) opened[dev] = true;
  return cudaSuccess;
}

// The blocks of `threads` threads and `smem` bytes of dynamic shared memory
// of kernel `fn` that the current device holds at once: the occupancy API
// times the SMs, asked once a (device, kernel, shared memory) and kept
inline cudaError_t coresident_blocks(const void* fn, int threads, size_t smem,
                                     int* blocks) {
  struct Entry {
    int dev;
    const void* fn;
    size_t smem;
    int blocks;
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry seen[kEntries];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_seen && i < kEntries; ++i)
      if (seen[i].dev == dev && seen[i].fn == fn && seen[i].smem == smem) {
        *blocks = seen[i].blocks;
        return cudaSuccess;
      }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = open_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  std::lock_guard<std::mutex> lock(mu);
  seen[n_seen++ % kEntries] = {dev, fn, smem, *blocks};
  return cudaSuccess;
}

// The most wide-route blocks of C value columns and n_groups * cols cells
// that the current device holds at once: blocks an SM (the occupancy API,
// at the launch's threads and shared memory) times its SMs.  The plan
// takes its grid within it, as the cooperative launch needs.
inline cudaError_t gs_wide_blocks(int C, int cols, int n_groups,
                                  int* blocks) {
  const size_t smem = (size_t)kDirectWarps * n_groups * cols * sizeof(float);
  return coresident_blocks(wide_kernel(C), kDirectWarps * 32, smem, blocks);
}

// rows_per_block, n_blocks and n_slices come from the caller's plan
// (kernels/_grouped_sum.py), which makes the same route choice.  Workspace
// (allocated by the caller, sizes from the same plan):
//   direct route: fws float: block partials[n_groups * cols, n_blocks]
//                 when n_blocks > 1 (narrow: n_blocks <= kDirectMaxBlocks;
//                 wide: within gs_wide_blocks); iws unused
//   partitioned:  n_blocks is the histogram's rows (PART_MAX_BLOCKS with
//                 counters in shared memory, else the global counters'
//                 warps);
//                 iws int32: hist[n_blocks * n_parts], totals[n_parts],
//                            base[n_parts + 1]
//                 fws float: rec[n * (1 + C)], then, when n_slices > 1,
//                            partials[n_slices * n_parts * 2^log_w * cols]
inline cudaError_t grouped_sum_launch(const int32_t* ids, const float* values,
                                      int64_t ldv, int64_t n, int C,
                                      int n_groups, int with_counts,
                                      int64_t rows_per_block, int n_blocks,
                                      int n_slices, int32_t* iws, float* fws,
                                      float* sums, int64_t lds, float* counts,
                                      cudaStream_t stream) {
  if (n_groups <= 0) return cudaGetLastError();
  if (ldv < C || lds < C || n_blocks < 1) return cudaErrorInvalidValue;
  const int n_cols = C + with_counts;
  if (direct_route(n_groups, n_cols)) {
    const bool wide = wide_route(n_groups, n_cols);
    if (!wide && n_blocks > kDirectMaxBlocks) return cudaErrorInvalidValue;
    const size_t smem =
        (size_t)kDirectWarps * n_groups * n_cols * sizeof(float);
    const void* fn = wide ? wide_kernel(C) : narrow_kernel();
    if (wide) {
      const cudaError_t err = open_smem();
      if (err != cudaSuccess) return err;
    }
    float* block_part = fws;
    void* args[] = {&ids,       &values,      &ldv,
                    &n,         &C,           &n_groups,
                    &with_counts, &rows_per_block, &block_part,
                    &sums,      &lds,         &counts};
    // a grid past what the card holds at once is refused
    // (cudaErrorCooperativeLaunchTooLarge), never run
    return cudaLaunchCooperativeKernel(fn, dim3((unsigned)n_blocks),
                                       dim3(kDirectWarps * 32), args, smem,
                                       stream);
  }
  if (n_slices < 1) return cudaErrorInvalidValue;
  int log_w = part_log_width(n_groups, n_cols);
  int n_parts = (int)(((int64_t)n_groups + (1 << log_w) - 1) >> log_w);
  int tile = part_tile(n_parts, C);
  cudaError_t err = open_smem();
  if (err != cudaSuccess) return err;
  // pass 1: the grid within what the card holds at once; staged, at most
  // n_blocks (the histogram's rows) and no more than kPartMinRows rows a
  // block ask for; with global counters enough warps for the n_blocks
  // units, within the card
  const void* part_fn = partition_kernel(C);
  const size_t part_smem =
      tile ? (18 * (size_t)n_parts + 1 + (size_t)tile * (2 + C)) *
                 sizeof(int32_t)
           : 0;
  int cap = 0;
  err = coresident_blocks(part_fn, kPartThreads, part_smem, &cap);
  if (err != cudaSuccess) return err;
  int units = tile ? 0 : n_blocks;
  int64_t grid = tile ? (n + kPartMinRows - 1) / kPartMinRows
                      : ((int64_t)n_blocks + kPartWarps - 1) / kPartWarps;
  if (tile && grid > n_blocks) grid = n_blocks;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  int32_t* hist = iws;
  int32_t* totals = hist + (int64_t)n_blocks * n_parts;
  int32_t* base = totals + n_parts;
  float* rec = fws;
  float* partials = rec + n * (1 + C);
  void* part_args[] = {&ids,    &values, &ldv,    &n,     &C,
                       &n_groups, &log_w, &n_parts, &units, &tile,
                       &hist,   &totals, &base,   &rec};
  err = cudaLaunchCooperativeKernel(part_fn, dim3((unsigned)grid),
                                    dim3(kPartThreads), part_args, part_smem,
                                    stream);
  if (err != cudaSuccess) return err;
  // pass 2: a block an item, within what the card holds at once
  const void* acc_fn = accumulate_kernel(C);
  const size_t acc_smem =
      ((size_t)kPartWarps * n_cols * sizeof(float)) << log_w;
  err = coresident_blocks(acc_fn, kPartThreads, acc_smem, &cap);
  if (err != cudaSuccess) return err;
  grid = (int64_t)n_parts * n_slices;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  void* acc_args[] = {&rec,      &base,     &n_parts, &C,
                      &with_counts, &n_groups, &log_w,  &n_slices,
                      &partials, &sums,     &lds,     &counts};
  return cudaLaunchCooperativeKernel(acc_fn, dim3((unsigned)grid),
                                     dim3(kPartThreads), acc_args, acc_smem,
                                     stream);
}

}  // namespace

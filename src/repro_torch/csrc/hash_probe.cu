// Open-addressing hash probe for the Lookup join (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hash_join/kernel.py:
// _hash_probe_kernel / hash_probe_pallas.  The table is built once on the
// host (repro_torch.kernels.hash_join.hash_build: linear probing, load
// factor <= 0.5, duplicate keys keep their first row), uploaded once per
// dimension table and packed once on the device
// (kernels/hash_join/ops.py: pack_table): slot s holds its key columns,
// then its row index (< 0: empty), then zeros, in kW(K) int32 words
// (K = 1: {key, row}, 8 bytes; K = 2, 3: 16 bytes; K = 4: 32 bytes).
// This kernel probes it for every fact row of a chunk.
//
// Result per probe row i: out_idx[i] = the build's first-occurrence row of
// the key tuple (0 on a miss), out_found[i] = 1 when the key is present.
// The probe leaves at the first key match or empty slot, or after
// max_probes slots.
//
// Bound: bytes.  Each row reads its K key columns (4 B each) and writes
// 5 B; the table stays in the 50 MB L2 (4 MB at most for the SSB scale-
// factor-1 dimensions).  What keeps the kernel from that bound is the
// latency of its dependent gathers, so the design is about loads in
// flight:
//   - Packed slots: one probe step is one aligned vector gather of the
//     slot's keys and row (one 32-byte sector), not 1 + K separate ones.
//   - Each thread takes kRows = 4 consecutive rows: one 16-byte load of
//     each key column (when the columns are 16-byte aligned), then the
//     first-slot gathers of all four rows before it resolves any of them.
//     The outputs go out as one 16-byte and one 4-byte store.
//   - K is a template parameter (1-4), so the key comparison unrolls.
//   - Every table is probed from L2 with read-only vector loads, by a grid
//     of 256-thread blocks, at most 8 an SM.  Staging the small tables
//     (SSB SF1 supplier and date, 32 and 64 KB) in shared memory measured
//     slower than this on the H100 (PERF.md).
// The TPU kernel instead ran a fixed max_probes trip count over a whole
// tile with a done-mask, because its lanes cannot branch independently.
// No atomics: the result depends on the input only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kFmixC1 = 0x85EBCA6Bu;
constexpr uint32_t kFmixC2 = 0xC2B2AE35u;
constexpr uint32_t kColMix = 0x9E3779B9u;
constexpr int kMaxKeys = 4;
constexpr int kRows = 4;  // rows a thread takes at once
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// int32 words a packed slot: K keys + the row index, padded to 8, 16 or
// 32 bytes
template <int K>
struct Slot {
  static constexpr int kW = K == 1 ? 2 : K <= 3 ? 4 : 8;
  int32_t w[kW];
};

struct Cols {
  const int32_t* col[kMaxKeys];
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kFmixC1;
  h ^= h >> 13;
  h *= kFmixC2;
  h ^= h >> 16;
  return h;
}

// one slot as one (or, K = 4, two) read-only vector load(s)
template <int K>
__device__ __forceinline__ Slot<K> fetch(const int32_t* __restrict__ tab,
                                         uint32_t s) {
  Slot<K> out;
  const int32_t* p = tab + (size_t)s * Slot<K>::kW;
  if constexpr (Slot<K>::kW == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    out.w[0] = v.x;
    out.w[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < Slot<K>::kW / 4; ++h) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p) + h);
      out.w[4 * h] = v.x;
      out.w[4 * h + 1] = v.y;
      out.w[4 * h + 2] = v.z;
      out.w[4 * h + 3] = v.w;
    }
  }
  return out;
}

// the key columns of rows [r0, r0 + kRows): one 16-byte load a column
// when the group is whole and the columns aligned, else row by row (rows
// at or past n read as 0 and are never stored)
template <int K>
__device__ __forceinline__ void load_keys(const Cols& vals, int64_t r0,
                                          int64_t n, int vec,
                                          int32_t (&key)[kRows][K]) {
  if (vec && r0 + kRows <= n) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(vals.col[c] + r0));
      key[0][c] = v.x;
      key[1][c] = v.y;
      key[2][c] = v.z;
      key[3][c] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < K; ++c)
        key[r][c] = r0 + r < n ? __ldg(vals.col[c] + r0 + r) : 0;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const int32_t* __restrict__ table, uint32_t table_mask,
                  int max_probes, Cols vals, int64_t n, int vec,
                  int32_t* __restrict__ out_idx,
                  bool* __restrict__ out_found) {
  using S = Slot<K>;
  const int64_t groups = (n + kRows - 1) / kRows;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t gi = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       gi < groups; gi += stride) {
    const int64_t r0 = gi * kRows;
    const bool whole = vec && r0 + kRows <= n;
    int32_t key[kRows][K];
    load_keys<K>(vals, r0, n, vec, key);
    uint32_t h[kRows];
    S slot[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      uint32_t x = 0;
#pragma unroll
      for (int c = 0; c < K; ++c)
        x = fmix32(x ^ ((uint32_t)key[r][c] * kColMix));
      h[r] = x;
      slot[r] = fetch<K>(table, x & table_mask);  // all in flight
    }
    int32_t idx[kRows];
    bool found[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      idx[r] = 0;
      found[r] = false;
      if (r0 + r >= n) continue;
      S sl = slot[r];
      int step = 0;
      while (step < max_probes) {
        const int32_t occ = sl.w[K];
        if (occ < 0) break;  // empty slot: the key is absent
        bool eq = true;
#pragma unroll
        for (int c = 0; c < K; ++c) eq = eq && sl.w[c] == key[r][c];
        if (eq) {
          idx[r] = occ;
          found[r] = true;
          break;
        }
        if (++step >= max_probes) break;
        sl = fetch<K>(table, (h[r] + (uint32_t)step) & table_mask);
      }
    }
    if (whole) {
      *reinterpret_cast<int4*>(out_idx + r0) =
          make_int4(idx[0], idx[1], idx[2], idx[3]);
      *reinterpret_cast<uint32_t*>(out_found + r0) =
          (uint32_t)found[0] | (uint32_t)found[1] << 8 |
          (uint32_t)found[2] << 16 | (uint32_t)found[3] << 24;
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r0 + r < n) {
          out_idx[r0 + r] = idx[r];
          out_found[r0 + r] = found[r];
        }
      }
    }
  }
}

// the current device's SM count, asked once a device
int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (count[dev] == 0) {
    int c = 0;
    if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        c <= 0)
      c = 132;
    count[dev] = c;
  }
  return count[dev];
}

template <int K>
cudaError_t launch(const int32_t* table, int64_t table_size, int max_probes,
                   const Cols& vals, int64_t n, int vec, int32_t* out_idx,
                   bool* out_found, cudaStream_t stream) {
  int64_t blocks = ((n + kRows - 1) / kRows + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sm_count() * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  hash_probe_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      table, (uint32_t)(table_size - 1), max_probes, vals, n, vec, out_idx,
      out_found);
  return cudaGetLastError();
}

}  // namespace

// table: the packed slots (16-byte aligned); v0..v3: the probe's int32
// key columns (those past n_keys unused).
extern "C" int repro_hash_probe(const void* table, int n_keys,
                                int64_t table_size, int max_probes,
                                int64_t n, const void* v0,
                                const void* v1, const void* v2,
                                const void* v3, void* out_idx,
                                void* out_found, void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || table_size < 1 ||
      (table_size & (table_size - 1)) || table_size > (1LL << 31) ||
      reinterpret_cast<uintptr_t>(table) % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Cols vals = {{static_cast<const int32_t*>(v0),
                      static_cast<const int32_t*>(v1),
                      static_cast<const int32_t*>(v2),
                      static_cast<const int32_t*>(v3)}};
  // 16-byte key loads and stores where every column allows them
  int vec = reinterpret_cast<uintptr_t>(out_idx) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(out_found) % 4 == 0;
  for (int c = 0; c < n_keys; ++c)
    vec = vec && reinterpret_cast<uintptr_t>(vals.col[c]) % 16 == 0;
  const auto* tab = static_cast<const int32_t*>(table);
  auto* idx = static_cast<int32_t*>(out_idx);
  auto* found = static_cast<bool*>(out_found);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n_keys) {
    case 1:
      return (int)launch<1>(tab, table_size, max_probes, vals, n, vec, idx,
                            found, s);
    case 2:
      return (int)launch<2>(tab, table_size, max_probes, vals, n, vec, idx,
                            found, s);
    case 3:
      return (int)launch<3>(tab, table_size, max_probes, vals, n, vec, idx,
                            found, s);
    default:
      return (int)launch<4>(tab, table_size, max_probes, vals, n, vec, idx,
                            found, s);
  }
}

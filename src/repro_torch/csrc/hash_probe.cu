// Open-addressing hash probe for the Lookup join (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hash_join/kernel.py:
// _hash_probe_kernel / hash_probe_pallas.  The table is built once on the
// host (repro_torch.kernels.hash_join.hash_build: linear probing, load
// factor <= 0.5, duplicate keys keep their first row) and uploaded once per
// dimension table; this kernel probes it for every fact row of a chunk.
//
// Result per probe row i: out_idx[i] = the build's first-occurrence row of
// the key tuple (0 on a miss), out_found[i] = 1 when the key is present.
//
// Bound: bytes.  Each row reads its k key columns (4 B each) and writes
// 5 B; the table reads are gathers into at most 4 MB of slots for the SSB
// scale-factor-1 dimensions, which stays resident in the 50 MB L2.  The
// design is therefore one thread per row with coalesced key loads and
// stores, fmix32 computed natively in uint32, and a probe loop that stops
// at the first key match or empty slot (the load factor keeps it short).
// The TPU kernel instead ran a fixed max_probes trip count over a whole
// tile with a done-mask, because its lanes cannot branch independently.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kFmixC1 = 0x85EBCA6Bu;
constexpr uint32_t kFmixC2 = 0xC2B2AE35u;
constexpr uint32_t kColMix = 0x9E3779B9u;
constexpr int kMaxKeys = 4;

struct KeyCols {
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

__global__ void hash_probe_kernel(KeyCols vals, KeyCols slot_keys,
                                  const int32_t* __restrict__ slot_idx,
                                  int n_keys, uint32_t table_mask,
                                  int max_probes, int64_t n,
                                  int32_t* __restrict__ out_idx,
                                  bool* __restrict__ out_found) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t v[kMaxKeys];
    uint32_t h = 0;
    for (int c = 0; c < n_keys; ++c) {
      v[c] = vals.col[c][i];
      h = fmix32(h ^ ((uint32_t)v[c] * kColMix));
    }
    int32_t idx = 0;
    bool found = false;
    for (int step = 0; step < max_probes; ++step) {
      const uint32_t cand = (h + (uint32_t)step) & table_mask;
      const int32_t occ = __ldg(slot_idx + cand);
      if (occ < 0) break;  // empty slot: the key is absent
      bool eq = true;
      for (int c = 0; c < n_keys; ++c)
        eq = eq && (__ldg(slot_keys.col[c] + cand) == v[c]);
      if (eq) {
        idx = occ;
        found = true;
        break;
      }
    }
    out_idx[i] = idx;
    out_found[i] = found;
  }
}

}  // namespace

extern "C" int repro_hash_probe(const void* const* val_ptrs,
                                const void* const* slot_key_ptrs,
                                const void* slot_idx, int n_keys,
                                int64_t table_size, int max_probes, int64_t n,
                                void* out_idx, void* out_found,
                                void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  KeyCols vals = {}, keys = {};
  for (int c = 0; c < n_keys; ++c) {
    vals.col[c] = static_cast<const int32_t*>(val_ptrs[c]);
    keys.col[c] = static_cast<const int32_t*>(slot_key_ptrs[c]);
  }
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  hash_probe_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      vals, keys, static_cast<const int32_t*>(slot_idx), n_keys,
      (uint32_t)(table_size - 1), max_probes, n,
      static_cast<int32_t*>(out_idx), static_cast<bool*>(out_found));
  return (int)cudaGetLastError();
}

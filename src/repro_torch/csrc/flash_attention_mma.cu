// Flash attention with an online softmax for bf16 on Hopper's tensor cores
// (sm_90a, warpgroup MMA: wgmma.mma_async).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// _flash_kernel / flash_attention_pallas, for bf16 q, k, v (the model's
// compute dtype, so every serving prefill).  fp32 inputs go to the FMA
// kernel in flash_attention.cu.  It computes, for every query row of
// q [B, Sq, Kh, G, hd] against k, v [B, Skv, Kh, hd] (kv head = the query's
// Kh index, shared by its G query heads):
//   s = (q . k) / sqrt(hd) in fp32, optionally softcap * tanh(s / softcap);
//   allowed pairs: k_pos < Skv, and k_pos <= q_pos when causal (positions
//   from 0, top-left aligned even when Sq != Skv), and k_pos > q_pos -
//   window when window > 0;
//   out = softmax(s) @ v over the allowed pairs, 0 for a row with none.
// The probabilities are rounded to bf16 before the value product and the
// output is rounded to bf16, as the TPU kernel does; the normalizer sums the
// unrounded fp32 probabilities.
//
// Bound on the H100: operations.  Causal prefill does 4 * hd flops per
// allowed (q, k) pair and reads each q, k, v element once, so at the
// stablelm-3b shape (B 4, S 2048, 32 heads of 80) the bf16 tensor cores
// (989 TFLOP/s) are the limit, not HBM.  What the design does about it:
//   - Both products run on the tensor cores as wgmma (bf16 in, fp32
//     accumulate).  S = Q K^T reads Q and K from shared memory; O += P V
//     takes P from registers: its fp32 score fragment, rounded to bf16 (the
//     TPU kernel's p.astype(v.dtype)), is the A operand as it stands, and V
//     comes through the transposing (MN-major) B descriptor.  The products
//     are exact in fp32; only the order of the sums differs from the plain
//     version.  Scores are scaled in fp32, never Q in bf16.
//   - A block is two warpgroups (256 threads) over 128 query rows of one
//     folded (b, kh, g) row, 64 rows a warpgroup, so each K/V tile copied to
//     shared memory serves 128 rows.  kv tiles are 64 rows (32 at hd 256).
//     The running max, normalizer and output accumulator stay in registers;
//     the row max meets across the 4 threads of a quad by shuffles.
//   - Each warpgroup pipelines its tiles: it issues S_t = Q K_t^T and
//     O += P_{t-1} V_{t-1} together, then runs the softmax of S_t while the
//     value product runs, and rescales O once that product is done.
//   - K and V stream through 2-stage shared-memory rings by cp.async.cg
//     16-byte copies, one tile ahead.  Q and K sit K-major in the 32-byte
//     swizzle (the two 16-byte halves of a k-step row swap on rows 4..7 of
//     each 8), V MN-major in 8x8 core matrices; hd 8 is zero-padded to 16
//     (exact), rows past Skv or Sq are zero-filled.
//   - Whole kv tiles that causality or the window masks for every row are
//     never loaded; the per-element mask runs only on tiles that cross an
//     edge for the warpgroup's rows.  Causal q tiles launch heaviest first,
//     so the long diagonal tiles do not form the tail.
//   - q, k, v and o are indexed in their [B, S, Kh, (G,) hd] layout; the
//     epilogue divides by l, rounds to bf16 and stores 16 bytes a thread.
//   - The NEG_INF = -1e30 guards of the TPU kernel are kept, and l == 0
//     flushes to 0.  No atomics and no split over kv: two launches are
//     bit-identical.
//   - For training, each row's log-sum-exp in base 2, m + log2(l) of the
//     scaled (capped) scores times log2(e), is written to lse
//     [B, Kh, G, Sq] when the caller asks for it (+inf for a row with no
//     allowed key); the backward kernel (flash_attention_bwd.cu) rebuilds
//     P from it.  The output's bits do not depend on it.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kBr = 128;       // query rows a block, 64 a warpgroup
constexpr int kStages = 2;     // K/V ring depth

using bf16 = __nv_bfloat16;

template <int HD>
struct Tile {
  static constexpr int kHdp = HD < 16 ? 16 : HD;  // depth of the products
  static constexpr int kChunks = HD / 8;          // 16-byte chunks a row
  static constexpr int kBc = HD > 128 ? 32 : 64;  // kv rows a tile
  static constexpr int kKSteps = kHdp / 16;       // k-steps of Q K^T
  static constexpr int kSTiles = kBc / 8;         // 8-column score tiles
  static constexpr int kPSteps = kBc / 16;        // k-steps of P V
  static constexpr int kOTiles = kHdp / 8;        // 8-column output tiles
  static constexpr int kPitch = kHdp + 8;         // epilogue staging row
  static constexpr int kSmemBytes =
      (kBr + 2 * kStages * kBc) * kHdp * (int)sizeof(bf16);
  static_assert(HD % 8 == 0, "head dim in 16-byte chunks");
  static_assert(kHdp % 64 == 0 || kHdp % 64 == 16 || kHdp % 64 == 32,
                "P V in n64 / n32 / n16 pieces");
};

// 16-byte async copy; with ok false it writes 16 zero bytes instead
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// O[:, OFF .. OFF + REM) += P V over one k-step, in n64 / n32 / n16 pieces;
// V's 8-column chunks are 128 bytes apart
template <int OFF, int REM, int NT>
__device__ __forceinline__ void pv_products(float (&acc)[NT][4],
                                            const uint32_t (&a)[4],
                                            uint32_t v_addr, uint32_t lbo) {
  const uint64_t db = gmma_desc(v_addr + OFF / 8 * 128, lbo, 128, 0);
  if constexpr (REM >= 64) {
    wgmma_rs_n64<OFF / 8>(acc, a, db, 1);
    pv_products<OFF + 64, REM - 64>(acc, a, v_addr, lbo);
  } else if constexpr (REM == 32) {
    wgmma_rs_n32<OFF / 8>(acc, a, db, 1);
  } else if constexpr (REM == 16) {
    wgmma_rs_n16<OFF / 8>(acc, a, db, 1);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 96 ? 2 : 1)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, int Sq, int Skv, int Kh, int G,
                   int causal, int window, float softcap, float scale) {
  using T = Tile<HD>;
  constexpr int Bc = T::kBc;
  constexpr int Hdp = T::kHdp;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBr x Hdp]
  bf16* ks = qs + kBr * Hdp;                     // [kStages][Bc x Hdp]
  bf16* vs = ks + kStages * Bc * Hdp;            // [kStages][Bc x Hdp]

  const int row = blockIdx.x;  // folded (b, kh, g)
  const int g = row % G;
  const int kh = (row / G) % Kh;
  const int b = row / (G * Kh);
  // heaviest causal q tiles first: blocks start in blockIdx order
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBr;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // warpgroup
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int w0 = q_start + wg * 64;     // this warpgroup's first row
  const int r0 = w0 + warp * 16 + gid;  // this thread's rows r0, r0 + 8

  const int64_t q_tok = (int64_t)Kh * G * HD;  // elements between positions
  const int64_t kv_tok = (int64_t)Kh * HD;
  const int64_t q_off = (int64_t)b * Sq * q_tok + ((int64_t)kh * G + g) * HD;
  const bf16* qb = q + q_off;
  const bf16* kb = k + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;
  const bf16* vb = v + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;

  // kv tiles that hold an allowed pair for some row of this block
  const int q_last = min(q_start + kBr, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  const int t_begin = kv_begin / Bc;
  const int t_end = (kv_end + Bc - 1) / Bc;

  if (HD < Hdp) {
    // hd 8: the products read dims 8..15, which no copy writes
    for (int i = tid; i < T::kSmemBytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  // Copies, 16 bytes a chunk; positions at or past limit are zero-filled.
  // Q, K: K-major with the 32-byte swizzle: k-step kk of row r at
  // kk * rows * 32 + r * 32 bytes, its two halves swapped on rows 4..7 of
  // each 8.  V: MN-major core matrices: chunk c of kv row r at
  // (r / 8) * Hdp * 16 + c * 128 + (r % 8) * 16 bytes.
  auto load_kmajor = [&](bf16* dst, const bf16* src, int64_t tok, int start,
                         int rows, int limit) {
    for (int c = tid; c < rows * T::kChunks; c += kThreads) {
      const int r = c / T::kChunks;
      const int ch = c - r * T::kChunks;
      const int pos = start + r;
      const bool ok = pos < limit;
      const int off =
          (ch >> 1) * rows * 16 + r * 16 + (((ch & 1) ^ ((r >> 2) & 1)) * 8);
      cp_async16(smem_u32(dst + off),
                 ok ? src + (int64_t)pos * tok + ch * 8 : src, ok);
    }
  };
  auto load_v = [&](bf16* dst, int start) {
    for (int c = tid; c < Bc * T::kChunks; c += kThreads) {
      const int r = c / T::kChunks;
      const int ch = c - r * T::kChunks;
      const int pos = start + r;
      const bool ok = pos < Skv;
      cp_async16(smem_u32(dst + (r >> 3) * Hdp * 8 + ch * 64 + (r & 7) * 8),
                 ok ? vb + (int64_t)pos * kv_tok + ch * 8 : vb, ok);
    }
  };
  auto kbuf = [&](int t) { return ks + ((t - t_begin) & 1) * Bc * Hdp; };
  auto vbuf = [&](int t) { return vs + ((t - t_begin) & 1) * Bc * Hdp; };
  auto sync_copies = [&]() {
    fence_proxy_async();
    __syncthreads();
  };

  float acc[T::kOTiles][4];  // O, unnormalized
#pragma unroll
  for (int d = 0; d < T::kOTiles; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float s[T::kSTiles][4];      // S of the current tile, then its P
#pragma unroll
  for (int j = 0; j < T::kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  uint32_t pa[T::kPSteps][4];  // P of the previous tile, bf16 (A operand)
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the normalizer
  float alpha[2];                   // rescale of what came before a tile
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 32;  // our 64 Q rows

  // S = Q K_t^T as one wgmma group
  auto issue_s = [&](int t) {
    const uint32_t k_addr = smem_u32(kbuf(t));
    hold(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kKSteps; ++kk) {
      const uint64_t da = gmma_desc(q_addr + kk * kBr * 32, 16, 256, 3);
      const uint64_t db = gmma_desc(k_addr + kk * Bc * 32, 16, 256, 3);
      if constexpr (Bc == 64)
        wgmma_ss_n64<0>(s, da, db, kk);
      else
        wgmma_ss_n32<0>(s, da, db, kk);
    }
    wgmma_commit();
  };
  // O += P V_t as one wgmma group, P from pa
  auto issue_pv = [&](int t) {
    const uint32_t v_addr = smem_u32(vbuf(t));
    hold(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kPSteps; ++kk)
      pv_products<0, Hdp>(acc, pa[kk], v_addr + kk * Hdp * 32, Hdp * 16);
    wgmma_commit();
  };
  // S of tile t: scale (and cap) in fp32, in log2 units; mask on tiles
  // that cross an edge for this warpgroup's rows; online softmax into s
  // (p, unrounded), l and alpha
  auto softmax = [&](int t) {
    const int k0 = t * Bc;
    const bool edge = k0 + Bc > Skv || (causal && k0 + Bc - 1 > w0) ||
                      (window > 0 && k0 < w0 + 64 - window);
#pragma unroll
    for (int j = 0; j < T::kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (softcap > 0.f) {
          x *= scale;
          x = softcap * tanhf(x / softcap) * kLog2e;
        } else {
          x *= scale_log2;
        }
        if (edge) {
          const int qp = r0 + (e >> 1) * 8;
          const int kp = k0 + 8 * j + 2 * tig + (e & 1);
          bool ok = kp < Skv;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows r0 (h = 0) and r0 + 8 (h = 1)
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < T::kSTiles; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      // guard fully masked rows: exp(NEG_INF - NEG_INF)
      const float m_sub = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      alpha[h] = m[h] <= kNegInf * 0.5f ? 0.f : exp2f(m[h] - m_new);
      m[h] = m_new;
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < T::kSTiles; ++j) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = exp2f(s[j][e] - m_sub);  // masked: exactly 0
          s[j][e] = p;
          p_sum += p;
        }
      }
      l[h] = l[h] * alpha[h] + p_sum;
    }
  };
  // P rounded to bf16 in the A operand's layout
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < T::kPSteps; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };

  // Copy groups: the first holds Q and K_first; the one issued at tile t
  // holds V_t and K_{t+1}, so each tile waits only for copies issued a
  // tile earlier.
  if (t_begin < t_end) {
    load_kmajor(qs, qb, q_tok, q_start, kBr, Sq);
    load_kmajor(kbuf(t_begin), kb, kv_tok, t_begin * Bc, Bc, Skv);
    cp_async_commit();
    load_v(vbuf(t_begin), t_begin * Bc);
    if (t_begin + 1 < t_end)
      load_kmajor(kbuf(t_begin + 1), kb, kv_tok, (t_begin + 1) * Bc, Bc, Skv);
    cp_async_commit();
    cp_async_wait<1>();
    sync_copies();
    issue_s(t_begin);
    wgmma_wait<0>();
    hold(s);
    softmax(t_begin);
    pack_p();
  }
  for (int t = t_begin + 1; t < t_end; ++t) {
    cp_async_wait<0>();  // V_{t-1} and K_t
    sync_copies();       // and every warpgroup is done with tile t - 2
    load_v(vbuf(t), t * Bc);
    if (t + 1 < t_end)
      load_kmajor(kbuf(t + 1), kb, kv_tok, (t + 1) * Bc, Bc, Skv);
    cp_async_commit();
    issue_s(t);
    issue_pv(t - 1);
    wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
    hold(s);
    softmax(t);
    wgmma_wait<0>();
    hold(acc);
    hold(pa);
#pragma unroll
    for (int d = 0; d < T::kOTiles; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
    pack_p();
  }
  if (t_begin < t_end) {
    cp_async_wait<0>();  // V of the last tile
    sync_copies();
    issue_pv(t_end - 1);
    wgmma_wait<0>();
    hold(acc);
    hold(pa);
  }
  cp_async_wait<0>();
  __syncthreads();  // every product and copy is done: staging may reuse all

  // epilogue: o = acc / l in bf16, staged in padded rows, then 16 bytes a
  // thread into o
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int qp = r0 + 8 * h;
    if (lse != nullptr && tig == 0 && qp < Sq)
      lse[(int64_t)row * Sq + qp] =
          l[h] > 0.f ? m[h] + log2f(l[h]) : __int_as_float(0x7f800000);
    l[h] = l[h] == 0.f ? 1.f : l[h];
  }
  constexpr int P = T::kPitch;
  bf16* ow = qs + (wg * 4 + warp) * 16 * P;  // this warp's 16 rows
#pragma unroll
  for (int d = 0; d < T::kOTiles; ++d) {
    const int col = 8 * d + 2 * tig;
    *reinterpret_cast<uint32_t*>(ow + gid * P + col) =
        pack_bf16(acc[d][0] / l[0], acc[d][1] / l[0]);
    *reinterpret_cast<uint32_t*>(ow + (gid + 8) * P + col) =
        pack_bf16(acc[d][2] / l[1], acc[d][3] / l[1]);
  }
  __syncwarp();
  bf16* ob = o + q_off;
  for (int c = lane; c < 16 * T::kChunks; c += 32) {
    const int r = c / T::kChunks;
    const int ch = c - r * T::kChunks;
    const int qp = w0 + warp * 16 + r;
    if (qp < Sq)
      *reinterpret_cast<uint4*>(ob + (int64_t)qp * q_tok + ch * 8) =
          *reinterpret_cast<const uint4*>(ow + r * P + ch * 8);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, Sq, Skv, Kh, G, causal, window;
  float softcap, scale;
  cudaStream_t stream;
};

template <int HD>
cudaError_t launch(const Args& a) {
  using T = Tile<HD>;
  const int64_t rows = (int64_t)a.B * a.Kh * a.G;
  const int64_t q_tiles = (a.Sq + kBr - 1) / kBr;
  if (rows > 0x7fffffffLL || q_tiles > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)rows, (unsigned)q_tiles);
  flash_wgmma_kernel<HD><<<grid, kThreads, T::kSmemBytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.Sq,
      a.Skv, a.Kh, a.G, a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, k, v and output; every pointer 16-byte aligned.  lse: null, or
// [B, Kh, G, Sq] fp32 for the rows' base-2 log-sum-exp.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int Sq, int Skv, int Kh,
                                          int G, int hd, int causal,
                                          int window, float softcap,
                                          float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Kh <= 0 || G <= 0) return (int)cudaSuccess;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, Kh, G,
               causal, window, softcap, scale,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 8: return (int)launch<8>(a);
    case 16: return (int)launch<16>(a);
    case 32: return (int)launch<32>(a);
    case 64: return (int)launch<64>(a);
    case 80: return (int)launch<80>(a);
    case 96: return (int)launch<96>(a);
    case 128: return (int)launch<128>(a);
    case 256: return (int)launch<256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

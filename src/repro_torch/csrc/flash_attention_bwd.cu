// The gradient of flash attention on the H100 (sm_90a): bf16 at head dims
// 64 to 128 on warpgroup MMAs (wgmma) fed by TMA, bf16 at 8, 16, 32 and 256
// on mma.sync, fp32 in FMAs.
//
// Replaces no TPU kernel: the reference trains by jax.grad of its plain
// attention (repro/kernels/flash_attention/ref.py:11), whose gradient XLA
// compiles into device code; this is that gradient as a kernel, so that
// training on the card never builds the [B, Kh, G, Sq, Skv] fp32 score
// matrices of the plain version's autograd.  The forward kernels
// (flash_attention_mma.cu, flash_attention.cu) saved each query row's
// base-2 log-sum-exp lse; with s the scaled (capped) score of an allowed
// pair (the forward's mask: k_pos < Skv, k_pos <= q_pos when causal,
// k_pos > q_pos - window when window > 0):
//   P  = exp2(s * log2(e) - lse), 0 off the mask (and for lse = +inf: a
//        row with no allowed key has no gradient)
//   D  = rowsum(dO * O)                                   (row_dot_kernel)
//   dV = P^T dO, P rounded to the input dtype as the forward rounds it
//   dS = P * (dO V^T - D), times (1 - tanh^2) under a softcap
//   dK = dS^T Q / sqrt(hd)                               (the dK/dV kernel)
//   dQ = dS K / sqrt(hd)                                     (the dQ kernel)
//
// Bound on the H100: operations, 10 * hd flops an allowed pair a query
// head (S, dP, dV, dK, dQ at 2 * hd each) on the bf16 tensor cores; each
// q, k, v, o, dO element is read a few times, from L2.  The two kernels do
// 14 * hd (S and dP are rebuilt in both): one pass at 10 * hd would have to
// add dQ over key blocks, which without atomics needs an ordered reduction
// the split below avoids.  What the design does:
//   - FlashAttention-2's split, made deterministic: one block per
//     (b, kv head, key tile) holds dK and dV in registers and loops over
//     its G query heads and the query tiles the mask allows, in a fixed
//     order; one block per (b, kv head, g, query tile) holds dQ and loops
//     over the allowed key tiles.  No atomics, no split sums: two launches
//     are bit-identical.
//   - bf16 at hd 64 to 128 (every full-size model the repo trains or
//     serves): all five products on wgmma, the tensor cores' full-rate
//     path, in blocks of three warpgroups.  The first warp of the third
//     produces: it keeps TMA loads of the streamed tiles in flight through
//     a ring of 3 or 4 stages guarded by mbarriers (Q and dO, with their
//     lse and D rows by cp.async, for dK/dV; K and V for dQ).  Two
//     consumer warpgroups compute; setmaxnreg moves the producer's
//     registers to them.  dK/dV: a block of 64 keys; warpgroup 0 makes
//     S^T = K Q^T, P^T and dV += P^T dO, warpgroup 1 dP^T = V dO^T, dS^T
//     (P^T handed over in shared memory) and dK += dS^T Q, so each holds
//     one 64 x hd accumulator (both at once would take 128 registers a
//     thread at hd 128 and make ptxas serialise the products); query
//     tiles of 128 rows at hd 64 and 80, 64 above.  dQ: a block of 128
//     queries, 64 a warpgroup, each making S = Q K^T, dP = dO V^T, dS and
//     dQ += dS K over key tiles of 64.  S and dP read both operands from
//     shared memory (K-major); P and dS are rounded to bf16 in registers
//     into the A operand of the accumulation, whose B operand is the same
//     tile read MN-major through the descriptor's transpose bit.  Tiles
//     lie in TMA's 32-byte swizzle, one 16-head-dim box a row block, the
//     layout both readings name.  exp2 is one ex2.approx.ftz; the loops
//     over a tile are compiled once for each (softcap, edge) case, so no
//     element branches.
//   - bf16 at hd 8, 16, 32 and 256 (no full-size configuration uses them;
//     the card tests do): mma.sync m16n8k16 fed by ldmatrix, a warp owning
//     16 keys (dK/dV) or 16 queries (dQ), tiles through a 2-stage cp.async
//     ring issued by every thread; at hd 256 two warps share a 16-row
//     group, each accumulating half of the head dims; hd 8 is zero-padded
//     to 16.
//   - Whole tiles that the mask allows everywhere skip the per-element
//     mask; query (key) tiles that causality or the window cut away are
//     never loaded, and a warpgroup skips a loaded tile none of whose pairs
//     its rows allow.
//   - fp32: no training run uses it (the models compute in bf16), but the
//     card tests do.  A plain shared-memory kernel with the same split:
//     32 x 32 tiles of S and dP, a thread 4 dot products of each, then
//     each thread accumulates hd / 8 elements of its key's (query's) rows.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// D[b, kh, g, s] = sum_h dO * O over a row of [B, Sq, Kh, G, hd]: half a
// warp a row, lane c of the half reading the row's 16-byte chunks c,
// c + 16, .., then the half's 16 partial sums meeting in a fixed shuffle
// tree
template <typename E, int HD>
__global__ void row_dot_kernel(const E* __restrict__ o,
                               const E* __restrict__ dout,
                               float* __restrict__ D, int64_t rows, int Sq,
                               int Kh, int G) {
  constexpr int kPer = 16 / (int)sizeof(E);  // elements a chunk
  static_assert(HD % kPer == 0, "whole 16-byte chunks a row");
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 4;
  const int c0 = threadIdx.x & 15;
  float acc = 0.f;
  if (r < rows) {
    const uint4* a = reinterpret_cast<const uint4*>(o + r * HD);
    const uint4* b = reinterpret_cast<const uint4*>(dout + r * HD);
    for (int c = c0; c < HD / kPer; c += 16) {
      const uint4 x = __ldg(a + c), y = __ldg(b + c);
      const E* xs = reinterpret_cast<const E*>(&x);
      const E* ys = reinterpret_cast<const E*>(&y);
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        acc = fmaf(to_f(xs[k]), to_f(ys[k]), acc);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r >= rows || c0 != 0) return;
  const int g = (int)(r % G);
  const int64_t t1 = r / G;
  const int kh = (int)(t1 % Kh);
  const int64_t t2 = t1 / Kh;
  const int s = (int)(t2 % Sq);
  const int64_t b0 = t2 / Sq;
  D[((b0 * Kh + kh) * G + g) * Sq + s] = acc;
}

// whether key kp may be attended by query qp (the forward's mask)
__device__ __forceinline__ bool allowed(int qp, int kp, int Sq, int Skv,
                                        int causal, int window) {
  bool ok = kp < Skv && qp < Sq;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// 2^x in one special-function instruction; a result below 2^-126 flushes
// to 0 (such a probability adds nothing to a bf16 gradient)
__device__ __forceinline__ float ex2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P of one score (s the raw dot product) from its row's lse; cap: the
// softcap's 1 - tanh^2 (1 without a softcap)
__device__ __forceinline__ float p_of(float s, float lse2, float softcap,
                                      float scale, float scale_log2,
                                      float& cap) {
  float x;
  cap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s * scale / softcap);
    x = softcap * t * kLog2e;
    cap = 1.f - t * t;
  } else {
    x = s * scale_log2;
  }
  return exp2f(x - lse2);
}

// The same for the wgmma kernels, whose loops over a tile are compiled once
// for each softcap choice (a template parameter of the kernels) and edge
// (with_edge) so that no element branches: kCap with a softcap (scale_cap
// = scale / softcap, cap_log2 = softcap * log2(e)), exp2 by ex2_fast.
template <bool kCap>
__device__ __forceinline__ float p_tile(float s, float lse2, float cap_log2,
                                        float scale_cap, float scale_log2,
                                        float& cap) {
  if constexpr (kCap) {
    const float t = tanhf(s * scale_cap);
    cap = 1.f - t * t;
    return ex2_fast(cap_log2 * t - lse2);
  } else {
    cap = 1.f;
    return ex2_fast(s * scale_log2 - lse2);
  }
}

// f(kEdge), the flag as a std::integral_constant
template <typename F>
__device__ __forceinline__ void with_edge(bool edge, F&& f) {
  if (edge)
    f(std::true_type{});
  else
    f(std::false_type{});
}

// P and dS of one score: s the raw dot product, dp the dO.V product
struct PdS {
  float p, ds;
};
__device__ __forceinline__ PdS p_ds(float s, float dp, float lse2, float D,
                                    float softcap, float scale,
                                    float scale_log2) {
  float cap;
  const float p = p_of(s, lse2, softcap, scale, scale_log2, cap);
  return {p, p * (dp - D) * cap};
}

// ------------------------------ bf16 on mma.sync (hd 8, 16, 32 and 256)
// 16- or 4-byte async copy; with ok false it writes zeros instead
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments (PTX mma m16n8k16; lane = 4 * gid + tig): an accumulator
// c[j][0..1] is row gid, columns 8 j + 2 tig, +1; c[j][2..3] the same of
// row gid + 8.  The A operand of k-step kk takes c[2 kk] and c[2 kk + 1]
// as they stand.  ldmatrix addresses: for A from row-major [M][K] rows,
// lane l gives row l % 16 at column (l / 16) * 8; for B from [N][K] rows
// (non-trans), row (l % 8) + (l / 16) * 8 at column ((l / 8) % 2) * 8,
// which yields the B fragments of two 8-column blocks; for B from
// row-major [K][N] (.trans), row (l % 8) + ((l / 8) % 2) * 8 at column
// (l / 16) * 8.
template <int HD>
struct Tile {
  static constexpr int kHdp = HD < 16 ? 16 : HD;  // depth of the products
  static constexpr int kLd = kHdp + 8;            // shared row, elements
  static constexpr int kChunks = HD / 8;          // 16-byte pieces a row
  static constexpr int kHS = HD > 128 ? 2 : 1;    // warps on a 16-row group
  static constexpr int kHdw = kHdp / kHS;         // head dims a warp holds
  static constexpr int kThreads = 128 * kHS;
  static constexpr int kBc = 64;                  // keys a dK/dV block
  static constexpr int kBr = HD >= 128 ? 32 : 64; // queries a dK/dV step
  static constexpr int kBq = 64;                  // queries a dQ block
  static constexpr int kBk = HD > 128 ? 32 : 64;  // keys a dQ step
  static constexpr int kDkvSmem =
      (2 * kBc + 4 * kBr) * kLd * (int)sizeof(bf16) + 4 * kBr * 4;
  static constexpr int kDqSmem = (2 * kBq + 4 * kBk) * kLd * (int)sizeof(bf16);
  static_assert(HD % 8 == 0 && kHdw % 16 == 0, "head dim");
  static_assert(kDkvSmem <= 232448 && kDqSmem <= 232448, "shared memory");
};

// rows [start, start + rows) of a [.., tok]-strided bf16 tensor into
// shared rows of kLd; rows at or past limit are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t tok, int start, int rows,
                                          int limit) {
  using T = Tile<HD>;
  for (int c = threadIdx.x; c < rows * T::kChunks; c += T::kThreads) {
    const int r = c / T::kChunks;
    const int ch = c - r * T::kChunks;
    const int pos = start + r;
    const bool ok = pos < limit;
    cp_async16(smem_u32(dst + r * T::kLd + ch * 8),
               ok ? src + (int64_t)pos * tok + ch * 8 : src, ok);
  }
}

// hd 8: the products read dims 8..15 of every row, which no copy writes
template <int HD>
__device__ __forceinline__ void zero_pad(unsigned char* smem, int bytes) {
  if (HD < Tile<HD>::kHdp) {
    for (int i = threadIdx.x; i < bytes / 16; i += Tile<HD>::kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
}

// A block: 64 keys of one (b, kv head); the loop runs over (g, query
// tile) pairs, g outer.
template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads, 1)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ Drow, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Sq, int Skv, int Kh, int G,
                      int causal, int window, float softcap, float scale) {
  using T = Tile<HD>;
  constexpr int Ld = T::kLd, Bc = T::kBc, Br = T::kBr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [Bc][Ld]
  bf16* vs = ks + Bc * Ld;                       // [Bc][Ld]
  bf16* qs = vs + Bc * Ld;                       // [2][Br][Ld]
  bf16* dos = qs + 2 * Br * Ld;                  // [2][Br][Ld]
  float* ls = reinterpret_cast<float*>(dos + 2 * Br * Ld);  // [2][Br]
  float* dsr = ls + 2 * Br;                                 // [2][Br]

  const int kh = blockIdx.x % Kh;
  const int b = blockIdx.x / Kh;
  const int k0 = blockIdx.y * Bc;  // low keys meet the most queries: first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp & 3;   // keys 16 wr .. 16 wr + 15 of the tile
  const int wh = warp >> 2;  // head dims wh * kHdw ..

  const int64_t q_tok = (int64_t)Kh * G * HD;
  const int64_t kv_tok = (int64_t)Kh * HD;
  const bf16* qb = q + (int64_t)b * Sq * q_tok + (int64_t)kh * G * HD;
  const bf16* dob = dout + (int64_t)b * Sq * q_tok + (int64_t)kh * G * HD;
  const bf16* kb = k + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;
  const bf16* vb = v + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;
  const float* lb = lse + ((int64_t)b * Kh + kh) * G * Sq;
  const float* db = Drow + ((int64_t)b * Kh + kh) * G * Sq;

  // the queries these keys meet: q >= k when causal, q < k + window
  const int k_last = min(k0 + Bc, Skv) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int qt_begin = q_lo / Br;
  const int n_qt = q_hi > q_lo ? (q_hi + Br - 1) / Br - qt_begin : 0;
  const int n_it = G * n_qt;

  zero_pad<HD>(smem_raw, T::kDkvSmem);
  auto load_q = [&](int it, int stage) {
    const int g = it / n_qt;
    const int q0 = (qt_begin + it % n_qt) * Br;
    load_rows<HD>(qs + stage * Br * Ld, qb + g * HD, q_tok, q0, Br, Sq);
    load_rows<HD>(dos + stage * Br * Ld, dob + g * HD, q_tok, q0, Br, Sq);
    for (int r = tid; r < Br; r += T::kThreads) {
      const int pos = q0 + r;
      const bool ok = pos < Sq;
      const int64_t off = (int64_t)g * Sq + (ok ? pos : 0);
      cp_async4(smem_u32(ls + stage * Br + r), lb + off, ok);
      cp_async4(smem_u32(dsr + stage * Br + r), db + off, ok);
    }
  };

  load_rows<HD>(ks, kb, kv_tok, k0, Bc, Skv);
  load_rows<HD>(vs, vb, kv_tok, k0, Bc, Skv);
  if (n_it > 0) load_q(0, 0);
  cp_commit();

  float dka[T::kHdw / 8][4], dva[T::kHdw / 8][4];
#pragma unroll
  for (int j = 0; j < T::kHdw / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt_begin + it % n_qt) * Br;
    const bf16* qsb = qs + stage * Br * Ld;
    const bf16* dosb = dos + stage * Br * Ld;
    const float* lsb = ls + stage * Br;
    const float* dsb = dsr + stage * Br;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
    float st[Br / 8][4], dpt[Br / 8][4];
#pragma unroll
    for (int j = 0; j < Br / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::kHdp / 16; ++kk) {
      uint32_t ka[4], va[4];
      const int a_off = (16 * wr + (lane & 15)) * Ld + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(ka, smem_u32(ks + a_off));
      ldsm_x4(va, smem_u32(vs + a_off));
#pragma unroll
      for (int n2 = 0; n2 < Br / 16; ++n2) {
        uint32_t qf[4], df[4];
        const int b_off = (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * Ld +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(qf, smem_u32(qsb + b_off));
        ldsm_x4(df, smem_u32(dosb + b_off));
        mma(st[2 * n2], ka, qf[0], qf[1]);
        mma(st[2 * n2 + 1], ka, qf[2], qf[3]);
        mma(dpt[2 * n2], va, df[0], df[1]);
        mma(dpt[2 * n2 + 1], va, df[2], df[3]);
      }
    }

    // P^T and dS^T (rows: keys; columns: queries)
    const bool edge = k0 + Bc > Skv || q0 + Br > Sq ||
                      (causal && k0 + Bc - 1 > q0) ||
                      (window > 0 && k0 <= q0 + Br - 1 - window);
#pragma unroll
    for (int j = 0; j < Br / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * tig + (e & 1);
        PdS r = p_ds(st[j][e], dpt[j][e], lsb[qc], dsb[qc], softcap, scale,
                     scale_log2);
        if (edge && !allowed(q0 + qc, k0 + 16 * wr + gid + (e >> 1) * 8, Sq,
                             Skv, causal, window))
          r.p = r.ds = 0.f;
        st[j][e] = r.p;
        dpt[j][e] = r.ds;
      }
    }
    uint32_t pa[Br / 16][4], dsa[Br / 16][4];
#pragma unroll
    for (int kk = 0; kk < Br / 16; ++kk) {
      pa[kk][0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[kk][1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[kk][2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      dsa[kk][0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      dsa[kk][1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      dsa[kk][2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      dsa[kk][3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
    }

    // dV += P^T dO, dK += dS^T Q over this warp's head dims
#pragma unroll
    for (int kk = 0; kk < Br / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < T::kHdw / 16; ++n2) {
        uint32_t df[4], qf[4];
        const int t_off =
            (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * Ld +
            wh * T::kHdw + n2 * 16 + (lane >> 4) * 8;
        ldsm_x4_t(df, smem_u32(dosb + t_off));
        ldsm_x4_t(qf, smem_u32(qsb + t_off));
        mma(dva[2 * n2], pa[kk], df[0], df[1]);
        mma(dva[2 * n2 + 1], pa[kk], df[2], df[3]);
        mma(dka[2 * n2], dsa[kk], qf[0], qf[1]);
        mma(dka[2 * n2 + 1], dsa[kk], qf[2], qf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_wait<0>();

  bf16* dkb = dk + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;
  bf16* dvb = dv + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;
#pragma unroll
  for (int j = 0; j < T::kHdw / 8; ++j) {
    const int col = wh * T::kHdw + 8 * j + 2 * tig;
    if (col >= HD) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kp = k0 + 16 * wr + gid + 8 * h;
      if (kp >= Skv) continue;
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)kp * kv_tok + col) =
          pack_bf16(dka[j][2 * h] * scale, dka[j][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)kp * kv_tok + col) =
          pack_bf16(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

// A block: 64 queries of one folded (b, kh, g); the loop runs over the
// allowed key tiles.
template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ Drow, bf16* __restrict__ dq,
                    int Sq, int Skv, int Kh, int G, int causal, int window,
                    float softcap, float scale) {
  using T = Tile<HD>;
  constexpr int Ld = T::kLd, Bq = T::kBq, Bk = T::kBk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [Bq][Ld]
  bf16* dos = qs + Bq * Ld;                      // [Bq][Ld]
  bf16* ks = dos + Bq * Ld;                      // [2][Bk][Ld]
  bf16* vs = ks + 2 * Bk * Ld;                   // [2][Bk][Ld]

  const int row = blockIdx.x;  // folded (b, kh, g)
  const int g = row % G;
  const int kh = (row / G) % Kh;
  const int b = row / (G * Kh);
  // heaviest causal query tiles first
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * Bq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp & 3;   // queries 16 wr .. 16 wr + 15 of the tile
  const int wh = warp >> 2;  // head dims wh * kHdw ..

  const int64_t q_tok = (int64_t)Kh * G * HD;
  const int64_t kv_tok = (int64_t)Kh * HD;
  const int64_t q_off = (int64_t)b * Sq * q_tok + ((int64_t)kh * G + g) * HD;
  const bf16* kb = k + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;
  const bf16* vb = v + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;

  // the keys these queries meet
  const int q_last = min(q0 + Bq, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / Bk;
  const int t_end = kv_end > kv_begin ? (kv_end + Bk - 1) / Bk : t_begin;

  // this thread's rows' lse and D (rows past Sq are masked)
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + 16 * wr + gid + 8 * h;
    const int64_t off = (int64_t)row * Sq + (qp < Sq ? qp : 0);
    lr[h] = lse[off];
    dr[h] = Drow[off];
  }

  zero_pad<HD>(smem_raw, T::kDqSmem);
  auto load_kv = [&](int t, int stage) {
    load_rows<HD>(ks + stage * Bk * Ld, kb, kv_tok, t * Bk, Bk, Skv);
    load_rows<HD>(vs + stage * Bk * Ld, vb, kv_tok, t * Bk, Bk, Skv);
  };
  load_rows<HD>(qs, q + q_off, q_tok, q0, Bq, Sq);
  load_rows<HD>(dos, dout + q_off, q_tok, q0, Bq, Sq);
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_commit();

  float acc[T::kHdw / 8][4];
#pragma unroll
  for (int j = 0; j < T::kHdw / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = t * Bk;
    const bf16* ksb = ks + stage * Bk * Ld;
    const bf16* vsb = vs + stage * Bk * Ld;

    // S = Q K^T and dP = dO V^T for the warp's 16 queries
    float s[Bk / 8][4], dp[Bk / 8][4];
#pragma unroll
    for (int j = 0; j < Bk / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::kHdp / 16; ++kk) {
      uint32_t qa[4], da[4];
      const int a_off = (16 * wr + (lane & 15)) * Ld + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(qa, smem_u32(qs + a_off));
      ldsm_x4(da, smem_u32(dos + a_off));
#pragma unroll
      for (int n2 = 0; n2 < Bk / 16; ++n2) {
        uint32_t kf[4], vf[4];
        const int b_off = (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * Ld +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(kf, smem_u32(ksb + b_off));
        ldsm_x4(vf, smem_u32(vsb + b_off));
        mma(s[2 * n2], qa, kf[0], kf[1]);
        mma(s[2 * n2 + 1], qa, kf[2], kf[3]);
        mma(dp[2 * n2], da, vf[0], vf[1]);
        mma(dp[2 * n2 + 1], da, vf[2], vf[3]);
      }
    }

    // dS (rows: queries; columns: keys), rounded to bf16 as the A operand
    const bool edge = k0 + Bk > Skv || q0 + Bq > Sq ||
                      (causal && k0 + Bk - 1 > q0) ||
                      (window > 0 && k0 <= q0 + Bq - 1 - window);
    uint32_t dsa[Bk / 16][4];
#pragma unroll
    for (int j = 0; j < Bk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        PdS r = p_ds(s[j][e], dp[j][e], lr[h], dr[h], softcap, scale,
                     scale_log2);
        if (edge && !allowed(q0 + 16 * wr + gid + 8 * h,
                             k0 + 8 * j + 2 * tig + (e & 1), Sq, Skv, causal,
                             window))
          r.ds = 0.f;
        s[j][e] = r.ds;
      }
    }
#pragma unroll
    for (int kk = 0; kk < Bk / 16; ++kk) {
      dsa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      dsa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      dsa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      dsa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // dQ += dS K over this warp's head dims
#pragma unroll
    for (int kk = 0; kk < Bk / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < T::kHdw / 16; ++n2) {
        uint32_t kf[4];
        const int t_off =
            (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * Ld +
            wh * T::kHdw + n2 * 16 + (lane >> 4) * 8;
        ldsm_x4_t(kf, smem_u32(ksb + t_off));
        mma(acc[2 * n2], dsa[kk], kf[0], kf[1]);
        mma(acc[2 * n2 + 1], dsa[kk], kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_wait<0>();

  bf16* dqb = dq + q_off;
#pragma unroll
  for (int j = 0; j < T::kHdw / 8; ++j) {
    const int col = wh * T::kHdw + 8 * j + 2 * tig;
    if (col >= HD) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = q0 + 16 * wr + gid + 8 * h;
      if (qp >= Sq) continue;
      *reinterpret_cast<uint32_t*>(dqb + (int64_t)qp * q_tok + col) =
          pack_bf16(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
    }
  }
}

// ------------------------------------------- bf16 on wgmma (hd 64 to 128)
// A block is three warpgroups: 0 and 1 consume, the first warp of 2
// produces; setmaxnreg moves the producer's registers to the consumers.
// Tiles arrive by TMA (cp.async.bulk.tensor, 32-byte swizzle, one
// 16-head-dim box a row block) into a ring of stages guarded by mbarriers:
// "full" completes when a stage's bytes (and its lse and D rows) have
// landed, "empty" when all 8 consumer warps are done with it.
constexpr int kHopThreads = 384;
// 128 x 56 + 256 x 224 registers fill the 384 x 168 of the launch
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
// a wait this long (clock cycles, about 2 s) means an arrival was lost: the
// kernel traps instead of hanging the card
constexpr long long kWaitLimit = 1LL << 32;

template <int HD, bool kCap>
struct Hop {
  static constexpr int kSteps = HD / 16;  // 32-byte k-steps a row
  static constexpr int kRow = HD * 2;     // bytes a row
  static constexpr int kBc = 64;  // keys a dK/dV block
  // queries a dK/dV step: 128 where shared memory holds 3 stages of them
  // and registers the softcap's arithmetic (it spills at 128)
  static constexpr int kBr = HD <= 80 && !kCap ? 128 : 64;
  static constexpr int kBq = 128;  // queries a dQ block
  static constexpr int kBk = 64;   // keys a dQ step
  static constexpr int kStages = kBr == 128 ? 3 : 4;  // the dK/dV ring
  static constexpr int kDqStages = 4;                 // the dQ ring
  // dK/dV: K and V (resident), a ring of (Q, dO) tiles and their lse and D
  // rows, two hand-off buffers of P^T (fp32, times the softcap's
  // 1 - tanh^2), then the barriers: full[St], empty[St], resident,
  // handed[2], taken[2]
  static constexpr int kDkvRows = 2 * kBc * kRow + kStages * 2 * kBr * kRow;
  static constexpr int kDkvHand = kDkvRows + kStages * 2 * kBr * 4;
  static constexpr int kDkvBars = kDkvHand + 2 * kBc * kBr * 4;
  static constexpr int kDkvSmem = kDkvBars + (2 * kStages + 5) * 8;
  // dQ: Q and dO (resident), a ring of (K, V) tiles, the barriers
  static constexpr int kDqBars = 2 * kBq * kRow + kDqStages * 2 * kBk * kRow;
  static constexpr int kDqSmem = kDqBars + (2 * kDqStages + 1) * 8;
  static_assert(HD % 16 == 0 && HD >= 64 && HD <= 128, "head dim");
  static_assert(kDkvSmem <= 232448 && kDqSmem <= 232448, "shared memory");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the inits become visible to the async proxy (TMA) and to other threads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(bar)
      : "memory");
}

// one arrival, and bytes more for the phase to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// an arrival on bar once this thread's earlier cp.async copies have landed
// (counted among the arrivals the barrier was initialised with)
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// bytes more for the phase to wait for, without an arrival
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of the given parity to complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kWaitLimit) __trap();
}

// one box of a 4-d tensor map into shared memory, counted on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Shared layouts.  A tile of R rows is HD / 16 blocks of R x 32 bytes: block
// kk holds head dims 16 kk .. 16 kk + 15, row r at r * 32 bytes, its two
// 16-byte halves swapped on rows 4..7 of each 8 (TMA's 32-byte swizzle,
// which the wgmma descriptors name).  Read along the head dim it is the
// K-major operand of a product over head dims (S, dP): descriptor at block
// kk, stride 256 bytes between 8-row groups.  Read along the rows it is the
// MN-major (transposed) operand of a product over rows (dV, dK, dQ): k-step
// ks of 16 rows starts at ks * 512 bytes, 8-row groups 256 bytes apart
// (SBO), 16-head-dim atoms R * 32 bytes apart (LBO).

// D[64 x N] = A (shared, K-major) B (shared, K-major), N 128 or 64
template <int N, int NT>
__device__ __forceinline__ void wgmma_ss(float (&d)[NT][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 128 || N == 64, "score tile width");
  if constexpr (N == 128)
    wgmma_ss_n128<0>(d, da, db, accumulate);
  else
    wgmma_ss_n64<0>(d, da, db, accumulate);
}

// acc[:, OFF .. OFF + REM) += A (registers, 16 rows of the product's depth)
// B (a tile's k-step at b_addr, MN-major), in n64 / n32 / n16 pieces
template <int OFF, int REM, int NT>
__device__ __forceinline__ void wgmma_rows(float (&acc)[NT][4],
                                           const uint32_t (&a)[4],
                                           uint32_t b_addr, uint32_t lbo) {
  const uint64_t db = gmma_desc(b_addr + OFF / 16 * lbo, lbo, 256, 3);
  if constexpr (REM >= 64) {
    wgmma_rs_n64<OFF / 8>(acc, a, db, 1);
    wgmma_rows<OFF + 64, REM - 64>(acc, a, b_addr, lbo);
  } else if constexpr (REM == 32) {
    wgmma_rs_n32<OFF / 8>(acc, a, db, 1);
  } else if constexpr (REM == 16) {
    wgmma_rs_n16<OFF / 8>(acc, a, db, 1);
  }
}

// fp32 accumulator fragments (columns 16 kk ..) rounded to bf16 A operands
template <int NT, int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4],
                                       const float (&s)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
}

// A block: 64 keys of one (b, kv head).  Consumer warpgroup 0 makes S^T
// and P^T and accumulates dV; warpgroup 1 makes dP^T, takes P^T from 0
// through shared memory (two buffers, handed / taken barriers), makes dS^T
// and accumulates dK.  Each warpgroup holds one 64 x hd accumulator and one
// 64 x Br score tile, its products wait on none of the other's registers,
// and its accumulation of a step runs on while the next step's scores are
// issued (at most about 100 accumulator registers in flight: more, and
// ptxas serialises the products).  The ring runs over (g, query tile) steps, g outer, in the
// same order for every block and launch.
template <int HD, bool kCap>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ lse,
                     const float* __restrict__ Drow, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Sq, int Skv, int Kh, int G,
                     int causal, int window, float softcap, float scale) {
  using T = Hop<HD, kCap>;
  constexpr int Bc = T::kBc, Br = T::kBr, St = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem_hop[];
  const uint32_t base = smem_u32(smem_hop);
  const uint32_t k_s = base, v_s = base + Bc * T::kRow;
  const uint32_t ring = base + 2 * Bc * T::kRow;  // stage st: Q, then dO
  float* rows = reinterpret_cast<float*>(smem_hop + T::kDkvRows);  // lse, D
  // hand-off buffer x: [Br / 8][128 threads] float4, a thread's fragment
  float4* hand = reinterpret_cast<float4*>(smem_hop + T::kDkvHand);
  const uint32_t bars = base + T::kDkvBars;  // full[St], empty[St]
  const uint32_t res = bars + 16 * St;
  const uint32_t handed = res + 8, taken = res + 24;  // [2] each

  const int kh = blockIdx.x % Kh;
  const int b = blockIdx.x / Kh;
  const int k0 = blockIdx.y * Bc;  // low keys meet the most queries: first
  // the queries these keys meet: q >= k when causal, q < k + window
  const int k_last = min(k0 + Bc, Skv) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int qt_begin = q_lo / Br;
  const int n_qt = q_hi > q_lo ? (q_hi + Br - 1) / Br - qt_begin : 0;
  const int steps = G * n_qt;  // (g, query tile) pairs
  const int tid = threadIdx.x;
  // the warpgroup, uniform to the compiler (setmaxnreg splits on it)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (tid == 0) {
    for (int st = 0; st < St; ++st) {
      mbar_init(bars + 8 * st, 32);        // the producer lanes' copies
      mbar_init(bars + 8 * (St + st), 8);  // the consumer warps
    }
    mbar_init(res, 1);
    for (int x = 0; x < 2; ++x) {
      mbar_init(handed + 8 * x, 128);  // warpgroup 0's threads
      mbar_init(taken + 8 * x, 128);   // warpgroup 1's threads
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (tid < 2 * 128 + 32) {  // one producer warp
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_arrive_expect_tx(res, 2 * Bc * T::kRow);
        for (int kk = 0; kk < T::kSteps; ++kk) {
          tma_load_4d(k_s + kk * Bc * 32, &tm_k, 16 * kk, k0, kh, b, res);
          tma_load_4d(v_s + kk * Bc * 32, &tm_v, 16 * kk, k0, kh, b, res);
        }
      }
      const float* lb = lse + ((int64_t)b * Kh + kh) * G * Sq;
      const float* db = Drow + ((int64_t)b * Kh + kh) * G * Sq;
      for (int it = 0; it < steps; ++it) {
        const int st = it % St;
        const int g = it / n_qt;
        const int q0 = (qt_begin + it % n_qt) * Br;
        const uint32_t full = bars + 8 * st;
        const uint32_t q_s = ring + st * 2 * Br * T::kRow;
        mbar_wait(bars + 8 * (St + st), ((it / St) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full, 2 * Br * T::kRow);
          for (int kk = 0; kk < T::kSteps; ++kk) {
            tma_load_4d(q_s + kk * Br * 32, &tm_q, 16 * kk, q0, kh * G + g,
                        b, full);
            tma_load_4d(q_s + Br * T::kRow + kk * Br * 32, &tm_do, 16 * kk,
                        q0, kh * G + g, b, full);
          }
        }
        // the rows' lse and D by cp.async, so the warp never waits on them
        const uint32_t r = smem_u32(rows + st * 2 * Br);
        for (int i = lane; i < Br; i += 32) {
          const int64_t off = (int64_t)g * Sq + min(q0 + i, Sq - 1);
          cp_async4(r + 4 * i, lb + off, true);
          cp_async4(r + 4 * (Br + i), db + off, true);
        }
        mbar_arrive_cp_async(full);
      }
    }
  } else {
    // consumers: warpgroup 0 (S^T, P^T, dV) and 1 (dP^T, dS^T, dK) over
    // the block's 64 keys, this thread's kp0 + {0, 8}
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
    const int lane = tid & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int t128 = tid & 127;
    const int kp0 = k0 + 16 * warp + gid;
    const float scale_log2 = scale * kLog2e;
    const float scale_cap = softcap > 0.f ? scale / softcap : 0.f;
    const float cap_log2 = softcap * kLog2e;
    const uint32_t a_s = wg == 0 ? k_s : v_s;  // K for S^T, V for dP^T
    float acc[HD / 8][4];  // dV (warpgroup 0) or dK (1)
    zero(acc);
    float sc[Br / 8][4];  // S^T (then P^T) or dP^T (then dS^T)
    zero(sc);
    uint32_t a[Br / 16][4];  // P^T or dS^T in bf16, the A operand
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (St + stage));
    };
    int xc = 0;     // hand-offs so far
    int held = -1;  // the stage this warpgroup's last accumulation reads
    mbar_wait(res, 0);

    for (int it = 0; it < steps; ++it) {
      const int st = it % St;
      const int q0 = (qt_begin + it % n_qt) * Br;
      const uint32_t q_s = ring + st * 2 * Br * T::kRow;
      const uint32_t do_s = q_s + Br * T::kRow;
      mbar_wait(bars + 8 * st, (it / St) & 1);
      // a tile that no pair of the block's keys allows
      if (k0 >= Skv || (causal && q0 + Br - 1 < k0) ||
          (window > 0 && q0 > k_last + window - 1)) {
        wgmma_wait<0>();
        hold(acc);
        hold(a);
        if (held >= 0) release(held);
        held = -1;
        release(st);
        continue;
      }
      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1), issued while the
      // last step's accumulation still runs
      const uint32_t b_s = wg == 0 ? q_s : do_s;
      hold(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk)
        wgmma_ss<Br>(sc, gmma_desc(a_s + kk * Bc * 32, 16, 256, 3),
                     gmma_desc(b_s + kk * Br * 32, 16, 256, 3), kk);
      wgmma_commit();
      wgmma_wait<1>();  // the last step's accumulation
      hold(acc);
      hold(a);
      if (held >= 0) release(held);
      wgmma_wait<0>();
      hold(sc);

      const float* r = rows + st * 2 * Br;
      float4* hx = hand + (xc & 1) * (Br / 8) * 128;
      const uint32_t x_par = (xc >> 1) & 1;
      const uint32_t x_off = 8 * (xc & 1);
      uint32_t b_t;  // the B operand of this warpgroup's accumulation
      if (wg == 0) {
        // P^T (rows: keys; columns: queries), the per-element mask only on
        // tiles that cross an edge; rounded into the A operand, and handed
        // to warpgroup 1 times the softcap's 1 - tanh^2
        const bool edge = k0 + Bc > Skv || q0 + Br > Sq ||
                          (causal && k0 + Bc - 1 > q0) ||
                          (window > 0 && k0 <= q0 + Br - 1 - window);
        mbar_wait(taken + x_off, x_par ^ 1);  // buffer free again
        with_edge(edge, [&](auto kedge) {
#pragma unroll
          for (int j = 0; j < Br / 8; ++j) {
            float p[4], pc[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = 8 * j + 2 * tig + (e & 1);
              float cap;
              p[e] = p_tile<kCap>(sc[j][e], r[qc], cap_log2, scale_cap,
                                  scale_log2, cap);
              if (decltype(kedge)::value &&
                  !allowed(q0 + qc, kp0 + (e >> 1) * 8, Sq, Skv, causal,
                           window))
                p[e] = 0.f;
              pc[e] = kCap ? p[e] * cap : p[e];
            }
            a[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
            a[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
            hx[j * 128 + t128] = make_float4(pc[0], pc[1], pc[2], pc[3]);
          }
        });
        mbar_arrive(handed + x_off);
        b_t = do_s;  // dV += P^T dO
      } else {
        // dS^T = P^T (dP^T - D), rounded into the A operand
        mbar_wait(handed + x_off, x_par);
#pragma unroll
        for (int j = 0; j < Br / 8; ++j) {
          const float4 pc = hx[j * 128 + t128];
          const float* d = r + Br + 8 * j + 2 * tig;
          sc[j][0] = pc.x * (sc[j][0] - d[0]);
          sc[j][1] = pc.y * (sc[j][1] - d[1]);
          sc[j][2] = pc.z * (sc[j][2] - d[0]);
          sc[j][3] = pc.w * (sc[j][3] - d[1]);
        }
        mbar_arrive(taken + x_off);
        pack_a(a, sc);
        b_t = q_s;  // dK += dS^T Q
      }
      ++xc;
      hold(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < Br / 16; ++ks)
        wgmma_rows<0, HD>(acc, a[ks], b_t + ks * 512, Br * 32);
      wgmma_commit();
      held = st;
    }
    wgmma_wait<0>();
    hold(acc);
    if (held >= 0) release(held);

    // dV as it stands, dK times the score scale
    const int64_t kv_tok = (int64_t)Kh * HD;
    bf16* out = (wg == 0 ? dv : dk) + (int64_t)b * Skv * kv_tok +
                (int64_t)kh * HD;
    const float f = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kp = kp0 + 8 * h;
        if (kp >= Skv) continue;
        *reinterpret_cast<uint32_t*>(out + (int64_t)kp * kv_tok + col) =
            pack_bf16(acc[j][2 * h] * f, acc[j][2 * h + 1] * f);
      }
    }
  }
}

// A block: 128 queries of one folded (b, kh, g), 64 a consumer warpgroup;
// the ring runs over the allowed key tiles in order.
template <int HD, bool kCap>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ lse,
                   const float* __restrict__ Drow, bf16* __restrict__ dq,
                   int Sq, int Skv, int Kh, int G, int causal, int window,
                   float softcap, float scale) {
  using T = Hop<HD, kCap>;
  constexpr int Bq = T::kBq, Bk = T::kBk, St = T::kDqStages;
  extern __shared__ __align__(1024) unsigned char smem_hop[];
  const uint32_t base = smem_u32(smem_hop);
  const uint32_t q_s = base, do_s = base + Bq * T::kRow;
  const uint32_t ring = base + 2 * Bq * T::kRow;  // stage st: K, then V
  const uint32_t bars = base + T::kDqBars;  // full[St], empty[St], resident
  const uint32_t res = bars + 16 * St;

  const int row = blockIdx.x;  // folded (b, kh, g)
  const int g = row % G;
  const int kh = (row / G) % Kh;
  const int b = row / (G * Kh);
  // heaviest causal query tiles first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * Bq;
  // the keys these queries meet
  const int q_last = min(q0 + Bq, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / Bk;
  const int steps = kv_end > kv_begin ? (kv_end + Bk - 1) / Bk - t_begin : 0;
  const int tid = threadIdx.x;
  // the warpgroup, uniform to the compiler (setmaxnreg splits on it)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (tid == 0) {
    for (int st = 0; st < St; ++st) {
      mbar_init(bars + 8 * st, 1);          // the producer thread
      mbar_init(bars + 8 * (St + st), 8);   // the consumer warps
    }
    mbar_init(res, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 2 * 128) {  // one producer thread
      mbar_arrive_expect_tx(res, 2 * Bq * T::kRow);
      for (int kk = 0; kk < T::kSteps; ++kk) {
        tma_load_4d(q_s + kk * Bq * 32, &tm_q, 16 * kk, q0, kh * G + g, b, res);
        tma_load_4d(do_s + kk * Bq * 32, &tm_do, 16 * kk, q0, kh * G + g, b,
                    res);
      }
      for (int it = 0; it < steps; ++it) {
        const int st = it % St;
        const int kt0 = (t_begin + it) * Bk;
        const uint32_t full = bars + 8 * st;
        const uint32_t k_s = ring + st * 2 * Bk * T::kRow;
        mbar_wait(bars + 8 * (St + st), ((it / St) & 1) ^ 1);
        mbar_arrive_expect_tx(full, 2 * Bk * T::kRow);
        for (int kk = 0; kk < T::kSteps; ++kk) {
          tma_load_4d(k_s + kk * Bk * 32, &tm_k, 16 * kk, kt0, kh, b, full);
          tma_load_4d(k_s + Bk * T::kRow + kk * Bk * 32, &tm_v, 16 * kk, kt0,
                      kh, b, full);
        }
      }
    }
  } else {
    // consumers: this warpgroup's 64 queries.  S and dP are issued
    // together and P is made while dP runs; each step ends with its dQ
    // product done (running it on beside the next step's S and dP gained
    // nothing measurable, and at hd 128 makes ptxas serialise the
    // products).
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
    const int lane = tid & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int qw = q0 + 64 * wg;
    const int qw_last = min(qw + 64, Sq) - 1;
    const uint32_t qa = q_s + wg * 64 * 32, oa = do_s + wg * 64 * 32;
    const float scale_log2 = scale * kLog2e;
    const float scale_cap = softcap > 0.f ? scale / softcap : 0.f;
    const float cap_log2 = softcap * kLog2e;
    // this thread's rows' lse and D (rows past Sq are masked)
    float lr[2], dr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = qw + 16 * warp + gid + 8 * h;
      const int64_t off = (int64_t)row * Sq + min(qp, Sq - 1);
      lr[h] = lse[off];
      dr[h] = Drow[off];
    }
    float acc[HD / 8][4];
    zero(acc);
    float s[Bk / 8][4], dp[Bk / 8][4];  // S, dP; then P, dS
    zero(s);
    zero(dp);
    uint32_t dsa[Bk / 16][4];
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (St + stage));
    };
    mbar_wait(res, 0);

    for (int it = 0; it < steps; ++it) {
      const int st = it % St;
      const int kt0 = (t_begin + it) * Bk;
      const uint32_t k_s = ring + st * 2 * Bk * T::kRow;
      const uint32_t v_s = k_s + Bk * T::kRow;
      mbar_wait(bars + 8 * st, (it / St) & 1);
      // a tile that no pair of this warpgroup's queries allows
      if (qw >= Sq || (causal && kt0 > qw_last) ||
          (window > 0 && kt0 + Bk - 1 <= qw - window)) {
        release(st);
        continue;
      }
      // S = Q K^T, then dP = dO V^T
      hold(s);
      hold(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk)
        wgmma_ss<Bk>(s, gmma_desc(qa + kk * Bq * 32, 16, 256, 3),
                     gmma_desc(k_s + kk * Bk * 32, 16, 256, 3), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk)
        wgmma_ss<Bk>(dp, gmma_desc(oa + kk * Bq * 32, 16, 256, 3),
                     gmma_desc(v_s + kk * Bk * 32, 16, 256, 3), kk);
      wgmma_commit();
      wgmma_wait<1>();  // S
      hold(s);

      // P (rows: queries; columns: keys) times the softcap's 1 - tanh^2;
      // the per-element mask only on tiles that cross an edge
      const bool edge = kt0 + Bk > Skv || qw + 64 > Sq ||
                        (causal && kt0 + Bk - 1 > qw) ||
                        (window > 0 && kt0 <= qw + 63 - window);
      with_edge(edge, [&](auto kedge) {
#pragma unroll
        for (int j = 0; j < Bk / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            float cap;
            float p = p_tile<kCap>(s[j][e], lr[h], cap_log2, scale_cap,
                                   scale_log2, cap);
            if (decltype(kedge)::value &&
                !allowed(qw + 16 * warp + gid + 8 * h,
                         kt0 + 8 * j + 2 * tig + (e & 1), Sq, Skv, causal,
                         window))
              p = 0.f;
            s[j][e] = kCap ? p * cap : p;
          }
        }
      });
      wgmma_wait<0>();  // dP
      hold(dp);
      // dS = P (dP - D), rounded into the A operand
#pragma unroll
      for (int j = 0; j < Bk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - dr[e >> 1]);
      pack_a(dsa, dp);
      // dQ += dS K
      hold(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < Bk / 16; ++ks)
        wgmma_rows<0, HD>(acc, dsa[ks], k_s + ks * 512, Bk * 32);
      wgmma_commit();
      wgmma_wait<0>();
      hold(acc);
      hold(dsa);
      release(st);
    }

    const int64_t q_tok = (int64_t)Kh * G * HD;
    bf16* dqb = dq + (int64_t)b * Sq * q_tok + ((int64_t)kh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qp = qw + 16 * warp + gid + 8 * h;
        if (qp >= Sq) continue;
        *reinterpret_cast<uint32_t*>(dqb + (int64_t)qp * q_tok + col) =
            pack_bf16(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------- fp32
// 32 x 32 tiles, 256 threads: thread (r = tid / 8, c8 = tid % 8) computes
// S and dP for row r against columns c8 + 8 i (i < 4), then accumulates
// elements c8 + 8 j (j < hd / 8) of row r of its gradient.
constexpr int kF32Threads = 256;
constexpr int kF32Tile = 32;

template <int HD>
struct F32 {
  static constexpr int kLd = HD + 4;  // float4 rows, spread over banks
  static constexpr int kPl = kF32Tile + 1;
  static constexpr int kSmem =
      (4 * kF32Tile * kLd + 2 * kF32Tile * kPl + 2 * kF32Tile) * 4;
  static_assert(kSmem <= 232448, "shared memory");
};

// rows [start, start + 32) of a [.., tok]-strided fp32 tensor into rows of
// kLd floats; rows at or past limit are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int64_t tok, int start,
                                              int limit) {
  for (int i = threadIdx.x; i < kF32Tile * HD / 4; i += kF32Threads) {
    const int r = i / (HD / 4);
    const int c = i - r * (HD / 4);
    const int pos = start + r;
    const float4 val =
        pos < limit
            ? *reinterpret_cast<const float4*>(src + (int64_t)pos * tok + 4 * c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * F32<HD>::kLd + 4 * c) = val;
  }
}

template <int HD>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int h = 0; h < HD; h += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + h);
    const float4 y = *reinterpret_cast<const float4*>(b + h);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// A block: 32 keys of one (b, kv head); loops over (g, query tile).
template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ Drow, float* __restrict__ dk,
                   float* __restrict__ dv, int Sq, int Skv, int Kh, int G,
                   int causal, int window, float softcap, float scale) {
  using C = F32<HD>;
  constexpr int Ld = C::kLd, Pl = C::kPl, Bt = kF32Tile;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;             // [32][Ld]
  float* vs = ks + Bt * Ld;    // [32][Ld]
  float* qs = vs + Bt * Ld;    // [32][Ld]
  float* dos = qs + Bt * Ld;   // [32][Ld]
  float* pt = dos + Bt * Ld;   // [32 keys][Pl]: P^T
  float* dst = pt + Bt * Pl;   // [32 keys][Pl]: dS^T
  float* ls = dst + Bt * Pl;   // [32]
  float* dsr = ls + Bt;        // [32]

  const int kh = blockIdx.x % Kh;
  const int b = blockIdx.x / Kh;
  const int k0 = blockIdx.y * Bt;
  const int r = threadIdx.x >> 3;
  const int c8 = threadIdx.x & 7;
  const int64_t q_tok = (int64_t)Kh * G * HD;
  const int64_t kv_tok = (int64_t)Kh * HD;
  const float* qb = q + (int64_t)b * Sq * q_tok + (int64_t)kh * G * HD;
  const float* dob = dout + (int64_t)b * Sq * q_tok + (int64_t)kh * G * HD;
  const float* lb = lse + ((int64_t)b * Kh + kh) * G * Sq;
  const float* db = Drow + ((int64_t)b * Kh + kh) * G * Sq;
  const int k_last = min(k0 + Bt, Skv) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int qt_begin = q_lo / Bt;
  const int n_qt = q_hi > q_lo ? (q_hi + Bt - 1) / Bt - qt_begin : 0;
  const float scale_log2 = scale * kLog2e;

  load_rows_f32<HD>(ks, k + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD,
                    kv_tok, k0, Skv);
  load_rows_f32<HD>(vs, v + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD,
                    kv_tok, k0, Skv);
  float dka[HD / 8], dva[HD / 8];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) dka[j] = dva[j] = 0.f;

  for (int it = 0; it < G * n_qt; ++it) {
    const int g = it / n_qt;
    const int q0 = (qt_begin + it % n_qt) * Bt;
    __syncthreads();  // the previous tile is done with
    load_rows_f32<HD>(qs, qb + g * HD, q_tok, q0, Sq);
    load_rows_f32<HD>(dos, dob + g * HD, q_tok, q0, Sq);
    if (threadIdx.x < Bt) {
      const int pos = q0 + threadIdx.x;
      ls[threadIdx.x] = pos < Sq ? lb[(int64_t)g * Sq + pos] : 0.f;
      dsr[threadIdx.x] = pos < Sq ? db[(int64_t)g * Sq + pos] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qc = c8 + 8 * i;
      PdS x = p_ds(dot_f32<HD>(ks + r * Ld, qs + qc * Ld),
                   dot_f32<HD>(vs + r * Ld, dos + qc * Ld), ls[qc], dsr[qc],
                   softcap, scale, scale_log2);
      if (!allowed(q0 + qc, k0 + r, Sq, Skv, causal, window))
        x.p = x.ds = 0.f;
      pt[r * Pl + qc] = x.p;
      dst[r * Pl + qc] = x.ds;
    }
    __syncthreads();
    for (int c = 0; c < Bt; ++c) {
      const float p = pt[r * Pl + c];
      const float ds = dst[r * Pl + c];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        dva[j] = fmaf(p, dos[c * Ld + c8 + 8 * j], dva[j]);
        dka[j] = fmaf(ds, qs[c * Ld + c8 + 8 * j], dka[j]);
      }
    }
  }
  const int kp = k0 + r;
  if (kp >= Skv) return;
  float* dkr = dk + (int64_t)b * Skv * kv_tok + (int64_t)kp * kv_tok +
               (int64_t)kh * HD;
  float* dvr = dv + (int64_t)b * Skv * kv_tok + (int64_t)kp * kv_tok +
               (int64_t)kh * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    dkr[c8 + 8 * j] = dka[j] * scale;
    dvr[c8 + 8 * j] = dva[j];
  }
}

// A block: 32 queries of one folded (b, kh, g); loops over key tiles.
template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ Drow, float* __restrict__ dq,
                 int Sq, int Skv, int Kh, int G, int causal, int window,
                 float softcap, float scale) {
  using C = F32<HD>;
  constexpr int Ld = C::kLd, Pl = C::kPl, Bt = kF32Tile;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;             // [32][Ld]
  float* dos = qs + Bt * Ld;   // [32][Ld]
  float* ks = dos + Bt * Ld;   // [32][Ld]
  float* vs = ks + Bt * Ld;    // [32][Ld]
  float* dss = vs + Bt * Ld;   // [32 queries][Pl]: dS

  const int row = blockIdx.x;
  const int g = row % G;
  const int kh = (row / G) % Kh;
  const int b = row / (G * Kh);
  const int q0 = blockIdx.y * Bt;
  const int r = threadIdx.x >> 3;
  const int c8 = threadIdx.x & 7;
  const int64_t q_tok = (int64_t)Kh * G * HD;
  const int64_t kv_tok = (int64_t)Kh * HD;
  const int64_t q_off = (int64_t)b * Sq * q_tok + ((int64_t)kh * G + g) * HD;
  const float* kb = k + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;
  const float* vb = v + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;
  const int q_last = min(q0 + Bt, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / Bt;
  const int t_end = kv_end > kv_begin ? (kv_end + Bt - 1) / Bt : t_begin;
  const float scale_log2 = scale * kLog2e;
  const int qp = q0 + r;
  const float lr = qp < Sq ? lse[(int64_t)row * Sq + qp] : 0.f;
  const float dr = qp < Sq ? Drow[(int64_t)row * Sq + qp] : 0.f;

  load_rows_f32<HD>(qs, q + q_off, q_tok, q0, Sq);
  load_rows_f32<HD>(dos, dout + q_off, q_tok, q0, Sq);
  float acc[HD / 8];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * Bt;
    __syncthreads();  // the previous tile is done with
    load_rows_f32<HD>(ks, kb, kv_tok, k0, Skv);
    load_rows_f32<HD>(vs, vb, kv_tok, k0, Skv);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = c8 + 8 * i;
      PdS x = p_ds(dot_f32<HD>(qs + r * Ld, ks + kc * Ld),
                   dot_f32<HD>(dos + r * Ld, vs + kc * Ld), lr, dr, softcap,
                   scale, scale_log2);
      if (!allowed(qp, k0 + kc, Sq, Skv, causal, window)) x.ds = 0.f;
      dss[r * Pl + kc] = x.ds;
    }
    __syncthreads();
    for (int c = 0; c < Bt; ++c) {
      const float ds = dss[r * Pl + c];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        acc[j] = fmaf(ds, ks[c * Ld + c8 + 8 * j], acc[j]);
    }
  }
  if (qp >= Sq) return;
  float* dqr = dq + q_off + (int64_t)qp * q_tok;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) dqr[c8 + 8 * j] = acc[j] * scale;
}

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  float* D;
  void *dq, *dk, *dv;
  int B, Sq, Skv, Kh, G, causal, window;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename E, int HD>
cudaError_t launch_row_dot(const Args& a) {
  const int64_t rows = (int64_t)a.B * a.Sq * a.Kh * a.G;
  const int64_t blocks = (rows + 15) / 16;  // 16 rows a block of 256
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  row_dot_kernel<E, HD><<<(unsigned)blocks, 256, 0, a.stream>>>(
      static_cast<const E*>(a.o), static_cast<const E*>(a.dout), a.D, rows,
      a.Sq, a.Kh, a.G);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  using T = Tile<HD>;
  cudaError_t err = launch_row_dot<bf16, HD>(a);
  if (err != cudaSuccess) return err;
  const int64_t kv_tiles = (a.Skv + T::kBc - 1) / T::kBc;
  const int64_t q_tiles = (a.Sq + T::kBq - 1) / T::kBq;
  const int64_t heads = (int64_t)a.B * a.Kh;
  if (heads * a.G > 0x7fffffffLL || kv_tiles > 65535 || q_tiles > 65535)
    return cudaErrorInvalidValue;
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* dout = static_cast<const bf16*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  if (kv_tiles > 0) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kDkvSmem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<HD>
        <<<dim3((unsigned)heads, (unsigned)kv_tiles), T::kThreads,
           T::kDkvSmem, a.stream>>>(
            q, k, v, dout, lse, a.D, static_cast<bf16*>(a.dk),
            static_cast<bf16*>(a.dv), a.Sq, a.Skv, a.Kh, a.G, a.causal,
            a.window, a.softcap, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<HD>
      <<<dim3((unsigned)(heads * a.G), (unsigned)q_tiles), T::kThreads,
         T::kDqSmem, a.stream>>>(q, k, v, dout, lse, a.D,
                                 static_cast<bf16*>(a.dq), a.Sq, a.Skv, a.Kh,
                                 a.G, a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Args& a) {
  using C = F32<HD>;
  cudaError_t err = launch_row_dot<float, HD>(a);
  if (err != cudaSuccess) return err;
  const int64_t kv_tiles = (a.Skv + kF32Tile - 1) / kF32Tile;
  const int64_t q_tiles = (a.Sq + kF32Tile - 1) / kF32Tile;
  const int64_t heads = (int64_t)a.B * a.Kh;
  if (heads * a.G > 0x7fffffffLL || kv_tiles > 65535 || q_tiles > 65535)
    return cudaErrorInvalidValue;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* dout = static_cast<const float*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_f32<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  if (kv_tiles > 0) {
    flash_bwd_dkdv_f32<HD><<<dim3((unsigned)heads, (unsigned)kv_tiles),
                             kF32Threads, C::kSmem, a.stream>>>(
        q, k, v, dout, lse, a.D, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.Sq, a.Skv, a.Kh, a.G, a.causal,
        a.window, a.softcap, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_f32<HD><<<dim3((unsigned)(heads * a.G), (unsigned)q_tiles),
                         kF32Threads, C::kSmem, a.stream>>>(
      q, k, v, dout, lse, a.D, static_cast<float*>(a.dq), a.Sq, a.Skv, a.Kh,
      a.G, a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda of its own); null when the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 [batch, rows, heads, hd] tensor as TMA boxes of 16 head dims x
// box_rows rows of one head, 32-byte swizzled; rows past the end load as
// zeros.
bool rows_map(CUtensorMap* map, const void* ptr, int batch, int rows,
              int heads, int hd, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)heads * hd * sizeof(bf16);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {row, (cuuint64_t)hd * sizeof(bf16),
                                 row * (cuuint64_t)rows};
  const cuuint32_t box[4] = {16, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// setmaxnreg moves registers within the block's allocation: a kernel
// compiled to fewer registers a thread than the split needs would leave the
// consumers' setmaxnreg.inc waiting forever, so it is refused instead
template <typename Kernel>
cudaError_t prepare_wgmma(Kernel kernel, int smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kHopThreads < kProducerRegs * 128 + kConsumerRegs * 256)
    return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD, bool kCap>
cudaError_t launch_wgmma_kernels(const Args& a) {
  using T = Hop<HD, kCap>;
  const int64_t kv_tiles = (a.Skv + T::kBc - 1) / T::kBc;
  const int64_t q_tiles = (a.Sq + T::kBq - 1) / T::kBq;
  const int64_t heads = (int64_t)a.B * a.Kh;
  if (heads * a.G > 0x7fffffffLL || kv_tiles > 65535 || q_tiles > 65535)
    return cudaErrorInvalidValue;
  const int skv = a.Skv > 0 ? a.Skv : 1;  // no key: the maps are not read
  const int qh = a.Kh * a.G;
  // K and V load in 64-row boxes in both kernels; Q and dO in the dK/dV
  // kernel's query tiles and the dQ kernel's query blocks
  static_assert(T::kBc == T::kBk, "one K / V box");
  CUtensorMap q_br, do_br, q_bq, do_bq, k_map, v_map;
  if (!rows_map(&q_br, a.q, a.B, a.Sq, qh, HD, T::kBr) ||
      !rows_map(&do_br, a.dout, a.B, a.Sq, qh, HD, T::kBr) ||
      !rows_map(&q_bq, a.q, a.B, a.Sq, qh, HD, T::kBq) ||
      !rows_map(&do_bq, a.dout, a.B, a.Sq, qh, HD, T::kBq) ||
      !rows_map(&k_map, a.k, a.B, skv, a.Kh, HD, T::kBk) ||
      !rows_map(&v_map, a.v, a.B, skv, a.Kh, HD, T::kBk))
    return cudaErrorInvalidValue;
  const auto* lse = static_cast<const float*>(a.lse);
  cudaError_t err;
  if (kv_tiles > 0) {
    err = prepare_wgmma(flash_bwd_dkdv_wgmma<HD, kCap>, T::kDkvSmem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_wgmma<HD, kCap>
        <<<dim3((unsigned)heads, (unsigned)kv_tiles), kHopThreads,
           T::kDkvSmem, a.stream>>>(
            q_br, do_br, k_map, v_map, lse, a.D, static_cast<bf16*>(a.dk),
            static_cast<bf16*>(a.dv), a.Sq, a.Skv, a.Kh, a.G, a.causal,
            a.window, a.softcap, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = prepare_wgmma(flash_bwd_dq_wgmma<HD, kCap>, T::kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma<HD, kCap>
      <<<dim3((unsigned)(heads * a.G), (unsigned)q_tiles), kHopThreads,
         T::kDqSmem, a.stream>>>(q_bq, do_bq, k_map, v_map, lse, a.D,
                                 static_cast<bf16*>(a.dq), a.Sq, a.Skv, a.Kh,
                                 a.G, a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

// D, then the dK/dV and dQ kernels compiled for the softcap's presence
template <int HD>
cudaError_t launch_wgmma(const Args& a) {
  const cudaError_t err = launch_row_dot<bf16, HD>(a);
  if (err != cudaSuccess) return err;
  return a.softcap > 0.f ? launch_wgmma_kernels<HD, true>(a)
                         : launch_wgmma_kernels<HD, false>(a);
}

Args make_args(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* D, void* dq, void* dk,
               void* dv, int B, int Sq, int Skv, int Kh, int G, int causal,
               int window, float softcap, float scale, void* stream) {
  return Args{q,  k,  v,  o,  lse,    dout,   static_cast<float*>(D),
              dq, dk, dv, B,  Sq,     Skv,    Kh,
              G,  causal, window, softcap, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// bf16 q, k, v, o, dout and gradients, fp32 lse [B, Kh, G, Sq] from the
// forward and D (scratch of the same shape); every pointer 16-byte
// aligned.  Three launches: D, dK/dV, dQ.
extern "C" int repro_flash_attention_backward_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* D, void* dq, void* dk, void* dv,
    int B, int Sq, int Skv, int Kh, int G, int hd, int causal, int window,
    float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Kh <= 0 || G <= 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, o, lse, dout, D, dq, dk, dv, B, Sq, Skv,
                           Kh, G, causal, window, softcap, scale, stream);
  switch (hd) {
    case 8: return (int)launch_bf16<8>(a);
    case 16: return (int)launch_bf16<16>(a);
    case 32: return (int)launch_bf16<32>(a);
    case 64: return (int)launch_wgmma<64>(a);
    case 80: return (int)launch_wgmma<80>(a);
    case 96: return (int)launch_wgmma<96>(a);
    case 128: return (int)launch_wgmma<128>(a);
    case 256: return (int)launch_bf16<256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same for fp32 q, k, v, o, dout and gradients.
extern "C" int repro_flash_attention_backward_fp32(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* D, void* dq, void* dk, void* dv,
    int B, int Sq, int Skv, int Kh, int G, int hd, int causal, int window,
    float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Kh <= 0 || G <= 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, o, lse, dout, D, dq, dk, dv, B, Sq, Skv,
                           Kh, G, causal, window, softcap, scale, stream);
  switch (hd) {
    case 8: return (int)launch_f32<8>(a);
    case 16: return (int)launch_f32<16>(a);
    case 32: return (int)launch_f32<32>(a);
    case 64: return (int)launch_f32<64>(a);
    case 80: return (int)launch_f32<80>(a);
    case 96: return (int)launch_f32<96>(a);
    case 128: return (int)launch_f32<128>(a);
    case 256: return (int)launch_f32<256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

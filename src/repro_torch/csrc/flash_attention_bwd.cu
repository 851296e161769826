// The gradient of flash attention (sm_90a): bf16 on the tensor cores
// (mma.sync m16n8k16, fp32 accumulation), fp32 in FMAs.
//
// Replaces no TPU kernel: the reference trains by jax.grad of its plain
// attention (repro/kernels/flash_attention/ref.py), whose gradient XLA
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
// Bound on the H100: operations.  The two kernels do 14 * hd flops an
// allowed pair a query head (S and dP are rebuilt in both), against
// 10 * hd for one pass that could add into dQ; each q, k, v, o, dO
// element is read a few times from L2.  What the design does:
//   - FlashAttention-2's split, made deterministic: one block per
//     (b, kv head, 64-key tile) holds dK and dV in registers and loops
//     over its G query heads and the query tiles the mask allows, in a
//     fixed order; one block per (b, kv head, g, 64-query tile) holds dQ
//     and loops over the allowed key tiles.  No atomics, no split sums:
//     two launches are bit-identical.
//   - bf16: every product is mma.sync on the tensor cores.  A warp owns
//     16 keys (dK/dV kernel) or 16 queries (dQ kernel), so S^T / S and
//     dP^T / dP come out as accumulator fragments whose rows are the
//     warp's own; P and dS are rounded to bf16 in registers into the A
//     operand of the next product (dV += P^T dO, dK += dS^T Q,
//     dQ += dS K) without touching shared memory.  Operands come from
//     shared memory by ldmatrix (.trans where the product runs along the
//     rows of the stored tile), rows padded by 16 bytes so that the eight
//     rows of a matrix fall in distinct banks.
//   - Tiles stream through a 2-stage cp.async ring: the next query tile
//     (dK/dV) or key tile (dQ) is in flight while the current one is used.
//   - Registers: dK and dV of 16 keys at hd 128 are 128 fp32 values a
//     thread, so query tiles shrink to 32 rows from hd 128; at hd 256 two
//     warps share a 16-row group, each accumulating half of the head dims
//     (both rebuild the group's S and dP).  hd 8 is zero-padded to 16.
//   - Whole tiles that the mask allows everywhere skip the per-element
//     mask; query tiles that causality or the window cut away are never
//     visited.
//   - fp32: no training run uses it (the models compute in bf16), but the
//     card tests do.  A plain shared-memory kernel with the same split:
//     32 x 32 tiles of S and dP, a thread 4 dot products of each, then
//     each thread accumulates hd / 8 elements of its key's (query's) rows.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// D[b, kh, g, s] = sum_h dO * O over a row of [B, Sq, Kh, G, hd]: one warp
// a row, lanes strided over hd, then a fixed shuffle tree
template <typename E>
__global__ void row_dot_kernel(const E* __restrict__ o,
                               const E* __restrict__ dout,
                               float* __restrict__ D, int64_t rows, int Sq,
                               int Kh, int G, int hd) {
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const E* a = o + r * hd;
  const E* b = dout + r * hd;
  float acc = 0.f;
  for (int i = lane; i < hd; i += 32) acc = fmaf(to_f(a[i]), to_f(b[i]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int g = (int)(r % G);
    const int64_t t1 = r / G;
    const int kh = (int)(t1 % Kh);
    const int64_t t2 = t1 / Kh;
    const int s = (int)(t2 % Sq);
    const int64_t b0 = t2 / Sq;
    D[((b0 * Kh + kh) * G + g) * Sq + s] = acc;
  }
}

// whether key kp may be attended by query qp (the forward's mask)
__device__ __forceinline__ bool allowed(int qp, int kp, int Sq, int Skv,
                                        int causal, int window) {
  bool ok = kp < Skv && qp < Sq;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// P and dS of one score: s the raw dot product, dp the dO.V product
struct PdS {
  float p, ds;
};
__device__ __forceinline__ PdS p_ds(float s, float dp, float lse2, float D,
                                    float softcap, float scale,
                                    float scale_log2) {
  float x, cap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s * scale / softcap);
    x = softcap * t * kLog2e;
    cap = 1.f - t * t;
  } else {
    x = s * scale_log2;
  }
  const float p = exp2f(x - lse2);
  return {p, p * (dp - D) * cap};
}

// ---------------------------------------------------------------- bf16
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// two fp32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

template <typename E>
cudaError_t launch_row_dot(const Args& a, int hd) {
  const int64_t rows = (int64_t)a.B * a.Sq * a.Kh * a.G;
  const int64_t blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  row_dot_kernel<E><<<(unsigned)blocks, 256, 0, a.stream>>>(
      static_cast<const E*>(a.o), static_cast<const E*>(a.dout), a.D, rows,
      a.Sq, a.Kh, a.G, hd);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  using T = Tile<HD>;
  cudaError_t err = launch_row_dot<bf16>(a, HD);
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
  cudaError_t err = launch_row_dot<float>(a, HD);
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
    case 64: return (int)launch_bf16<64>(a);
    case 80: return (int)launch_bf16<80>(a);
    case 96: return (int)launch_bf16<96>(a);
    case 128: return (int)launch_bf16<128>(a);
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

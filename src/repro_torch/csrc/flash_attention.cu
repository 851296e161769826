// Flash attention with an online softmax for fp32 (sm_90a, FMAs outside
// the tensor cores).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// _flash_kernel / flash_attention_pallas, for fp32 q, k, v.  bf16 inputs
// (the model's compute dtype, every serving prefill) go to the tensor-core
// kernel in flash_attention_mma.cu.  It computes, for every query row of
// q [B, Sq, Kh, G, hd] against k, v [B, Skv, Kh, hd] (kv head = the query's
// Kh index, shared by its G query heads):
//   s = (q . k) / sqrt(hd), optionally softcap * tanh(s / softcap);
//   allowed pairs: k_pos < Skv, and k_pos <= q_pos when causal (positions
//   from 0, top-left aligned even when Sq != Skv), and k_pos > q_pos -
//   window when window > 0;
//   out = softmax(s) @ v over the allowed pairs, 0 for a row with none.
// Scores, the softmax, the accumulator and the output are fp32.
//
// Bound on the H100: operations.  Causal prefill does 4 * hd flops per
// allowed (q, k) pair and reads each q, k, v element once.  fp32 cannot go
// to the bf16 tensor cores or TF32 without leaving the fp32 tolerance, so
// this kernel keeps to fp32 FMAs, whose peak is 67 TFLOP/s.  Feeding the
// FMA pipe from shared memory is the limit, so the kernel is laid out as a
// register-blocked SIMT GEMM, twice:
//   - A block of 256 threads takes kBQ query rows (128 at hd 16-128) of one
//     folded (b, kh, g) and walks the allowed kv tiles of kBK keys (64, or
//     32 at hd >= 128) with a loop inside the block, in place of the TPU's
//     sequential grid axis.  The running max m, the row sums l and the
//     output accumulator stay in registers across it.
//   - S = Q.K^T: each thread owns a kRM x kKN micro-tile (8 rows x 4 keys).
//     For every 4 head dims it reads its rows' Q and its keys' K as float4s
//     from shared memory and does 16 * kRM * kKN / 4 FMAs: 128 FMAs for 12
//     vector loads.  The kCG lanes of a row group (16, or 8 at hd 8) share
//     its rows; their keys interleave (key cg + kCG * kk), and rows are
//     padded to hd + 4 floats, so the warp's K loads fall in distinct
//     banks.
//   - The online softmax works in the log2 domain: the scale is folded with
//     log2(e), so exp2f replaces expf.  The row max meets across a row
//     group's lanes by warp shuffles; each lane keeps its own part of the
//     row sum l and they meet once, at the end.
//   - P goes through a per-warp slice of shared memory ([key][row], float4
//     chunks XOR-swizzled by the key, so the writes do not conflict): only
//     the lanes of one warp exchange it, so a __syncwarp suffices.
//   - O += P.V: the same thread owns the same kRM rows times hd / kCG head
//     dims (float4 chunks, then single floats, interleaved over the row
//     group's lanes), so the rescale by exp2(m_old - m_new) and the final
//     1 / l stay in registers: kRM * hd / kCG FMAs for 2 P loads and
//     hd / kCG / 4 + hd % (4 kCG) / kCG V loads a key.
//   - Q is copied once; K and V come in through a 2-stage cp.async ring, so
//     the loads of tile t + 1 overlap the arithmetic of tile t.
//   - Whole kv tiles that causality or the window masks for every row of
//     the block are never loaded (the TPU kernel's pl.when pruning); only
//     tiles that cross the diagonal, the window edge or Skv pay for the
//     per-element mask.  Rows and keys past Sq / Skv are zero-filled in
//     shared memory; nothing is padded in device memory.  With causality,
//     blocks take the q tiles with the most kv tiles first.
//   - The NEG_INF = -1e30 guards of the TPU kernel are kept as they are,
//     and l == 0 flushes to 0.  No atomics: two launches are bit-identical.
// The tile shape is chosen from hd alone at compile time (Cfg below): hd 8
// has 8 lanes a row group (one head dim a lane in P.V), hd >= 128 takes
// 32-key tiles and hd 256 4-row micro-tiles, to stay within the 227 KB of
// shared memory and the registers a thread.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int HD>
struct Cfg {
  static constexpr int kCG = HD >= 16 ? 16 : 8;   // lanes a row group
  static constexpr int kRG = 32 / kCG;            // row groups a warp
  static constexpr int kRM = HD > 128 ? 4 : 8;    // rows a thread
  static constexpr int kKN = HD >= 128 ? 2 : 4;   // keys a thread, a tile
  static constexpr int kBQ = kWarps * kRG * kRM;  // query rows a block
  static constexpr int kBK = kCG * kKN;           // keys a tile
  static constexpr int kDN = HD / kCG;            // head dims a thread in O
  static constexpr int kV4 = kDN / 4;             // ... as float4 chunks
  static constexpr int kR1 = kDN % 4;             // ... and single floats
  static constexpr int kLd = HD + 4;              // padded row, floats
  static constexpr int kQFloats = kBQ * kLd;
  static constexpr int kKVFloats = kBK * kLd;
  static constexpr int kWRows = kRG * kRM;       // query rows a warp
  static constexpr int kWarpP = kBK * kWRows;     // a warp's P slice
  static constexpr int kNC = kWRows / 4;          // float4s a key of P
  static constexpr int kKR = 8 / kNC;             // keys of P a 128-B line
  static constexpr int kSmemBytes =
      4 * (kQFloats + 4 * kKVFloats + kWarps * kWarpP);
  static_assert(HD % kCG == 0 && HD % 4 == 0, "head dim");
  static_assert(kRM % 4 == 0 && kRM * kKN <= 32, "the mask is one word");
  static_assert(kNC >= 1 && kNC <= 8, "a key of P within one 128-B line");
  static_assert((kLd / 4) % 2 == 1, "odd row stride in float4s");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy `n_rows` rows of HD floats, row i from src + i * stride (elements),
// into dst rows of C::kLd floats; rows at or past `valid` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int n_rows,
                                          int valid, int tid) {
  using C = Cfg<HD>;
  constexpr int kChunks = HD / 4;
  for (int i = tid; i < n_rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool ok = r < valid;
    cp_async16(dst + r * C::kLd + 4 * c,
               ok ? src + (int64_t)r * stride + 4 * c : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Sq,
             int Skv, int Kh, int G, int causal, int window, float softcap,
             float scale) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [kBQ][kLd]
  float* kvs = qs + C::kQFloats;             // 2 stages of K, then V
  float* ps_all = kvs + 4 * C::kKVFloats;    // per warp [kBK][kRG * kRM]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane / C::kCG;
  const int cg = lane % C::kCG;
  // the thread's rows: wr0 + kRG * i of the block's (the row groups of a
  // warp interleave, so their Q loads fall in distinct banks); in the
  // warp's P slice they are the float4 chunks pc0 + i / 4
  const int wr0 = warp * C::kWRows + rg;
  const int pc0 = rg * (C::kRM / 4);
  float* ps = ps_all + warp * C::kWarpP;

  const int row = blockIdx.x;  // folded (b, kh, g)
  const int g = row % G;
  const int kh = (row / G) % Kh;
  const int b = row / (G * Kh);
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * C::kBQ;

  const int64_t q_tok = (int64_t)Kh * G * HD;  // elements between positions
  const int64_t kv_tok = (int64_t)Kh * HD;
  const int64_t q_off = (int64_t)b * Sq * q_tok + ((int64_t)kh * G + g) * HD;
  const float* kb = k + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;
  const float* vb = v + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;

  // log2 domain: s2 = log2(e) * s
  const bool capped = softcap > 0.f;
  const float mul_in = capped ? scale / softcap : scale * kLog2e;
  const float mul_out = softcap * kLog2e;

  // kv tiles that hold an allowed pair for some row of this block
  const int q_last = min(q0 + C::kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / C::kBK;
  const int t_end = (kv_end + C::kBK - 1) / C::kBK;

  float acc[C::kRM][C::kDN];
  float m[C::kRM], l[C::kRM];
#pragma unroll
  for (int i = 0; i < C::kRM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < C::kDN; ++e) acc[i][e] = 0.f;
  }

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * C::kBK;
    float* ks = kvs + stage * C::kKVFloats;
    float* vs = kvs + (2 + stage) * C::kKVFloats;
    load_rows<HD>(ks, kb + (int64_t)k0 * kv_tok, kv_tok, C::kBK, Skv - k0,
                  tid);
    load_rows<HD>(vs, vb + (int64_t)k0 * kv_tok, kv_tok, C::kBK, Skv - k0,
                  tid);
  };

  if (t_begin < t_end) {
    load_rows<HD>(qs, q + q_off + (int64_t)q0 * q_tok, q_tok, C::kBQ,
                  Sq - q0, tid);
    load_kv(t_begin, 0);
    cp_commit();
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile t (and Q) are in shared memory
    const float* ks = kvs + stage * C::kKVFloats;
    const float* vs = kvs + (2 + stage) * C::kKVFloats;
    const int k0 = t * C::kBK;

    // ---- S = Q . K^T for kRM rows x kKN keys (keys cg + kCG * kk)
    float s[C::kRM][C::kKN];
#pragma unroll
    for (int i = 0; i < C::kRM; ++i)
#pragma unroll
      for (int kk = 0; kk < C::kKN; ++kk) s[i][kk] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 kf[C::kKN];
#pragma unroll
      for (int kk = 0; kk < C::kKN; ++kk)
        kf[kk] = *reinterpret_cast<const float4*>(
            ks + (cg + C::kCG * kk) * C::kLd + d);
#pragma unroll
      for (int i = 0; i < C::kRM; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(
            qs + (wr0 + C::kRG * i) * C::kLd + d);
#pragma unroll
        for (int kk = 0; kk < C::kKN; ++kk) {
          s[i][kk] = fmaf(qf.x, kf[kk].x, s[i][kk]);
          s[i][kk] = fmaf(qf.y, kf[kk].y, s[i][kk]);
          s[i][kk] = fmaf(qf.z, kf[kk].z, s[i][kk]);
          s[i][kk] = fmaf(qf.w, kf[kk].w, s[i][kk]);
        }
      }
    }

    // ---- scale, softcap and the mask (per element only on edge tiles)
    const bool full =
        k0 + C::kBK <= Skv && (!causal || k0 + C::kBK - 1 <= q0) &&
        (window <= 0 || k0 > q0 + C::kBQ - 1 - window);
    uint32_t ok_bits = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < C::kRM; ++i) {
      const int qp = q0 + wr0 + C::kRG * i;
#pragma unroll
      for (int kk = 0; kk < C::kKN; ++kk) {
        float x = capped ? mul_out * tanhf(s[i][kk] * mul_in)
                         : s[i][kk] * mul_in;
        if (!full) {
          const int kp = k0 + cg + C::kCG * kk;
          bool ok = kp < Skv;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) {
            x = kNegInf;
            ok_bits &= ~(1u << (i * C::kKN + kk));
          }
        }
        s[i][kk] = x;
      }
    }

    // ---- online softmax: row max across the row group's lanes
#pragma unroll
    for (int i = 0; i < C::kRM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int kk = 1; kk < C::kKN; ++kk) mx = fmaxf(mx, s[i][kk]);
#pragma unroll
      for (int off = C::kCG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // guard fully masked rows: exp(NEG_INF - NEG_INF)
      const float m_sub = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      const float alpha = m[i] <= kNegInf * 0.5f ? 0.f : exp2f(m[i] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::kKN; ++kk) {
        const float p = ((ok_bits >> (i * C::kKN + kk)) & 1u)
                            ? exp2f(s[i][kk] - m_sub)
                            : 0.f;
        s[i][kk] = p;
        p_sum += p;
      }
      l[i] = l[i] * alpha + p_sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < C::kDN; ++e) acc[i][e] *= alpha;
    }

    // ---- P to the warp's slice: [key][kWRows], float4 chunk c of key j
    // stored at c ^ ((j / kKR) % kNC): the 8 keys that a quarter of the
    // warp writes at once land in 8 distinct 16-byte bank groups
    __syncwarp();  // every lane is done reading the previous tile's P
#pragma unroll
    for (int kk = 0; kk < C::kKN; ++kk) {
      const int j = cg + C::kCG * kk;
#pragma unroll
      for (int i4 = 0; i4 < C::kRM / 4; ++i4) {
        const int chunk = (pc0 + i4) ^ ((j / C::kKR) % C::kNC);
        *reinterpret_cast<float4*>(ps + j * C::kWRows + 4 * chunk) =
            make_float4(s[4 * i4][kk], s[4 * i4 + 1][kk], s[4 * i4 + 2][kk],
                        s[4 * i4 + 3][kk]);
      }
    }
    __syncwarp();

    // ---- O += P . V for kRM rows x kDN head dims (16 keys a trip: the
    // fastest of 4, 8, 16 and all 64 at the stablelm-3b shape, PERF.md)
#pragma unroll 16
    for (int j = 0; j < C::kBK; ++j) {
      float pr[C::kRM];
#pragma unroll
      for (int i4 = 0; i4 < C::kRM / 4; ++i4) {
        const int chunk = (pc0 + i4) ^ ((j / C::kKR) % C::kNC);
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + j * C::kWRows + 4 * chunk);
        pr[4 * i4] = p4.x;
        pr[4 * i4 + 1] = p4.y;
        pr[4 * i4 + 2] = p4.z;
        pr[4 * i4 + 3] = p4.w;
      }
      const float* vr = vs + j * C::kLd;
      float vv[C::kDN];
#pragma unroll
      for (int c = 0; c < C::kV4; ++c) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(vr + 4 * (cg + C::kCG * c));
        vv[4 * c] = v4.x;
        vv[4 * c + 1] = v4.y;
        vv[4 * c + 2] = v4.z;
        vv[4 * c + 3] = v4.w;
      }
#pragma unroll
      for (int e = 0; e < C::kR1; ++e)
        vv[4 * C::kV4 + e] = vr[4 * C::kCG * C::kV4 + cg + C::kCG * e];
#pragma unroll
      for (int i = 0; i < C::kRM; ++i)
#pragma unroll
        for (int e = 0; e < C::kDN; ++e)
          acc[i][e] = fmaf(pr[i], vv[e], acc[i][e]);
    }
    __syncthreads();  // every warp is done with this stage
  }

  // ---- the row sums meet across the row group; out = acc / l
#pragma unroll
  for (int i = 0; i < C::kRM; ++i) {
#pragma unroll
    for (int off = C::kCG / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  }
#pragma unroll
  for (int i = 0; i < C::kRM; ++i) {
    const int qp = q0 + wr0 + C::kRG * i;
    if (qp >= Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    float* orow = o + q_off + (int64_t)qp * q_tok;
#pragma unroll
    for (int c = 0; c < C::kV4; ++c)
      *reinterpret_cast<float4*>(orow + 4 * (cg + C::kCG * c)) =
          make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv,
                      acc[i][4 * c + 2] * inv, acc[i][4 * c + 3] * inv);
#pragma unroll
    for (int e = 0; e < C::kR1; ++e)
      orow[4 * C::kCG * C::kV4 + cg + C::kCG * e] =
          acc[i][4 * C::kV4 + e] * inv;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, Kh, G, causal, window;
  float softcap, scale;
  cudaStream_t stream;
};

template <int HD>
cudaError_t launch(const Args& a) {
  using C = Cfg<HD>;
  const int64_t rows = (int64_t)a.B * a.Kh * a.G;
  const int64_t q_tiles = (a.Sq + C::kBQ - 1) / C::kBQ;
  if (rows > 0x7fffffffLL || q_tiles > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)rows, (unsigned)q_tiles);
  flash_kernel<HD><<<grid, kThreads, C::kSmemBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.Sq, a.Skv,
      a.Kh, a.G, a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

}  // namespace

// fp32 q, k, v and output; every pointer 16-byte aligned.
extern "C" int repro_flash_attention_fp32(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Sq, int Skv, int Kh, int G,
                                          int hd, int causal, int window,
                                          float softcap, float scale,
                                          void* stream) {
  if (B <= 0 || Sq <= 0 || Kh <= 0 || G <= 0) return (int)cudaSuccess;
  const Args a{q, k, v, o, B, Sq, Skv, Kh, G, causal, window, softcap, scale,
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

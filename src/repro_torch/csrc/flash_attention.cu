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
// this kernel keeps to fp32 FMAs, whose peak is 67 TFLOP/s.  What the
// design does:
//   - One block per (folded b*Kh*G row, tile of query positions).  A loop
//     over kv tiles inside the block replaces the TPU's sequential grid
//     axis; the running max m, normalizer l and the output accumulator
//     stay in registers across it.
//   - Each kv tile (k and v) is staged once in shared memory and read by
//     every query row of the block as broadcast float4 loads.  kTpr
//     neighbouring threads share one query row, each holding hd / kTpr of
//     its dims (interleaved in float4 chunks, so the kTpr addresses of one
//     load fall in distinct banks); their partial dot products meet through
//     warp shuffles.
//   - Whole kv tiles that causality or the window masks for every row of
//     the block are never loaded (the TPU kernel's pl.when pruning).
//     k_pos >= Skv is masked inside the tile; nothing is padded.
//   - The NEG_INF = -1e30 guards of the TPU kernel are kept as they are,
//     and l == 0 flushes to 0.  No atomics: two launches are bit-identical.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float out(float x) { return x; }
  // rounding of the probabilities to v's type before the value product
  static __device__ __forceinline__ float round(float x) { return x; }
};

// Per head dim: threads per query row, dims per thread, rows per block and
// kv rows per shared-memory tile.
template <int HD>
struct Shape {
  static constexpr int kTpr = HD <= 32 ? 1 : HD <= 64 ? 2 : HD <= 128 ? 4 : 8;
  static constexpr int kDpt = HD / kTpr;
  static constexpr int kVec = kDpt / 4;
  static constexpr int kRows = kThreads / kTpr;
  static constexpr int kBk = HD > 128 ? 16 : 32;
  static_assert(HD % (4 * kTpr) == 0, "head dim must split into float4s");
  static_assert(kBk <= 32, "the mask of a tile is one 32-bit word");
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
             int Kh, int G, int causal, int window, float softcap,
             float scale) {
  using S = Shape<HD>;
  __shared__ __align__(16) float ks[S::kBk * HD];
  __shared__ __align__(16) float vs[S::kBk * HD];

  const int row = blockIdx.x;  // folded (b, kh, g)
  const int g = row % G;
  const int kh = (row / G) % Kh;
  const int b = row / (G * Kh);
  const int q_start = blockIdx.y * S::kRows;
  const int tid = threadIdx.x;
  const int part = tid % S::kTpr;
  const int qp = q_start + tid / S::kTpr;
  const bool q_ok = qp < Sq;

  const int64_t q_tok = (int64_t)Kh * G * HD;  // elements between positions
  const int64_t kv_tok = (int64_t)Kh * HD;
  const int64_t q_off = (int64_t)b * Sq * q_tok + ((int64_t)kh * G + g) * HD;
  const T* kb = k + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;
  const T* vb = v + (int64_t)b * Skv * kv_tok + (int64_t)kh * HD;

  float qr[S::kDpt], acc[S::kDpt];
#pragma unroll
  for (int c = 0; c < S::kVec; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 4 * (part + S::kTpr * c) + e;
      qr[4 * c + e] =
          q_ok ? Io<T>::load(q + q_off + (int64_t)qp * q_tok + dim) : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  // kv tiles that hold an allowed pair for some row of this block
  const int q_last = min(q_start + S::kRows, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  const int t_begin = kv_begin / S::kBk;
  const int t_end = (kv_end + S::kBk - 1) / S::kBk;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * S::kBk;
    __syncthreads();  // every row is done with the previous tile
    for (int i = tid; i < S::kBk * HD; i += kThreads) {
      const int j = i / HD;
      const int dim = i - j * HD;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Skv) {
        kv = Io<T>::load(kb + (int64_t)kp * kv_tok + dim);
        vv = Io<T>::load(vb + (int64_t)kp * kv_tok + dim);
      }
      ks[i] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    float s[S::kBk];
    uint32_t ok_bits = 0;
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < S::kBk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * HD);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < S::kVec; ++c) {
        const float4 kk = kr[part + S::kTpr * c];
        dot = fmaf(qr[4 * c + 0], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = 1; off < S::kTpr; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      float sc = dot * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      const int kp = k0 + j;
      bool ok = kp < Skv;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      s[j] = ok ? sc : kNegInf;
      ok_bits |= (ok ? 1u : 0u) << j;
      m_cur = fmaxf(m_cur, s[j]);
    }

    const float m_new = fmaxf(m, m_cur);
    // guard fully masked rows: exp(NEG_INF - NEG_INF)
    const float m_sub = m_new <= kNegInf * 0.5f ? 0.f : m_new;
    const float alpha = m <= kNegInf * 0.5f ? 0.f : expf(m - m_new);
#pragma unroll
    for (int i = 0; i < S::kDpt; ++i) acc[i] *= alpha;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < S::kBk; ++j) {
      const float p = ((ok_bits >> j) & 1u) ? expf(s[j] - m_sub) : 0.f;
      p_sum += p;
      const float pv = Io<T>::round(p);
      const float4* vr = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
      for (int c = 0; c < S::kVec; ++c) {
        const float4 vv = vr[part + S::kTpr * c];
        acc[4 * c + 0] = fmaf(pv, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(pv, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(pv, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(pv, vv.w, acc[4 * c + 3]);
      }
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (!q_ok) return;
  const float denom = l == 0.f ? 1.f : l;
  T* orow = o + q_off + (int64_t)qp * q_tok;
#pragma unroll
  for (int c = 0; c < S::kVec; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      orow[4 * (part + S::kTpr * c) + e] = Io<T>::out(acc[4 * c + e] / denom);
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

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  using S = Shape<HD>;
  const int64_t rows = (int64_t)a.B * a.Kh * a.G;
  const int64_t q_tiles = (a.Sq + S::kRows - 1) / S::kRows;
  if (rows > 0x7fffffffLL || q_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows, (unsigned)q_tiles);
  flash_kernel<T, HD><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.Sq, a.Skv, a.Kh,
      a.G, a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

}  // namespace

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
    case 8: return (int)launch<float, 8>(a);
    case 16: return (int)launch<float, 16>(a);
    case 32: return (int)launch<float, 32>(a);
    case 64: return (int)launch<float, 64>(a);
    case 80: return (int)launch<float, 80>(a);
    case 96: return (int)launch<float, 96>(a);
    case 128: return (int)launch<float, 128>(a);
    case 256: return (int)launch<float, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

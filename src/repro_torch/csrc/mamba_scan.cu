// Mamba-1 selective scan (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mamba_scan/kernel.py:
// _mamba_scan_kernel / mamba_scan_pallas.  Per batch row b, channel c and
// state n, from h0:
//   h_t[c, n] = exp(delta_t[c] * A[c, n]) * h_{t-1}[c, n]
//               + delta_t[c] * B_t[n] * x_t[c]
//   y_t[c]    = sum_n h_t[c, n] * C_t[n]
// with delta, x [Bt, T, d] both fp32 or both bf16 (widened in registers,
// which is exact, as the TPU kernel widens at its entry), B, C [Bt, T, N],
// A [d, N], h0 [Bt, d, N], and y [Bt, T, d] and the final state hT
// [Bt, d, N] in fp32.
//
// Bound on the H100: one exp per (b, t, c, n) on the special-function
// units (16 a clock an SM), above the bytes of delta, x and y.  The point of
// the TPU kernel is kept: the [d, N] outer products exp(delta*A) and
// delta*B*x never reach device memory.  What the design does:
//   - Few instructions per (t, n): A is loaded once, scaled by log2(e), so
//     each exp is one multiply and one ex2.approx; delta*x is formed once a
//     step; B_t / C_t come from shared memory as 16-byte vector loads.
//   - Enough warps: the N states of a channel may be split over L lanes of
//     a warp (S = NS / L states a lane), so a block of 64 channels has
//     64 * L threads.  The wrapper picks L from the shape (ops.py:
//     default_lanes): L = 1 once Bt * d reaches 32,768 channels, as at
//     falcon-mamba-7b's prefill of 4 prompts, where each lane's extra loads
//     and shuffles a state cost more than the warps gain; 2 or 4 below
//     that, where one lane a channel leaves the SMs short of warps
//     (PERF.md).  y sums the L lanes' partials with a butterfly of
//     __shfl_xor_sync that also scatters: after L steps each lane holds the
//     sum of one step and stores it.  Every step's sum takes the same pairs
//     in the same tree, so the result does not depend on a step's place in
//     its group or on the launch.  A loop trip scans kUnroll steps, which
//     gives each thread independent exps to overlap.
//   - Loads overlap compute: a ring of kStages shared-memory stages, each a
//     kChunk-step tile of delta and x for the block's channels and the B / C
//     rows, filled with cp.async (16-byte copies where d and the dtype
//     allow, 4-byte otherwise; bf16 rows at odd element offsets are copied
//     with plain loads).  Chunk k + 1 streams in while chunk k is scanned.
//     Out-of-range rows and channels are zero-filled.
//   - y is stored straight from the lane that holds it: a warp writes L
//     rows of 32 / L channels, whole 32-byte sectors.
//   - The state size is a template bucket (4, 8, 16 or 32): states past N
//     are padded with A = 0 and B = C = 0, so they stay 0 and add nothing.
//     N above 32 is refused.
//   - T is scanned in order by every thread with no atomics: two launches
//     are bit-identical, and scanning [0, T1) then [T1, T) from its hT gives
//     the same bits as scanning [0, T).  The steps of a last, partial group
//     leave the state untouched.  The arithmetic is spelled out in _rn
//     intrinsics, so the fp32 and bf16 instances round alike.
//   - For training, the state before every kCarry-th step (32 for N <= 8,
//     16 for N <= 16, 8 above: a group start) goes to carries
//     [Bt, ceil(T / kCarry), d, N] when the caller asks for it; the
//     backward kernel (mamba_scan_bwd.cu) rebuilds each chunk's states
//     from it with the same instructions, so bit for bit.  y and hT do not
//     depend on it.  Those are instances of their own (kCarries), so the
//     serving path's code is the same as without them (the stores in the
//     scan loop slowed it).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 64;  // channels a block scans
constexpr int kChunk = 32;     // time steps in one ring stage
constexpr int kStages = 2;     // ring depth
constexpr int kUnroll = 8;     // steps a loop trip scans (at least L)
constexpr float kLog2e = 1.4426950408889634f;

// steps between the saved carries for state bucket NS (ops.carry_steps)
template <int NS>
constexpr int kCarry = NS <= 8 ? 32 : 256 / NS;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t bf16_bits) {
  return __uint_as_float(static_cast<uint32_t>(bf16_bits) << 16);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// cp.async of `bytes` (4 or 16); copies zeros when !ok (src is not read)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One ring stage: delta and x tiles [kChunk][kChannels], B and C rows
// [kChunk][NS].
template <typename E, int NS>
struct Stage {
  static constexpr int kBytes =
      2 * kChunk * kChannels * (int)sizeof(E) + 2 * kChunk * NS * 4;
  E* dl;
  E* xs;
  float* bs;
  float* cs;
  __device__ Stage(unsigned char* base, int k) {
    unsigned char* p = base + (k % kStages) * kBytes;
    dl = reinterpret_cast<E*>(p);
    xs = dl + kChunk * kChannels;
    bs = reinterpret_cast<float*>(xs + kChunk * kChannels);
    cs = bs + kChunk * NS;
  }
};

// delta / x tiles of one chunk in copies of kBytes (a copy holds whole
// channels, all in range or all out, as the caller's choice of kBytes
// ensures)
template <int kBytes, typename E>
__device__ __forceinline__ void copy_dx(E* dl_s, E* x_s, const E* delta,
                                        const E* x, int64_t row0, int t0,
                                        int T, int d, int c0) {
  constexpr int kPer = kBytes / (int)sizeof(E);  // channels a copy
  constexpr int kRow = kChannels / kPer;         // copies a row
  for (int i = threadIdx.x; i < kChunk * kRow; i += blockDim.x) {
    const int tt = i / kRow;
    const int cc = (i - tt * kRow) * kPer;
    const bool ok = t0 + tt < T && c0 + cc < d;
    const int64_t off = ok ? (row0 + t0 + tt) * d + c0 + cc : 0;
    cp_async<kBytes>(dl_s + tt * kChannels + cc, delta + off, ok);
    cp_async<kBytes>(x_s + tt * kChannels + cc, x + off, ok);
  }
}

template <int kBytes, int NS>
__device__ __forceinline__ void copy_bc(float* b_s, float* c_s,
                                        const float* Bm, const float* Cm,
                                        int64_t row0, int t0, int T, int N) {
  constexpr int kPer = kBytes / 4;
  constexpr int kRow = NS / kPer;
  for (int i = threadIdx.x; i < kChunk * kRow; i += blockDim.x) {
    const int tt = i / kRow;
    const int n = (i - tt * kRow) * kPer;
    const bool ok = t0 + tt < T && n < N;
    const int64_t off = ok ? (row0 + t0 + tt) * N + n : 0;
    cp_async<kBytes>(b_s + tt * NS + n, Bm + off, ok);
    cp_async<kBytes>(c_s + tt * NS + n, Cm + off, ok);
  }
}

// Issue the copies of chunk k into its stage.  vec_dx: 16, 4, or 2 (bf16
// rows at odd element offsets: plain loads); vec_bc: 16 or 4.
template <typename E, int NS>
__device__ __forceinline__ void load_chunk(unsigned char* smem, int k,
                                           const E* delta, const E* x,
                                           const float* Bm, const float* Cm,
                                           int64_t row0, int T, int d, int c0,
                                           int N, int vec_dx, int vec_bc) {
  const Stage<E, NS> st(smem, k);
  const int t0 = k * kChunk;
  if (vec_dx == 16) {
    copy_dx<16>(st.dl, st.xs, delta, x, row0, t0, T, d, c0);
  } else if (vec_dx == 4) {
    copy_dx<4>(st.dl, st.xs, delta, x, row0, t0, T, d, c0);
  } else {
    for (int i = threadIdx.x; i < kChunk * kChannels; i += blockDim.x) {
      const int tt = i / kChannels;
      const int cc = i - tt * kChannels;
      const bool ok = t0 + tt < T && c0 + cc < d;
      const int64_t off = (row0 + t0 + tt) * d + c0 + cc;
      st.dl[i] = ok ? delta[off] : E(0);
      st.xs[i] = ok ? x[off] : E(0);
    }
  }
  if (vec_bc == 16) {
    copy_bc<16, NS>(st.bs, st.cs, Bm, Cm, row0, t0, T, N);
  } else {
    copy_bc<4, NS>(st.bs, st.cs, Bm, Cm, row0, t0, T, N);
  }
}

template <int S>
__device__ __forceinline__ void load_states(const float* p, float (&v)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int i = 0; i < S / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else if constexpr (S == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

// U steps from row g0 of a stage, in blocks of L: for each step each lane
// adds its states' share of y_t, then the butterfly leaves the sum of step
// g + q on lane q, which stores it (y_c: y at the chunk's first step, this
// channel; null for a channel past d).  In a tail group the steps past len
// leave the state as it is.
template <bool kTail, typename E, int NS, int L>
__device__ __forceinline__ void scan_group(const Stage<E, NS>& st, int g0,
                                           int len, int q, int cl,
                                           const float (&a2)[NS / L],
                                           float (&h)[NS / L], float* y_c,
                                           int64_t d) {
  constexpr int S = NS / L;
  constexpr int U = kUnroll > L ? kUnroll : L;
#pragma unroll
  for (int g = g0; g < g0 + U; g += L) {
    float part[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      part[j] = 0.f;
      if (kTail && g + j >= len) continue;
      const int tt = g + j;
      const float dt = widen(st.dl[tt * kChannels + cl]);
      const float dtx = __fmul_rn(dt, widen(st.xs[tt * kChannels + cl]));
      float bv[S], cv[S];
      load_states<S>(st.bs + tt * NS + q * S, bv);
      load_states<S>(st.cs + tt * NS + q * S, cv);
      float p = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float dA = ex2(__fmul_rn(dt, a2[s]));
        h[s] = __fmaf_rn(dA, h[s], __fmul_rn(dtx, bv[s]));
        p = __fmaf_rn(h[s], cv[s], p);
      }
      part[j] = p;
    }
#pragma unroll
    for (int w = L / 2; w >= 1; w /= 2) {
      const bool upper = q & w;  // keeps the steps with bit w set
#pragma unroll
      for (int i = 0; i < w; ++i) {
        const float keep = upper ? part[i + w] : part[i];
        const float send = upper ? part[i] : part[i + w];
        part[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, w));
      }
    }
    if (y_c != nullptr && g + q < len) y_c[(g + q) * d] = part[0];
  }
}

// 4 blocks an SM; 3 for N <= 32 split over 2 or 4 lanes when they save
// carries, which then need more than 128 or 64 registers a thread
template <int NS, int L, bool kCarries>
constexpr int kMinBlocks = kCarries && NS == 32 && L > 1 ? 3 : 4;

template <typename E, int NS, int L, bool kCarries>
__global__ void __launch_bounds__(kChannels * L,
                                  (kMinBlocks<NS, L, kCarries>))
mamba_scan_kernel(const E* __restrict__ delta, const E* __restrict__ x,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ hT,
                  float* __restrict__ carries, int T, int d, int N,
                  int vec_dx, int vec_bc) {
  constexpr int S = NS / L;  // states a lane holds
  constexpr int U = kUnroll > L ? kUnroll : L;
  constexpr int CH = kCarry<NS>;
  static_assert(CH % U == 0 && kChunk % CH == 0, "carries at group starts");
  extern __shared__ __align__(16) unsigned char smem[];

  const int q = threadIdx.x % L;  // lane within the channel's group
  const int cl = threadIdx.x / L;  // channel within the block
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const bool c_ok = c < d;
  const int64_t row0 = (int64_t)blockIdx.y * T;
  const int64_t state0 = ((int64_t)blockIdx.y * d + c) * N;

  float a2[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = q * S + s;
    const bool ok = c_ok && n < N;
    a2[s] = ok ? __fmul_rn(A[(int64_t)c * N + n], kLog2e) : 0.f;
    h[s] = ok ? h0[state0 + n] : 0.f;
  }

  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int n_carries = (T + CH - 1) / CH;
  // the state before step t, when t starts a carry interval
  auto save = [&](int t) {
    if (!kCarries || !c_ok || t % CH != 0) return;
    float* dst =
        carries + (((int64_t)blockIdx.y * n_carries + t / CH) * d + c) * N;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (q * S + s < N) dst[q * S + s] = h[s];
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_chunks)
      load_chunk<E, NS>(smem, k, delta, x, Bm, Cm, row0, T, d, c0, N, vec_dx,
                        vec_bc);
    cp_commit();
  }

  for (int k = 0; k < n_chunks; ++k) {
    cp_wait<kStages - 2>();  // this thread's copies of chunk k landed
    __syncthreads();         // everyone's, and chunk k-1's stage is free
    const int kn = k + kStages - 1;
    if (kn < n_chunks)
      load_chunk<E, NS>(smem, kn, delta, x, Bm, Cm, row0, T, d, c0, N, vec_dx,
                        vec_bc);
    cp_commit();

    const Stage<E, NS> st(smem, k);
    const int t0 = k * kChunk;
    const int len = min(kChunk, T - t0);
    float* y_c = c_ok ? y + (row0 + t0) * d + c : nullptr;
    int g = 0;
    for (; g + U <= len; g += U) {
      save(t0 + g);
      scan_group<false, E, NS, L>(st, g, len, q, cl, a2, h, y_c, d);
    }
    if (g < len) {
      save(t0 + g);
      scan_group<true, E, NS, L>(st, g, len, q, cl, a2, h, y_c, d);
    }
  }

  if (!c_ok) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = q * S + s;
    if (n < N) hT[state0 + n] = h[s];
  }
}

template <typename E, int NS, int L, bool kCarries>
cudaError_t launch_kernel(const void* delta, const void* x, const float* Bm,
                          const float* Cm, const float* A, const float* h0,
                          float* y, float* hT, float* cr, int Bt, int T,
                          int d, int N, int vec_dx, int vec_bc,
                          cudaStream_t stream) {
  constexpr int kSmem = kStages * Stage<E, NS>::kBytes;
  static_assert(kSmem <= 48 * 1024, "ring exceeds the default shared memory");
  const dim3 grid((unsigned)((d + kChannels - 1) / kChannels), (unsigned)Bt);
  mamba_scan_kernel<E, NS, L, kCarries>
      <<<grid, kChannels * L, kSmem, stream>>>(
          static_cast<const E*>(delta), static_cast<const E*>(x), Bm, Cm, A,
          h0, y, hT, cr, T, d, N, vec_dx, vec_bc);
  return cudaGetLastError();
}

// the instance with carries when the caller asks for them
template <typename E, int NS, int L>
cudaError_t launch(const void* delta, const void* x, const float* Bm,
                   const float* Cm, const float* A, const float* h0, float* y,
                   float* hT, float* cr, int Bt, int T, int d, int N,
                   int vec_dx, int vec_bc, cudaStream_t stream) {
  if (cr != nullptr)
    return launch_kernel<E, NS, L, true>(delta, x, Bm, Cm, A, h0, y, hT, cr,
                                         Bt, T, d, N, vec_dx, vec_bc, stream);
  return launch_kernel<E, NS, L, false>(delta, x, Bm, Cm, A, h0, y, hT, cr,
                                        Bt, T, d, N, vec_dx, vec_bc, stream);
}

template <typename E, int L>
cudaError_t launch_n(const void* delta, const void* x, const float* Bm,
                     const float* Cm, const float* A, const float* h0,
                     float* y, float* hT, float* cr, int Bt, int T, int d,
                     int N, int vec_dx, int vec_bc, cudaStream_t st) {
  if (N <= 4)
    return launch<E, 4, L>(delta, x, Bm, Cm, A, h0, y, hT, cr, Bt, T, d, N,
                           vec_dx, vec_bc, st);
  if (N <= 8)
    return launch<E, 8, L>(delta, x, Bm, Cm, A, h0, y, hT, cr, Bt, T, d, N,
                           vec_dx, vec_bc, st);
  if (N <= 16)
    return launch<E, 16, L>(delta, x, Bm, Cm, A, h0, y, hT, cr, Bt, T, d, N,
                            vec_dx, vec_bc, st);
  return launch<E, 32, L>(delta, x, Bm, Cm, A, h0, y, hT, cr, Bt, T, d, N,
                          vec_dx, vec_bc, st);
}

template <typename E>
cudaError_t launch_e(int lanes, const void* delta, const void* x,
                     const float* Bm, const float* Cm, const float* A,
                     const float* h0, float* y, float* hT, float* cr, int Bt,
                     int T, int d, int N, int vec_dx, int vec_bc,
                     cudaStream_t st) {
  if (lanes == 1)
    return launch_n<E, 1>(delta, x, Bm, Cm, A, h0, y, hT, cr, Bt, T, d, N,
                          vec_dx, vec_bc, st);
  if (lanes == 2)
    return launch_n<E, 2>(delta, x, Bm, Cm, A, h0, y, hT, cr, Bt, T, d, N,
                          vec_dx, vec_bc, st);
  return launch_n<E, 4>(delta, x, Bm, Cm, A, h0, y, hT, cr, Bt, T, d, N,
                        vec_dx, vec_bc, st);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// bf16: delta and x are bf16 (else fp32).  lanes: threads a channel's
// states are split over (1, 2 or 4).  carries: null, or
// [Bt, ceil(T / kCarry), d, N] fp32 for the states the backward starts from.
extern "C" int repro_mamba_scan(const void* delta, const void* x,
                                const void* Bm, const void* Cm, const void* A,
                                const void* h0, void* y, void* hT,
                                void* carries, int Bt, int T, int d, int N,
                                int bf16, int lanes, void* stream) {
  if (Bt <= 0 || d <= 0) return (int)cudaSuccess;
  if (Bt > 65535 || N < 1 || N > 32 || T < 0 ||
      (lanes != 1 && lanes != 2 && lanes != 4))
    return (int)cudaErrorInvalidValue;
  const int elt = bf16 ? 2 : 4;
  const bool rows16 = (int64_t)d * elt % 16 == 0;
  const bool rows4 = (int64_t)d * elt % 4 == 0;
  const int vec_dx = rows16 && aligned(delta, 16) && aligned(x, 16) ? 16
                     : rows4 && aligned(delta, 4) && aligned(x, 4)  ? 4
                                                                    : 2;
  const int vec_bc = N % 4 == 0 && aligned(Bm, 16) && aligned(Cm, 16) ? 16 : 4;
  const auto* bb = static_cast<const float*>(Bm);
  const auto* cc = static_cast<const float*>(Cm);
  const auto* aa = static_cast<const float*>(A);
  const auto* hh = static_cast<const float*>(h0);
  auto* yy = static_cast<float*>(y);
  auto* ht = static_cast<float*>(hT);
  auto* cr = static_cast<float*>(carries);
  auto* st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_e<uint16_t>(lanes, delta, x, bb, cc, aa, hh, yy, ht,
                                   cr, Bt, T, d, N, vec_dx, vec_bc, st);
  return (int)launch_e<float>(lanes, delta, x, bb, cc, aa, hh, yy, ht, cr, Bt,
                              T, d, N, vec_dx, vec_bc, st);
}

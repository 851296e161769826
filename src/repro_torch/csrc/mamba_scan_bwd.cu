// The gradient of the Mamba-1 selective scan (sm_90a).
//
// Replaces no TPU kernel: the reference trains by jax.grad of its plain
// chunked scan (the lax.scan of repro/models/mamba.py), whose gradient XLA
// compiles into device code; this is that gradient as kernels, so that
// training on the card never runs the plain scan's loop over time steps.
// With a_t = exp(delta_t A) and h_t = a_t h_{t-1} + delta_t B_t x_t (the
// forward, mamba_scan.cu), y_t = sum_n h_t C_t, and g the gradient of the
// state after step t, walking back from g = dhT:
//   g += C_t dy_t
//   dC_t[n]     = sum_c h_t dy_t        dB_t[n] = sum_c g delta_t x_t
//   dx_t[c]     = delta_t sum_n g B_t
//   d delta_t[c] = sum_n g (A a_t h_{t-1} + B_t x_t)
//   dA[c, n]   += g delta_t a_t h_{t-1};    g = a_t g
// and dh0 = g.
//
// Bound on the H100: the function's bytes (delta, x, dy, the carries and
// the gradients), about 0.08 ms at falcon-mamba-7b's training microbatch;
// the design adds a second exp per (b, t, c, n) on the special-function
// units and its own workspace traffic (chip_smoke.py prints both).
//
// Time-parallel chunks.  A walk back through T steps is a chain: each
// step's g waits on the next step's.  But g is linear in the gradient at
// a chunk's end: over steps [t0, t1), g_{t0-1} = u + (prod a_t) g_{t1-1},
// where u is the walk's result from g_{t1-1} = 0.  So T is cut into time
// chunks of kTimeChunk steps (a whole number of the forward's carry
// intervals), and four launches replace the one walk:
//   1. mamba_scan_bwd_local, per (channel block, time chunk, batch row):
//      the chunk's sweep back from g = 0, with only a_t, C_t and dy_t (no
//      states, no x, B or carries): u and the decay P = prod a_t, each
//      [Bt, chunks, d, N].
//   2. mamba_scan_bwd_cross, per (b, c, n): the chunks last to first in a
//      fixed order, g_end(k) = u(k + 1) + P(k + 1) g_end(k + 1) from dhT;
//      it writes g_end over u and dh0 at the end.
//   3. mamba_scan_bwd_walk, per (channel block, time chunk, batch row):
//      the full walk of the chunk from its own g_end.  It rebuilds each
//      carry interval's states from the forward's carry with the
//      forward's own instructions (so bit for bit the forward's states),
//      then walks the interval back.  It writes d delta and dx, dB/dC
//      partials a channel block, and dA partials a time chunk.
//   4. mamba_scan_bwd_reduce: dB and dC summed over the channel blocks in
//      block order, dA over (batch row, time chunk) in that order.
// No atomics: two launches are bit-identical.  At falcon's microbatch
// (Bt 1, T 2048, d 8192) that is 128 x 16 = 2,048 blocks a pass where the
// one walk had 128.
//
// The walk's design (pass 3), for instruction and shared-memory traffic
// as much as for latency:
//   - The N states of a channel are split over kLanes = 4 lanes (S = N / 4
//     a lane; states past N padded with A = B = C = 0; the state buckets
//     4, 8, 16, 32), 64 channels a block of 256 threads, two blocks an SM
//     up to N 16.  The forward's lane split does not matter here: the
//     carries are the same bits under every split.
//   - An interval's states h_{t-1} stay in registers (the interval's steps
//     are unrolled: CH x S = 64 values for N > 4), its a_t in shared memory
//     as 16-byte vectors, one exp per (t, c, n).  The inputs of the
//     interval before stream in (cp.async, a 2-stage ring) while this one
//     runs.
//   - dx and d delta sum a channel's states over its 4 lanes in a
//     butterfly that scatters: after 4 steps each lane holds one step's.
//   - dB_t and dC_t sum over channels: a step's 2 S products a lane are
//     summed over the warp's 8 channels by a reduce-scatter of shuffles
//     (each lane ends with max(1, 2 S / 8) of the sums), the block sums its
//     8 warps in warp order and writes one partial a channel block.
//   - dA stays in registers across the time chunk.
//   - bf16 delta / x get their fp32 gradients rounded to nearest even.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 64;   // channels a block takes
constexpr int kLanes = 4;       // lanes a channel's states are split over
constexpr int kThreads = kChannels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;      // ring depth
constexpr int kTimeChunk = 128; // steps a time chunk (ops.TIME_CHUNK)
constexpr float kLog2e = 1.4426950408889634f;

// steps between the forward's carries for state bucket NS (ops.carry_steps)
template <int NS>
constexpr int kCh = NS <= 8 ? 32 : 256 / NS;
static_assert(kTimeChunk % kCh<4> == 0 && kTimeChunk % kCh<32> == 0,
              "a time chunk is a whole number of carry intervals");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t bf16_bits) {
  return __uint_as_float(static_cast<uint32_t>(bf16_bits) << 16);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(uint16_t* p, float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  *p = *reinterpret_cast<const uint16_t*>(&b);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// cp.async of kBytes (4 or 16); copies zeros when !ok (src is not read)
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

// One ring stage: delta, x [CH][64] (E), dy [CH][64] (fp32), B, C
// [CH][NS], and the interval's carry [64][NS].
template <typename E, int NS>
struct Stage {
  static constexpr int CH = kCh<NS>;
  static constexpr int kBytes = 2 * CH * kChannels * (int)sizeof(E) +
                                CH * kChannels * 4 + 2 * CH * NS * 4 +
                                kChannels * NS * 4;
  E* dl;
  E* xs;
  float* dys;
  float* bs;
  float* cs;
  float* hc;
  __device__ Stage(unsigned char* base, int k) {
    unsigned char* p = base + (k % kStages) * kBytes;
    dl = reinterpret_cast<E*>(p);
    xs = dl + CH * kChannels;
    dys = reinterpret_cast<float*>(xs + CH * kChannels);
    bs = dys + CH * kChannels;
    cs = bs + CH * NS;
    hc = cs + CH * NS;
  }
};

// rows t0 .. t0 + CH of `width`-wide rows (columns col0 .. col0 + ncols)
// into [CH][ncols], in copies of kBytes that lie wholly inside or outside
// the width (the caller's choice of kBytes ensures it); the rest zeros
template <int kBytes, typename E>
__device__ __forceinline__ void copy_tile(E* dst, const E* src, int64_t row0,
                                          int t0, int CH, int T, int width,
                                          int col0, int ncols) {
  constexpr int kPer = kBytes / (int)sizeof(E);
  const int per_row = ncols / kPer;
  for (int i = threadIdx.x; i < CH * per_row; i += blockDim.x) {
    const int tt = i / per_row;
    const int cc = (i - tt * per_row) * kPer;
    const bool ok = t0 + tt < T && col0 + cc < width;
    const int64_t off = ok ? (row0 + t0 + tt) * width + col0 + cc : 0;
    cp_async<kBytes>(dst + tt * ncols + cc, src + off, ok);
  }
}

// the same with plain loads, for bf16 rows at odd element offsets
template <typename E>
__device__ __forceinline__ void load_tile(E* dst, const E* src, int64_t row0,
                                          int t0, int CH, int T, int width,
                                          int col0, int ncols) {
  for (int i = threadIdx.x; i < CH * ncols; i += blockDim.x) {
    const int tt = i / ncols;
    const int cc = i - tt * ncols;
    const bool ok = t0 + tt < T && col0 + cc < width;
    dst[i] = ok ? src[(row0 + t0 + tt) * width + col0 + cc] : E(0);
  }
}

// Issue carry interval k's copies into its stage: the inputs and the
// carry (block row of carries [Bt * n_carries, d, N]; 16-byte copies when
// N fills the bucket, else 4-byte ones).  vec_dx: 16, 4 or 2 (plain loads);
// vec_dy, vec_bc: 16 or 4.
template <typename E, int NS>
__device__ __forceinline__ void load_chunk(
    unsigned char* ring, int k, const E* delta, const E* x, const float* dy,
    const float* Bm, const float* Cm, const float* carries, int64_t crow,
    int64_t row0, int T, int d, int c0, int N, int vec_dx, int vec_dy,
    int vec_bc) {
  constexpr int CH = kCh<NS>;
  const Stage<E, NS> st(ring, k);
  const int t0 = k * CH;
  if (N == NS && vec_bc == 16)
    copy_tile<16>(st.hc, carries, crow + k, 0, 1, 1, d * N, c0 * N,
                  kChannels * NS);
  else
    for (int i = threadIdx.x; i < kChannels * NS; i += blockDim.x) {
      const int cl = i / NS, n = i - cl * NS;
      const bool ok = c0 + cl < d && n < N;
      const int64_t off = ok ? (crow + k) * d * N + (int64_t)(c0 + cl) * N + n
                             : 0;
      cp_async<4>(st.hc + i, carries + off, ok);
    }
  if (vec_dx == 16) {
    copy_tile<16>(st.dl, delta, row0, t0, CH, T, d, c0, kChannels);
    copy_tile<16>(st.xs, x, row0, t0, CH, T, d, c0, kChannels);
  } else if (vec_dx == 4) {
    copy_tile<4>(st.dl, delta, row0, t0, CH, T, d, c0, kChannels);
    copy_tile<4>(st.xs, x, row0, t0, CH, T, d, c0, kChannels);
  } else {
    load_tile(st.dl, delta, row0, t0, CH, T, d, c0, kChannels);
    load_tile(st.xs, x, row0, t0, CH, T, d, c0, kChannels);
  }
  if (vec_dy == 16)
    copy_tile<16>(st.dys, dy, row0, t0, CH, T, d, c0, kChannels);
  else
    copy_tile<4>(st.dys, dy, row0, t0, CH, T, d, c0, kChannels);
  if (vec_bc == 16) {
    copy_tile<16>(st.bs, Bm, row0, t0, CH, T, N, 0, NS);
    copy_tile<16>(st.cs, Cm, row0, t0, CH, T, N, 0, NS);
  } else {
    copy_tile<4>(st.bs, Bm, row0, t0, CH, T, N, 0, NS);
    copy_tile<4>(st.cs, Cm, row0, t0, CH, T, N, 0, NS);
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

template <int S>
__device__ __forceinline__ void store_states(float* p, const float (&v)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int i = 0; i < S / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (S == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// One stage of a reduce-scatter over lane bit w: with K values a lane
// (K >= 2), the lane keeps one half, adds its partner's copy of that half
// and ends with K / 2 sums, at offset off (advanced by K / 2 on the upper
// lane); with K == 1 both partners end with the sum.  Each sum adds the
// same two values on both sides (a + b == b + a), so it is bit-stable.
template <int K, int M>
__device__ __forceinline__ void rs_stage(float (&v)[M], int lane, int w,
                                         int& off) {
  const bool up = lane & w;
  if constexpr (K >= 2) {
    constexpr int H = K / 2;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float keep = up ? v[H + i] : v[i];
      const float send = up ? v[i] : v[H + i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, w));
    }
    if (up) off += H;
  } else {
    v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], w));
  }
}

// Sums of each of a lane's M values over the warp's 8 channels (lane bits
// 2 to 4; bits 0 and 1 are the lane within its channel): the lane ends
// with max(1, M / 8) of them, v[i] the sum of index off + i (the return);
// for M < 8 lanes that differ in the low channel bits hold the same sums
template <int M>
__device__ __forceinline__ int channel_sums(float (&v)[M], int lane) {
  int off = 0;
  rs_stage<M>(v, lane, 16, off);
  rs_stage<(M / 2 > 1 ? M / 2 : 1)>(v, lane, 8, off);
  rs_stage<(M / 4 > 1 ? M / 4 : 1)>(v, lane, 4, off);
  return off;
}

template <typename E, int NS>
struct Walk {
  static constexpr int S = NS / kLanes > 0 ? NS / kLanes : 1;  // a lane's
  static constexpr int CH = kCh<NS>;          // steps an interval
  static constexpr int M = 2 * S;             // dB and dC products a lane
  static constexpr int R = M / 8 > 0 ? M / 8 : 1;  // sums a lane keeps
  // lanes whose low channel bits (lane >> 2) meet this mask hold copies
  static constexpr int kDup = M >= 8 ? 0 : M == 4 ? 1 : 3;
  // a_t of an interval: [CH][kThreads][S] floats
  static constexpr int kAFloats = CH * kThreads * S;
  // per-warp channel sums of dB_t and dC_t: [kWarps][CH][2 NS]
  static constexpr int kRedFloats = kWarps * CH * 2 * NS;
  static constexpr int kSmem =
      (kAFloats + kRedFloats) * 4 + kStages * Stage<E, NS>::kBytes;
  static_assert(NS % kLanes == 0 || NS < kLanes, "state bucket");
  static_assert(S * kLanes == NS, "states a lane");
  static_assert(kSmem <= 232448, "shared memory of one block");
  static_assert(CH % kLanes == 0, "interval shape");
};

// Pass 1's shared memory: the time chunk's delta [kTimeChunk][64] (E), dy
// [kTimeChunk][64] and C [kTimeChunk][NS], staged in one go
template <typename E, int NS>
constexpr int kLocalSmem =
    kTimeChunk * kChannels * ((int)sizeof(E) + 4) + kTimeChunk * NS * 4;

// Pass 1: the local sweep of one time chunk for 64 channels of batch row
// b, from g = 0 at its end: u (g at its start) and P = prod a_t.  The
// chunk's inputs are copied in first (cp.async, all in flight at once),
// so the sweep's steps wait on shared memory only
template <typename E, int NS>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_local(const E* __restrict__ delta,
                     const float* __restrict__ Cm,
                     const float* __restrict__ A,
                     const float* __restrict__ dy, float* __restrict__ U,
                     float* __restrict__ P, int T, int d, int N, int vec_dx,
                     int vec_dy, int vec_bc) {
  constexpr int S = Walk<E, NS>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  E* dl = reinterpret_cast<E*>(smem);
  float* dys = reinterpret_cast<float*>(dl + kTimeChunk * kChannels);
  float* cs = dys + kTimeChunk * kChannels;
  const int tid = threadIdx.x;
  const int q = tid % kLanes, cl = tid / kLanes;
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const bool c_ok = c < d;
  const int tc = blockIdx.y, n_tc = gridDim.y, b = blockIdx.z;
  const int64_t row0 = (int64_t)b * T;
  const int t0 = tc * kTimeChunk;
  const int len = min(kTimeChunk, T - t0);
  if (vec_dx == 16)
    copy_tile<16>(dl, delta, row0, t0, kTimeChunk, T, d, c0, kChannels);
  else if (vec_dx == 4)
    copy_tile<4>(dl, delta, row0, t0, kTimeChunk, T, d, c0, kChannels);
  else
    load_tile(dl, delta, row0, t0, kTimeChunk, T, d, c0, kChannels);
  if (vec_dy == 16)
    copy_tile<16>(dys, dy, row0, t0, kTimeChunk, T, d, c0, kChannels);
  else
    copy_tile<4>(dys, dy, row0, t0, kTimeChunk, T, d, c0, kChannels);
  if (vec_bc == 16)
    copy_tile<16>(cs, Cm, row0, t0, kTimeChunk, T, N, 0, NS);
  else
    copy_tile<4>(cs, Cm, row0, t0, kTimeChunk, T, N, 0, NS);
  cp_commit();
  float a2[S], g[S], p[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = q * S + s;
    a2[s] = c_ok && n < N ? __fmul_rn(A[(int64_t)c * N + n], kLog2e) : 0.f;
    g[s] = 0.f;
    p[s] = 1.f;
  }
  cp_wait<0>();
  __syncthreads();
#pragma unroll 4
  for (int tt = len - 1; tt >= 0; --tt) {
    const float dt = widen(dl[tt * kChannels + cl]);
    const float dyv = dys[tt * kChannels + cl];
    float cv[S];
    load_states<S>(cs + tt * NS + q * S, cv);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float a = ex2(__fmul_rn(dt, a2[s]));
      g[s] = __fmul_rn(a, __fmaf_rn(cv[s], dyv, g[s]));
      p[s] = __fmul_rn(p[s], a);
    }
  }
  if (!c_ok) return;
  const int64_t base = (((int64_t)b * n_tc + tc) * d + c) * N;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = q * S + s;
    if (n < N) {
      U[base + n] = g[s];
      P[base + n] = p[s];
    }
  }
}

// Pass 2: per (b, c, n), the time chunks last to first from dhT: g_end of
// chunk k over u(k), then g = u(k) + P(k) g; dh0 at the end
__global__ void mamba_scan_bwd_cross(float* __restrict__ U,
                                     const float* __restrict__ P,
                                     const float* __restrict__ dhT,
                                     float* __restrict__ dh0, int Bt, int d,
                                     int N, int n_tc) {
  const int64_t dn = (int64_t)d * N;
  const int64_t total = (int64_t)Bt * dn;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = i / dn;
    const int64_t cn = i - b * dn;
    float g = dhT[i];
    // kBatch chunks' u and P load together, then fold in order
    constexpr int kBatch = 8;
    for (int k1 = n_tc - 1; k1 >= 0; k1 -= kBatch) {
      float u[kBatch], p[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int64_t at = (b * n_tc + k1 - j) * dn + cn;
        u[j] = k1 - j >= 0 ? U[at] : 0.f;
        p[j] = k1 - j >= 0 ? P[at] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = k1 - j;
        if (k < 0) break;
        U[(b * n_tc + k) * dn + cn] = g;  // chunk k's g_end
        g = __fmaf_rn(p[j], g, u[j]);
      }
    }
    dh0[i] = g;
  }
}

// blocks of the walk an SM: two up to N <= 16 (at most 128 registers a
// thread); N <= 32 keeps twice the states a lane and takes one
template <int NS>
constexpr int kWalkBlocks = NS <= 16 ? 2 : 1;

// Pass 3: the full walk of one time chunk for 64 channels of batch row b,
// from its g_end (pass 2)
template <typename E, int NS>
__global__ void __launch_bounds__(kThreads, kWalkBlocks<NS>)
mamba_scan_bwd_walk(const E* __restrict__ delta, const E* __restrict__ x,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ A,
                    const float* __restrict__ carries,
                    const float* __restrict__ dy,
                    const float* __restrict__ g_end, E* __restrict__ ddelta,
                    E* __restrict__ dx, float* __restrict__ part_A,
                    float* __restrict__ part_B, float* __restrict__ part_C,
                    int T, int d, int N, int vec_dx, int vec_dy, int vec_bc) {
  using K = Walk<E, NS>;
  constexpr int S = K::S, CH = K::CH, M = K::M;
  constexpr int kSub = kTimeChunk / CH;  // intervals a time chunk
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);  // a_t: [CH][kThreads][S]
  float* red = as + K::kAFloats;               // [kWarps][CH][2 NS]
  unsigned char* ring = reinterpret_cast<unsigned char*>(red + K::kRedFloats);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = tid % kLanes;   // lane within the channel's group
  const int cl = tid / kLanes;  // channel within the block
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const bool c_ok = c < d;
  const int tc = blockIdx.y, n_tc = gridDim.y, b = blockIdx.z;
  const int64_t row0 = (int64_t)b * T;
  const int n_carries = (T + CH - 1) / CH;
  const int k_lo = tc * kSub;
  const int k_hi = min(n_carries, k_lo + kSub) - 1;
  const int64_t chunk0 = (((int64_t)b * n_tc + tc) * d + c) * N;

  float Av[S], a2[S], g[S], dA[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = q * S + s;
    const bool ok = c_ok && n < N;
    Av[s] = ok ? A[(int64_t)c * N + n] : 0.f;
    a2[s] = __fmul_rn(Av[s], kLog2e);  // as the forward scales it
    g[s] = ok ? g_end[chunk0 + n] : 0.f;
    dA[s] = 0.f;
  }

  const int64_t crow = (int64_t)b * n_carries;
  load_chunk<E, NS>(ring, k_hi, delta, x, dy, Bm, Cm, carries, crow, row0, T,
                    d, c0, N, vec_dx, vec_dy, vec_bc);
  cp_commit();

  float* pB = part_B + ((int64_t)b * gridDim.x + blockIdx.x) * T * N;
  float* pC = part_C + ((int64_t)b * gridDim.x + blockIdx.x) * T * N;
  for (int k = k_hi; k >= k_lo; --k) {
    if (k > k_lo) {
      load_chunk<E, NS>(ring, k - 1, delta, x, dy, Bm, Cm, carries, crow,
                        row0, T, d, c0, N, vec_dx, vec_dy, vec_bc);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // interval k is in; a_t and the sums are free
    const Stage<E, NS> st(ring, k);
    const int t0 = k * CH;
    const int len = min(CH, T - t0);

    // the interval's states from its carry, as the forward computed them:
    // h_{t-1} into registers, a_t into shared memory
    float hp[CH][S];
    load_states<S>(st.hc + cl * NS + q * S, h);
#pragma unroll
    for (int tt = 0; tt < CH; ++tt) {
      if (tt < len) {
        const float dt = widen(st.dl[tt * kChannels + cl]);
        const float dtx = __fmul_rn(dt, widen(st.xs[tt * kChannels + cl]));
        float bv[S], av[S];
        load_states<S>(st.bs + tt * NS + q * S, bv);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          av[s] = ex2(__fmul_rn(dt, a2[s]));
          hp[tt][s] = h[s];
          h[s] = __fmaf_rn(av[s], h[s], __fmul_rn(dtx, bv[s]));
        }
        store_states<S>(as + (tt * kThreads + tid) * S, av);
      }
    }

    // back through the interval, kLanes steps a group; h is the state
    // after the step at hand
#pragma unroll
    for (int gb = CH - kLanes; gb >= 0; gb -= kLanes) {
      float sx[kLanes], sd[kLanes];  // sum_n g B, sum_n A g' h_{t-1}
#pragma unroll
      for (int j = kLanes - 1; j >= 0; --j) {
        const int tt = gb + j;
        sx[j] = sd[j] = 0.f;
        if (tt >= len) continue;  // the whole block
        const float dt = widen(st.dl[tt * kChannels + cl]);
        const float dtx = __fmul_rn(dt, widen(st.xs[tt * kChannels + cl]));
        const float dyv = st.dys[tt * kChannels + cl];
        float bv[S], cv[S], av[S], v[M];
        load_states<S>(st.bs + tt * NS + q * S, bv);
        load_states<S>(st.cs + tt * NS + q * S, cv);
        load_states<S>(as + (tt * kThreads + tid) * S, av);
        float px = 0.f, pd = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float gs = __fmaf_rn(cv[s], dyv, g[s]);
          v[s] = __fmul_rn(gs, dtx);      // dB_t's term
          v[S + s] = __fmul_rn(h[s], dyv);  // dC_t's term
          px = __fmaf_rn(gs, bv[s], px);
          const float gn = __fmul_rn(av[s], gs);  // g into h_{t-1}
          const float gh = __fmul_rn(gn, hp[tt][s]);
          dA[s] = __fmaf_rn(gh, dt, dA[s]);
          pd = __fmaf_rn(gh, Av[s], pd);
          h[s] = hp[tt][s];
          g[s] = gn;
        }
        sx[j] = px;
        sd[j] = pd;
        const int off = channel_sums<M>(v, lane);
        if (((lane >> 2) & K::kDup) == 0) {
          float* row = red + (warp * CH + tt) * 2 * NS;
#pragma unroll
          for (int i = 0; i < K::R; ++i) {
            const int idx = off + i;  // (dB or dC, state s) of lane q
            const int arr = idx / S, s = idx - arr * S;
            row[arr * NS + q * S + s] = v[i];
          }
        }
      }
      // the lanes' partials meet in the forward's butterfly: lane q ends
      // with step gb + q's sums
#pragma unroll
      for (int w = kLanes / 2; w >= 1; w /= 2) {
        const bool upper = q & w;
#pragma unroll
        for (int i = 0; i < w; ++i) {
          const float kx = upper ? sx[i + w] : sx[i];
          const float tx = upper ? sx[i] : sx[i + w];
          const float kd = upper ? sd[i + w] : sd[i];
          const float td = upper ? sd[i] : sd[i + w];
          sx[i] = __fadd_rn(kx, __shfl_xor_sync(0xffffffffu, tx, w));
          sd[i] = __fadd_rn(kd, __shfl_xor_sync(0xffffffffu, td, w));
        }
      }
      const int tt = gb + q;
      if (c_ok && tt < len) {
        const float dt = widen(st.dl[tt * kChannels + cl]);
        const float xv = widen(st.xs[tt * kChannels + cl]);
        const int64_t off = (row0 + t0 + tt) * d + c;
        narrow(dx + off, __fmul_rn(dt, sx[0]));
        narrow(ddelta + off, __fmaf_rn(xv, sx[0], sd[0]));
      }
    }
    __syncthreads();  // every warp's sums of the interval are in

    // dB_t and dC_t of this block: each (t, n) sums its 8 warps in warp
    // order
    for (int i = tid; i < len * 2 * NS; i += kThreads) {
      const int tt = i / (2 * NS);
      const int r = i - tt * 2 * NS;
      const int arr = r / NS, n = r - arr * NS;
      if (n >= N) continue;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        acc = __fadd_rn(acc, red[(w * CH + tt) * 2 * NS + r]);
      (arr ? pC : pB)[(int64_t)(t0 + tt) * N + n] = acc;
    }
  }

  if (!c_ok) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = q * S + s;
    if (n < N) part_A[chunk0 + n] = dA[s];
  }
}

// dB, dC: the channel blocks' partials summed in block order; dA: the
// (batch row, time chunk) partials summed in that order
__global__ void mamba_scan_bwd_reduce(const float* __restrict__ part_B,
                                      const float* __restrict__ part_C,
                                      const float* __restrict__ part_A,
                                      float* __restrict__ dB,
                                      float* __restrict__ dC,
                                      float* __restrict__ dA, int Bt, int T,
                                      int d, int N, int blocks, int n_tc) {
  const int64_t tn = (int64_t)T * N;
  const int64_t nbc = (int64_t)Bt * tn;
  const int64_t dn = (int64_t)d * N;
  const int64_t total = 2 * nbc + dn;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (i < 2 * nbc) {
      const bool is_c = i >= nbc;
      const int64_t j = is_c ? i - nbc : i;
      const int64_t b = j / tn;
      const float* src = (is_c ? part_C : part_B) + b * blocks * tn + (j - b * tn);
#pragma unroll 8
      for (int blk = 0; blk < blocks; ++blk)
        acc = __fadd_rn(acc, src[blk * tn]);
      (is_c ? dC : dB)[j] = acc;
    } else {
      const int64_t j = i - 2 * nbc;
      const int64_t parts = (int64_t)Bt * n_tc;
#pragma unroll 8
      for (int64_t k = 0; k < parts; ++k)
        acc = __fadd_rn(acc, part_A[k * dn + j]);
      dA[j] = acc;
    }
  }
}

struct Args {
  const void *delta, *x;
  const float *Bm, *Cm, *A, *carries, *dy, *dhT;
  void *ddelta, *dx;
  float *dB, *dC, *dA, *dh0, *U, *P, *part_A, *part_B, *part_C;
  int Bt, T, d, N, n_tc, blocks, vec_dx, vec_dy, vec_bc;
  cudaStream_t stream;
};

unsigned grid_of(int64_t total) {
  const int64_t g = total > 0 ? (total + 255) / 256 : 1;
  return (unsigned)(g < 65535 * 16 ? g : 65535 * 16);
}

template <typename E, int NS>
cudaError_t launch(const Args& a) {
  using K = Walk<E, NS>;
  const dim3 grid((unsigned)a.blocks, (unsigned)a.n_tc, (unsigned)a.Bt);
  // the kernels' shared memory past 48 KB, opened once a device
  static bool opened[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !opened[dev]) {
    err = cudaFuncSetAttribute(mamba_scan_bwd_local<E, NS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kLocalSmem<E, NS>);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mamba_scan_bwd_walk<E, NS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 K::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opened[dev] = true;
  }
  if (a.n_tc > 0) {
    mamba_scan_bwd_local<E, NS>
        <<<grid, kThreads, kLocalSmem<E, NS>, a.stream>>>(
            static_cast<const E*>(a.delta), a.Cm, a.A, a.dy, a.U, a.P, a.T,
            a.d, a.N, a.vec_dx, a.vec_dy, a.vec_bc);
  }
  const int64_t states = (int64_t)a.Bt * a.d * a.N;
  mamba_scan_bwd_cross<<<grid_of(states), 256, 0, a.stream>>>(
      a.U, a.P, a.dhT, a.dh0, a.Bt, a.d, a.N, a.n_tc);
  if (a.n_tc > 0) {
    mamba_scan_bwd_walk<E, NS><<<grid, kThreads, K::kSmem, a.stream>>>(
        static_cast<const E*>(a.delta), static_cast<const E*>(a.x), a.Bm,
        a.Cm, a.A, a.carries, a.dy, a.U, static_cast<E*>(a.ddelta),
        static_cast<E*>(a.dx), a.part_A, a.part_B, a.part_C, a.T, a.d, a.N,
        a.vec_dx, a.vec_dy, a.vec_bc);
  }
  const int64_t total = 2 * (int64_t)a.Bt * a.T * a.N + (int64_t)a.d * a.N;
  mamba_scan_bwd_reduce<<<grid_of(total), 256, 0, a.stream>>>(
      a.part_B, a.part_C, a.part_A, a.dB, a.dC, a.dA, a.Bt, a.T, a.d, a.N,
      a.blocks, a.n_tc);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_n(const Args& a) {
  if (a.N <= 4) return launch<E, 4>(a);
  if (a.N <= 8) return launch<E, 8>(a);
  if (a.N <= 16) return launch<E, 16>(a);
  return launch<E, 32>(a);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// bf16: delta, x and their gradients are bf16 (else fp32).  carries:
// [Bt, ceil(T / kCh), d, N] from the forward; dy [Bt, T, d], dhT
// [Bt, d, N].  Workspace (fp32, from the caller): u (then g_end), P and
// the dA partials, each [Bt, ceil(T / kTimeChunk), d, N]; the dB and dC
// partials, each [Bt, ceil(d / 64), T, N].  Four launches: the local
// sweeps, the cross-chunk pass, the walks, the sums.
extern "C" int repro_mamba_scan_backward(
    const void* delta, const void* x, const void* Bm, const void* Cm,
    const void* A, const void* carries, const void* dy, const void* dhT,
    void* ddelta, void* dx, void* dB, void* dC, void* dA, void* dh0,
    void* workspace, int Bt, int T, int d, int N, int bf16, void* stream) {
  if (Bt <= 0 || d <= 0) return (int)cudaSuccess;
  const int n_tc = (T + kTimeChunk - 1) / kTimeChunk;
  if (Bt > 65535 || N < 1 || N > 32 || T < 0 || n_tc > 65535)
    return (int)cudaErrorInvalidValue;
  const int elt = bf16 ? 2 : 4;
  const bool rows16 = (int64_t)d * elt % 16 == 0;
  const bool rows4 = (int64_t)d * elt % 4 == 0;
  Args a;
  a.delta = delta;
  a.x = x;
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.A = static_cast<const float*>(A);
  a.carries = static_cast<const float*>(carries);
  a.dy = static_cast<const float*>(dy);
  a.dhT = static_cast<const float*>(dhT);
  a.ddelta = ddelta;
  a.dx = dx;
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.dA = static_cast<float*>(dA);
  a.dh0 = static_cast<float*>(dh0);
  a.Bt = Bt;
  a.T = T;
  a.d = d;
  a.N = N;
  a.n_tc = n_tc;
  a.blocks = (d + kChannels - 1) / kChannels;
  const int64_t chunk_floats = (int64_t)Bt * n_tc * d * N;
  const int64_t part_floats = (int64_t)Bt * a.blocks * T * N;
  a.U = static_cast<float*>(workspace);
  a.P = a.U + chunk_floats;
  a.part_A = a.P + chunk_floats;
  a.part_B = a.part_A + chunk_floats;
  a.part_C = a.part_B + part_floats;
  a.vec_dx = rows16 && aligned(delta, 16) && aligned(x, 16) ? 16
             : rows4 && aligned(delta, 4) && aligned(x, 4)  ? 4
                                                            : 2;
  a.vec_dy = d % 4 == 0 && aligned(dy, 16) ? 16 : 4;
  a.vec_bc = N % 4 == 0 && aligned(Bm, 16) && aligned(Cm, 16) &&
                     aligned(carries, 16)
                 ? 16
                 : 4;
  a.stream = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_n<uint16_t>(a) : launch_n<float>(a));
}

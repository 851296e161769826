// The gradient of the Mamba-1 selective scan (sm_90a).
//
// Replaces no TPU kernel: the reference trains by jax.grad of its plain
// chunked scan (the lax.scan of repro/models/mamba.py), whose gradient XLA
// compiles into device code; this is that gradient as a kernel, so that
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
// Bound on the H100: one exp per (b, t, c, n) on the special-function
// units, above the bytes of delta, x, dy, the carries and the gradients;
// the states, their exps and the per-state products stay on chip.  What
// the design does:
//   - The forward's grid: a block scans 64 channels of one batch row, the
//     N states of a channel split over L lanes (the forward's lanes), with
//     the forward's state buckets 4, 8, 16, 32 (states past N padded with
//     A = B = C = 0).
//   - The forward saved the state before every kCh-th step (carries).  The
//     block walks those chunks last to first: it streams a chunk's delta,
//     x, dy, B and C into shared memory (cp.async, a 2-stage ring: the
//     chunk before streams in while this one runs), rebuilds the chunk's
//     states from its carry with the forward's own instructions (so bit
//     for bit the forward's states), keeping each state h_{t-1} and each
//     a_t in shared memory, one exp per (t, c, n), then walks the chunk
//     backwards.  kCh is chosen so that the states and exps of a chunk fill
//     128 KB: 32 steps for N <= 8, 16 for N <= 16, 8 for N <= 32.
//   - dx and d delta sum a channel's states over its L lanes in the
//     forward's fixed butterfly; dA stays in registers across all steps.
//   - dB_t and dC_t sum over channels, which span blocks: each step's
//     per-channel products overwrite the slots their h_{t-1} and a_t came
//     from, the block sums its 64 channels in channel order, and writes
//     one partial per block; the second kernel sums the blocks' partials in
//     block order, and dA's per-batch-row partials in row order.  No
//     atomics: two launches are bit-identical.
//   - bf16 delta / x get their fp32 gradients rounded to nearest even.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 64;  // channels a block scans
constexpr int kStages = 2;     // ring depth
constexpr float kLog2e = 1.4426950408889634f;

// steps between the forward's carries for state bucket NS (ops.carry_steps)
template <int NS>
constexpr int kCh = NS <= 8 ? 32 : 256 / NS;

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

// One ring stage: delta, x [CH][64] (E), dy [CH][64] (fp32), B, C [CH][NS].
template <typename E, int NS>
struct Stage {
  static constexpr int CH = kCh<NS>;
  static constexpr int kBytes =
      2 * CH * kChannels * (int)sizeof(E) + CH * kChannels * 4 + 2 * CH * NS * 4;
  E* dl;
  E* xs;
  float* dys;
  float* bs;
  float* cs;
  __device__ Stage(unsigned char* base, int k) {
    unsigned char* p = base + (k % kStages) * kBytes;
    dl = reinterpret_cast<E*>(p);
    xs = dl + CH * kChannels;
    dys = reinterpret_cast<float*>(xs + CH * kChannels);
    bs = dys + CH * kChannels;
    cs = bs + CH * NS;
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

// Issue chunk k's copies into its stage.  vec_dx: 16, 4 or 2 (plain
// loads); vec_dy, vec_bc: 16 or 4.
template <typename E, int NS>
__device__ __forceinline__ void load_chunk(
    unsigned char* ring, int k, const E* delta, const E* x, const float* dy,
    const float* Bm, const float* Cm, int64_t row0, int T, int d, int c0,
    int N, int vec_dx, int vec_dy, int vec_bc) {
  constexpr int CH = kCh<NS>;
  const Stage<E, NS> st(ring, k);
  const int t0 = k * CH;
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

template <typename E, int NS, int L>
struct Bwd {
  static constexpr int S = NS / L;              // states a lane holds
  static constexpr int NT = kChannels * L;      // threads a block
  static constexpr int CH = kCh<NS>;            // steps a chunk
  static constexpr int kPitch = NT + 1;         // a slot row, floats
  // h_{t-1} and a_t of a chunk: [CH * S][kPitch] each, a thread's slot at
  // (t * S + s) * kPitch + tid; rounded up to 16 bytes
  static constexpr int kStoreFloats = (CH * S * kPitch + 3) / 4 * 4;
  static constexpr int kSmem =
      2 * kStoreFloats * 4 + kStages * Stage<E, NS>::kBytes;
  static_assert(kSmem <= 232448, "shared memory of one block");
  static_assert(CH % L == 0 && (CH * S) % 32 == 0, "chunk shape");
};

template <typename E, int NS, int L>
__global__ void __launch_bounds__(kChannels * L, 1)
mamba_scan_bwd_kernel(const E* __restrict__ delta, const E* __restrict__ x,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ A,
                      const float* __restrict__ carries,
                      const float* __restrict__ dy,
                      const float* __restrict__ dhT, E* __restrict__ ddelta,
                      E* __restrict__ dx, float* __restrict__ part_A,
                      float* __restrict__ dh0, float* __restrict__ part_B,
                      float* __restrict__ part_C, int T, int d, int N,
                      int vec_dx, int vec_dy, int vec_bc) {
  using K = Bwd<E, NS, L>;
  constexpr int S = K::S, CH = K::CH, P = K::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);  // h_{t-1}, then dB partials
  float* as = hs + K::kStoreFloats;            // a_t, then dC partials
  unsigned char* ring = reinterpret_cast<unsigned char*>(as + K::kStoreFloats);

  const int tid = threadIdx.x;
  const int q = tid % L;   // lane within the channel's group
  const int cl = tid / L;  // channel within the block
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const bool c_ok = c < d;
  const int b = blockIdx.y;
  const int64_t row0 = (int64_t)b * T;
  const int64_t state0 = ((int64_t)b * d + c) * N;
  const int n_chunks = (T + CH - 1) / CH;

  float Av[S], g[S], dA[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = q * S + s;
    const bool ok = c_ok && n < N;
    Av[s] = ok ? A[(int64_t)c * N + n] : 0.f;
    g[s] = ok ? dhT[state0 + n] : 0.f;
    dA[s] = 0.f;
  }

  if (n_chunks > 0)
    load_chunk<E, NS>(ring, n_chunks - 1, delta, x, dy, Bm, Cm, row0, T, d,
                      c0, N, vec_dx, vec_dy, vec_bc);
  cp_commit();

  for (int k = n_chunks - 1; k >= 0; --k) {
    if (k > 0) {
      load_chunk<E, NS>(ring, k - 1, delta, x, dy, Bm, Cm, row0, T, d, c0, N,
                        vec_dx, vec_dy, vec_bc);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // chunk k is in, and the slots are free
    const Stage<E, NS> st(ring, k);
    const int t0 = k * CH;
    const int len = min(CH, T - t0);

    // the chunk's states from its carry, as the forward computed them
    const float* carry = carries + (((int64_t)b * n_chunks + k) * d + c) * N;
#pragma unroll
    for (int s = 0; s < S; ++s)
      h[s] = c_ok && q * S + s < N ? carry[q * S + s] : 0.f;
    for (int tt = 0; tt < len; ++tt) {
      const float dt = widen(st.dl[tt * kChannels + cl]);
      const float dtx = __fmul_rn(dt, widen(st.xs[tt * kChannels + cl]));
      float bv[S];
      load_states<S>(st.bs + tt * NS + q * S, bv);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int slot = (tt * S + s) * P + tid;
        const float a = ex2(__fmul_rn(dt, __fmul_rn(Av[s], kLog2e)));
        as[slot] = a;
        hs[slot] = h[s];
        h[s] = __fmaf_rn(a, h[s], __fmul_rn(dtx, bv[s]));
      }
    }

    // back through the chunk, L steps a group (the top one may be short);
    // h is the state after the step at hand
    for (int gb = (len + L - 1) / L * L - L; gb >= 0; gb -= L) {
      float sx[L], sd[L];  // sum_n g B, sum_n g A a h_{t-1}, step gb + j
#pragma unroll
      for (int j = L - 1; j >= 0; --j) {
        sx[j] = sd[j] = 0.f;
        const int tt = gb + j;
        if (tt >= len) continue;
        const float dt = widen(st.dl[tt * kChannels + cl]);
        const float dtx = __fmul_rn(dt, widen(st.xs[tt * kChannels + cl]));
        const float dyv = st.dys[tt * kChannels + cl];
        float bv[S], cv[S];
        load_states<S>(st.bs + tt * NS + q * S, bv);
        load_states<S>(st.cs + tt * NS + q * S, cv);
        float px = 0.f, pd = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int slot = (tt * S + s) * P + tid;
          const float a = as[slot];
          const float hp = hs[slot];
          const float gs = __fmaf_rn(cv[s], dyv, g[s]);
          as[slot] = __fmul_rn(h[s], dyv);  // dC_t's term
          hs[slot] = __fmul_rn(gs, dtx);    // dB_t's term
          const float ah = __fmul_rn(a, hp);
          px = __fmaf_rn(gs, bv[s], px);
          pd = __fmaf_rn(gs, __fmul_rn(Av[s], ah), pd);
          dA[s] = __fmaf_rn(gs, __fmul_rn(dt, ah), dA[s]);
          h[s] = hp;
          g[s] = __fmul_rn(a, gs);
        }
        sx[j] = px;
        sd[j] = pd;
      }
      // the lanes' partials meet in the forward's butterfly: lane q ends
      // with step gb + q's sums
#pragma unroll
      for (int w = L / 2; w >= 1; w /= 2) {
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
    __syncthreads();  // every step's terms are in the slots

    // dB_t and dC_t of this block: each (t, n) sums its 64 channels in
    // channel order; a warp takes 32 consecutive slot rows of one lane, so
    // its reads fall in 32 banks (the pitch is 1 mod 32)
    constexpr int kItems = CH * S * L;  // (t, n) pairs of one array
    float* pB = part_B + ((int64_t)b * gridDim.x + blockIdx.x) * T * N;
    float* pC = part_C + ((int64_t)b * gridDim.x + blockIdx.x) * T * N;
    for (int i = tid; i < 2 * kItems; i += K::NT) {
      const bool is_c = i >= kItems;
      const int it = is_c ? i - kItems : i;
      const int lq = it / (CH * S);
      const int r = it - lq * (CH * S);  // t * S + s
      const int tt = r / S;
      const int n = lq * S + (r - tt * S);
      if (tt >= len || n >= N) continue;
      const float* src = (is_c ? as : hs) + r * P + lq;
      float acc = 0.f;
#pragma unroll 8
      for (int cc = 0; cc < kChannels; ++cc) acc = __fadd_rn(acc, src[cc * L]);
      (is_c ? pC : pB)[(int64_t)(t0 + tt) * N + n] = acc;
    }
    __syncthreads();  // the slots are free for the next chunk
  }

  if (!c_ok) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = q * S + s;
    if (n < N) {
      dh0[state0 + n] = g[s];
      part_A[state0 + n] = dA[s];
    }
  }
}

// dB, dC: the blocks' partials summed in block order; dA: the batch rows'
// partials summed in row order
__global__ void mamba_scan_bwd_reduce(const float* __restrict__ part_B,
                                      const float* __restrict__ part_C,
                                      const float* __restrict__ part_A,
                                      float* __restrict__ dB,
                                      float* __restrict__ dC,
                                      float* __restrict__ dA, int Bt, int T,
                                      int d, int N, int blocks) {
  const int64_t tn = (int64_t)T * N;
  const int64_t nbc = (int64_t)Bt * tn;
  const int64_t total = 2 * nbc + (int64_t)d * N;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (i < 2 * nbc) {
      const bool is_c = i >= nbc;
      const int64_t j = is_c ? i - nbc : i;
      const int64_t b = j / tn;
      const float* src = (is_c ? part_C : part_B) + b * blocks * tn + (j - b * tn);
      for (int blk = 0; blk < blocks; ++blk)
        acc = __fadd_rn(acc, src[blk * tn]);
      (is_c ? dC : dB)[j] = acc;
    } else {
      const int64_t j = i - 2 * nbc;
      for (int b = 0; b < Bt; ++b)
        acc = __fadd_rn(acc, part_A[(int64_t)b * d * N + j]);
      dA[j] = acc;
    }
  }
}

struct Args {
  const void *delta, *x;
  const float *Bm, *Cm, *A, *carries, *dy, *dhT;
  void *ddelta, *dx;
  float *part_A, *dh0, *part_B, *part_C, *dB, *dC, *dA;
  int Bt, T, d, N, vec_dx, vec_dy, vec_bc;
  cudaStream_t stream;
};

template <typename E, int NS, int L>
cudaError_t launch(const Args& a) {
  using K = Bwd<E, NS, L>;
  const cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<E, NS, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.d + kChannels - 1) / kChannels),
                  (unsigned)a.Bt);
  mamba_scan_bwd_kernel<E, NS, L><<<grid, K::NT, K::kSmem, a.stream>>>(
      static_cast<const E*>(a.delta), static_cast<const E*>(a.x), a.Bm, a.Cm,
      a.A, a.carries, a.dy, a.dhT, static_cast<E*>(a.ddelta),
      static_cast<E*>(a.dx), a.part_A, a.dh0, a.part_B, a.part_C, a.T, a.d,
      a.N, a.vec_dx, a.vec_dy, a.vec_bc);
  return cudaGetLastError();
}

template <typename E, int L>
cudaError_t launch_n(const Args& a) {
  if (a.N <= 4) return launch<E, 4, L>(a);
  if (a.N <= 8) return launch<E, 8, L>(a);
  if (a.N <= 16) return launch<E, 16, L>(a);
  return launch<E, 32, L>(a);
}

template <typename E>
cudaError_t launch_e(const Args& a, int lanes) {
  if (lanes == 1) return launch_n<E, 1>(a);
  if (lanes == 2) return launch_n<E, 2>(a);
  return launch_n<E, 4>(a);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// bf16: delta, x and their gradients are bf16 (else fp32).  lanes: as the
// forward's.  carries: [Bt, ceil(T / kCh), d, N] from the forward; dy
// [Bt, T, d], dhT [Bt, d, N].  Scratch: part_A [Bt, d, N], part_B and
// part_C [Bt, ceil(d / 64), T, N].  Two launches: the scan, the sums.
extern "C" int repro_mamba_scan_backward(
    const void* delta, const void* x, const void* Bm, const void* Cm,
    const void* A, const void* carries, const void* dy, const void* dhT,
    void* ddelta, void* dx, void* part_A, void* dh0, void* part_B,
    void* part_C, void* dB, void* dC, void* dA, int Bt, int T, int d, int N,
    int bf16, int lanes, void* stream) {
  if (Bt <= 0 || d <= 0) return (int)cudaSuccess;
  if (Bt > 65535 || N < 1 || N > 32 || T < 0 ||
      (lanes != 1 && lanes != 2 && lanes != 4))
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
  a.part_A = static_cast<float*>(part_A);
  a.dh0 = static_cast<float*>(dh0);
  a.part_B = static_cast<float*>(part_B);
  a.part_C = static_cast<float*>(part_C);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.dA = static_cast<float*>(dA);
  a.Bt = Bt;
  a.T = T;
  a.d = d;
  a.N = N;
  a.vec_dx = rows16 && aligned(delta, 16) && aligned(x, 16) ? 16
             : rows4 && aligned(delta, 4) && aligned(x, 4)  ? 4
                                                            : 2;
  a.vec_dy = d % 4 == 0 && aligned(dy, 16) ? 16 : 4;
  a.vec_bc = N % 4 == 0 && aligned(Bm, 16) && aligned(Cm, 16) ? 16 : 4;
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? launch_e<uint16_t>(a, lanes)
                         : launch_e<float>(a, lanes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d + kChannels - 1) / kChannels;
  const int64_t total = 2 * (int64_t)Bt * T * N + (int64_t)d * N;
  const int64_t grid = total > 0 ? (total + 255) / 256 : 1;
  mamba_scan_bwd_reduce<<<(unsigned)(grid < 65535 * 16 ? grid : 65535 * 16),
                          256, 0, a.stream>>>(a.part_B, a.part_C, a.part_A,
                                               a.dB, a.dC, a.dA, Bt, T, d, N,
                                               blocks);
  return (int)cudaGetLastError();
}

// Mamba-1 selective scan (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mamba_scan/kernel.py:
// _mamba_scan_kernel / mamba_scan_pallas.  Per batch row b, channel c and
// state n, from h0:
//   h_t[c, n] = exp(delta_t[c] * A[c, n]) * h_{t-1}[c, n]
//               + delta_t[c] * B_t[n] * x_t[c]
//   y_t[c]    = sum_n h_t[c, n] * C_t[n]
// with delta, x, y [Bt, T, d], B, C [Bt, T, N], A [d, N], h0 and the final
// state hT [Bt, d, N], all fp32.
//
// Bound on the H100: bytes.  delta and x are read once and y written once
// (12 bytes per (b, t, c)); B, C, A, h0 and hT are small beside them.  The
// point of the TPU kernel is kept: the [d, N] outer products exp(delta*A)
// and delta*B*x never reach device memory.  What the design does:
//   - One thread per (batch row, channel).  It holds the channel's N state
//     values and its row of A in registers and loops over all T steps; that
//     loop replaces the TPU's sequential chunk grid and its VMEM carry.
//   - A block of kChannels channels stages a chunk of kChunk time steps of
//     delta and x in shared memory (each thread loads its own column, so
//     neighbouring threads load neighbouring addresses and many loads are in
//     flight at once), and the B_t / C_t rows of the chunk, which every
//     channel reads, as broadcasts.  y is stored coalesced across channels.
//   - The state size is a template bucket (4, 8, 16 or 32): states past N
//     are padded with A = 0 and B = C = 0, so they stay 0 and add nothing.
//     N above 32 is refused: the states would leave the registers.
//   - Every thread runs its steps in order with no atomics, so two launches
//     are bit-identical, and scanning [0, T1) then [T1, T) from its hT gives
//     the same result as scanning [0, T).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 64;  // threads (channels) per block
constexpr int kChunk = 64;     // time steps staged per pass

template <int NS>
__global__ void __launch_bounds__(kChannels)
mamba_scan_kernel(const float* __restrict__ delta, const float* __restrict__ x,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ hT, int T, int d,
                  int N) {
  __shared__ float d_s[kChunk][kChannels];
  __shared__ float x_s[kChunk][kChannels];
  __shared__ float b_s[kChunk][NS];
  __shared__ float c_s[kChunk][NS];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = blockIdx.x * kChannels + tid;
  const bool c_ok = c < d;
  const int64_t state0 = ((int64_t)b * d + c) * N;

  float a[NS], h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const bool ok = c_ok && n < N;
    a[n] = ok ? A[(int64_t)c * N + n] : 0.f;
    h[n] = ok ? h0[state0 + n] : 0.f;
  }

  const int64_t row0 = (int64_t)b * T;
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int len = min(kChunk, T - t0);
    __syncthreads();  // the previous chunk is consumed
#pragma unroll 8
    for (int tt = 0; tt < len; ++tt) {
      const int64_t off = (row0 + t0 + tt) * d + c;
      d_s[tt][tid] = c_ok ? delta[off] : 0.f;
      x_s[tt][tid] = c_ok ? x[off] : 0.f;
    }
    for (int i = tid; i < kChunk * NS; i += kChannels) {
      const int tt = i / NS;
      const int n = i - tt * NS;
      float bv = 0.f, cv = 0.f;
      if (tt < len && n < N) {
        const int64_t off = (row0 + t0 + tt) * N + n;
        bv = Bm[off];
        cv = Cm[off];
      }
      b_s[tt][n] = bv;
      c_s[tt][n] = cv;
    }
    __syncthreads();

    for (int tt = 0; tt < len; ++tt) {
      const float dt = d_s[tt][tid];
      const float xt = x_s[tt][tid];
      float yt = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float dA = expf(dt * a[n]);
        const float dBx = dt * b_s[tt][n] * xt;
        h[n] = dA * h[n] + dBx;
        yt += h[n] * c_s[tt][n];
      }
      if (c_ok) y[(row0 + t0 + tt) * d + c] = yt;
    }
  }

  if (!c_ok) return;
#pragma unroll
  for (int n = 0; n < NS; ++n)
    if (n < N) hT[state0 + n] = h[n];
}

template <int NS>
cudaError_t launch(const float* delta, const float* x, const float* Bm,
                   const float* Cm, const float* A, const float* h0, float* y,
                   float* hT, int Bt, int T, int d, int N,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((d + kChannels - 1) / kChannels), (unsigned)Bt);
  mamba_scan_kernel<NS><<<grid, kChannels, 0, stream>>>(
      delta, x, Bm, Cm, A, h0, y, hT, T, d, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_mamba_scan(const void* delta, const void* x,
                                const void* Bm, const void* Cm, const void* A,
                                const void* h0, void* y, void* hT, int Bt,
                                int T, int d, int N, void* stream) {
  if (Bt <= 0 || d <= 0) return (int)cudaSuccess;
  if (Bt > 65535 || N < 1 || N > 32) return (int)cudaErrorInvalidValue;
  const auto* dl = static_cast<const float*>(delta);
  const auto* xx = static_cast<const float*>(x);
  const auto* bb = static_cast<const float*>(Bm);
  const auto* cc = static_cast<const float*>(Cm);
  const auto* aa = static_cast<const float*>(A);
  const auto* hh = static_cast<const float*>(h0);
  auto* yy = static_cast<float*>(y);
  auto* ht = static_cast<float*>(hT);
  auto* st = static_cast<cudaStream_t>(stream);
  if (N <= 4) return (int)launch<4>(dl, xx, bb, cc, aa, hh, yy, ht, Bt, T, d, N, st);
  if (N <= 8) return (int)launch<8>(dl, xx, bb, cc, aa, hh, yy, ht, Bt, T, d, N, st);
  if (N <= 16) return (int)launch<16>(dl, xx, bb, cc, aa, hh, yy, ht, Bt, T, d, N, st);
  return (int)launch<32>(dl, xx, bb, cc, aa, hh, yy, ht, Bt, T, d, N, st);
}

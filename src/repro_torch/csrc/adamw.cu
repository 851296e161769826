// AdamW's update and the gradients' global norm in fused passes (sm_90a).
//
// No TPU kernel corresponds: the reference's AdamW is jnp code
// (repro/train/optimizer.py: adamw_update, global_norm) that XLA fuses.
// Eager PyTorch runs the same math as some 20 fp32 ops a piece
// (repro_torch/train/optimizer.py, the plain route), each reading and
// writing whole fp32 temporaries, plus a squared copy of every gradient for
// the norm and a pass dividing the gradients by the pass count: some
// 200-240 bytes a parameter.
//
// Bound on the H100: bytes.  The update reads p, g, m and v once and writes
// p, m and v once: 28 bytes a parameter at fp32 state; the norm reads g once
// more, 4 bytes.  What the design does:
//   - The update is one grid-stride pass a leaf (a stacked leaf as one flat
//     buffer) that keeps every intermediate in registers, four elements a
//     thread at a time (16-byte loads of fp32, 8-byte of bf16) where every
//     pointer allows, one at a time otherwise and for the tail.
//   - The scalars lr, the clip scale and the two bias corrections are read
//     from device memory, where PyTorch computed them: the host never
//     synchronises.  b1, 1 - b1, b2, 1 - b2, eps and the weight decay come
//     as floats rounded from the host's doubles, as PyTorch rounds a Python
//     number into an fp32 op.
//   - Each operation is an _rn intrinsic in the plain route's order, so
//     nvcc contracts nothing into an FMA; with the same scale, p, m and v
//     are bitwise the plain route's on the card.  p, g, m and v are each
//     fp32 or bf16 (templates), widened exactly in registers and stored with
//     round-to-nearest-even, as copy_ stores.
//   - The gradients arrive summed over the step's passes: both kernels
//     multiply each by the reciprocal of the pass count and round it to the
//     gradient's dtype first, which is what g.div_(passes) does on the card
//     (a CPU scalar divisor becomes a product with its reciprocal).
//   - The norm: each block sums its squares in fp64 and writes the sum to a
//     slot of its own in a workspace (no atomics); one block then sums the
//     slots in a fixed order, rounds to fp32, takes the square root and the
//     clip scale, min(clip / (norm + 1e-9), 1) computed as PyTorch computes
//     it (a reciprocal, then a product).  Reruns are bit-identical; the
//     fp64 sums keep the result within fp32 rounding of the exact norm
//     whatever the order.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kFinishThreads = 1024;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load(const float* p, float (&x)[kVec]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&x)[kVec]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ void put(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&x)[kVec]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&x)[kVec]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(
        bits(x[0]) | bits(x[1]) << 16, bits(x[2]) | bits(x[3]) << 16);
  }
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// The gradient as the plain route takes it: g.div_(passes) rounded to G
template <typename G>
__device__ __forceinline__ float grad_in(float g, float inv_div, bool div) {
  return div ? Io<G>::round(__fmul_rn(g, inv_div)) : g;
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, inv_div;
  bool div;
};

// One element, in the plain route's order (train/optimizer.py)
__device__ __forceinline__ void adamw_one(float& p, float g, float& m,
                                          float& v, float lr, float scale,
                                          float bc1, float bc2,
                                          const Hyper& h) {
  const float g32 = __fmul_rn(g, scale);
  const float m32 = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g32, h.omb1));
  const float v32 = __fadd_rn(__fmul_rn(v, h.b2),
                              __fmul_rn(__fmul_rn(g32, h.omb2), g32));
  const float mh = __fdiv_rn(m32, bc1);
  const float vh = __fdiv_rn(v32, bc2);
  const float den = __fadd_rn(__fsqrt_rn(vh), h.eps);
  const float upd = __fmul_rn(lr, __fadd_rn(__fdiv_rn(mh, den),
                                            __fmul_rn(p, h.wd)));
  p = __fsub_rn(p, upd);
  m = m32;
  v = v32;
}

template <typename P, typename G, typename M, typename V>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(P* __restrict__ p, const G* __restrict__ g, M* __restrict__ m,
             V* __restrict__ v, int64_t n, bool vec,
             const float* __restrict__ lr_p, const float* __restrict__ scale_p,
             const float* __restrict__ bc1_p, const float* __restrict__ bc2_p,
             Hyper h) {
  const float lr = *lr_p, scale = *scale_p, bc1 = *bc1_p, bc2 = *bc2_p;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nv = vec ? n / kVec : 0;
  for (int64_t i = tid; i < nv; i += stride) {
    const int64_t o = i * kVec;
    float pp[kVec], gg[kVec], mm[kVec], vv[kVec];
    Io<P>::load(p + o, pp);
    Io<G>::load(g + o, gg);
    Io<M>::load(m + o, mm);
    Io<V>::load(v + o, vv);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      adamw_one(pp[j], grad_in<G>(gg[j], h.inv_div, h.div), mm[j], vv[j], lr,
                scale, bc1, bc2, h);
    Io<P>::store(p + o, pp);
    Io<M>::store(m + o, mm);
    Io<V>::store(v + o, vv);
  }
  for (int64_t i = nv * kVec + tid; i < n; i += stride) {
    float pp = Io<P>::get(p + i), mm = Io<M>::get(m + i),
          vv = Io<V>::get(v + i);
    adamw_one(pp, grad_in<G>(Io<G>::get(g + i), h.inv_div, h.div), mm, vv,
              lr, scale, bc1, bc2, h);
    Io<P>::put(p + i, pp);
    Io<M>::put(m + i, mm);
    Io<V>::put(v + i, vv);
  }
}

// The block's sum of its threads' values in a fixed tree; valid in thread 0
template <int kBlock>
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kBlock / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kBlock / 32 ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
square_partials_kernel(const G* __restrict__ g, int64_t n, bool vec,
                       float inv_div, bool div, double* __restrict__ part) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nv = vec ? n / kVec : 0;
  double acc = 0.0;
  for (int64_t i = tid; i < nv; i += stride) {
    float gg[kVec];
    Io<G>::load(g + i * kVec, gg);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const double x = grad_in<G>(gg[j], inv_div, div);
      acc = fma(x, x, acc);
    }
  }
  for (int64_t i = nv * kVec + tid; i < n; i += stride) {
    const double x = grad_in<G>(Io<G>::get(g + i), inv_div, div);
    acc = fma(x, x, acc);
  }
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

// out[0] the sum of squares, out[1] its square root, out[2] the clip scale
__global__ void __launch_bounds__(kFinishThreads)
square_finish_kernel(const double* __restrict__ part, int64_t n_part,
                     float clip, float tiny, bool has_clip,
                     float* __restrict__ out) {
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < n_part; i += kFinishThreads)
    acc += part[i];
  acc = block_sum<kFinishThreads>(acc);
  if (threadIdx.x == 0) {
    const float ss = (float)acc;
    const float norm = __fsqrt_rn(ss);
    float scale = 1.0f;
    if (has_clip) {
      scale = __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(norm, tiny)), clip);
      scale = scale > 1.0f ? 1.0f : scale;     // a NaN stays, as clamp keeps it
    }
    out[0] = ss;
    out[1] = norm;
    out[2] = scale;
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename T>
bool vec_ok(const void* ptr) {
  return aligned(ptr, kVec * (int)sizeof(T));
}

// Calls f with a value of the type that bf16 selects
template <typename F>
cudaError_t with_type(int bf16, F f) {
  return bf16 ? f(__nv_bfloat16{}) : f(float{});
}

}  // namespace

// The update of one leaf of n elements in place.  *_bf16: that tensor is
// bf16 (else fp32).  lr, scale, bc1, bc2: fp32 scalars on the device.
// div: the pass count the gradients are divided by (1: not divided).
extern "C" int repro_adamw_update(void* p, int p_bf16, const void* g,
                                  int g_bf16, void* m, int m_bf16, void* v,
                                  int v_bf16, int64_t n, const void* lr,
                                  const void* scale, const void* bc1,
                                  const void* bc2, float b1, float omb1,
                                  float b2, float omb2, float eps, float wd,
                                  int div, int blocks, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (blocks <= 0 || div <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd, 1.0f / (float)div, div != 1};
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* lr_p = static_cast<const float*>(lr);
  const auto* scale_p = static_cast<const float*>(scale);
  const auto* bc1_p = static_cast<const float*>(bc1);
  const auto* bc2_p = static_cast<const float*>(bc2);
  return (int)with_type(p_bf16, [&](auto p_t) {
    return with_type(g_bf16, [&](auto g_t) {
      return with_type(m_bf16, [&](auto m_t) {
        return with_type(v_bf16, [&](auto v_t) {
          using P = decltype(p_t);
          using G = decltype(g_t);
          using M = decltype(m_t);
          using V = decltype(v_t);
          const bool vec = vec_ok<P>(p) && vec_ok<G>(g) && vec_ok<M>(m) &&
                           vec_ok<V>(v);
          adamw_kernel<P, G, M, V><<<blocks, kThreads, 0, st>>>(
              static_cast<P*>(p), static_cast<const G*>(g),
              static_cast<M*>(m), static_cast<V*>(v), n, vec, lr_p, scale_p,
              bc1_p, bc2_p, h);
          return cudaGetLastError();
        });
      });
    });
  });
}

// Sums of squares of the n elements of g (each divided by div as the update
// divides it) into blocks fp64 partials at part[0, blocks)
extern "C" int repro_adamw_square_partials(const void* g, int g_bf16,
                                           int64_t n, int div, int blocks,
                                           void* part, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (blocks <= 0 || div <= 0) return (int)cudaErrorInvalidValue;
  const float inv_div = 1.0f / (float)div;
  auto* st = static_cast<cudaStream_t>(stream);
  return (int)with_type(g_bf16, [&](auto g_t) {
    using G = decltype(g_t);
    square_partials_kernel<G><<<blocks, kThreads, 0, st>>>(
        static_cast<const G*>(g), n, vec_ok<G>(g), inv_div, div != 1,
        static_cast<double*>(part));
    return cudaGetLastError();
  });
}

// out (3 fp32): the sum of the n_part partials, its square root and the
// clip scale for clip where has_clip (else the scale is 1)
extern "C" int repro_adamw_square_finish(const void* part, int64_t n_part,
                                         float clip, int has_clip, void* out,
                                         void* stream) {
  if (n_part < 0) return (int)cudaErrorInvalidValue;
  square_finish_kernel<<<1, kFinishThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(part), n_part, clip, (float)1e-9,
      has_clip != 0, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Kernel K4: the elementwise chains between the beam decode step's GEMMs,
// two entry points (ops/step_norm.py is their wrapper and holds their plain
// versions).
//
// Replaces no TPU kernel: the JAX package's step
// (index_tts_dubbing_tpu/models/gpt.py, trunk_decode_step_split_anc) is plain
// XLA ops. It takes the place of the ~28 small PyTorch ops each layer of the
// port's graphed beam step ran between its GEMMs: each LayerNorm's cast, two
// means, subtract, square, rsqrt, scale, shift and cast; each GELU's ~8 ops;
// the bias adds of the attention's output projection and of both MLP
// linears; the two residual adds.
//
// add_layer_norm, for each row of (R, C) in T: with a GEMM output y,
//   t = round_T(y + bias), x' = round_T(x + t), written over y;
// without one, x' = x. Then LN(x') = round_T(((x' - mean) * rsqrt(var + eps))
// * g + b) with mean and var in float32 over the row (two passes: the mean,
// then the mean of the centred squares), each product and sum rounded as the
// plain chain's separate float32 ops round it (no contraction into FMAs).
// The residual stream is therefore the plain chain's bit for bit; LN(x')
// differs only by the order of the float32 sums behind mean and var.
// bias_gelu, over (R, N) in T, in place: h = round_T(gelu(round_T(h + bias)))
// with gelu in float32, the tanh form with the accurate tanhf (no
// tanh.approx) or the erf form.
//
// Bound on the H100: launch latency. At the decode's shapes a launch touches
// 3-48 rows of 1024-1280 values (4x that for bias_gelu): a few hundred KB at
// most, well under a microsecond at 3.35 TB/s, against the few microseconds
// the card takes to start and retire any kernel. So the design spends one
// launch where the plain chain spent nine: add_layer_norm is one CTA a row,
// the row held in registers as 16-byte vectors (C / vector width threads,
// rounded up to whole warps: 128-320 at the cells' widths), both reductions
// a warp shuffle and one pass over shared memory, summed in a fixed order so
// that the result does not depend on scheduling; bias_gelu is one 16-byte
// vector a thread. Nothing is allocated here; the wrapper allocates LN's
// output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxVecs = 4;         // 16-byte vectors a thread of a long row
constexpr int kGeluThreads = 256;

template <typename T>
__host__ __device__ constexpr int vec_of() {
  return 16 / static_cast<int>(sizeof(T));
}

// 16 bytes of T as float32 values, and back.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < vec_of<T>(); ++k) out[k] = to_f32<T>(e[k]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* in) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int k = 0; k < vec_of<T>(); ++k) e[k] = from_f32<T>(in[k]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The block's sum of v, every thread getting it: the warps' sums, then the
// warps' partials in shared memory added in warp order.
__device__ __forceinline__ float block_sum(float v, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  const int warps = blockDim.x / 32;
  for (int w = 0; w < warps; ++w) s += part[w];
  return s;
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
add_layer_norm_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const T* __restrict__ bias, const T* __restrict__ g,
                      const T* __restrict__ b, T* __restrict__ out, int C,
                      float eps) {
  constexpr int V = vec_of<T>();
  __shared__ float part_sum[kMaxThreads / 32];
  __shared__ float part_sq[kMaxThreads / 32];
  const int nvec = C / V;
  const long long row = static_cast<long long>(blockIdx.x) * C;
  float v[K][V];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * static_cast<int>(blockDim.x) + static_cast<int>(threadIdx.x);
    if (i < nvec) {
      const long long at = row + static_cast<long long>(i) * V;
      load16<T>(x + at, v[k]);
      if (y != nullptr) {
        float t[V];
        load16<T>(y + at, t);
        if (bias != nullptr) {
          float bb[V];
          load16<T>(bias + i * V, bb);
#pragma unroll
          for (int e = 0; e < V; ++e) t[e] = round_to<T>(__fadd_rn(t[e], bb[e]));
        }
#pragma unroll
        for (int e = 0; e < V; ++e) v[k][e] = round_to<T>(__fadd_rn(v[k][e], t[e]));
        store16<T>(y + at, v[k]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) sum += v[k][e];
    }
  }
  const float mean = __fdiv_rn(block_sum(sum, part_sum), static_cast<float>(C));
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * static_cast<int>(blockDim.x) + static_cast<int>(threadIdx.x) < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = __fsub_rn(v[k][e], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
  }
  const float var = __fdiv_rn(block_sum(sq, part_sq), static_cast<float>(C));
  const float rstd = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * static_cast<int>(blockDim.x) + static_cast<int>(threadIdx.x);
    if (i < nvec) {
      float gg[V], bb[V], o[V];
      load16<T>(g + i * V, gg);
      load16<T>(b + i * V, bb);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float n = __fmul_rn(__fsub_rn(v[k][e], mean), rstd);
        o[e] = __fadd_rn(__fmul_rn(n, gg[e]), bb[e]);
      }
      store16<T>(out + row + static_cast<long long>(i) * V, o);
    }
  }
}

// gelu_pytorch_tanh / gelu_new in float32, op for op as nn.gelu_tanh:
// 0.5·x·(1 + tanh(√(2/π)·(x + 0.044715·x³))), x³ as (x·x)·x.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = static_cast<float>(0.7978845608028654);   // sqrt(2 / pi)
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fadd_rn(x, __fmul_rn(0.044715f, x3));
  const float t = tanhf(__fmul_rn(k, inner));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, t));
}

// nn.gelu_exact: 0.5·x·(1 + erf(x / √2)).
__device__ __forceinline__ float gelu_erf(float x) {
  const float r2 = static_cast<float>(1.4142135623730951);  // sqrt(2)
  const float e = erff(__fdiv_rn(x, r2));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, e));
}

template <typename T>
__global__ void __launch_bounds__(kGeluThreads)
bias_gelu_kernel(T* __restrict__ h, const T* __restrict__ bias, int N,
                 long long vecs, int erf_form) {
  constexpr int V = vec_of<T>();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= vecs) return;
  const long long at = i * V;
  float t[V];
  load16<T>(h + at, t);
  if (bias != nullptr) {
    float bb[V];
    load16<T>(bias + at % N, bb);
#pragma unroll
    for (int e = 0; e < V; ++e) t[e] = round_to<T>(__fadd_rn(t[e], bb[e]));
  }
#pragma unroll
  for (int e = 0; e < V; ++e) t[e] = erf_form ? gelu_erf(t[e]) : gelu_tanh(t[e]);
  store16<T>(h + at, t);
}

template <typename T>
int launch_norm(const void* x, void* y, const void* bias, const void* g,
                const void* b, void* out, int R, int C, float eps,
                cudaStream_t stream) {
  constexpr int V = vec_of<T>();
  if (R < 1 || C < V || C % V != 0 || C / V > kMaxVecs * kMaxThreads ||
      (y == nullptr && bias != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nvec = C / V;
  const int K = nvec <= kMaxThreads ? 1 : kMaxVecs;
  const int threads = ((nvec + K - 1) / K + 31) / 32 * 32;
  auto* xt = static_cast<const T*>(x);
  auto* yt = static_cast<T*>(y);
  auto* bt = static_cast<const T*>(bias);
  auto* gp = static_cast<const T*>(g);
  auto* bp = static_cast<const T*>(b);
  auto* ot = static_cast<T*>(out);
  if (K == 1) {
    add_layer_norm_kernel<T, 1><<<R, threads, 0, stream>>>(
        xt, yt, bt, gp, bp, ot, C, eps);
  } else {
    add_layer_norm_kernel<T, kMaxVecs><<<R, threads, 0, stream>>>(
        xt, yt, bt, gp, bp, ot, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gelu(void* h, const void* bias, int R, int N, int erf_form,
                cudaStream_t stream) {
  constexpr int V = vec_of<T>();
  if (R < 1 || N < V || N % V != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long vecs = static_cast<long long>(R) * (N / V);
  const long long blocks = (vecs + kGeluThreads - 1) / kGeluThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bias_gelu_kernel<T><<<static_cast<unsigned>(blocks), kGeluThreads, 0,
                        stream>>>(static_cast<T*>(h),
                                  static_cast<const T*>(bias), N, vecs,
                                  erf_form);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (R, C) the residual stream; y (R, C) a GEMM's output or null, written
// with the new residual; bias (C,) or null (only with y); g, b (C,); out
// (R, C) LN of the residual. All T (dtype: float32 or bfloat16), on the
// device, contiguous and 16-byte aligned.
extern "C" int add_layer_norm(const void* x, void* y, const void* bias,
                              const void* g, const void* b, void* out, int R,
                              int C, float eps, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_norm<float>(x, y, bias, g, b, out, R, C, eps, s);
  }
  if (dtype == kBFloat16) {
    return launch_norm<__nv_bfloat16>(x, y, bias, g, b, out, R, C, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// h (R, N) in T, overwritten with gelu(h + bias); bias (N,) in T or null;
// erf_form 0 the tanh form, 1 the erf form. On the device, contiguous and
// 16-byte aligned.
extern "C" int bias_gelu(void* h, const void* bias, int R, int N,
                         int erf_form, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_gelu<float>(h, bias, R, N, erf_form, s);
  if (dtype == kBFloat16) {
    return launch_gelu<__nv_bfloat16>(h, bias, R, N, erf_form, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

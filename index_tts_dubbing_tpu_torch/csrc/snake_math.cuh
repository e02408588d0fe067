// What the anti-aliased SnakeBeta kernels K1 (snake_cmajor.cu) and B3
// (snake_clast.cu) share: sin^2, and vector loads and stores of float32 or
// bfloat16 runs as float32.
//
// sin^2 has period pi, so y is reduced to r = y - k*pi, k = rint(y/pi), with
// pi split into two float32 constants (PI_HI = fp32(pi), PI_LO = fp32(pi -
// PI_HI)) and FMAs; then sin(r) on [-pi/2, pi/2] is the Taylor polynomial of
// degree 11 in Horner form, and the result is squared. For |y| <= 2^15 the
// first FMA is exact (y - k*PI_HI is a multiple of 2^-22 below 2 in
// magnitude) and the result is within 5e-7 of sin^2 in float64
// (tests/test_torch_snake.py holds a float32 mirror of these exact steps);
// the accurate sinf, squared, is within 1.3e-7. Above the limit the kernel
// calls sinf itself, so no input loses accuracy. NaN propagates; +-inf
// gives NaN, as sinf.
//
// The accurate sinf (a Cody-Waite reduction, its polynomial, a range test
// and the Payne-Hanek path) becomes about 15 instructions here; the sines
// were the most of an output's issue slots in both kernels.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace snake_math {

constexpr float kSin2Limit = 32768.0f;          // 2^15
constexpr float kInvPi = 0.318309886183790672f;
constexpr float kPiHi = 3.14159274101257324f;   // fp32(pi)
constexpr float kPiLo = -8.74227766e-08f;       // fp32(pi - kPiHi)
constexpr float kS3 = -1.0f / 6.0f;             // (-1)^n / (2n+1)!
constexpr float kS5 = 1.0f / 120.0f;
constexpr float kS7 = -1.0f / 5040.0f;
constexpr float kS9 = 1.0f / 362880.0f;
constexpr float kS11 = -1.0f / 39916800.0f;

// sin^2(y) for |y| <= kSin2Limit. Callers take it for every value, then
// redo with sin2_accurate, in one branch for a whole group of values, any
// value past the limit: a branch per value would split the unrolled
// arithmetic into regions the compiler does not interleave.
__device__ __forceinline__ float sin2(float y) {
  const float k = rintf(y * kInvPi);
  float r = fmaf(-k, kPiHi, y);
  r = fmaf(-k, kPiLo, r);
  const float r2 = r * r;
  float p = fmaf(kS11, r2, kS9);
  p = fmaf(p, r2, kS7);
  p = fmaf(p, r2, kS5);
  p = fmaf(p, r2, kS3);
  const float s = fmaf(r * r2, p, r);
  return s * s;
}

__device__ __forceinline__ bool past_limit(float y) {
  return fabsf(y) > kSin2Limit;
}

// sin^2(y) through the accurate sinf (any y): out of line, so the cold
// accurate path the callers keep beside their fast one stays small.
static __device__ __noinline__ float sin2_accurate(float y) {
  const float s = sinf(y);
  return s * s;
}

// The 12 kaiser-sinc taps f as the kernels apply them: up-phase taps (gain
// 2) and decimation taps. Passed by value, so they live in the constant
// bank and cost no registers or loads.
struct Taps {
  float up_e[6], up_o[6], dn_e[6], dn_o[6];
};

inline Taps make_taps(const float* f) {   // f: 12 floats in host memory
  Taps t;
  for (int q = 0; q < 6; ++q) {
    t.up_e[q] = 2.0f * f[11 - 2 * q];
    t.up_o[q] = 2.0f * f[10 - 2 * q];
    t.dn_o[q] = f[2 * q];
    t.dn_e[q] = f[2 * q + 1];
  }
  return t;
}

// SnakeBeta's parameters as the caller holds them: alpha and beta (beta null
// means alpha) of C elements in float32 or bfloat16 (dtype), and whether
// they are log-scale. Passed by value (constant bank).
struct SnakeParams {
  const void* alpha;
  const void* beta;
  int dtype;
  int logscale;
};

__device__ __forceinline__ float param_at(const void* p, int dtype, int c) {
  return dtype == kBFloat16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
             : static_cast<const float*>(p)[c];
}

// Channel c's (a, binv) as ops/snake_cmajor.fold_params makes them: exp in
// the parameters' own dtype when log-scale, binv = 1 / (b + 1e-9) in float32.
// Folded here rather than by separate PyTorch ops, which cost a launch each.
__device__ __forceinline__ void fold(const SnakeParams& sp, int c, float& av,
                                     float& bv) {
  float al = param_at(sp.alpha, sp.dtype, c);
  float be = sp.beta ? param_at(sp.beta, sp.dtype, c) : al;
  if (sp.logscale) {
    al = expf(al);
    be = expf(be);
    if (sp.dtype == kBFloat16) {
      al = round_to<__nv_bfloat16>(al);
      be = round_to<__nv_bfloat16>(be);
    }
  }
  av = al;
  bv = 1.0f / (be + 1e-9f);
}

// One up-phase pair from the 6 inputs w[0..5] (oldest first), the snake
// applied: pe = e + bv sin^2(av e) with e = sum_d up_e[d] w[d], po likewise
// with up_o. The fast form (kAccurate false) takes sin2 and sets `big` if an
// argument was past the limit; the caller then redoes its group with
// kAccurate true (sin2_accurate throughout), so the fast path has no branch.
template <bool kAccurate>
__device__ __forceinline__ void snake_pair(const float* w, const Taps& tp,
                                           float av, float bv, float& pe,
                                           float& po, bool& big) {
  float e = 0.0f, o = 0.0f;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    e = e + tp.up_e[d] * w[d];
    o = o + tp.up_o[d] * w[d];
  }
  const float ye = e * av;
  const float yo = o * av;
  if constexpr (kAccurate) {
    pe = e + bv * sin2_accurate(ye);
    po = o + bv * sin2_accurate(yo);
  } else {
    pe = e + bv * sin2(ye);
    po = o + bv * sin2(yo);
    big |= past_limit(ye) | past_limit(yo);
  }
}

// One decimated output from its 6 pairs pe/po[0..5], oldest first (output
// t reads the pairs t-2 .. t+3): sum_q f[2q] po[q] + f[2q+1] pe[q].
__device__ __forceinline__ float decimate(const float* pe, const float* po,
                                          const Taps& tp) {
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    acc = acc + tp.dn_o[q] * po[q];
    acc = acc + tp.dn_e[q] * pe[q];
  }
  return acc;
}

// N consecutive elements at p as float32: one load per 16 bytes (float32:
// N % 4 == 0, p 16-byte aligned; bfloat16: N % 8 == 0, p 16-byte aligned,
// or N == 4, p 8-byte aligned), or one plain load for N == 1.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (N == 1) {
    v[0] = __ldg(p);
  } else {
    static_assert(N % 4 == 0, "N");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (N == 1) {
    v[0] = __bfloat162float(p[0]);
  } else if constexpr (N == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    static_assert(N % 8 == 0, "N");
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + j);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[8 * j + 2 * i] = f.x;
        v[8 * j + 2 * i + 1] = f.y;
      }
    }
  }
}

// v[0..N) stored at p in p's type (bfloat16 rounds to nearest even, as
// from_f32); the alignment rules of load_vec.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 1) {
    p[0] = from_f32<__nv_bfloat16>(v[0]);
  } else if constexpr (N == 4) {
    uint2 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
    static_assert(N % 8 == 0, "N");
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint4 q;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = __floats2bfloat162_rn(v[8 * j + 2 * i], v[8 * j + 2 * i + 1]);
      }
      reinterpret_cast<uint4*>(p)[j] = q;
    }
  }
}

}  // namespace snake_math

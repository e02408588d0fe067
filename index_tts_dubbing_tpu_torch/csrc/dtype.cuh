// Element-type helpers shared by the port's kernels: every kernel reads and
// writes float32 or bfloat16 and computes in float32.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Round a float32 value to T's precision and back.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

enum DtypeCode { kFloat32 = 0, kBFloat16 = 1 };

// Kernel K1: fused anti-aliased SnakeBeta on C-major (B, C, T).
//
// Replaces the Pallas TPU kernel fused_anti_alias_snake_cmajor
// (index_tts_dubbing_tpu/ops/pallas_snake.py:168, _kernel_cmajor).
// Per (row b*C+c, time): replicate-pad x → x2 polyphase upsample through the
// 12-tap kaiser-sinc FIR (gain 2) → SnakeBeta v + sin^2(a v) * binv in float32
// → 12-tap FIR x2 decimation → store in the input dtype.
//
// Bound on the H100: device memory. Each output needs ~60 float32 operations
// (two 6-tap phases, two sines, a 12-tap decimation) against 2x its element
// size of traffic, far below the card's ~20 float32 operations per byte, so
// the least time is (bytes in + bytes out) / 3.35 TB/s.
// Design: one block per (row, tile of 256 outputs). The block reads its input
// span [t0-6, t0+256+6) once into shared memory as float32 (the index clamped
// to [0, T-1] is the replicate pad), forms the 262 even and odd up-phase
// samples with the snake applied in shared memory, then each thread writes
// one decimated output. Reads and writes are contiguous along time, so every
// warp access is coalesced; the halo re-read is 12/256 of the traffic.
#include "dtype.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kPad = 6;

template <typename T>
__global__ void __launch_bounds__(kTile)
snake_cmajor_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const float* __restrict__ a, const float* __restrict__ binv,
                    const float* __restrict__ filt, int C, int T_len) {
  __shared__ float xs[kTile + 2 * kPad];
  __shared__ float ue[kTile + 6];
  __shared__ float uo[kTile + 6];
  const int row = blockIdx.x;
  const int c = row % C;
  const int t0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(row) * T_len;

  for (int i = threadIdx.x; i < kTile + 2 * kPad; i += blockDim.x) {
    int g = min(max(t0 - kPad + i, 0), T_len - 1);
    xs[i] = to_f32<T>(x[base + g]);
  }
  float up_e[6], up_o[6], down[12];
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    up_e[d] = 2.0f * filt[11 - 2 * d];
    up_o[d] = 2.0f * filt[10 - 2 * d];
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) down[j] = filt[j];
  const float av = a[c];
  const float bv = binv[c];
  __syncthreads();

  // up-phase sample ui <-> u = ui - 3 (relative to t0):
  //   ue[u] = sum_d 2 f[11-2d] x[u-3+d],  uo[u] = sum_d 2 f[10-2d] x[u-2+d]
  for (int ui = threadIdx.x; ui < kTile + 6; ui += blockDim.x) {
    float e = 0.0f, o = 0.0f;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      e = e + up_e[d] * xs[ui + d];
      o = o + up_o[d] * xs[ui + 1 + d];
    }
    float s = sinf(e * av);
    ue[ui] = e + bv * s * s;
    s = sinf(o * av);
    uo[ui] = o + bv * s * s;
  }
  __syncthreads();

  // y[t] = sum_j f[j] * up[2t - 5 + j]: even offsets from ue, odd from uo
  const int t = threadIdx.x;
  if (t0 + t < T_len) {
    float y = 0.0f;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int m = j - 5;
      const float v = (m % 2 == 0) ? ue[t + 3 + m / 2] : uo[t + 3 + (m - 1) / 2];
      y = y + down[j] * v;
    }
    out[base + t0 + t] = from_f32<T>(y);
  }
}

template <typename T>
void launch(const void* x, void* out, const float* a, const float* binv,
            const float* filt, int rows, int C, int T_len, cudaStream_t s) {
  dim3 grid(rows, (T_len + kTile - 1) / kTile);
  snake_cmajor_kernel<T><<<grid, kTile, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), a, binv, filt, C, T_len);
}

}  // namespace

extern "C" int snake_cmajor(const void* x, void* out, const void* a,
                            const void* binv, const void* filt, int rows,
                            int C, int T_len, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto af = static_cast<const float*>(a);
  auto bf = static_cast<const float*>(binv);
  auto ff = static_cast<const float*>(filt);
  if (dtype == kFloat32) {
    launch<float>(x, out, af, bf, ff, rows, C, T_len, s);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16>(x, out, af, bf, ff, rows, C, T_len, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

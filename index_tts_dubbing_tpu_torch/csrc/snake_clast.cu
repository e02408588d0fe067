// Kernel B3: fused anti-aliased SnakeBeta on channels-last (B, T, C).
//
// Replaces the Pallas TPU kernel fused_anti_alias_snake
// (index_tts_dubbing_tpu/ops/pallas_snake.py:221, _kernel). It computes what
// K1 (snake_cmajor.cu) computes, along time for every (b, c): replicate-pad x
// -> x2 polyphase upsample through the 12-tap kaiser-sinc FIR (gain 2) ->
// SnakeBeta v + sin^2(a v) * binv in float32 -> 12-tap FIR x2 decimation ->
// store in the input dtype.
//
// Bound on the H100: device memory. ~58 float32 operations per output
// against 2x its element size of traffic is far below the card's ~20 float32
// operations per byte, so the least time is (bytes in + bytes out) / 3.35 TB/s.
// Design: C is the contiguous axis, so the kernel never transposes. One block
// per (batch, tile of kTt times, tile of ct channels) stages the input span
// [t0-6, t0+kTt+6) x ct in shared memory as float32 (the time index clamped
// to [0, T-1] is the replicate pad), forms the even and odd up-phase samples
// with the snake applied in shared memory, then decimates from shared
// memory. Every loop walks the tile's flat (time, channel) index with the
// channel fastest, so consecutive threads touch consecutive channels: reads
// and writes coalesce along C, and at C = 24 or 48 (ct = C) a warp spans
// several time rows of one contiguous span instead of idling lanes. Ragged
// time and channel tiles are masked; offsets are 64-bit.
#include "dtype.cuh"

namespace {

constexpr int kTt = 64;       // output times per block
constexpr int kPad = 6;       // input frames each output depends on, each side
constexpr int kMaxCt = 48;    // widest channel tile (shared memory < 48 KB)
constexpr int kThreads = 256;

// channel tile: the whole C when it fits (one contiguous span per block),
// else 32 channels (128 bytes in float32) per time row
inline int channel_tile(int C) { return C <= kMaxCt ? C : 32; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_clast_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const float* __restrict__ a, const float* __restrict__ binv,
                   const float* __restrict__ filt, int T_len, int C, int ct) {
  __shared__ float xs[(kTt + 2 * kPad) * kMaxCt];
  __shared__ float ue[(kTt + 6) * kMaxCt];
  __shared__ float uo[(kTt + 6) * kMaxCt];
  const int t0 = blockIdx.x * kTt;
  const int c0 = blockIdx.y * ct;
  const size_t batch = static_cast<size_t>(blockIdx.z) * T_len;

  for (int i = threadIdx.x; i < (kTt + 2 * kPad) * ct; i += blockDim.x) {
    const int r = i / ct;
    const int c = c0 + i - r * ct;
    const int g = min(max(t0 - kPad + r, 0), T_len - 1);
    xs[i] = c < C ? to_f32<T>(x[(batch + g) * C + c]) : 0.0f;
  }
  float up_e[6], up_o[6], down[12];
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    up_e[d] = 2.0f * filt[11 - 2 * d];
    up_o[d] = 2.0f * filt[10 - 2 * d];
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) down[j] = filt[j];
  __syncthreads();

  // up-phase row r <-> u = r - 3 (relative to t0):
  //   ue[u] = sum_d 2 f[11-2d] x[u-3+d],  uo[u] = sum_d 2 f[10-2d] x[u-2+d]
  for (int i = threadIdx.x; i < (kTt + 6) * ct; i += blockDim.x) {
    const int r = i / ct;
    const int cc = i - r * ct;
    const int c = min(c0 + cc, C - 1);
    float e = 0.0f, o = 0.0f;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      e = e + up_e[d] * xs[(r + d) * ct + cc];
      o = o + up_o[d] * xs[(r + 1 + d) * ct + cc];
    }
    const float av = a[c];
    const float bv = binv[c];
    float s = sinf(e * av);
    ue[i] = e + bv * s * s;
    s = sinf(o * av);
    uo[i] = o + bv * s * s;
  }
  __syncthreads();

  // y[t] = sum_j f[j] * up[2t - 5 + j]: even offsets from ue, odd from uo
  for (int i = threadIdx.x; i < kTt * ct; i += blockDim.x) {
    const int r = i / ct;
    const int cc = i - r * ct;
    const int t = t0 + r;
    const int c = c0 + cc;
    if (t >= T_len || c >= C) continue;
    float y = 0.0f;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int m = j - 5;
      const float v = (m % 2 == 0) ? ue[(r + 3 + m / 2) * ct + cc]
                                   : uo[(r + 3 + (m - 1) / 2) * ct + cc];
      y = y + down[j] * v;
    }
    out[(batch + t) * C + c] = from_f32<T>(y);
  }
}

template <typename T>
void launch(const void* x, void* out, const float* a, const float* binv,
            const float* filt, int B, int T_len, int C, cudaStream_t s) {
  const int ct = channel_tile(C);
  dim3 grid((T_len + kTt - 1) / kTt, (C + ct - 1) / ct, B);
  snake_clast_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), a, binv, filt, T_len, C,
      ct);
}

}  // namespace

extern "C" int snake_clast(const void* x, void* out, const void* a,
                           const void* binv, const void* filt, int B,
                           int T_len, int C, int dtype, void* stream) {
  if (B == 0 || T_len == 0 || C == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  auto af = static_cast<const float*>(a);
  auto bf = static_cast<const float*>(binv);
  auto ff = static_cast<const float*>(filt);
  if (dtype == kFloat32) {
    launch<float>(x, out, af, bf, ff, B, T_len, C, s);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16>(x, out, af, bf, ff, B, T_len, C, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel K2: one whole AMP resblock on C-major (B, C, T), C <= 128.
//
// Replaces the Pallas TPU kernel fused_resblock_cmajor
// (index_tts_dubbing_tpu/ops/pallas_resblock.py:175, _kernel). For each of
// the 3 (dilation d) pairs: anti-aliased snake -> conv k (dilation d) ->
// anti-aliased snake -> conv k -> residual add. Activations in float32; each
// conv rounds its input to the caller's dtype and accumulates in float32.
//
// Bound on the H100: operations. Six convs of 2*C*C*k FLOPs per output column
// (C = 96/48/24 at k = 3/7/11) against 2x the element size of traffic per
// column put the block far above the card's float32 operations-per-byte
// ratio; the convs are CUDA-core FMAs here (no wgmma yet).
// Design: one block of 256 threads per (batch row, tile of tt outputs). The
// block loads x[t0-span, t0+tt+span) once (index clamped to [0, T-1] = the
// replicate pad) into shared buffer Y as float32, and keeps the whole chain
// on chip in two float32 buffers Y and A of C x (tt + 2*span) plus a
// per-warp up-phase scratch: with span <= 96 and tt = 64 at C = 96 this is
// 212,992 bytes, within the 227 KB a block may use. Every op shrinks the
// valid width as the Pallas kernel's (_act_shrink -12, conv -d(k-1)):
//   - an activation runs one warp per channel row: up-phases with the snake
//     go to the warp's scratch, then the decimated row is written (in place
//     when source and destination are the same row), rounded to the caller's
//     dtype because a conv consumes it;
//   - a conv runs in place in A over column chunks of 128: each warp owns a
//     contiguous range of ceil(C/8) output channels and each lane 4 columns,
//     all held in registers; the block syncs, then writes the chunk
//     left-aligned (a chunk's outputs only overwrite inputs that later
//     chunks no longer read);
//   - the residual adds A into Y in place at the pair's offset.
// Conv weights are read from global memory (L2 resident: <= 406 KB per
// conv); a warp's loads for one (tap, input channel) are one contiguous run
// of its output channels, and each loaded weight feeds 4 columns.
#include "dtype.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkCols = 128;              // 32 lanes x 4 columns
constexpr int kMaxCoPerThread = 16;          // C <= 128 over 8 warps
constexpr int kSmemLimit = 232448;           // dynamic shared memory per block

__host__ __device__ inline int pair_shrink(int k, int d) {
  return 12 + (d + 1) * (k - 1) / 2;
}

__host__ __device__ inline int chain_span(int k, int d0, int d1, int d2) {
  return pair_shrink(k, d0) + pair_shrink(k, d1) + pair_shrink(k, d2);
}

__host__ inline size_t smem_bytes(int C, int W) {
  return sizeof(float) * static_cast<size_t>(W) * (2 * C + 2 * kWarps);
}

struct Filters {
  float up_e[6], up_o[6], down[12];
};

// Anti-aliased snake over every channel row: src rows of width n (row stride
// W) -> dst rows of width n - 12. Output column t' is input column t' + 6.
template <typename T>
__device__ __forceinline__ void act_rows(const float* src, float* dst, int n, int C, int W,
                         const float* a, const float* binv, const Filters& f,
                         float* scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ue = scratch + warp * 2 * W;
  float* uo = ue + W;
  const int m = n - 6;
  const int nout = n - 12;
  for (int c = warp; c < C; c += kWarps) {
    const float* s_row = src + c * W;
    const float av = a[c];
    const float bv = binv[c];
    for (int i = lane; i < m; i += 32) {
      float e = 0.0f, o = 0.0f;
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const float v = s_row[i + d];
        e = e + f.up_e[d] * v;
        o = o + f.up_o[d] * v;
      }
      float s = sinf(e * av);
      ue[i] = e + bv * s * s;
      s = sinf(o * av);
      uo[i] = o + bv * s * s;
    }
    __syncwarp();
    float* d_row = dst + c * W;
    for (int t = lane; t < nout; t += 32) {
      float y = 0.0f;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int mm = j - 5;
        const float v = (mm % 2 == 0) ? ue[t + 3 + mm / 2] : uo[t + 4 + (mm - 1) / 2];
        y = y + f.down[j] * v;
      }
      d_row[t] = round_to<T>(y);   // a conv consumes it in the caller dtype
    }
    __syncwarp();
  }
  __syncthreads();
}

// Valid conv in place over A: rows of width n -> n - d(k-1), left-aligned.
// w: (k * cpad, C) rows kk*cpad + ci, columns co; bias b: (C).
template <typename T>
__device__ __forceinline__ void conv_in_place(float* buf, int n, int C, int W,
                              const T* __restrict__ w,
                              const float* __restrict__ b, int k, int d,
                              int cpad) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nout = n - d * (k - 1);
  const int per_warp = (C + kWarps - 1) / kWarps;
  const int co0 = warp * per_warp;
  for (int c0 = 0; c0 < nout; c0 += kChunkCols) {
    float acc[4][kMaxCoPerThread];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kMaxCoPerThread; ++j) acc[r][j] = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      for (int ci = 0; ci < C; ++ci) {
        const float* row = buf + ci * W + kk * d;
        float xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = c0 + lane + 32 * r;
          xv[r] = col < nout ? row[col] : 0.0f;
        }
        const T* wr = w + static_cast<size_t>(kk * cpad + ci) * C;
#pragma unroll
        for (int j = 0; j < kMaxCoPerThread; ++j) {
          const int co = co0 + j;
          if (j < per_warp && co < C) {
            const float wv = to_f32<T>(wr[co]);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][j] = acc[r][j] + wv * xv[r];
          }
        }
      }
    }
    __syncthreads();   // every read of this chunk's input span is done
#pragma unroll
    for (int j = 0; j < kMaxCoPerThread; ++j) {
      const int co = co0 + j;
      if (j < per_warp && co < C) {
        const float bias = b[co];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = c0 + lane + 32 * r;
          if (col < nout) buf[co * W + col] = acc[r][j] + bias;
        }
      }
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resblock_kernel(const T* __restrict__ x, T* __restrict__ out,
                const T* __restrict__ w1, const float* __restrict__ b1,
                const T* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ acts, const float* __restrict__ filt,
                int C, int T_len, int k, int d0, int d1, int d2, int tt,
                int cpad) {
  extern __shared__ float smem[];
  const int span = chain_span(k, d0, d1, d2);
  const int W = tt + 2 * span;
  float* Y = smem;
  float* A = Y + C * W;
  float* scratch = A + C * W;
  const int bi = blockIdx.y;
  const int t0 = blockIdx.x * tt;

  Filters f;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    f.up_e[d] = 2.0f * filt[11 - 2 * d];
    f.up_o[d] = 2.0f * filt[10 - 2 * d];
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) f.down[j] = filt[j];

  const T* xb = x + static_cast<size_t>(bi) * C * T_len;
  for (int idx = threadIdx.x; idx < C * W; idx += kThreads) {
    const int c = idx / W;
    const int i = idx - c * W;
    const int g = min(max(t0 - span + i, 0), T_len - 1);
    Y[idx] = to_f32<T>(xb[static_cast<size_t>(c) * T_len + g]);
  }
  __syncthreads();

  const int dils[3] = {d0, d1, d2};
  const size_t wstride = static_cast<size_t>(k) * cpad * C;
  int off = 0;        // Y's valid columns are [off, off + width)
  int width = W;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int d = dils[p];
    const float* ap = acts + static_cast<size_t>(p) * 4 * C;
    int n = width;
    act_rows<T>(Y + off, A, n, C, W, ap, ap + C, f, scratch);
    n -= 12;
    conv_in_place<T>(A, n, C, W, w1 + p * wstride, b1 + p * C, k, d, cpad);
    n -= d * (k - 1);
    act_rows<T>(A, A, n, C, W, ap + 2 * C, ap + 3 * C, f, scratch);
    n -= 12;
    conv_in_place<T>(A, n, C, W, w2 + p * wstride, b2 + p * C, k, 1, cpad);
    n -= k - 1;
    const int s = pair_shrink(k, d);
    for (int idx = threadIdx.x; idx < C * n; idx += kThreads) {
      const int c = idx / n;
      const int i = idx - c * n;
      Y[c * W + off + s + i] += A[c * W + i];
    }
    __syncthreads();
    off += s;
    width -= 2 * s;
  }

  T* ob = out + static_cast<size_t>(bi) * C * T_len;
  for (int idx = threadIdx.x; idx < C * tt; idx += kThreads) {
    const int c = idx / tt;
    const int i = idx - c * tt;
    if (t0 + i < T_len) {
      ob[static_cast<size_t>(c) * T_len + t0 + i] = from_f32<T>(Y[c * W + off + i]);
    }
  }
}

template <typename T>
int launch(const void* x, void* out, const void* w1, const float* b1,
           const void* w2, const float* b2, const float* acts,
           const float* filt, int B, int C, int T_len, int k, int d0, int d1,
           int d2, int tt, int cpad, cudaStream_t s) {
  if (C > kWarps * kMaxCoPerThread || tt <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = tt + 2 * chain_span(k, d0, d1, d2);
  const size_t smem = smem_bytes(C, W);
  if (smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // opt in to the whole shared memory once per element type, so no runtime
  // API call sits between launches (a CUDA graph can capture the launch)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        resblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((T_len + tt - 1) / tt, B);
  resblock_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2, acts, filt,
      C, T_len, k, d0, d1, d2, tt, cpad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int resblock_cmajor(const void* x, void* out, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* acts, const void* filt, int B,
                               int C, int T_len, int k, int d0, int d1, int d2,
                               int tt, int cpad, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto b1f = static_cast<const float*>(b1);
  auto b2f = static_cast<const float*>(b2);
  auto af = static_cast<const float*>(acts);
  auto ff = static_cast<const float*>(filt);
  if (dtype == kFloat32) {
    return launch<float>(x, out, w1, b1f, w2, b2f, af, ff, B, C, T_len, k, d0,
                         d1, d2, tt, cpad, s);
  }
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(x, out, w1, b1f, w2, b2f, af, ff, B, C, T_len,
                                 k, d0, d1, d2, tt, cpad, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

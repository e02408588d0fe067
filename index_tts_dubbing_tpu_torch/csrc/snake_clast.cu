// Kernel B3: fused anti-aliased SnakeBeta on channels-last (B, T, C).
//
// Replaces the Pallas TPU kernel fused_anti_alias_snake
// (index_tts_dubbing_tpu/ops/pallas_snake.py:221, _kernel). It computes what
// K1 (snake_cmajor.cu) computes, along time for every (b, c): replicate-pad x
// -> x2 polyphase upsample through the 12-tap kaiser-sinc FIR (gain 2) ->
// SnakeBeta v + sin^2(a v) * binv in float32 -> 12-tap FIR x2 decimation ->
// store in the input dtype. The pairs and taps are K1's (see its note):
// output t reads the pairs u = t-2 .. t+3, and pair u the inputs u-3 .. u+2,
// the time index clamped to [0, T-1] (the replicate pad).
//
// Bound on the H100: device memory, as K1, if the instructions per output
// stay near 60 (K1's count; the range-reduced sin^2 of snake_math.cuh).
// Design: C is the contiguous axis, so time-adjacent taps cannot come from
// neighbouring lanes of a coalesced load; one thread keeps them instead. A
// thread owns kVec channels (16 bytes of float32, 8 of bfloat16) and a run
// of `run` consecutive output times, and walks along time with the last 6
// inputs and the last 6 pairs in register rings: each step is one vector
// load, one pair per channel (with the snake), one decimated output per
// channel and one vector store. Neighbouring lanes own neighbouring channel
// vectors, so a warp's loads and stores are 16 bytes a lane along C. A run
// starts by loading 10 inputs and forming 5 pairs (its halo: 5 extra pairs
// per run); the ring's slots repeat every 6 steps, so the walk is unrolled
// by 6 and every index is a constant (the last group's extra steps only
// compute, and read clamped inputs). The next group's inputs are loaded a
// group ahead. No shared memory; a thread's (batch, run, channel vector) is
// found once, with no division per element. The wrapper's plan
// (ops/snake_clast.py run_plan) fits the grid to whole waves of the threads
// the card holds (snake_clast_resident); C % kVec != 0, or a pointer off
// the vector size, runs one channel per thread (vec 1). A sine argument
// past sin2's limit makes the thread walk its run again with the accurate
// sinf (one branch per run). The taps and SnakeBeta's raw parameters come
// by value (constant bank); a thread folds its channels' (a, binv) itself,
// so no PyTorch op runs beside the kernel.
#include <cstdint>

#include "dtype.cuh"
#include "snake_math.cuh"

namespace {

using snake_math::SnakeParams;
using snake_math::Taps;

constexpr int kVec = 4;       // channels per thread (VEC in ops/snake_clast.py)
constexpr int kThreads = 128;
constexpr int kMinBlocks = 3; // per SM: at most 170 registers a thread

// One run's walk: outputs t0 .. t0+n-1 of kVec (or 1) channels at xb/ob.
// Ring slots: input p (time t0 - 5 + p) in X[p % 6]; pair q (u = t0 - 2 +
// q, inputs p = q .. q+5) in PE/PO[q % 6]; output s (time t0 + s) reads
// the pairs q = s .. s+5. N holds the next 6 inputs, loaded a group ahead
// (and before the stores that precede their use), so the loads of a walk
// never wait on its own arithmetic. The fast form (kAccurate false) returns
// true if a sine argument was past sin2's limit; the kernel then walks the
// run again with the accurate sinf, rewriting its outputs.
template <bool kAccurate, typename T, int V>
__device__ __forceinline__ bool walk(const T* xb, T* ob, int T_len, int C,
                                     int t0, int n, const Taps& tp,
                                     const float* av, const float* bv) {
  bool big = false;
  float X[6][V], N[6][V], PE[6][V], PO[6][V];
  auto load = [&](int t, float (&dst)[V]) {
    const int tc = min(max(t, 0), T_len - 1);
    snake_math::load_vec<V>(xb + static_cast<size_t>(tc) * C, dst);
  };
  auto pair = [&](int first, float (&pe)[V], float (&po)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float w[6];
#pragma unroll
      for (int d = 0; d < 6; ++d) w[d] = X[(first + d) % 6][i];
      snake_math::snake_pair<kAccurate>(w, tp, av[i], bv[i], pe[i], po[i],
                                        big);
    }
  };

#pragma unroll
  for (int p = 0; p < 6; ++p) load(t0 - 5 + p, X[p]);
#pragma unroll
  for (int k = 0; k < 6; ++k) load(t0 + 5 + k, N[k]);
  pair(0, PE[0], PO[0]);
#pragma unroll
  for (int q = 1; q < 5; ++q) {
    load(t0 + q, X[(q + 5) % 6]);
    pair(q, PE[q], PO[q]);
  }
  for (int s = 0; s < n; s += 6) {
    const bool more = s + 6 < n;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int i = 0; i < V; ++i) X[(k + 4) % 6][i] = N[k][i];
      if (more) load(t0 + s + k + 11, N[k]);
      pair(k + 5, PE[(k + 5) % 6], PO[(k + 5) % 6]);
      if (s + k < n) {
        float y[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float pe[6], po[6];
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            pe[q] = PE[(k + q) % 6][i];
            po[q] = PO[(k + q) % 6][i];
          }
          y[i] = snake_math::decimate(pe, po, tp);
        }
        snake_math::store_vec<V>(ob + static_cast<size_t>(t0 + s + k) * C, y);
      }
    }
  }
  return big;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
snake_clast_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const SnakeParams sp, const Taps taps, int T_len, int C,
                   int run, int runs, int threads) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= threads) return;
  const int nv = C / V;
  const int cv = g % nv;
  const int rest = g / nv;
  const int b = rest / runs;
  const int t0 = (rest - b * runs) * run;
  const int n = min(run, T_len - t0);
  const size_t off = static_cast<size_t>(b) * T_len * C + cv * V;

  float av[V], bv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) snake_math::fold(sp, cv * V + i, av[i], bv[i]);
  if (walk<false, T, V>(x + off, out + off, T_len, C, t0, n, taps, av, bv)) {
    walk<true, T, V>(x + off, out + off, T_len, C, t0, n, taps, av, bv);
  }
}

template <typename T>
int launch(const void* x, void* out, const SnakeParams& sp,
           const Taps& taps, int B, int T_len, int C, int vec, int run,
           int runs, int threads, cudaStream_t s) {
  const size_t align = (vec == kVec ? kVec : 1) * sizeof(T);
  const bool ok =
      (vec == 1 || vec == kVec) && C % vec == 0 && run > 0 &&
      static_cast<long long>(run) * runs >= T_len &&
      static_cast<long long>(B) * runs * (C / vec) == threads &&
      reinterpret_cast<uintptr_t>(x) % align == 0 &&
      reinterpret_cast<uintptr_t>(out) % align == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (threads + kThreads - 1) / kThreads;
  if (vec == kVec) {
    snake_clast_kernel<T, kVec><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), sp, taps, T_len, C,
        run, runs, threads);
  } else {
    snake_clast_kernel<T, 1><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), sp, taps, T_len, C,
        run, runs, threads);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resident(int vec, int* threads_per_sm) {
  int blocks = 0;
  const cudaError_t err =
      vec == kVec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, snake_clast_kernel<T, kVec>, kThreads, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, snake_clast_kernel<T, 1>, kThreads, 0);
  *threads_per_sm = blocks * kThreads;
  return static_cast<int>(err);
}

}  // namespace

// Threads of the kernel (dtype, vec) that one SM holds at once: the launch
// plan fills the card with whole waves of them.
extern "C" int snake_clast_resident(int dtype, int vec, void* threads_per_sm) {
  auto out = static_cast<int*>(threads_per_sm);
  if (vec != 1 && vec != kVec) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) return resident<float>(vec, out);
  if (dtype == kBFloat16) return resident<__nv_bfloat16>(vec, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// alpha, beta (null: alpha) of C elements in param_dtype, and logscale, as
// the caller holds them; taps: the 12 filter taps in host memory. vec (kVec
// or 1), run, runs (per
// batch row) and threads (B * runs * C/vec) come from the wrapper's plan
// (ops/snake_clast.py run_plan).
extern "C" int snake_clast(const void* x, void* out, const void* alpha,
                           const void* beta, int param_dtype, int logscale,
                           const void* taps, int B,
                           int T_len, int C, int vec, int run, int runs,
                           int threads, int dtype, void* stream) {
  if (B == 0 || T_len == 0 || C == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  if (param_dtype != kFloat32 && param_dtype != kBFloat16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SnakeParams sp{alpha, beta, param_dtype, logscale};
  const Taps tp = snake_math::make_taps(static_cast<const float*>(taps));
  if (dtype == kFloat32) {
    return launch<float>(x, out, sp, tp, B, T_len, C, vec, run, runs,
                         threads, s);
  }
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(x, out, sp, tp, B, T_len, C, vec, run,
                                 runs, threads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

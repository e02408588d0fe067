// Kernel K1: fused anti-aliased SnakeBeta on C-major (B, C, T).
//
// Replaces the Pallas TPU kernel fused_anti_alias_snake_cmajor
// (index_tts_dubbing_tpu/ops/pallas_snake.py:168, _kernel_cmajor).
// Per (row b*C+c, time): replicate-pad x → x2 polyphase upsample through the
// 12-tap kaiser-sinc FIR (gain 2) → SnakeBeta v + sin^2(a v) * binv in float32
// → 12-tap FIR x2 decimation → store in the input dtype.
//
// With xc the input with its index clamped to [0, T-1] (the replicate pad),
// f the 12 taps, and for every up-phase position u the pair
//   ue[u] = sum_d 2 f[11-2d] xc[u-3+d],  uo[u] = sum_d 2 f[10-2d] xc[u-3+d]
// (snake applied to each), output t is
//   y[t] = sum_q f[2q] uo[t-2+q] + f[2q+1] ue[t-2+q],  q = 0..5,
// so it reads the inputs t-5 .. t+5 and the pairs t-2 .. t+3.
//
// Bound on the H100: device memory at 8 bytes per float32 output, if the
// instructions per output stay under the ~70 that 30 T thread-instructions
// per second allow there. The arithmetic is ~51 per output (12 FMAs per
// pair, two sin^2 of ~11 with the range-reduced sin^2 of snake_math.cuh,
// where the accurate sinf took ~30, and 12 FMAs of decimation), so the
// design spends as little as it can on everything else.
// Design: outputs in registers along time, no shared memory. Each row's
// outputs are cut into runs of kRun; a row has ceil(T/kRun) such lanes and
// one helper lane past its end, which computes the pairs the row's last run
// needs from its clamped inputs and stores nothing. The rows' lanes are
// numbered one after another (virtual lanes, lanes_per_row each) and cut
// into passes of 32: pass p is virtual lanes 31p .. 31p+31, of which lanes
// 0-30 store and lane 31 only lends its pairs to lane 30 (it is lane 0 of
// pass p+1). So a pass is not tied to a row, and T = 576 leaves few lanes
// idle. In a pass a lane loads its kRun inputs with 16-byte loads, takes the
// 5 inputs before them from the lane below by shuffle (lane 0: below; a
// lane at a row start replicates x[0]), forms its kRun pairs with the snake,
// takes the lane above's first 5 pairs by shuffle, decimates and stores with
// 16-byte stores. The grid is one wave of the warps the card holds
// (snake_cmajor_resident); each walks `chunk` consecutive passes, so its
// set-up is paid once, its loads run a pass ahead of its arithmetic, and
// lane 0's 5 inputs before its run come by shuffle from lane 30 of the pass
// before (only a chunk's first pass reads them). The taps and SnakeBeta's
// raw parameters come by value (constant bank); each pass folds a lane's
// (a, binv) itself, so no PyTorch op runs beside the kernel (on the H100
// the four small ops that folded them took about as long as the kernel at
// the shapes that run 18 times a window batch). One division per warp finds
// a lane's row; a pass moves it on by additions. T % kRun != 0, or a pointer off 16 bytes, takes the scalar load
// and store path (kVec false). A value past sin2's limit makes the lane
// redo its pairs with the accurate sinf (one branch per pass).
// Exact-edge mode (kExact, one flag a launch): a lane whose pairs reach a
// row's end (the row's first lane, and the last lane that stores) replaces
// the pairs past it as the exact route pads its x2 signal
// (exact_edge.cuh), after every shuffle, so a lane's neighbours see its
// pairs unchanged; the other lanes run as in the default mode.
#include <climits>
#include <cstdint>

#include "dtype.cuh"
#include "exact_edge.cuh"
#include "snake_math.cuh"

namespace {

using snake_math::SnakeParams;
using snake_math::Taps;

constexpr int kRun = 8;        // outputs per lane (RUN in ops/snake_cmajor.py)
constexpr int kHalo = 5;       // inputs before a run, and pairs after it
constexpr int kStride = 31;    // storing lanes per pass
// blocks of 128: the compiler then keeps ~87 registers (~100 at 256), and
// five blocks fit an SM
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// a lane's halo comes from one neighbour, and a warp reads whole 16 bytes
static_assert(kRun >= kHalo && kRun % 8 == 0, "kRun");

// A lane's place: its row, c = row % C, and the index j of its run in the
// row. A pass moves it kStride lanes on, without a division.
struct Place {
  int row, c, j;
};

__device__ __forceinline__ void advance(Place& q, int lanes_per_row, int C) {
  q.j += kStride;
  while (q.j >= lanes_per_row) {   // more than once only for rows of < 31 lanes
    q.j -= lanes_per_row;
    ++q.row;
    if (++q.c == C) q.c = 0;
  }
}

// What a lane reads for one pass, loaded a pass ahead.
struct Pass {
  int row, tb;                 // row (clamped for lanes past the last) and
  bool live;                   // first output time; false past the last row
  float av, bv;
  float own[kRun];             // xc[tb .. tb + kRun)
};

template <typename T, bool kVec>
__device__ __forceinline__ Pass load_pass(const T* __restrict__ x,
                                          const SnakeParams& sp,
                                          const Place& q, int rows,
                                          int T_len) {
  Pass s;
  s.tb = q.j * kRun;
  s.live = q.row < rows;
  s.row = s.live ? q.row : rows - 1;
  snake_math::fold(sp, q.c, s.av, s.bv);
  const T* xr = x + static_cast<size_t>(s.row) * T_len;
  if (kVec && s.tb + kRun <= T_len) {
    snake_math::load_vec<kRun>(xr + s.tb, s.own);
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      s.own[i] = to_f32<T>(xr[min(s.tb + i, T_len - 1)]);
    }
  }
  return s;
}

// the lane's pairs pe/po[0 .. kRun) (u = tb - 2 + r) from its inputs; true
// if a value was past sin2's limit (the fast form)
template <bool kAccurate>
__device__ __forceinline__ bool make_pairs(const float (&xv)[kRun + kHalo],
                                           const Taps& tp, float av, float bv,
                                           float (&pe)[kRun + kHalo],
                                           float (&po)[kRun + kHalo]) {
  bool big = false;
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    snake_math::snake_pair<kAccurate>(xv + r, tp, av, bv, pe[r], po[r], big);
  }
  return big;
}

// One pass. below: lane 0's 5 inputs before its run; on return, the next
// pass's (lane 30's tail here). Every shuffle runs before any lane branches.
template <typename T, bool kVec, bool kExact>
__device__ __forceinline__ void run_pass(const Pass& s, float (&below)[kHalo],
                                         T* __restrict__ out, const Taps& tp,
                                         int lane, int T_len) {
  float xv[kRun + kHalo];      // xc[tb - kHalo + i]
#pragma unroll
  for (int i = 0; i < kRun; ++i) xv[kHalo + i] = s.own[i];
#pragma unroll
  for (int i = 0; i < kHalo; ++i) {
    float h = __shfl_up_sync(0xffffffffu, s.own[kRun - kHalo + i], 1);
    if (lane == 0) h = below[i];
    if (s.tb == 0) h = s.own[0];
    xv[i] = h;
    below[i] = __shfl_sync(0xffffffffu, s.own[kRun - kHalo + i], kStride - 1);
  }
  float pe[kRun + kHalo], po[kRun + kHalo];
  if (make_pairs<false>(xv, tp, s.av, s.bv, pe, po)) {
    make_pairs<true>(xv, tp, s.av, s.bv, pe, po);
  }
#pragma unroll
  for (int j = 0; j < kHalo; ++j) {   // the lane above's first pairs
    pe[kRun + j] = __shfl_down_sync(0xffffffffu, pe[j], 1);
    po[kRun + j] = __shfl_down_sync(0xffffffffu, po[j], 1);
  }
  if constexpr (kExact) {   // pe/po[r] is pair u = tb - 2 + r
    if (s.tb == 0 || s.tb + kRun + 2 >= T_len) {
      exact_edge::clamp_pairs(pe, po, s.tb - 2, T_len);
    }
  }
  if (s.live && lane != kStride && s.tb < T_len) {
    float y[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      y[r] = snake_math::decimate(pe + r, po + r, tp);
    }
    T* orow = out + static_cast<size_t>(s.row) * T_len;
    if (kVec && s.tb + kRun <= T_len) {
      snake_math::store_vec<kRun>(orow + s.tb, y);
    } else {
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (s.tb + r < T_len) orow[s.tb + r] = from_f32<T>(y[r]);
      }
    }
  }
}

template <typename T, bool kVec, bool kExact>
__global__ void __launch_bounds__(kThreads)
snake_cmajor_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const SnakeParams sp, const Taps taps, int rows, int C,
                    int T_len,
                    int lanes_per_row, int passes, int chunk) {
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * chunk;
  if (first >= passes) return;        // whole warps: the shuffles stay full
  const int end = min(first + chunk, passes);
  const int v = first * kStride + lane;
  Place q;
  q.row = v / lanes_per_row;
  q.j = v - q.row * lanes_per_row;
  q.c = q.row % C;
  Pass cur = load_pass<T, kVec>(x, sp, q, rows, T_len);
  float below[kHalo];
  if (lane == 0) {
    const T* xr = x + static_cast<size_t>(cur.row) * T_len;
#pragma unroll
    for (int i = 0; i < kHalo; ++i) {
      below[i] = to_f32<T>(xr[min(max(cur.tb - kHalo + i, 0), T_len - 1)]);
    }
  }
  for (int p = first; p < end; ++p) {
    Pass next = cur;
    if (p + 1 < end) {
      advance(q, lanes_per_row, C);
      next = load_pass<T, kVec>(x, sp, q, rows, T_len);
    }
    run_pass<T, kVec, kExact>(cur, below, out, taps, lane, T_len);
    cur = next;
  }
}

// the default mode's residency; the exact-edge mode's plan uses it too
template <typename T, bool kVec>
int resident(int* threads_per_sm) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, snake_cmajor_kernel<T, kVec, false>, kThreads, 0);
  *threads_per_sm = blocks * kThreads;
  return static_cast<int>(err);
}

template <typename T, bool kExact>
int launch(const void* x, void* out, const SnakeParams& sp,
           const Taps& taps, int rows, int C, int T_len, int vec,
           int lanes_per_row, int passes, int chunk, cudaStream_t s) {
  if (rows == 0 || T_len == 0) return static_cast<int>(cudaSuccess);
  const long long lanes = static_cast<long long>(rows) * lanes_per_row;
  const bool aligned = T_len % kRun == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (rows < 0 || C <= 0 || T_len < 0 || chunk <= 0 || (vec && !aligned) ||
      (lanes_per_row - 1) * static_cast<long long>(kRun) < T_len ||
      lanes > INT_MAX - 64 ||
      static_cast<long long>(passes) * kStride < lanes - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int warps = (passes + chunk - 1) / chunk;
  const int blocks = (warps + kWarps - 1) / kWarps;
  if (vec) {
    snake_cmajor_kernel<T, true, kExact><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), sp, taps, rows, C,
        T_len, lanes_per_row, passes, chunk);
  } else {
    snake_cmajor_kernel<T, false, kExact><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), sp, taps, rows, C,
        T_len, lanes_per_row, passes, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Threads of the kernel (dtype; vec 1: the 16-byte path, 0: the scalar one)
// that one SM holds at once: the launch plan's wave.
extern "C" int snake_cmajor_resident(int dtype, int vec, void* threads_per_sm) {
  auto n = static_cast<int*>(threads_per_sm);
  if (dtype == kFloat32) {
    return vec ? resident<float, true>(n) : resident<float, false>(n);
  }
  if (dtype == kBFloat16) {
    return vec ? resident<__nv_bfloat16, true>(n)
               : resident<__nv_bfloat16, false>(n);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// alpha, beta (null: alpha) of C elements in param_dtype, and logscale, as
// the caller holds them; taps: the 12 filter taps in host memory. run must
// be kRun; vec (1: the
// 16-byte path, which needs T % kRun == 0 and 16-byte pointers),
// lanes_per_row, passes and chunk (passes per warp) come from the wrapper's
// plan (ops/snake_cmajor.py launch_plan); exact 1 is the exact-edge mode.
extern "C" int snake_cmajor(const void* x, void* out, const void* alpha,
                            const void* beta, int param_dtype, int logscale,
                            const void* taps, int rows, int C, int T_len,
                            int run, int vec,
                            int lanes_per_row, int passes, int chunk,
                            int exact, int dtype, void* stream) {
  if (run != kRun) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (param_dtype != kFloat32 && param_dtype != kBFloat16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SnakeParams sp{alpha, beta, param_dtype, logscale};
  const Taps tp = snake_math::make_taps(static_cast<const float*>(taps));
  if (dtype == kFloat32) {
    return (exact ? launch<float, true> : launch<float, false>)(
        x, out, sp, tp, rows, C, T_len, vec, lanes_per_row, passes, chunk, s);
  }
  if (dtype == kBFloat16) {
    return (exact ? launch<__nv_bfloat16, true>
                  : launch<__nv_bfloat16, false>)(
        x, out, sp, tp, rows, C, T_len, vec, lanes_per_row, passes, chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel K3: the beam decode step's ancestry attention, one launch a layer
// (ops/anc_attention.py is its wrapper and holds its plain version).
//
// Replaces no TPU kernel: the JAX package's step
// (index_tts_dubbing_tpu/models/gpt.py, trunk_decode_step_split_anc) is plain
// XLA ops. It takes the place of the ~20 small PyTorch ops each layer of the
// port's graphed beam step ran around its GEMMs: the slot writes, the float32
// copies of q and of the whole cache, scores against every physical beam and
// a gather, a softmax, a one-hot routing of the weights and two value
// products.
//
// What it computes, for each batch row b, head h and logical beam n: the
// current step's k and v (read from the qkv GEMM's output, (B·nb, 3·H·D), by
// strides) are written at gen slot `slot` of physical beam n; q attends to
// the row's prefix keys (pad-masked by keep) and to gen slots 0..slot, slot s
// read from the physical beam amap[b, n, s] (at s == slot: beam n itself,
// from the qkv output). Scores and softmax in float32, from the cache's
// values upcast exactly; the weights rounded to T before the value product,
// which accumulates in float32; o rounded once to T, in the (B·nb, H·D)
// layout the output projection takes. Slots past `slot` are never read.
//
// Bound on the H100: device memory. A decode step does ~2·D operations a key
// byte, so the least time is the live K/V bytes (the prefix once a row and
// head, each beam's live ancestors' rows) over 3.35 TB/s; at the line's one
// row that is well under a microsecond, so there the bound in practice is
// the latency of a few dependent loads and one launch.
// Design: a (row, head) pair is one thread-block cluster of `split` CTAs
// (the grid's x) that cut its keys into contiguous chunks. Each key row is
// read as 16-byte vectors by a group of D·sizeof(T)/16 lanes; a CTA's lane
// groups are shared out among the beams, each group holding its beam's q in
// registers and 128 bytes a lane of key rows in flight. A CTA keeps its
// chunk's scores in shared memory, the cluster combines the chunk maxima and
// sums through distributed shared memory, and after the value product the
// partial outputs, so the split needs no second pass. The wrapper sets
// `split` from B·H against the CTAs the card holds at once: 8 at the line's
// 16 pairs. All combining runs in a fixed order, so the result does not
// depend on scheduling.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSplit = 8;          // the portable cluster size
constexpr int kSmemLimit = 232448;    // dynamic shared memory a block may use

// 16 bytes of T as float32 values.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
};

struct Shape {
  int nb, s0, g, cap;       // beams, prefix slots, gen slots, chunk capacity
  long long qkv_row;        // elements between two rows of qkv
  float scale;
};

// Lane groups of a CTA: a key row is D·sizeof(T)/16 lanes.
template <typename T, int D>
__host__ __device__ constexpr int groups() {
  return kThreads / (D / Vec<T>::kN);
}

// The shared memory of one CTA, in floats: the chunk's scores and then
// weights (nb·cap), the chunk's (max, sum) per beam (2·nb, read by the
// cluster), the combined (max, sum) (2·nb), the lane groups' partial
// outputs (at most groups·D) and the CTA's partial output (nb·D, read by
// the cluster).
template <typename T, int D>
size_t smem_floats(int nb, int cap) {
  return static_cast<size_t>(nb) * (cap + 4 + D) + groups<T, D>() * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
anc_attention_kernel(const T* __restrict__ qkv, const T* __restrict__ kp,
                     const T* __restrict__ vp, T* __restrict__ kg,
                     T* __restrict__ vg, const uint8_t* __restrict__ keep,
                     const long long* __restrict__ amap,
                     const long long* __restrict__ slot_ptr,
                     T* __restrict__ out, Shape sh) {
  constexpr int V = Vec<T>::kN;
  constexpr int LPK = D / V;                 // lanes a key row
  constexpr int NG = groups<T, D>();         // lane groups
  constexpr int U = 32 / V;                  // key rows a group has in flight
  static_assert(LPK >= 1 && LPK <= 32 && (LPK & (LPK - 1)) == 0,
                "a key row must be 1-32 lanes of 16 bytes");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const int C = H * D;
  const int nb = sh.nb, s0 = sh.s0, g = sh.g, cap = sh.cap;
  const int slot = static_cast<int>(*slot_ptr);
  if (slot < 0 || slot >= g) __trap();    // as an index_copy_ out of range
  const int tid = threadIdx.x;
  // lane group gi serves beam n, keys j, j + gpb, ... of the chunk; the
  // groups past gpb·nb idle (they still join the shuffles)
  const int gi = tid / LPK, lane = tid % LPK;
  const int gpb = NG / nb;
  const bool active = gi < gpb * nb;
  const int n = active ? gi / gpb : 0;
  const int j = gi % gpb;

  extern __shared__ float4 smem_raw[];
  float* sc = reinterpret_cast<float*>(smem_raw);   // nb·cap
  float* stat = sc + nb * cap;                      // m[nb], l[nb]
  float* glob = stat + 2 * nb;                      // M[nb], L[nb]
  float* opart = glob + 2 * nb;                     // nb·D
  float* red = opart + nb * D;                      // gpb·nb·D

  const T* qkv_b = qkv + static_cast<long long>(b) * nb * sh.qkv_row;
  // (b, h) slabs of the caches
  const long long pre = (static_cast<long long>(b) * H + h) * s0 * D;
  const long long gen = (static_cast<long long>(b) * H + h) * nb * g * D;

  // the step's k and v into the gen cache (rank 0 alone)
  if (rank == 0) {
    for (int t = tid; t < nb * D; t += kThreads) {
      const int m = t / D, d = t % D;
      const T* row = qkv_b + m * sh.qkv_row + C + h * D + d;
      const long long at = gen + (static_cast<long long>(m) * g + slot) * D + d;
      kg[at] = row[0];
      vg[at] = row[C];
    }
  }
  // this group's slice of q, as float32
  float q[V];
  Vec<T>::load(qkv_b + n * sh.qkv_row + h * D + lane * V, q);

  // this CTA's chunk of the keys: prefix 0..s0-1, then gen slots 0..slot
  const int total = s0 + slot + 1;
  const int per = (total + split - 1) / split;
  const int c0 = min(total, rank * per);
  const int len = min(total, c0 + per) - c0;

  // the row of chunk key i for this group's beam: in the prefix cache pc,
  // in the gen cache gc, or at the current slot in qkv's k (part 1) or v
  // (part 2) block; nullptr for a padded prefix key
  auto key_row = [&](const T* pc, const T* gc, int part,
                     int i) -> const T* {
    const int key = c0 + i;
    if (key < s0) {
      return keep[static_cast<long long>(b) * s0 + key]
                 ? pc + pre + static_cast<long long>(key) * D
                 : nullptr;
    }
    const int s = key - s0;
    if (s == slot) return qkv_b + n * sh.qkv_row + part * C + h * D;
    const long long p = amap[(static_cast<long long>(b) * nb + n) * g + s];
    return gc + gen + (p * g + s) * D;
  };

  // scores, U rows a group in flight; every lane of a warp runs the same
  // trips, for the shuffles
  for (int base = 0; base < len; base += gpb * U) {
    float kv[U][V];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * gpb + j;
      const T* row = active && i < len ? key_row(kp, kg, 1, i) : nullptr;
      live[u] = row != nullptr;
      if (live[u]) Vec<T>::load(row + lane * V, kv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * gpb + j;
      float p = 0.f;
      if (live[u]) {
#pragma unroll
        for (int e = 0; e < V; ++e) p = fmaf(q[e], kv[u][e], p);
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, off);
      }
      if (lane == 0 && active && i < len) {
        sc[n * cap + i] = live[u] ? p * sh.scale : -INFINITY;
      }
    }
  }
  __syncthreads();

  // the chunk's max and sum of exp per beam: a warp a beam
  const int warp = tid / 32, wl = tid % 32;
  for (int m = warp; m < nb; m += kThreads / 32) {
    float mx = -INFINITY;
    for (int i = wl; i < len; i += 32) mx = fmaxf(mx, sc[m * cap + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    float l = 0.f;
    if (mx > -INFINITY) {
      for (int i = wl; i < len; i += 32) l += expf(sc[m * cap + i] - mx);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    if (wl == 0) {
      stat[m] = mx;
      stat[nb + m] = l;
    }
  }
  cluster.sync();

  // the cluster's max and sum, combined in rank order
  for (int m = tid; m < nb; m += kThreads) {
    float mx = -INFINITY;
    for (int r = 0; r < split; ++r) {
      mx = fmaxf(mx, cluster.map_shared_rank(stat, r)[m]);
    }
    float l = 0.f;
    for (int r = 0; r < split; ++r) {
      const float* st = cluster.map_shared_rank(stat, r);
      if (st[m] > -INFINITY) l += st[nb + m] * expf(st[m] - mx);
    }
    glob[m] = mx;
    glob[nb + m] = l;
  }
  __syncthreads();

  // the weights, rounded to T as the value product takes them
  for (int t = tid; t < nb * len; t += kThreads) {
    const int m = t / len, i = t % len;
    float* w = sc + m * cap + i;
    *w = round_to<T>(expf(*w - glob[m]) / glob[nb + m]);
  }
  __syncthreads();

  // the value product, U rows a group in flight; a zero weight (a padded
  // key) reads nothing
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  for (int base = 0; base < len; base += gpb * U) {
    float vv[U][V];
    float wt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * gpb + j;
      wt[u] = active && i < len ? sc[n * cap + i] : 0.f;
      if (wt[u] != 0.f) Vec<T>::load(key_row(vp, vg, 2, i) + lane * V, vv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (wt[u] != 0.f) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(wt[u], vv[u][e], acc[e]);
      }
    }
  }
  if (active) {
    float* r = red + (j * nb + n) * D + lane * V;
#pragma unroll
    for (int e = 0; e < V; ++e) r[e] = acc[e];
  }
  __syncthreads();
  for (int t = tid; t < nb * D; t += kThreads) {
    float s = 0.f;
    for (int k = 0; k < gpb; ++k) s += red[k * nb * D + t];
    opart[t] = s;
  }
  cluster.sync();

  // o: the CTAs' partial outputs summed in rank order
  for (int t = rank * kThreads + tid; t < nb * D; t += split * kThreads) {
    float s = 0.f;
    for (int r = 0; r < split; ++r) s += cluster.map_shared_rank(opart, r)[t];
    const int m = t / D, d = t % D;
    out[(static_cast<long long>(b) * nb + m) * C + h * D + d] =
        from_f32<T>(s);
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

template <typename T, int D>
int launch(const void* qkv, const void* kp, const void* vp, void* kg,
           void* vg, const void* keep, const void* amap, const void* slot,
           void* out, long long qkv_row, int B, int H, int nb, int s0, int g,
           int split, cudaStream_t stream) {
  if (B < 1 || H < 1 || nb < 1 || nb > groups<T, D>() || s0 < 0 || g < 1 ||
      split < 1 || split > kMaxSplit || qkv_row % Vec<T>::kN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape sh;
  sh.nb = nb;
  sh.s0 = s0;
  sh.g = g;
  sh.cap = (s0 + g + split - 1) / split;
  sh.qkv_row = qkv_row;
  sh.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const size_t smem = smem_floats<T, D>(nb, sh.cap) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // opt in to the whole shared memory once per instantiation, so no runtime
  // API call sits between launches (a CUDA graph can capture the launch)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        anc_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, anc_attention_kernel<T, D>, static_cast<const T*>(qkv),
      static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<T*>(kg), static_cast<T*>(vg),
      static_cast<const uint8_t*>(keep),
      static_cast<const long long*>(amap),
      static_cast<const long long*>(slot), static_cast<T*>(out), sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* qkv, const void* kp, const void* vp, void* kg,
             void* vg, const void* keep, const void* amap, const void* slot,
             void* out, long long qkv_row, int B, int H, int nb, int s0,
             int g, int D, int split, cudaStream_t stream) {
#define K3_HEAD_DIM(DIM)                                                  \
  case DIM:                                                               \
    return launch<T, DIM>(qkv, kp, vp, kg, vg, keep, amap, slot, out,    \
                          qkv_row, B, H, nb, s0, g, split, stream);
  switch (D) {
    K3_HEAD_DIM(16)
    K3_HEAD_DIM(32)
    K3_HEAD_DIM(64)
    K3_HEAD_DIM(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_HEAD_DIM
}

template <typename T>
int resident_d(int D, int* threads_per_sm) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
    case 16:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, anc_attention_kernel<T, 16>, kThreads, 0);
      break;
    case 32:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, anc_attention_kernel<T, 32>, kThreads, 0);
      break;
    case 64:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, anc_attention_kernel<T, 64>, kThreads, 0);
      break;
    case 128:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, anc_attention_kernel<T, 128>, kThreads, 0);
      break;
  }
  *threads_per_sm = blocks * kThreads;
  return static_cast<int>(err);
}

}  // namespace

// Threads of K3 an SM holds at once for (dtype, D), as its registers and
// threads allow: the shared memory, a few KB a CTA at the decode's shapes,
// does not bind.
extern "C" int anc_attention_resident(int dtype, int D, int* threads_per_sm) {
  if (dtype == kFloat32) return resident_d<float>(D, threads_per_sm);
  if (dtype == kBFloat16) return resident_d<__nv_bfloat16>(D, threads_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

// qkv (B·nb, 3·H·D) with rows qkv_row elements apart; kp, vp (B, H, S0, D);
// kg, vg (B, H, nb, G, D), written at gen slot *slot; keep (B, S0) bool;
// amap (B, nb, G) int64; slot a 0-d int64; out (B·nb, H·D). All on the
// device, T (dtype) throughout, contiguous and 16-byte aligned.
extern "C" int anc_attention(const void* qkv, const void* kp, const void* vp,
                             void* kg, void* vg, const void* keep,
                             const void* amap, const void* slot, void* out,
                             long long qkv_row, int B, int H, int nb, int s0,
                             int g, int D, int split, int dtype,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_d<float>(qkv, kp, vp, kg, vg, keep, amap, slot, out,
                           qkv_row, B, H, nb, s0, g, D, split, s);
  }
  if (dtype == kBFloat16) {
    return launch_d<__nv_bfloat16>(qkv, kp, vp, kg, vg, keep, amap, slot, out,
                                   qkv_row, B, H, nb, s0, g, D, split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

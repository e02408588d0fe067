// Kernel K2: one whole AMP resblock on C-major (B, C, T), any C <= 128.
// This header holds the kernel; resblock_cmajor.cu instantiates its default
// mode and holds the C entry point, resblock_cmajor_exact.cu its exact-edge
// mode.
//
// Replaces the Pallas TPU kernel fused_resblock_cmajor
// (index_tts_dubbing_tpu/ops/pallas_resblock.py:175, _kernel). For each of
// the 3 (dilation d) pairs: anti-aliased snake -> conv k (dilation d) ->
// anti-aliased snake -> conv k -> residual add. Activations in float32; each
// conv rounds its input to the caller's dtype and accumulates in float32
// with a float32 bias; the residual stays float32 until the output cast.
// Edges: the block reads x[t0-span, t0+tt+span) with the index clamped to
// [0, T-1] (the replicate pad), and every op then runs in valid mode, so the
// result does not depend on the tile.
// Exact-edge mode (kExact, one flag a launch): the exact route's semantics
// over the whole launch tensor, every op padding at x's own two ends. A
// block whose columns [t0-span, t0+tt+span) stay inside [0, T) runs as in
// the default mode (a branch uniform over the block). A block whose columns
// reach past an end, before each op, sets its buffer's columns outside
// [0, T) to 0 before a conv (the zero pad), and to the edge column's value
// before an activation (the upsampler's replicate pad); inside the
// activation the pairs past an end take the x2 signal's edge value
// (exact_edge.cuh). The valid-mode ops then give the exact route's values
// at every column inside [0, T), also when one tile reaches both ends.
//
// Widths: the kernel is built for the padded widths Cp in {8, 16, 24, 32,
// 48, 64, 96, 128} (the switch in launch_c; Plan<Cp> needs Cp % 8 == 0 and
// Cp % kKS == 0), and a call at C runs on the smallest Cp >= C. The wrapper
// packs the weights, the biases and the snake parameters at Cp with zeros
// (alpha = 1/beta = 1 on the pad rows); the kernel reads only x's C rows,
// sets the pad rows of Y to 0, and stores only the C output rows, so x and
// out need no padded copy. The pad channels stay exactly 0 through the
// resblock: the snake of 0 is 0, a conv of zero rows with zero weights and
// zero bias is 0, and the residual adds 0. C = 24, 48 and 96 (the
// 1536-channel BigVGAN's C <= 128 stages) run unpadded.
//
// Bound on the H100: operations. The six convs (2*C*C*k FLOPs per output
// column each) are 93% of the work, and C*k FLOPs per byte puts them far
// above the card's operations-per-byte ratio.
//
// Design, one block of 8 warps per (batch row, tile of tt outputs):
// (a) Convs on the tensor cores. Each conv is an implicit GEMM,
//     out[Cout, cols] += W_kk[Cout, Cin] . X[Cin, cols + kk*d] summed over
//     the k taps, with mma.sync m16n8k8 in TF32 (M = Cout padded to 16s:
//     24 -> 32; K = Cin per tap; N = columns). float32 splits each operand
//     into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna) and accumulates
//     hi*hi + hi*lo + lo*hi, which holds chip_smoke.py's float32 tolerance
//     where one TF32 pass does not (tests/test_torch_resblock.py emulates
//     both). The tensor cores' own float32 accumulation over K = k*C terms,
//     not the split, sets the remaining error. bfloat16 values are exact in
//     TF32, so the
//     bfloat16 path runs one pass and its products are exact, as bf16 x bf16
//     products in a float32 accumulator. mma.sync, not wgmma: wgmma's 64-row
//     tiles would waste a third of M = 96.
// (b) Weight reuse. A conv walks its output columns in chunks of 256. For
//     each chunk the (tap, 32- or C-row) weight slabs stream through a ring
//     of 3 shared-memory stages with cp.async, two stages ahead of the one
//     the warps multiply, so loads overlap the products. Each weight a warp
//     loads from shared memory feeds 64 (C = 96) or 32 columns, and each
//     slab read from L2 feeds the whole 256-column chunk (a 128-column
//     chunk doubles the slab traffic and the operand splits per product).
// (c) Long time tiles. The residual stream Y lives in a per-block float32
//     scratch in device memory (allocated by the wrapper, L2 resident while
//     the block runs); shared memory holds only the conv/activation buffer
//     A (float32, C x lda, lda >= W - 12 where W = tt + 2*span) and the
//     weight ring. The last conv of each pair adds its result into Y from
//     registers; the last pair writes the output instead. Tile plan (float32
//     sizes, tt the largest multiple of 32 <= 768 that fits 227 KB; W/tt =
//     (tt + 2*span)/tt; shared bytes = 4*C*lda + ring; two C = 24 blocks
//     share an SM):
//        C \ k |  3 (span 48)          |  7 (span 72)          | 11 (span 96)
//        96    | tt 384, 1.25, 227,328 | tt 320, 1.45, 221,184 | tt 288, 1.67, 227,328
//        48    | tt 768, 1.12, 199,680 | tt 768, 1.19, 208,896 | tt 768, 1.25, 218,112
//        24    | tt 768, 1.12,  95,232 | tt 768, 1.19,  99,840 | tt 768, 1.25, 104,448
//     A longer cap than 768 leaves a partial last wave of blocks at the
//     vocoder's window batches (1-16 windows) on 132 SMs.
// (d) Activations from registers. A warp owns channel rows; each lane
//     computes a run of 7 consecutive outputs, loads its 12 inputs once,
//     forms its 7 even and odd up-phases with the snake (accurate sinf) in
//     registers, takes the next lane's first 5 by shuffle, and decimates.
//     A warp covers 218 outputs of a row per pass; in-place activations are
//     safe because every lane reads before any lane of the warp writes
//     (__syncwarp) and a row's passes run in order. No integer division
//     per element anywhere: loops run over rows, then columns.
// Syncs: one __syncthreads per weight stage, one after each activation, and
// around the in-place conv's write-back (outputs only overwrite inputs that
// later chunks no longer read).
#pragma once
#include <cstdint>
#include <type_traits>

#include "dtype.cuh"
#include "exact_edge.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;     // dynamic shared memory per block
constexpr int kStages = 3;             // weight ring depth
constexpr int kRun = 7;                // activation outputs per lane
constexpr int kSeg = 32 * kRun - 6;    // activation outputs per warp pass

__host__ __device__ inline int pair_shrink(int k, int d) {
  return 12 + (d + 1) * (k - 1) / 2;
}

__host__ __device__ inline int chain_span(int k, int d0, int d1, int d2) {
  return pair_shrink(k, d0) + pair_shrink(k, d1) + pair_shrink(k, d2);
}

// Row stride of the buffer A: >= m, and 8 or 24 mod 32 words, so the B
// fragments' four k-rows fall in distinct banks.
__host__ __device__ inline int lda_of(int W) {
  return (W - 12 + 15) / 16 * 16 + 8;
}

// The GEMM shape of a conv at C channels.
template <int C>
struct Plan {
  static constexpr int kCM = (C + 15) / 16 * 16;       // M, padded
  static constexpr int kMTiles = kCM / 16;
  static constexpr int kWM = (kMTiles % 2 == 0 && kMTiles >= 4) ? 2 : 1;
  static constexpr int kMT = kMTiles / kWM;            // m16 tiles per warp
  static constexpr int kWN = kWarps / kWM;
  static constexpr int kNT = kWM == 2 ? 8 : 4;         // n8 tiles per warp
  static constexpr int kNC = kWN * kNT * 8;            // columns per chunk
  static constexpr int kKS = C <= 48 ? C : 32;         // Cin rows per stage
  static constexpr int kLDW = kCM + 8;                 // slab row stride
  static_assert(C % 8 == 0 && C % kKS == 0 && kKS % 8 == 0, "C");
  static_assert(kNC == 256, "chunk");
};

template <typename T, int C>
__host__ __device__ inline size_t smem_bytes(int W) {
  using P = Plan<C>;
  return sizeof(float) * static_cast<size_t>(C) * lda_of(W) +
         sizeof(T) * static_cast<size_t>(kStages) * P::kKS * P::kLDW;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// hi = tf32(v), lo = tf32(v - hi) when SPLIT; else v is exact in TF32.
template <bool SPLIT>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = tf32_rna(v);
    lo = tf32_rna(v - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Anti-aliased snake over every channel row: src rows of width n (row stride
// ls; shared or device memory) -> dst rows of width n - 12 (row stride ld).
// Output column t' is input column t' + 6. Rounded to T: a conv consumes it.
// edge (kExact only): src column 0 is the launch tensor's column g, and the
// pairs past its ends [0, T_len) take the x2 signal's edge values.
template <typename T, int C, bool kExact>
__device__ __forceinline__ void act_rows(const float* src, int ls, float* dst,
                                         int ld, int n, const float* a,
                                         const float* binv,
                                         const float* __restrict__ filt,
                                         bool edge, int g, int T_len) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float up_e[6], up_o[6], dn_e[6], dn_o[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    up_e[q] = 2.0f * filt[11 - 2 * q];
    up_o[q] = 2.0f * filt[10 - 2 * q];
    dn_o[q] = filt[2 * q];       // weighs uo[t + 1 + q]
    dn_e[q] = filt[2 * q + 1];   // weighs ue[t + 1 + q]
  }
  const int nout = n - 12;
  for (int c = warp; c < C; c += kWarps) {
    const float* sr = src + c * ls;
    float* dr = dst + c * ld;
    const float av = a[c];
    const float bv = binv[c];
    for (int s = 0; s < nout; s += kSeg) {
      const int base = s + lane * kRun;    // this lane's first output
      float v[kRun + 5];                   // src[base + 1 + j]
#pragma unroll
      for (int j = 0; j < kRun + 5; ++j) {
        const int i = base + 1 + j;
        v[j] = i < n ? sr[i] : 0.0f;
      }
      float ue[kRun], uo[kRun];            // up-phases at base + 1 + r
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        float e = 0.0f, o = 0.0f;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          e = e + up_e[q] * v[r + q];
          o = o + up_o[q] * v[r + q];
        }
        float sn = sinf(e * av);
        ue[r] = e + bv * sn * sn;
        sn = sinf(o * av);
        uo[r] = o + bv * sn * sn;
      }
      float ne[5], no[5];                  // the next lane's first five
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        ne[j] = __shfl_down_sync(0xffffffffu, ue[j], 1);
        no[j] = __shfl_down_sync(0xffffffffu, uo[j], 1);
      }
      if constexpr (kExact) {
        if (edge) {                        // pair j is src column base + 4 + j
          float pe[kRun + 5], po[kRun + 5];
#pragma unroll
          for (int j = 0; j < kRun + 5; ++j) {
            pe[j] = j < kRun ? ue[j] : ne[j - kRun];
            po[j] = j < kRun ? uo[j] : no[j - kRun];
          }
          exact_edge::clamp_pairs(pe, po, g + base + 4, T_len);
#pragma unroll
          for (int j = 0; j < kRun + 5; ++j) {
            if (j < kRun) {
              ue[j] = pe[j];
              uo[j] = po[j];
            } else {
              ne[j - kRun] = pe[j];
              no[j - kRun] = po[j];
            }
          }
        }
      }
      __syncwarp();                        // every read precedes any write
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const int t = base + r;
        if (lane * kRun + r < kSeg && t < nout) {
          float y = 0.0f;
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            const int j = r + q;
            const float o = j < kRun ? uo[j] : no[j - kRun];
            const float e = j < kRun ? ue[j] : ne[j - kRun];
            y = y + dn_o[q] * o;
            y = y + dn_e[q] * e;
          }
          dr[t] = round_to<T>(y);
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// Exact-edge mode: the columns of every channel row (width n, row stride
// ld) outside the launch tensor's [0, T_len), column 0 being its column g,
// set to 0 (zero: a conv's pad) or to the edge column's value (an
// activation's). Each warp takes the rows act_rows gives it; a conv reads
// its input only after a __syncthreads.
template <int C>
__device__ __forceinline__ void pad_rows(float* buf, int ld, int n, int g,
                                         int T_len, bool zero) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lo = min(max(-g, 0), n);          // [0, lo): before column 0
  const int hi = min(max(T_len - g, 0), n);   // [hi, n): at or past T_len
  for (int c = warp; c < C; c += kWarps) {
    float* r = buf + c * ld;
    const float vl = zero || lo == 0 ? 0.0f : r[lo];
    const float vr = zero || hi == n ? 0.0f : r[hi - 1];
    for (int i = lane; i < lo; i += 32) r[i] = vl;
    for (int i = hi + lane; i < n; i += 32) r[i] = vr;
  }
  __syncwarp();
}

enum Epilogue { kInPlace, kAddToY, kToOut };

// Valid conv of the rows of A (width n_in) with k taps at dilation d ->
// n_in - d(k-1) columns. w: (k * cpad, C) rows kk*cpad + ci, columns co;
// bias: (C). kInPlace writes A (left-aligned); kAddToY adds into y (row
// stride ly); kToOut writes out[co * T_len + col] = y + conv for col < nvalid
// and co < c_act (the caller's rows; the rest are pad rows).
template <typename T, int C, int E>
__device__ __forceinline__ void conv(float* A, int lda, int n_in,
                                     const T* __restrict__ w,
                                     const float* __restrict__ bias, int k,
                                     int d, int cpad, T* ring, float* y, int ly,
                                     T* out, int T_len, int nvalid,
                                     int c_act) {
  using P = Plan<C>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kSPT = C / P::kKS;                      // stages per tap
  constexpr int kCPR = C * static_cast<int>(sizeof(T)) / 16;   // 16 B per row
  constexpr int kPerCopy = 16 / static_cast<int>(sizeof(T));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp / P::kWN;
  const int wn = warp - wm * P::kWN;
  const int nout = n_in - d * (k - 1);
  const int nchunks = (nout + P::kNC - 1) / P::kNC;
  const int per_chunk = k * kSPT;
  const int total = nchunks * per_chunk;

  auto prefetch = [&](int gi) {
    if (gi < total) {
      const int s = gi % per_chunk;
      const int kk = s / kSPT;
      const int cb = s - kk * kSPT;
      const T* src = w + static_cast<size_t>(kk * cpad + cb * P::kKS) * C;
      T* dst = ring + (gi % kStages) * P::kKS * P::kLDW;
      for (int i = threadIdx.x; i < P::kKS * kCPR; i += kThreads) {
        const int r = i / kCPR;
        const int q = i - r * kCPR;
        cp_async16(dst + r * P::kLDW + q * kPerCopy, src + r * C + q * kPerCopy);
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  prefetch(1);
  for (int ch = 0; ch < nchunks; ++ch) {
    float acc[P::kMT][P::kNT][4];
#pragma unroll
    for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < P::kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    const int c0 = ch * P::kNC + wn * P::kNT * 8;   // this warp's columns
    for (int s = 0; s < per_chunk; ++s) {
      const int gi = ch * per_chunk + s;
      cp_async_wait<1>();
      __syncthreads();    // stage gi landed; stage gi - 1 is read by all
      prefetch(gi + 2);
      const int kk = s / kSPT;
      const int cb = s - kk * kSPT;
      const T* wb = ring + (gi % kStages) * P::kKS * P::kLDW + tig * P::kLDW +
                    wm * P::kMT * 16 + g;
      const float* xb = A + (cb * P::kKS + tig) * lda + c0 + kk * d + g;
#pragma unroll
      for (int ks = 0; ks < P::kKS / 8; ++ks) {
        uint32_t ah[P::kMT][4], al[P::kMT][4];
#pragma unroll
        for (int mt = 0; mt < P::kMT; ++mt) {
          const T* p0 = wb + ks * 8 * P::kLDW + mt * 16;
          const T* p1 = p0 + 4 * P::kLDW;
          split<kSplit>(to_f32<T>(p0[0]), ah[mt][0], al[mt][0]);
          split<kSplit>(to_f32<T>(p0[8]), ah[mt][1], al[mt][1]);
          split<kSplit>(to_f32<T>(p1[0]), ah[mt][2], al[mt][2]);
          split<kSplit>(to_f32<T>(p1[8]), ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < P::kNT; ++nt) {
          const float* q0 = xb + ks * 8 * lda + nt * 8;
          uint32_t bh[2], bl[2];
          split<kSplit>(q0[0], bh[0], bl[0]);
          split<kSplit>(q0[4 * lda], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < P::kMT; ++mt) {
            if constexpr (kSplit) {   // the small terms first
              mma_tf32(acc[mt][nt], al[mt], bh);
              mma_tf32(acc[mt][nt], ah[mt], bl);
            }
            mma_tf32(acc[mt][nt], ah[mt], bh);
          }
        }
      }
    }
    if constexpr (E == kInPlace) {
      __syncthreads();    // every read of this chunk's input span is done
    }
#pragma unroll
    for (int mt = 0; mt < P::kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = wm * P::kMT * 16 + mt * 16 + g + 8 * h;
        if (co >= (E == kToOut ? c_act : C)) continue;
        const float b = bias[co];
#pragma unroll
        for (int nt = 0; nt < P::kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + nt * 8 + 2 * tig + e;
            const float v = acc[mt][nt][2 * h + e] + b;
            if (E == kInPlace) {
              if (col < nout) A[co * lda + col] = v;
            } else if (E == kAddToY) {
              if (col < nout) y[co * ly + col] += v;
            } else {
              if (col < nvalid) {
                out[static_cast<size_t>(co) * T_len + col] =
                    from_f32<T>(v + y[co * ly + col]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <typename T, int C, bool kExact>
__global__ void __launch_bounds__(kThreads, C <= 24 ? 2 : 1)
resblock_kernel(const T* __restrict__ x, T* __restrict__ out,
                const T* __restrict__ w1, const float* __restrict__ b1,
                const T* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ acts, const float* __restrict__ filt,
                float* scratch, int c_act, int T_len, int k, int d0, int d1,
                int d2, int tt, int cpad) {
  using P = Plan<C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int span = chain_span(k, d0, d1, d2);
  const int W = tt + 2 * span;
  const int lda = lda_of(W);
  float* A = reinterpret_cast<float*>(smem_raw);
  T* ring = reinterpret_cast<T*>(A + C * lda);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bi = blockIdx.y;
  const int t0 = blockIdx.x * tt;
  // the launch tensor's column of Y's column 0, and whether the block's
  // columns reach past an end (exact-edge mode; uniform over the block)
  const int gy = t0 - span;
  const bool edge = kExact && (gy < 0 || t0 + tt + span > T_len);
  float* Y = scratch +
             (static_cast<size_t>(bi) * gridDim.x + blockIdx.x) * C * W;

  if constexpr (P::kCM > C) {   // the padded output rows weigh zero
    for (int i = threadIdx.x; i < kStages * P::kKS; i += kThreads) {
      T* row = ring + i * P::kLDW;
      for (int co = C; co < P::kCM; ++co) row[co] = from_f32<T>(0.0f);
    }
  }
  const T* xb = x + static_cast<size_t>(bi) * c_act * T_len;
  for (int c = warp; c < C; c += kWarps) {
    float* yr = Y + c * W;
    if (c >= c_act) {             // a pad row: zero
      for (int i = lane; i < W; i += 32) yr[i] = 0.0f;
      continue;
    }
    const T* xr = xb + static_cast<size_t>(c) * T_len;
    for (int i = lane; i < W; i += 32) {
      yr[i] = to_f32<T>(xr[min(max(t0 - span + i, 0), T_len - 1)]);
    }
  }
  __syncthreads();

  const int dils[3] = {d0, d1, d2};
  const size_t wstride = static_cast<size_t>(k) * cpad * C;
  T* ob = out + static_cast<size_t>(bi) * c_act * T_len + t0;
  const int nvalid = min(tt, T_len - t0);
  int off = 0;        // Y's valid columns are [off, off + width)
  int width = W;
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    const int d = dils[p];
    const float* ap = acts + static_cast<size_t>(p) * 4 * C;
    const int s = pair_shrink(k, d);
    int n = width;
    int g = gy + off;               // the op's first input column
    if (edge) pad_rows<C>(Y + off, W, n, g, T_len, false);
    act_rows<T, C, kExact>(Y + off, W, A, lda, n, ap, ap + C, filt, edge, g,
                           T_len);
    n -= 12;
    g += 6;
    if (edge) pad_rows<C>(A, lda, n, g, T_len, true);
    conv<T, C, kInPlace>(A, lda, n, w1 + p * wstride, b1 + p * C, k, d, cpad,
                         ring, nullptr, 0, nullptr, 0, 0, c_act);
    n -= d * (k - 1);
    g += d * (k - 1) / 2;
    if (edge) pad_rows<C>(A, lda, n, g, T_len, false);
    act_rows<T, C, kExact>(A, lda, A, lda, n, ap + 2 * C, ap + 3 * C, filt,
                           edge, g, T_len);
    n -= 12;
    g += 6;
    if (edge) pad_rows<C>(A, lda, n, g, T_len, true);
    if (p < 2) {
      conv<T, C, kAddToY>(A, lda, n, w2 + p * wstride, b2 + p * C, k, 1, cpad,
                          ring, Y + off + s, W, nullptr, 0, 0, c_act);
    } else {
      conv<T, C, kToOut>(A, lda, n, w2 + p * wstride, b2 + p * C, k, 1, cpad,
                         ring, Y + off + s, W, ob, T_len, nvalid, c_act);
    }
    off += s;
    width -= 2 * s;
  }
}

template <typename T, int C, bool kExact>
int launch(const void* x, void* out, const void* w1, const float* b1,
           const void* w2, const float* b2, const float* acts,
           const float* filt, float* scratch, int B, int c_act, int T_len,
           int k, int d0, int d1, int d2, int tt, int cpad, cudaStream_t s) {
  const int W = tt + 2 * chain_span(k, d0, d1, d2);
  const size_t smem = smem_bytes<T, C>(W);
  if (tt <= 0 || c_act < 1 || c_act > C || cpad != (C + 31) / 32 * 32 ||
      smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // opt in to the whole shared memory once per instantiation, so no runtime
  // API call sits between launches (a CUDA graph can capture the launch)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        resblock_kernel<T, C, kExact>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((T_len + tt - 1) / tt, B);
  resblock_kernel<T, C, kExact><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2, acts, filt,
      scratch, c_act, T_len, k, d0, d1, d2, tt, cpad);
  return static_cast<int>(cudaGetLastError());
}

// Cp: the padded width the call runs on (the wrapper's kernel_width(C)).
template <typename T, bool kExact>
int launch_c(const void* x, void* out, const void* w1, const float* b1,
             const void* w2, const float* b2, const float* acts,
             const float* filt, float* scratch, int B, int C, int Cp,
             int T_len, int k, int d0, int d1, int d2, int tt, int cpad,
             cudaStream_t s) {
#define K2_WIDTH(CP)                                                       \
  case CP:                                                                 \
    return launch<T, CP, kExact>(x, out, w1, b1, w2, b2, acts, filt,       \
                                 scratch, B, C, T_len, k, d0, d1, d2, tt,  \
                                 cpad, s);
  switch (Cp) {
    K2_WIDTH(8)
    K2_WIDTH(16)
    K2_WIDTH(24)
    K2_WIDTH(32)
    K2_WIDTH(48)
    K2_WIDTH(64)
    K2_WIDTH(96)
    K2_WIDTH(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K2_WIDTH
}

// One mode of the C entry point (resblock_cmajor.cu): the dtype's
// launch_c. Each mode is instantiated in a source of its own, so the two
// build in parallel.
template <bool kExact>
int launch_mode(const void* x, void* out, const void* w1, const void* b1,
                const void* w2, const void* b2, const void* acts,
                const void* filt, void* scratch, int B, int C, int Cp,
                int T_len, int k, int d0, int d1, int d2, int tt, int cpad,
                int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto b1f = static_cast<const float*>(b1);
  auto b2f = static_cast<const float*>(b2);
  auto af = static_cast<const float*>(acts);
  auto ff = static_cast<const float*>(filt);
  auto sf = static_cast<float*>(scratch);
  if (dtype == kFloat32) {
    return launch_c<float, kExact>(x, out, w1, b1f, w2, b2f, af, ff, sf, B,
                                   C, Cp, T_len, k, d0, d1, d2, tt, cpad, s);
  }
  if (dtype == kBFloat16) {
    return launch_c<__nv_bfloat16, kExact>(x, out, w1, b1f, w2, b2f, af, ff,
                                           sf, B, C, Cp, T_len, k, d0, d1, d2,
                                           tt, cpad, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Gen-cache permute kernels for the beam decode: copy-on-fork (in place) and
// the row gather with an optional bound (out of place).
//
// Replace the Pallas TPU kernels of index_tts_dubbing_tpu/ops/pallas_permute.py:
//   copy_on_fork                 (:182)  -> copy_on_fork below
//   permute_gen_cache            (:41)   -> permute_gen_cache, no bound
//   permute_gen_cache_burst      (:87)   -> permute_gen_cache, with bound
//   permute_gen_cache_pipelined  (:266)  -> permute_gen_cache, no bound
//   permute_gen_cache_bounded    (:306)  -> permute_gen_cache, with bound
// The gen cache is (L, BN, H, G, D), contiguous, so one (layer, row, head)
// slab is G*D contiguous elements.
//
// Bound on the H100: device memory. Both kernels only move bytes, so the
// least time is (bytes read + bytes written) / 3.35 TB/s.
// Design: one block per (layer, row, head) slab and per buffer (k or v, the
// grid's y), so both buffers go in one launch. A block reads its own row index
// from device memory (the TPU kernels' scalar prefetch), so the host never
// waits for the index vector. Rows that do not fork (cp < 0) leave at once.
// Every thread moves 16-byte vectors, neighbouring threads on neighbouring
// addresses along the contiguous span, so each warp access is coalesced; the
// element type is never read, so bfloat16 and float32 share one code path.
// Narrower stores appear only at a ragged tail or at an unaligned base. The
// TPU kernels' G-block ("gb") rule survives only in the span length that the
// wrapper computes on the host, so the result equals theirs slot for slot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Copy n bytes from src to dst (disjoint) with the whole block.
__device__ __forceinline__ void block_copy(char* __restrict__ dst,
                                           const char* __restrict__ src,
                                           long long n) {
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const long long nv = n >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = s4[i];
    done = nv << 4;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Zero n bytes at dst with the whole block.
__device__ __forceinline__ void block_zero(char* __restrict__ dst, long long n) {
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const long long nv = n >> 4;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = z;
    done = nv << 4;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = 0;
}

// blockIdx.x = (l * BN + r) * H + h; blockIdx.y = 0 for k, 1 for v.
// Row r with cp[r] >= 0 takes row cp[r]'s first copy_elems elements of the
// slab. Sources (kept rows) and destinations (freed rows) are disjoint.
__global__ void __launch_bounds__(kThreads)
copy_on_fork_kernel(char* k, char* v, const int* __restrict__ cp, int BN, int H,
                    long long slab_elems, long long copy_elems, int esize) {
  const long long slab = blockIdx.x;
  const int h = static_cast<int>(slab % H);
  const long long lr = slab / H;
  const int r = static_cast<int>(lr % BN);
  const int src_row = cp[r];
  if (src_row < 0) return;
  const long long l = lr / BN;
  char* base = blockIdx.y == 0 ? k : v;
  const long long slab_bytes = slab_elems * esize;
  const long long src_slab = (l * BN + src_row) * H + h;
  block_copy(base + slab * slab_bytes, base + src_slab * slab_bytes,
             copy_elems * esize);
}

// out[l, i, h] = in[l, src[i], h] over the first live_elems elements of the
// slab; the rest of the slab is zero.
__global__ void __launch_bounds__(kThreads)
permute_gen_cache_kernel(const char* k_in, const char* v_in, char* k_out,
                         char* v_out, const int* __restrict__ src, int BN,
                         int H, long long slab_elems, long long live_elems,
                         int esize) {
  const long long slab = blockIdx.x;
  const int h = static_cast<int>(slab % H);
  const long long lr = slab / H;
  const int i = static_cast<int>(lr % BN);
  const long long l = lr / BN;
  const char* in = blockIdx.y == 0 ? k_in : v_in;
  char* out = blockIdx.y == 0 ? k_out : v_out;
  const long long slab_bytes = slab_elems * esize;
  const long long live_bytes = live_elems * esize;
  const long long src_slab = (l * BN + src[i]) * H + h;
  char* dst = out + slab * slab_bytes;
  block_copy(dst, in + src_slab * slab_bytes, live_bytes);
  block_zero(dst + live_bytes, slab_bytes - live_bytes);
}

}  // namespace

// k, v: (L, BN, H, G, D) in place; cp: (BN,) int32 on the device. A launch
// with copy_elems == 0 (bound -1, the decode's first step) copies nothing.
extern "C" int copy_on_fork(void* k, void* v, const void* cp, int L, int BN,
                            int H, long long slab_elems, long long copy_elems,
                            int esize, void* stream) {
  dim3 grid(static_cast<unsigned>(static_cast<long long>(L) * BN * H), 2);
  copy_on_fork_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k), static_cast<char*>(v), static_cast<const int*>(cp),
      BN, H, slab_elems, copy_elems, esize);
  return static_cast<int>(cudaGetLastError());
}

// k_in, v_in -> k_out, v_out: (L, BN, H, G, D); src: (BN,) int32 on the device.
extern "C" int permute_gen_cache(const void* k_in, const void* v_in,
                                 void* k_out, void* v_out, const void* src,
                                 int L, int BN, int H, long long slab_elems,
                                 long long live_elems, int esize, void* stream) {
  dim3 grid(static_cast<unsigned>(static_cast<long long>(L) * BN * H), 2);
  permute_gen_cache_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(k_in), static_cast<const char*>(v_in),
      static_cast<char*>(k_out), static_cast<char*>(v_out),
      static_cast<const int*>(src), BN, H, slab_elems, live_elems, esize);
  return static_cast<int>(cudaGetLastError());
}

// Kernel K2's exact-edge mode (the kernel: resblock_cmajor.cuh), called by
// the C entry point in resblock_cmajor.cu.
#include "resblock_cmajor.cuh"

int resblock_cmajor_exact(const void* x, void* out, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          const void* acts, const void* filt, void* scratch,
                          int B, int C, int Cp, int T_len, int k, int d0,
                          int d1, int d2, int tt, int cpad, int dtype,
                          void* stream) {
  return launch_mode<true>(x, out, w1, b1, w2, b2, acts, filt, scratch, B, C,
                           Cp, T_len, k, d0, d1, d2, tt, cpad, dtype, stream);
}

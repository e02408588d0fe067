// Kernel K2's C entry point and its default mode (the kernel:
// resblock_cmajor.cuh). The exact-edge mode is instantiated in
// resblock_cmajor_exact.cu.
#include "resblock_cmajor.cuh"

int resblock_cmajor_exact(const void* x, void* out, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          const void* acts, const void* filt, void* scratch,
                          int B, int C, int Cp, int T_len, int k, int d0,
                          int d1, int d2, int tt, int cpad, int dtype,
                          void* stream);

// exact: 1 for the exact-edge mode.
extern "C" int resblock_cmajor(const void* x, void* out, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* acts, const void* filt,
                               void* scratch, int B, int C, int Cp, int T_len,
                               int k, int d0, int d1, int d2, int tt, int cpad,
                               int exact, int dtype, void* stream) {
  return (exact ? resblock_cmajor_exact : launch_mode<false>)(
      x, out, w1, b1, w2, b2, acts, filt, scratch, B, C, Cp, T_len, k, d0, d1,
      d2, tt, cpad, dtype, stream);
}

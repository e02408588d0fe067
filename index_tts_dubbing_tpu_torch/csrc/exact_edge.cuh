// The exact-edge mode that kernels K1 (snake_cmajor.cu) and K2
// (resblock_cmajor.cu) share: the anti-aliased activation with the exact
// route's pads at the launch tensor's two ends (ops/alias_free.py).
//
// The exact route replicate-pads the input x for the x2 upsampler, which the
// kernels do by clamping x's index, and then replicate-pads the x2 snake
// signal v for the decimation: v[i] for i < 0 is v[0], and for i >= 2T is
// v[2T-1]. The kernels hold v as up-phase pairs: pair u is (po, pe) =
// (v[2u-1], v[2u]), both from the inputs x[u-3 .. u+2]. So in exact-edge
// mode pe(u < 0) and po(u <= 0) take pe(0), and pe(u >= T) and po(u > T)
// take po(T); every other pair is as the default mode computes it.
#pragma once

namespace exact_edge {

// e/o: the pairs u = g .. g+N-1, snake applied. An output reads the pairs
// t-2 .. t+3, so one at t in [0, T) that reads a pair at u <= 0 also reads
// u = 0, and one that reads u >= T also reads u = T: the caller passes
// every pair its outputs read, and gets the exact route's pairs back.
template <int N>
__device__ __forceinline__ void clamp_pairs(float (&e)[N], float (&o)[N],
                                            int g, int T_len) {
  float e0 = 0.0f, oT = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (g + j == 0) e0 = e[j];
    if (g + j == T_len) oT = o[j];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int u = g + j;
    if (u < 0) e[j] = e0;
    if (u <= 0) o[j] = e0;
    if (u >= T_len) e[j] = oT;
    if (u > T_len) o[j] = oT;
  }
}

}  // namespace exact_edge

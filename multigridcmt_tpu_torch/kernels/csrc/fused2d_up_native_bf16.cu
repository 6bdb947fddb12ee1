// The native bfloat16 fused2d up leg (packed2d_legs.cuh's up stream on the
// unpacked frame with the native arithmetic, native_up_kernel, a kernel
// for each stage count), in a file of its own so that it compiles beside
// fused2d_native_bf16.cu, whose note says what it replaces and how it
// works.
#include "packed2d_legs.cuh"

extern "C" {

// x, b, out: (n+2)^2 bfloat16; e: ((n-1)/2 + 2)^2 bfloat16; h2 .. coef:
// native_bf16.constants' five bfloat16 values; geometry:
// fused2d.leg_geometry's 7 ints.
int mg_fused2d_up_native_bf16(const void* x, const void* e, const void* b,
                              void* out, int n, double h2, double inv_h2,
                              double sig, double inv_den, double coef,
                              int kind, int sweeps, const int* geom,
                              void* stream) {
  return launch_native<false>(
      x, e, b, out, nullptr, Unpacked{n},
      native_coef(h2, inv_h2, sig, inv_den, coef), kind, sweeps, geom,
      stream);
}

}  // extern "C"

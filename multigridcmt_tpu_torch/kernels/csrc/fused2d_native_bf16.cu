// The native bfloat16 fused2d down leg: one launch, one pass over the fine
// grid, as the float legs (fused2d.cu): packed2d_legs.cuh's row-streaming
// down stream on the unpacked frame with the native arithmetic (T = Nb:
// every operation rounded to bfloat16, the host's constants) and
// bfloat16 storage, native_down_kernel, a kernel for each stage count.
// fused2d_up_native_bf16.cu instantiates the up leg, so that the two
// compile in parallel.
//
// Replace the bfloat16 modes of the TPU kernels
// multigridcmt_tpu/kernels/fused2d.py:
//   smooth_residual_restrict -> fused2d_down_native (:289)
//   prolong_add_smooth       -> fused2d_up_native   (:479)
// (kernels/native_bf16.py states the rule and JAX's order). The down leg:
// nu native sweeps, the residual with sig u at every interior point (as
// JAX's fused2d kernel takes it, even at sigma 0), full weighting over
// rows, then columns ((0.25 lo + 0.5 mid) + 0.25 hi, each operation
// rounded), the store of u' and of the coarse residual. The up leg: x + P e
// with P interpolating rows first (an odd point 0.5 a + 0.5 b rounded
// once), the sum rounded, then nu native sweeps and the store.
//
// What bounds them on the card: device-memory traffic (u, b read, u' and
// the quarter-size rc written: 6.5 bytes a point, 0.0081 ms at 2047^2 on
// an H100), or the instructions a point issues, if they take longer: each
// operation is a float32 operation and a rounding (one cvt), a stage's
// update some 6-11 operations, the down leg's residual 9 a point and the
// restriction 15 a coarse point (PERF.md has the prediction beside the
// times). They replace a chain of native_bf16.cu's launches (a launch a
// colour a sweep, then a thread a coarse or fine point for the transfer),
// which read and wrote the grid about five times a leg at nu = 2.
//
// The stream is the float legs' (fused2d.cu's note): lane l holds columns
// 2l and 2l + 1, on an even row one aligned pair (here a 4-byte word of two
// bfloat16: the launcher takes arrays that start on one); rows in flight
// stay in the bfloat16 rings of PR 19's loads (load_raw, widened in the
// step that first reads them); each stencil in the plain versions' order
// (gs_value, residual_of, jacobi_step on Nb). Every value in flight is a
// bfloat16 one, so the store rounds nothing and the residual reads the
// window (no ring of rounded rows). A NaN or Inf spreads only through the
// stencil, as in the plain versions: points the stream does not set are
// selected, never multiplied. The launch geometry is fused2d.leg_geometry.
#include "packed2d_legs.cuh"

extern "C" {

// u, b, u_out: (n+2)^2 bfloat16; rc: ((n-1)/2 + 2)^2 bfloat16; h2 ..
// coef: native_bf16.constants' five bfloat16 values; geometry:
// fused2d.leg_geometry's 7 ints.
int mg_fused2d_down_native_bf16(const void* u, const void* b, void* u_out,
                                void* rc, int n, double h2, double inv_h2,
                                double sig, double inv_den, double coef,
                                int kind, int sweeps, const int* geom,
                                void* stream) {
  return launch_native<true>(
      u, nullptr, b, u_out, rc, Unpacked{n},
      native_coef(h2, inv_h2, sig, inv_den, coef), kind, sweeps, geom,
      stream);
}

}  // extern "C"

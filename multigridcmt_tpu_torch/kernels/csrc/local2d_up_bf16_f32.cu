// The local2d up leg with bfloat16 x and b, a float coarse correction and
// a float x' (packed2d_legs.cuh's up_kernel on the UTile frame, O =
// float): the top level of a mixed cycle, in a file of its own so that it
// compiles beside the other up legs.
//
// Replaces the TPU kernel multigridcmt_tpu/kernels/local2d.py:843 (up_leg)
// with out_dtype float32, as the sharded MG-PCG of the JAX package runs it
// (multigridcmt_tpu/parallel/sharded.py:1553-1562): x + P e and the
// sweeps are computed in float registers from the widened x and b, as in
// the bfloat16 mode (local2d_legs_bf16.cu), and stored in float, so the
// preconditioner's output carries no final bfloat16 rounding. x and b pair
// on a 4-byte boundary, x' on an 8-byte one: a row takes paired accesses
// only where all three start on their pair.
#include "packed2d_legs.cuh"

extern "C" {

int mg_local2d_up_bf16_f32(const void* x, const void* e, const void* b,
                           void* out, int R, int C, int Rc, int Cc, int n,
                           int row_off, int col_off, int crow, int ccol,
                           double h, double sigma, int kind, double omega,
                           int sweeps, const int* geom, void* stream) {
  const UTile f = utile_frame(
      mg::Rect{R, C, row_off, col_off}, mg::Rect{Rc, Cc, crow, ccol}, n, 0,
      Rc, 0, Cc,
      on_pairs<__nv_bfloat16>(x, b, x) && on_pairs<float>(out, out, out));
  return launch_up<float, kMaxTileStages, UTile, __nv_bfloat16, float>(
      x, e, b, out, f, h, sigma, kind, omega, sweeps, 0, geom, stream);
}

}  // extern "C"

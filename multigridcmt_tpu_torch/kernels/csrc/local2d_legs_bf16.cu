// The bfloat16 storage modes of the local2d down and up legs
// (packed2d_legs.cuh's down_kernel and up_kernel on a shard's unpacked
// extended tile, the UTile frame, with S = bfloat16 and T = float; a
// kernel for each stage count), in a file of their own so that they
// compile beside the float32 and float64 legs and do not lengthen them.
// The up leg storing x' in float32 (the top level of a mixed cycle) is in
// local2d_up_bf16_f32.cu.
//
// Replace the bfloat16 modes of the TPU kernels
// multigridcmt_tpu/kernels/local2d.py:
//   down_leg -> local2d_down_bf16  (down_kernel, :616)
//   up_leg   -> local2d_up_bf16    (up_kernel, :843; x' in bfloat16, the
//                                   TPU kernel's own mode, which no solver
//                                   of the port runs)
// as the TPU module's _cdt rule (local2d.py:332-343) runs them: the tiles
// are stored in bfloat16, every value is computed in float registers and
// each point of u' or x' is rounded once, on its store, to nearest even.
// The down leg takes the residual of u' as stored (local2d.py:454-457), so
// that the coarse correction targets the u' that goes up, and writes the
// coarse right-hand side in float: every coarser level of a mixed cycle
// runs the float32 legs. The up leg reads a float coarse correction.
//
// What bounding by bytes changes on the tile: u, b and u' move half the
// float32 bytes; the float rc and e are a quarter of the points. The frame
// is local2d_legs.cu's. A pair is two 2-byte values, so the odd rows of a
// row tile take one 4-byte access for a lane's two points where the arrays
// start on a 4-byte boundary (utile_frame, on_pairs of bfloat16). The rows
// in flight stay bfloat16 until the step that first reads them (a pair as
// the one word it came as), and the down leg rounds each row of u' once
// into a ring that its residual and store read (packed2d_legs.cuh): on an
// H100 at 700 W, S1's tile, nu = 2, the legs went from 1.37-1.53x their
// float32 twins' chained time (widened at the load) to 0.76-0.83x, 36-54%
// of their bounds (PERF.md).
#include "packed2d_legs.cuh"

extern "C" {

// local2d_legs.cu's arguments; u, b and u_out bfloat16, rc float.
int mg_local2d_down_bf16(const void* u, const void* b, void* u_out,
                         void* rc, int R, int C, int Rc, int Cc, int n,
                         int row_off, int col_off, int crow, int ccol,
                         int qlo, int qhi, int slo, int shi, double h,
                         double sigma, int kind, double omega, int sweeps,
                         const int* geom, void* stream) {
  const UTile f = utile_frame(mg::Rect{R, C, row_off, col_off},
                              mg::Rect{Rc, Cc, crow, ccol}, n, qlo, qhi, slo,
                              shi, on_pairs<__nv_bfloat16>(u, b, u_out));
  return launch_down<float, kMaxTileStages, UTile, __nv_bfloat16>(
      u, b, u_out, rc, f, h, sigma, kind, omega, sweeps, 0, geom, stream);
}

// x, b and out bfloat16, e float.
int mg_local2d_up_bf16(const void* x, const void* e, const void* b,
                       void* out, int R, int C, int Rc, int Cc, int n,
                       int row_off, int col_off, int crow, int ccol,
                       double h, double sigma, int kind, double omega,
                       int sweeps, const int* geom, void* stream) {
  const UTile f = utile_frame(mg::Rect{R, C, row_off, col_off},
                              mg::Rect{Rc, Cc, crow, ccol}, n, 0, Rc, 0, Cc,
                              on_pairs<__nv_bfloat16>(x, b, out));
  return launch_up<float, kMaxTileStages, UTile, __nv_bfloat16>(
      x, e, b, out, f, h, sigma, kind, omega, sweeps, 0, geom, stream);
}

}  // extern "C"

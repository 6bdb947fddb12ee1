// The plocal2d up leg with bfloat16 x and b, a float coarse correction and
// a float x' (packed2d_legs.cuh's up_kernel on the Tile frame, O = float):
// the top level of a mixed cycle on a colour-packed fine level, in a file
// of its own so that it compiles beside the other up legs.
//
// Replaces the TPU kernel multigridcmt_tpu/kernels/plocal2d.py:708
// (up_leg) with out_dtype float32 (:654-655), as the sharded MG-PCG of the
// JAX package runs it (multigridcmt_tpu/parallel/sharded.py:1553-1562), by
// local2d_up_bf16_f32.cu's rule on plocal2d_legs_bf16.cu's frame.
#include "packed2d_legs.cuh"

extern "C" {

int mg_plocal2d_up_bf16_f32(const void* x, const void* e, const void* b,
                            void* out, int R, int C, int Rc, int Cc, int n,
                            int row_off, int col_off, int crow, int ccol,
                            double h, double sigma, int kind, double omega,
                            int sweeps, const int* geom, void* stream) {
  const Tile f = tile_frame(mg::PRect{R, C, row_off, col_off},
                            mg::Rect{Rc, Cc, crow, ccol}, n, 0, Rc, 0, Cc);
  return launch_up<float, kMaxTileStages, Tile, __nv_bfloat16, float>(
      x, e, b, out, f, h, sigma, kind, omega, sweeps, 0, geom, stream);
}

}  // extern "C"

// The bfloat16 storage modes of the plocal2d down and up legs
// (packed2d_legs.cuh's down_kernel and up_kernel on a shard's packed
// extended tile, the Tile frame, with S = bfloat16 and T = float; a kernel
// for each stage count), in a file of their own so that they compile
// beside the float32 and float64 legs. The up leg storing x' in float32 is
// in plocal2d_up_bf16_f32.cu.
//
// Replace the bfloat16 modes of the TPU kernels
// multigridcmt_tpu/kernels/plocal2d.py:
//   down_leg -> plocal2d_down_bf16  (down_kernel, :501)
//   up_leg   -> plocal2d_up_bf16    (up_kernel, :708; x' in bfloat16, the
//                                    TPU kernel's own mode, which no
//                                    solver of the port runs)
// by local2d_legs_bf16.cu's rule: bfloat16 planes, float registers, each
// point rounded once on its store, the down leg's residual that of u' as
// stored (plocal2d.py:369-376; the red points only after an RB-GS sweep,
// as the float32 leg), a float coarse right-hand side and correction. A
// lane's two points lie in the two planes, so every access is one 2-byte
// element, 32 consecutive ones a warp a plane. The design is the float32
// tile leg's (plocal2d.cu's note) with local2d_legs_bf16.cu's rings: rows
// in flight kept bfloat16 until the step that first reads them, u' rounded
// once a row for its residual and store. On an H100 at 700 W, S1's packed
// tile, nu = 2: 1.27-1.35x the float32 twins' chained time widened at the
// load, 0.86-0.89x with the rings, 35-49% of their bounds (PERF.md).
#include "packed2d_legs.cuh"

extern "C" {

// plocal2d_legs.cu's arguments; u, b and u_out bfloat16, rc float.
int mg_plocal2d_down_bf16(const void* u, const void* b, void* u_out,
                          void* rc, int R, int C, int Rc, int Cc, int n,
                          int row_off, int col_off, int crow, int ccol,
                          int qlo, int qhi, int slo, int shi, double h,
                          double sigma, int kind, double omega, int sweeps,
                          const int* geom, void* stream) {
  const Tile f = tile_frame(mg::PRect{R, C, row_off, col_off},
                            mg::Rect{Rc, Cc, crow, ccol}, n, qlo, qhi, slo,
                            shi);
  return launch_down<float, kMaxTileStages, Tile, __nv_bfloat16>(
      u, b, u_out, rc, f, h, sigma, kind, omega, sweeps, 0, geom, stream);
}

// x, b and out bfloat16, e float.
int mg_plocal2d_up_bf16(const void* x, const void* e, const void* b,
                        void* out, int R, int C, int Rc, int Cc, int n,
                        int row_off, int col_off, int crow, int ccol,
                        double h, double sigma, int kind, double omega,
                        int sweeps, const int* geom, void* stream) {
  const Tile f = tile_frame(mg::PRect{R, C, row_off, col_off},
                            mg::Rect{Rc, Cc, crow, ccol}, n, 0, Rc, 0, Cc);
  return launch_up<float, kMaxTileStages, Tile, __nv_bfloat16>(
      x, e, b, out, f, h, sigma, kind, omega, sweeps, 0, geom, stream);
}

}  // extern "C"

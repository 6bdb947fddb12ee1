// The local2d down and up legs in float32: packed2d_legs.cuh's down_kernel
// and up_kernel on a shard's unpacked extended tile (the UTile frame; a
// kernel for each stage count), in a file of their own so that they
// compile beside local2d_legs_f64.cu and the other leg files.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/local2d.py:
//   down_leg -> local2d_down (down_kernel on a UTile frame)
//   up_leg   -> local2d_up   (up_kernel on a UTile frame)
//
// What bounds them on the card: device-memory traffic, as the fused2d
// legs on the whole grid (fused2d.cu): a leg reads u and b and writes u'
// and the quarter-size coarse tile (down), or reads x, b and the
// quarter-size correction and writes x' (up), 12-13 bytes a point in
// float32 (0.0654 ms at config 5's 4095^2 tile, 4112 x 4097, on an H100).
//
// The design is packed2d.cu's row stream (a warp streams a 32-lane strip
// down a segment of rows in registers, every stage one row apart; its
// note), on a frame that joins two others. From the tile frame of the
// plocal2d legs (plocal2d.cu's note) it takes the rows and the coarse
// side: global rows from the tile's odd first row, the row above the tile
// streamed as zeros so that every unit starts on an even row, updates
// only off the tile's outer ring, the coarse tile (local2d's extended
// convention) written by restriction on its owned box and as zeros by
// every warp off it, and read as 0 off the tile by the up leg. From the
// unpacked frame of the fused2d legs (fused2d.cu's note) it takes the
// fine side: lane l holds two adjacent columns, the down leg's residual is
// taken at every interior point and each stencil is summed in the plain
// versions' order, so that at sigma = 0 and h = 2^-k the legs round as
// local2d's plain versions do. One thing is new: the row pitch is the
// tile's, odd on a row tile and even on a block tile, and the tile's
// offsets are odd, so a lane's two points form an aligned pair on the odd
// rows of a row tile and on no row of a block tile (utile_frame derives
// it from the tile and the pointers; the kernels test it on odd rows
// only, the rows' parity being known at compile time); elsewhere a lane
// makes two scalar accesses, whose 64 points a warp covers the same
// sectors. The launch geometry is packed2d.py's leg_geometry on this
// frame (local2d.leg_geometry).
#include "packed2d_legs.cuh"

extern "C" {

// R x C: the tile at global (row_off, col_off); Rc x Cc: the coarse tile
// at (crow, ccol) and its owned box [qlo, qhi) x [slo, shi) (coarse tile
// indices); geometry: local2d.leg_geometry's 7 ints.
int mg_local2d_down_f32(const void* u, const void* b, void* u_out, void* rc,
                        int R, int C, int Rc, int Cc, int n, int row_off,
                        int col_off, int crow, int ccol, int qlo, int qhi,
                        int slo, int shi, double h, double sigma, int kind,
                        double omega, int sweeps, const int* geom,
                        void* stream) {
  const UTile f = utile_frame(mg::Rect{R, C, row_off, col_off},
                              mg::Rect{Rc, Cc, crow, ccol}, n, qlo, qhi, slo,
                              shi, on_pairs<float>(u, b, u_out));
  return launch_down<float, kMaxTileStages>(u, b, u_out, rc, f, h, sigma,
                                            kind, omega, sweeps, 0, geom,
                                            stream);
}

// The up leg reads e on the whole coarse tile (no owned box).
int mg_local2d_up_f32(const void* x, const void* e, const void* b, void* out,
                      int R, int C, int Rc, int Cc, int n, int row_off,
                      int col_off, int crow, int ccol, double h, double sigma,
                      int kind, double omega, int sweeps, const int* geom,
                      void* stream) {
  const UTile f = utile_frame(mg::Rect{R, C, row_off, col_off},
                              mg::Rect{Rc, Cc, crow, ccol}, n, 0, Rc, 0, Cc,
                              on_pairs<float>(x, b, out));
  return launch_up<float, kMaxTileStages>(x, e, b, out, f, h, sigma, kind,
                                          omega, sweeps, 0, geom, stream);
}

}  // extern "C"

// The plocal2d down and up legs in float64: packed2d_legs.cuh's down_kernel
// and up_kernel on a shard's packed extended tile (the Tile frame; a kernel
// for each stage count), in a file of their own so that they compile
// beside packed2d.cu, packed2d_up*.cu and plocal2d_legs.cu. plocal2d.cu's note
// says how the tile frame works.
#include "packed2d_legs.cuh"

extern "C" {

// R x C: the unpacked tile at global (row_off, col_off); Rc x Cc: the
// coarse tile at (crow, ccol) and its owned box [qlo, qhi) x [slo, shi)
// (coarse tile indices); geometry: plocal2d.leg_geometry's 7 ints.
int mg_plocal2d_down_f64(const void* u, const void* b, void* u_out, void* rc,
                         int R, int C, int Rc, int Cc, int n, int row_off,
                         int col_off, int crow, int ccol, int qlo, int qhi,
                         int slo, int shi, double h, double sigma, int kind,
                         double omega, int sweeps, const int* geom,
                         void* stream) {
  const Tile f = tile_frame(mg::PRect{R, C, row_off, col_off},
                            mg::Rect{Rc, Cc, crow, ccol}, n, qlo, qhi, slo,
                            shi);
  return launch_down<double, kMaxTileStages>(u, b, u_out, rc, f, h, sigma,
                                             kind, omega, sweeps, 0, geom,
                                             stream);
}

// The up leg reads e on the whole coarse tile (no owned box).
int mg_plocal2d_up_f64(const void* x, const void* e, const void* b, void* out,
                       int R, int C, int Rc, int Cc, int n, int row_off,
                       int col_off, int crow, int ccol, double h,
                       double sigma, int kind, double omega, int sweeps,
                       const int* geom, void* stream) {
  const Tile f = tile_frame(mg::PRect{R, C, row_off, col_off},
                            mg::Rect{Rc, Cc, crow, ccol}, n, 0, Rc, 0, Cc);
  return launch_up<double, kMaxTileStages>(x, e, b, out, f, h, sigma, kind,
                                           omega, sweeps, 0, geom, stream);
}

}  // extern "C"

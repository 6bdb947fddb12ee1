// The local2d down and up legs in float64: packed2d_legs.cuh's down_kernel
// and up_kernel on a shard's unpacked extended tile (the UTile frame; a
// kernel for each stage count), in a file of their own so that they
// compile beside local2d_legs.cu and the other leg files. local2d_legs.cu's
// note says what they replace and how the frame works.
#include "packed2d_legs.cuh"

extern "C" {

// R x C: the tile at global (row_off, col_off); Rc x Cc: the coarse tile
// at (crow, ccol) and its owned box [qlo, qhi) x [slo, shi) (coarse tile
// indices); geometry: local2d.leg_geometry's 7 ints.
int mg_local2d_down_f64(const void* u, const void* b, void* u_out, void* rc,
                        int R, int C, int Rc, int Cc, int n, int row_off,
                        int col_off, int crow, int ccol, int qlo, int qhi,
                        int slo, int shi, double h, double sigma, int kind,
                        double omega, int sweeps, const int* geom,
                        void* stream) {
  const UTile f = utile_frame(mg::Rect{R, C, row_off, col_off},
                              mg::Rect{Rc, Cc, crow, ccol}, n, qlo, qhi, slo,
                              shi, on_pairs<double>(u, b, u_out));
  return launch_down<double, kMaxTileStages>(u, b, u_out, rc, f, h, sigma,
                                             kind, omega, sweeps, 0, geom,
                                             stream);
}

// The up leg reads e on the whole coarse tile (no owned box).
int mg_local2d_up_f64(const void* x, const void* e, const void* b, void* out,
                      int R, int C, int Rc, int Cc, int n, int row_off,
                      int col_off, int crow, int ccol, double h, double sigma,
                      int kind, double omega, int sweeps, const int* geom,
                      void* stream) {
  const UTile f = utile_frame(mg::Rect{R, C, row_off, col_off},
                              mg::Rect{Rc, Cc, crow, ccol}, n, 0, Rc, 0, Cc,
                              on_pairs<double>(x, b, out));
  return launch_up<double, kMaxTileStages>(x, e, b, out, f, h, sigma, kind,
                                           omega, sweeps, 0, geom, stream);
}

}  // extern "C"

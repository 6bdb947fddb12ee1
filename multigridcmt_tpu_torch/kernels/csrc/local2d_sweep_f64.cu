// The local2d RB-GS and Jacobi sweeps in float64 (packed2d_legs.cuh's
// sweep_kernel on the unpacked tile frame), compiled beside
// local2d_sweep.cu, whose note says what they replace and how they work.
#include "packed2d_legs.cuh"

extern "C" {

int mg_local2d_sweep_f64(const void* u, const void* b, void* out, int R,
                         int C, int n, int row_off, int col_off, double h,
                         double sigma, int kind, double omega, int sweeps,
                         const int* geom, void* stream) {
  const UTile f = utile_frame(mg::Rect{R, C, row_off, col_off},
                              mg::Rect{0, 0, 0, 0}, n, 0, 0, 0, 0,
                              on_pairs<double>(u, b, out));
  return launch_sweep<double, kMaxUpStages, true>(u, b, out, f, h, sigma,
                                                  kind, omega, sweeps, geom,
                                                  stream);
}

}  // extern "C"

// The fused RB-GS and Jacobi sweeps of the unpacked 2D levels in float64
// (packed2d_legs.cuh's sweep_kernel on the unpacked frame), compiled beside
// stencil2d_sweep.cu, whose note says what they replace and how they work.
#include "packed2d_legs.cuh"

extern "C" {

int mg_stencil2d_sweep_f64(const void* u, const void* b, void* out, int n,
                           double h, double sigma, int kind, double omega,
                           int sweeps, const int* geom, void* stream) {
  return launch_sweep<double, kMaxUpStages, true>(
      u, b, out, Unpacked{n}, h, sigma, kind, omega, sweeps, geom, stream);
}

}  // extern "C"

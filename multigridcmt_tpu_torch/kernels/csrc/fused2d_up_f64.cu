// The fused2d up leg in float64 (packed2d_legs.cuh's up_kernel on the
// unpacked frame), compiled beside fused2d.cu and fused2d_up.cu.
#include "packed2d_legs.cuh"

extern "C" {

int mg_fused2d_up_f64(const void* x, const void* e, const void* b, void* out,
                      int n, double h, double sigma, int kind, double omega,
                      int sweeps, const int* geom, void* stream) {
  return launch_up<double, kMaxUpStages>(
      x, e, b, out, Unpacked{n}, h, sigma, kind, omega, sweeps, 0, geom,
      stream);
}

}  // extern "C"

// The fused2d up leg in float32 (packed2d_legs.cuh's up_kernel on the
// unpacked frame, one kernel per stage count), in a file of its own so
// that it compiles beside fused2d.cu and fused2d_up_f64.cu. fused2d.cu's
// note says what it replaces and how it works.
#include "packed2d_legs.cuh"

extern "C" {

// x, b, out: (n+2)^2; e: ((n-1)/2 + 2)^2; geometry: packed2d.leg_geometry's
// 7 ints.
int mg_fused2d_up_f32(const void* x, const void* e, const void* b, void* out,
                      int n, double h, double sigma, int kind, double omega,
                      int sweeps, const int* geom, void* stream) {
  return launch_up<float, kMaxUpStages>(
      x, e, b, out, Unpacked{n}, h, sigma, kind, omega, sweeps, 0, geom,
      stream);
}

}  // extern "C"

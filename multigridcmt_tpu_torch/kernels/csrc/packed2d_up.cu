// The up leg of the packed2d tier in float32 (packed2d_legs.cuh's
// up_kernel, one kernel per stage count and coarse layout), in a file of
// its own so that it compiles beside packed2d.cu and packed2d_up_f64.cu.
#include "packed2d_legs.cuh"

extern "C" {

int mg_packed2d_up_f32(const void* x, const void* e, const void* b, void* out,
                       int n, double h, double sigma, int kind, double omega,
                       int sweeps, int packed_e, const int* geom,
                       void* stream) {
  return launch_up<float, kMaxUpStages>(x, e, b, out, Whole{n}, h, sigma,
                                        kind, omega, sweeps, packed_e, geom,
                                        stream);
}

}  // extern "C"

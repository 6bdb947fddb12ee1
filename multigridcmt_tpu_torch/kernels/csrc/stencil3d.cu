// 3D 7-point Poisson kernels in float32 and float64: the entry points of
// stencil3d.cuh's z-march (its note has the design and the rules).
//
// Replace the three modes of the one TPU kernel in
// multigridcmt_tpu/kernels/stencil3d.py (its pallas_call):
//   residual     -> mg_stencil3d_residual  (pass_kernel, kResidual)
//   jacobi_sweep -> mg_stencil3d_jacobi    (pass_kernel, kJacobi; a launch
//                                           a sweep)
//   rbgs_sweep   -> mg_stencil3d_rbgs      (rbgs_kernel: a launch a sweep,
//                                           one pass)
// The bfloat16 storage modes are in stencil3d_bf16.cu.
#include "stencil3d.cuh"

extern "C" {

int mg_stencil3d_residual_f32(const void* u, const void* b, void* out, int p,
                              int r, int c, int n, double h, double sigma,
                              int goff, int roff, const int* geom,
                              void* stream) {
  return residual<float>(u, b, out, p, r, c, n, h, sigma, goff, roff, geom,
                         stream);
}

int mg_stencil3d_residual_f64(const void* u, const void* b, void* out, int p,
                              int r, int c, int n, double h, double sigma,
                              int goff, int roff, const int* geom,
                              void* stream) {
  return residual<double>(u, b, out, p, r, c, n, h, sigma, goff, roff, geom,
                          stream);
}

int mg_stencil3d_jacobi_f32(const void* u, const void* b, void* out, int p,
                            int r, int c, int n, double h, double sigma,
                            double omega, int goff, int roff,
                            const int* geom, void* stream) {
  return jacobi<float>(u, b, out, p, r, c, n, h, sigma, omega, goff, roff,
                       geom, stream);
}

int mg_stencil3d_jacobi_f64(const void* u, const void* b, void* out, int p,
                            int r, int c, int n, double h, double sigma,
                            double omega, int goff, int roff,
                            const int* geom, void* stream) {
  return jacobi<double>(u, b, out, p, r, c, n, h, sigma, omega, goff, roff,
                        geom, stream);
}

int mg_stencil3d_rbgs_f32(const void* u, const void* b, void* out, int p,
                          int r, int c, int n, double h, double sigma,
                          int goff, int roff, const int* geom, void* stream) {
  return rbgs<float>(u, b, out, p, r, c, n, h, sigma, goff, roff, geom,
                     stream);
}

int mg_stencil3d_rbgs_f64(const void* u, const void* b, void* out, int p,
                          int r, int c, int n, double h, double sigma,
                          int goff, int roff, const int* geom, void* stream) {
  return rbgs<double>(u, b, out, p, r, c, n, h, sigma, goff, roff, geom,
                      stream);
}

}  // extern "C"

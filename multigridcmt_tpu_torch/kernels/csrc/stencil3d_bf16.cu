// The bfloat16 storage modes of the 3D 7-point kernels (stencil3d.cuh's
// z-march with u and b stored in bfloat16, float registers), in a file of
// their own so that they compile beside the float32 and float64 kernels.
//
// Replace the bfloat16 modes of the TPU kernel in
// multigridcmt_tpu/kernels/stencil3d.py, the fine level of a mixed 3D
// cycle:
//   residual     -> mg_stencil3d_residual_bf16 (:474; r stored in float32,
//                   as the TPU kernel's, :362-366)
//   jacobi_sweep -> mg_stencil3d_jacobi_bf16, _bf16_f32 (:485; the output
//                   in bfloat16, or in float32: out_dtype; the bfloat16
//                   output launches the paired march, jacobi_pairs_kernel,
//                   where the layout pairs, and pass_kernel elsewhere; the
//                   float32 output always pass_kernel)
//   rbgs_sweep   -> mg_stencil3d_rbgs_bf16, _bf16_f32 (:510; the red values
//                   rounded to bfloat16 before the black stage reads them;
//                   rbgs launches the paired march, rbgs_pairs_kernel,
//                   where the layout pairs, and rbgs_kernel elsewhere)
// Each launch is one sweep; each output point is rounded once, on its
// store.
#include "stencil3d.cuh"

extern "C" {

int mg_stencil3d_residual_bf16(const void* u, const void* b, void* out,
                               int p, int r, int c, int n, double h,
                               double sigma, int goff, int roff,
                               const int* geom, void* stream) {
  return residual<float, __nv_bfloat16, float>(u, b, out, p, r, c, n, h,
                                               sigma, goff, roff, geom,
                                               stream);
}

int mg_stencil3d_jacobi_bf16(const void* u, const void* b, void* out, int p,
                             int r, int c, int n, double h, double sigma,
                             double omega, int goff, int roff,
                             const int* geom, void* stream) {
  return jacobi<float, __nv_bfloat16, __nv_bfloat16>(
      u, b, out, p, r, c, n, h, sigma, omega, goff, roff, geom, stream);
}

int mg_stencil3d_jacobi_bf16_f32(const void* u, const void* b, void* out,
                                 int p, int r, int c, int n, double h,
                                 double sigma, double omega, int goff,
                                 int roff, const int* geom, void* stream) {
  return jacobi<float, __nv_bfloat16, float>(
      u, b, out, p, r, c, n, h, sigma, omega, goff, roff, geom, stream);
}

int mg_stencil3d_rbgs_bf16(const void* u, const void* b, void* out, int p,
                           int r, int c, int n, double h, double sigma,
                           int goff, int roff, const int* geom,
                           void* stream) {
  return rbgs<float, __nv_bfloat16, __nv_bfloat16>(
      u, b, out, p, r, c, n, h, sigma, goff, roff, geom, stream);
}

int mg_stencil3d_rbgs_bf16_f32(const void* u, const void* b, void* out,
                               int p, int r, int c, int n, double h,
                               double sigma, int goff, int roff,
                               const int* geom, void* stream) {
  return rbgs<float, __nv_bfloat16, float>(u, b, out, p, r, c, n, h, sigma,
                                           goff, roff, geom, stream);
}

}  // extern "C"

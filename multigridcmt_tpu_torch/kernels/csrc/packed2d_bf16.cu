// The bfloat16 storage modes of the packed2d down leg and residual (the
// TPU module's _cdt rule, multigridcmt_tpu/kernels/packed2d.py:74-90), in a
// file of their own so that they compile beside the float32 and float64
// legs and do not lengthen them.
//
// Replace the bfloat16 modes of the TPU kernels
// multigridcmt_tpu/kernels/packed2d.py:
//   smooth_residual_restrict -> packed2d_down_bf16  (down_kernel, :839)
//   residual                 -> packed2d_residual_bf16
//                                                   (mg::presidual_pairs_kernel
//                                                   where the layout pairs,
//                                                   mg::presidual_kernel
//                                                   elsewhere; :440)
//   residual_norm_sq         -> packed2d_resnorm_bf16
//                                                   (mg::presnorm_partial,
//                                                   mg::sum_partials; :553)
//
// u, b and u' are bfloat16; the smoothing and the residual run in float
// registers, and each point is rounded once, on its store, to nearest
// even. The down leg takes the residual of u' as stored (rounded), so that
// the coarse correction targets the u' that goes up (packed2d.py:678-683),
// and writes the coarse right-hand side in float: every coarser level of a
// mixed cycle runs the float32 kernels. The residual is bfloat16 out, as
// the TPU kernel's (packed2d.py:420-422).
// What bounds them: device memory, half the float32 bytes on the fine grid
// (packed2d.cu's note). The down leg is the float32 row stream with two
// rings (packed2d_legs.cuh): the rows in flight stay bfloat16 until the
// step that first reads them, and each row of u' is rounded once, as it
// leaves the last stage, into a ring of three rows that its residual and
// its store read. Widening at the load instead, and rounding each residual
// operand where it was read, ran 1.36x slower than float32 (0.1421 against
// 0.1045 ms chained at 4095^2, nu = 2, on an H100 at 700 W); with the rings
// it runs 0.75x (0.0784 ms), 45% of its bound (PERF.md). The residual, a
// thread a lane with six 2-byte loads and a 64-bit division a point, ran
// 0.081 ms (35% of its bound); on words of two lanes (packed_tile.cuh,
// the planes' rows i side by side in the grid) it runs 0.049 ms, 61%,
// against float32's 0.099 (PERF.md). The norm widens u and b at each
// load and returns a float32 sum, as the TPU kernel's (packed2d.py:534):
// 4 bytes a point read (3 red only), half float32's.
#include "packed2d_legs.cuh"

extern "C" {

int mg_packed2d_down_bf16(const void* u, const void* b, void* u_out, void* rc,
                          int n, double h, double sigma, int kind,
                          double omega, int sweeps, int packed_coarse,
                          const int* geom, void* stream) {
  return launch_down<float, kMaxDownStages, Whole, __nv_bfloat16>(
      u, b, u_out, rc, Whole{n}, h, sigma, kind, omega, sweeps,
      packed_coarse, geom, stream);
}

int mg_packed2d_residual_bf16(const void* u, const void* b, void* r, int n,
                              double h, double sigma, void* stream) {
  return mg::launch_presidual<float, mg::Interior, __nv_bfloat16>(
      u, b, r, mg::PRect{n + 2, n + 2, 0, 0}, mg::Interior{n}, h, sigma, true,
      stream);
}

// The whole grid's residual norm (red only or both planes), u and b
// bfloat16, out[0] float32.
int mg_packed2d_resnorm_bf16(const void* u, const void* b, void* partial,
                             void* out, int n, double h, double sigma,
                             int red_only, int blocks, void* stream) {
  return mg::launch_presnorm<float, mg::Interior, __nv_bfloat16>(
      u, b, partial, out, mg::PRect{n + 2, n + 2, 0, 0}, mg::Interior{n}, 1,
      n + 1, 0, n + 2, h, sigma, red_only, blocks, stream);
}

}  // extern "C"

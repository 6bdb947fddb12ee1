// The bfloat16 storage mode of the packed2d RB-GS sweeps (packed2d_sweep.cu's
// sweep stream with bfloat16 u, b and out, float registers), in a file of
// its own so that it compiles beside the float32 and float64 kernels.
//
// Replaces the bfloat16 mode of the TPU kernel
// multigridcmt_tpu/kernels/packed2d.py:
//   rbgs_sweep -> packed2d_rbgs_bf16 (sweep_kernel, :305)
// the pre-smoothing of a mixed cycle's top level whose leg has more sweeps
// than a fused leg takes (RB-GS V(4,4)). Each point is rounded once, on its
// store, after all the launch's sweeps, as the TPU kernel narrows once
// (packed2d.py:256-257).
#include "packed2d_legs.cuh"

extern "C" {

int mg_packed2d_rbgs_bf16(const void* u, const void* b, void* out, int n,
                          double h, double sigma, int sweeps, const int* geom,
                          void* stream) {
  return launch_sweep<float, kMaxUpStages, false, Whole, __nv_bfloat16>(
      u, b, out, Whole{n}, h, sigma, mg::kRbgs, 1.0, sweeps, geom, stream);
}

}  // extern "C"

// The bfloat16 storage modes of the packed shard tile's residual, operator
// apply and residual norm (the TPU module's _cdt rule,
// multigridcmt_tpu/kernels/packed2d.py:74-90), in a file of their own so
// that they compile beside the float32 and float64 ones of plocal2d.cu.
//
// Replace the bfloat16 modes of the TPU kernels
// multigridcmt_tpu/kernels/plocal2d.py:
//   residual, apply_op -> plocal2d_residual_bf16 (mg::presidual_kernel,
//                         :262 and :982)
//   residual_norm_sq   -> plocal2d_resnorm_bf16  (mg::presnorm_partial,
//                         mg::sum_partials; :855)
//
// u and b are bfloat16; each load widens to float32 (the JAX kernels widen
// at plocal2d.py:201-202 and :917-918), sigma and 1/h^2 are float32, the
// residual and the apply round each point once, to nearest even, on its
// store, and the norm sums the float32 residual's squares in float64 and
// returns a float32 sum, as the TPU kernel's. These are plocal2d.cu's
// kernels with S = bfloat16, on the tile's PRect and mg::tile_inner: the
// scalar residual, a thread a lane (the word kernel of packed2d_bf16.cu
// takes a whole grid only, whose rows start on alternate parities).
// What bounds them: device memory, half plocal2d.cu's float32 bytes (the
// residual 6 bytes a point, the apply 4, the norm 4 or, red only, 3).
#include "packed_tile.cuh"

extern "C" {

// has_b: 1 the residual b - (A - sigma I) u, 0 the apply (A - sigma I) u
// (b unused).
int mg_plocal2d_residual_bf16(const void* u, const void* b, void* out, int R,
                              int C, int n, int row_off, int col_off,
                              double h, double sigma, int has_b,
                              void* stream) {
  const mg::PRect a{R, C, row_off, col_off};
  const mg::InteriorBox upd = mg::tile_inner(a, n);
  return mg::launch_presidual<float, mg::InteriorBox, __nv_bfloat16>(
      u, b, out, a, upd, h, sigma, has_b, stream);
}

// The owned box [qlo, qhi) x [slo, shi) is in tile rows and (unpacked)
// tile columns; out[0] is float32.
int mg_plocal2d_resnorm_bf16(const void* u, const void* b, void* partial,
                             void* out, int R, int C, int n, int row_off,
                             int col_off, int qlo, int qhi, int slo, int shi,
                             double h, double sigma, int red_only, int blocks,
                             void* stream) {
  const mg::PRect a{R, C, row_off, col_off};
  const mg::InteriorBox upd = mg::tile_inner(a, n);
  return mg::launch_presnorm<float, mg::InteriorBox, __nv_bfloat16>(
      u, b, partial, out, a, upd, qlo, qhi, slo, shi, h, sigma, red_only,
      blocks, stream);
}

}  // extern "C"

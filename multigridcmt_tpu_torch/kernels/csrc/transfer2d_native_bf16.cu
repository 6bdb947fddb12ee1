// The native bfloat16 residual restriction: one launch, one pass over the
// fine grid, as the float one (transfer2d.cu): packed2d_legs.cuh's down
// stream on the unpacked frame at K = 0, with no store of u' and no sigma
// u term, the native arithmetic (T = Nb: every operation rounded to
// bfloat16, the host's constants) and bfloat16 storage,
// native_residual_restrict_kernel.
//
// Replaces the bfloat16 mode of the TPU kernel
// multigridcmt_tpu/kernels/transfer2d.py:
//   residual_restrict -> native2d_residual_restrict (:371)
// (kernels/native_bf16.py states the rule and JAX's order): the residual
// b - au, au = ((((4 u - up) - down) - left) - right) * inv_h2, at every
// interior point, with no sigma u term (transfer2d.py:265; residual_of
// without SHIFT, which at sigma = 0 is not the same bits: -0 + 0 u is +0
// where u > 0, and 0 u is NaN where u is +-Inf), full weighting over rows,
// then columns ((0.25 lo + 0.5 mid) + 0.25 hi, each operation rounded,
// weigh), the coarse ring 0.
//
// What bounds it on the card: device-memory traffic (u and b read once,
// the quarter-size rc written: 4.5 bytes a fine point, 0.0056 ms at 2047^2
// on an H100), or the instructions a point issues, if they take longer:
// the residual's 7 operations a point and the weighting's 15 a coarse
// point, each a float32 operation and a rounding (PERF.md has the
// prediction beside the times). It replaces native_bf16.cu's kernel of a
// thread a coarse point, whose nine fine residuals of five loads each came
// from the cache.
//
// The stream is the native down leg's (fused2d_native_bf16.cu's note)
// without its stages and its fine store; the launch geometry is the
// zero-sweep down leg's, fused2d.leg_geometry("down", n, "rbgs", 0).
#include "packed2d_legs.cuh"

namespace {

__global__ void __launch_bounds__(kLegWarps * kWarp)
native_residual_restrict_kernel(const bf16* __restrict__ u,
                                const bf16* __restrict__ b,
                                bf16* __restrict__ rc, Unpacked f,
                                mg::Coef<Nb> cf, LegGeom g) {
  down_stream<Nb, mg::kRbgs, 0, false, Unpacked, bf16, bf16, false>(
      u, b, nullptr, rc, f, cf, 0, g);
}

}  // namespace

extern "C" {

// u, b: (n+2)^2 bfloat16, each starting on a 4-byte pair; rc: ((n-1)/2 +
// 2)^2 bfloat16; inv_h2: a bfloat16 value; geometry: the zero-sweep
// fused2d.leg_geometry("down", ...)'s 7 ints (halos of 2 rows above, 1
// below and 1 lane).
int mg_native2d_residual_restrict_bf16(const void* u, const void* b,
                                       void* rc, int n, double inv_h2,
                                       const int* geom, void* stream) {
  const Unpacked f{n};
  LegGeom g;
  if (!leg_geom(geom, f, &g) || g.top < 2 || g.bottom < 1 || g.hp < 1 ||
      !on_pairs<bf16>(u, b, u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  native_residual_restrict_kernel<<<leg_blocks(g), kLegWarps * kWarp, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(u), static_cast<const bf16*>(b),
      static_cast<bf16*>(rc), f, native_coef(0.0, inv_h2, 0.0, 0.0, 0.0), g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

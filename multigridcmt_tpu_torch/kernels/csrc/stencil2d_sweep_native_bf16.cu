// The native bfloat16 RB-GS sweeps of a whole grid: one launch, one pass,
// as the float sweeps (stencil2d_sweep.cu): packed2d_legs.cuh's sweep
// stream (the up leg's stream without its coarse operand) on the unpacked
// frame with the native arithmetic (T = Nb: every operation rounded to
// bfloat16, the host's constants) and bfloat16 storage,
// native_sweep_kernel, a kernel for each stage count (K = 2 nu half-sweeps,
// nu = 1 .. 4).
//
// Replaces the bfloat16 mode of the TPU kernel
// multigridcmt_tpu/kernels/stencil2d.py:
//   rbgs_sweep -> stencil2d_sweep_native (:284)
// on a whole (n+2)^2 grid (kernels/native_bf16.py states the rule and
// JAX's order): red, then black points take ((((h2 b + up) + down) + left)
// + right) * inv_den, each operation rounded; the ghosts keep u's values.
// The Jacobi kind runs the same stream from its own file
// (stencil2d_jacobi_native_bf16.cu); a shard's tile at an offset (local2d)
// keeps native_bf16.cu's launches.
//
// What bounds it on the card: device-memory traffic (u and b read once, u'
// written once: 6 bytes a point, 0.0075 ms at 2047^2 on an H100), or the
// instructions a point issues, if they take longer: each operation is a
// float32 operation and a rounding (one cvt), a half-sweep's update 6 of
// them a point (PERF.md has the prediction beside the times). It replaces
// native_bf16.cu's launch a colour a sweep, 2 nu passes over the grid.
//
// The stream is the float sweeps' on the native legs' loads and stores
// (fused2d_native_bf16.cu's note): lane l holds columns 2l and 2l + 1, on
// an even row one aligned 4-byte word (the launcher takes arrays that start
// on one), rows in flight in bfloat16 rings widened in the step that first
// reads them, gs_value in the plain versions' order on Nb. A NaN or Inf
// spreads only through the stencil, as in the plain version. The launch
// geometry is fused2d.leg_geometry("sweep", ...), whose halos the launcher
// checks.
#include "packed2d_legs.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(kLegWarps * kWarp)
native_sweep_kernel(const bf16* __restrict__ u, const bf16* __restrict__ b,
                    bf16* __restrict__ out, Unpacked f, mg::Coef<Nb> cf,
                    LegGeom g) {
  // e's type is bfloat16, as the native up leg's; the sweep never reads it.
  up_stream<Nb, mg::kRbgs, K, false, false, Unpacked, bf16, bf16, bf16>(
      u, nullptr, b, out, f, cf, g);
}

// The kernel of `stages` half-sweeps, 2 .. kMaxUpStages.
template <int K = 2>
int launch_k(int stages, const bf16* u, const bf16* b, bf16* out,
             const Unpacked& f, const mg::Coef<Nb>& cf, const LegGeom& g,
             cudaStream_t stream) {
  if constexpr (K > kMaxUpStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (stages != K) {
      return launch_k<K + 2>(stages, u, b, out, f, cf, g, stream);
    }
    native_sweep_kernel<K><<<leg_blocks(g), kLegWarps * kWarp, 0, stream>>>(
        u, b, out, f, cf, g);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

extern "C" {

// u, b, out: (n+2)^2 bfloat16, each starting on a 4-byte pair; h2 .. coef:
// native_bf16.constants' five bfloat16 values; sweeps: 1 .. 4; geometry:
// fused2d.leg_geometry("sweep", ...)'s 7 ints (halos of 2 nu rows and nu
// lanes).
int mg_stencil2d_sweep_native_bf16(const void* u, const void* b, void* out,
                                   int n, double h2, double inv_h2,
                                   double sig, double inv_den, double coef,
                                   int sweeps, const int* geom,
                                   void* stream) {
  const Unpacked f{n};
  const int K = leg_stages(mg::kRbgs, sweeps);
  LegGeom g;
  if (K < 1 || !leg_geom(geom, f, &g) || g.top < K || g.bottom < K ||
      2 * g.hp < K || !on_pairs<bf16>(u, b, out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_k(K, static_cast<const bf16*>(u), static_cast<const bf16*>(b),
                  static_cast<bf16*>(out), f,
                  native_coef(h2, inv_h2, sig, inv_den, coef), g,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"

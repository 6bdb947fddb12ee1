// The native bfloat16 Jacobi sweeps of a whole grid: one launch, one pass,
// as the float sweeps (stencil2d_sweep.cu): packed2d_legs.cuh's sweep
// stream (the up leg's stream without its coarse operand) on the unpacked
// frame with the native arithmetic (T = Nb: every operation rounded to
// bfloat16, the host's constants) and bfloat16 storage,
// native_jacobi_sweep_kernel, a kernel for each stage count (K = nu
// sweeps, 1 .. 8). The RB-GS twin is stencil2d_sweep_native_bf16.cu; the
// two files compile in parallel.
//
// Replaces the bfloat16 mode of the TPU kernel
// multigridcmt_tpu/kernels/stencil2d.py:
//   jacobi_sweep -> stencil2d_jacobi_native (:295)
// on a whole (n+2)^2 grid (kernels/native_bf16.py states the rule and
// JAX's order): every interior point takes u + coef r, r = (b - au) + sig u,
// au = ((((4 u - up) - down) - left) - right) * inv_h2, each operation
// rounded (jacobi_step and residual_of on Nb); the ghosts keep u's values.
// A shard's tile at an offset (local2d) keeps native_bf16.cu's launches.
//
// What bounds it on the card: device-memory traffic (u and b read once, u'
// written once: 6 bytes a point, 0.0075 ms at 2047^2 on an H100), or the
// instructions a point issues, if they take longer: a sweep's update is 11
// rounded operations a point, nu of them in turn, and the stream computes
// its halo rows and lanes again in each unit (at nu = 8 some 1.7 to 3.7
// times the grid's points, by level). With Nb's own arithmetic (a float32
// operation, then a cvt to round it) the cvts bound it, their pipe an
// eighth of the float32 adds' rate: 3.6% of the bytes bound at 2047^2,
// slower than the kernel it replaces (PERF.md, P30-1). So each stage works
// on the word of a lane's two points (jacobi_pair): one sm_90 bfloat16x2
// add, sub or mul an operation for both, each half rounded once, which are
// Nb's bits. It replaces native_bf16.cu's launch a sweep, which made nu
// passes over the grid (48 bytes a point at nu = 8) through a scratch
// grid; this one makes one pass and takes no scratch grid.
//
// The stream is the RB-GS sweeps' (stencil2d_sweep_native_bf16.cu's note):
// lane l holds columns 2l and 2l + 1, on an even row one aligned 4-byte
// word (the launcher takes arrays that start on one), rows in flight in
// bfloat16 rings widened in the step that first reads them; Jacobi stage k
// reads stage k - 1's window (smooth_step). A NaN or Inf spreads only
// through the stencil, as in the plain version: the points a stage does not
// set are selected, never multiplied. The launch geometry is
// fused2d.leg_geometry("sweep", n, "jacobi", nu), whose halos (nu rows and
// ceil(nu/2) lanes) the launcher checks.
#include "packed2d_legs.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(kLegWarps * kWarp)
native_jacobi_sweep_kernel(const bf16* __restrict__ u,
                           const bf16* __restrict__ b,
                           bf16* __restrict__ out, Unpacked f,
                           mg::Coef<Nb> cf, LegGeom g) {
  // e's type is bfloat16, as the native up leg's; the sweep never reads it.
  // PAIRED: each stage on the word of a lane's two points (jacobi_pair).
  up_stream<Nb, mg::kJacobi, K, false, false, Unpacked, bf16, bf16, bf16,
            true>(u, nullptr, b, out, f, cf, g);
}

// The kernel of `stages` sweeps, 1 .. kMaxUpStages.
template <int K = 1>
int launch_k(int stages, const bf16* u, const bf16* b, bf16* out,
             const Unpacked& f, const mg::Coef<Nb>& cf, const LegGeom& g,
             cudaStream_t stream) {
  if constexpr (K > kMaxUpStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (stages != K) {
      return launch_k<K + 1>(stages, u, b, out, f, cf, g, stream);
    }
    native_jacobi_sweep_kernel<K>
        <<<leg_blocks(g), kLegWarps * kWarp, 0, stream>>>(u, b, out, f, cf,
                                                          g);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

extern "C" {

// u, b, out: (n+2)^2 bfloat16, each starting on a 4-byte pair; h2 .. coef:
// native_bf16.constants' five bfloat16 values; sweeps: 1 .. 8; geometry:
// fused2d.leg_geometry("sweep", ...)'s 7 ints (halos of nu rows and
// ceil(nu/2) lanes).
int mg_stencil2d_jacobi_native_bf16(const void* u, const void* b, void* out,
                                    int n, double h2, double inv_h2,
                                    double sig, double inv_den, double coef,
                                    int sweeps, const int* geom,
                                    void* stream) {
  const Unpacked f{n};
  const int K = leg_stages(mg::kJacobi, sweeps);
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

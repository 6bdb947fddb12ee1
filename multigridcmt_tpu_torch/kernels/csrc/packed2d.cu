// Colour-packed kernels for the finest 2D levels: the down leg, the fused
// residual norm of the convergence check and the residual (the up leg in
// packed2d_up.cu and packed2d_up_f64.cu, the fused RB-GS sweeps in
// packed2d_sweep.cu).
//
// Replace the TPU kernels multigridcmt_tpu/kernels/packed2d.py:
//   smooth_residual_restrict -> packed2d_down     (down_kernel, :839)
//   prolong_add_smooth       -> packed2d_up       (up_kernel, :1067;
//                                                 packed2d_up.cu)
//   residual_norm_sq         -> packed2d_resnorm  (mg::presnorm_partial,
//                                                 mg::sum_partials)
//   residual                 -> packed2d_residual (mg::presidual_kernel)
//   rbgs_sweep               -> packed2d_rbgs     (sweep_kernel, :305;
//                                                 packed2d_sweep.cu)
//
// Layout: packed_tile.cuh's, the whole padded grid of P = n+2 (odd) points
// a side as the rectangle at (0, 0) (mg::PRect{P, P, 0, 0}): two planes
// (2, P, cp), cp = (P+1)/2, each row packed along lanes with a row-parity
// offset, as in the TPU module:
//   R[i][l] = u[i][2l + (i&1)]          B[i][l] = u[i][2l + 1 - (i&1)]
// A row's lane past its last point of that colour is a pad and stays 0. The
// neighbour algebra (sums in packed_tile.cuh's order), the residual and the
// norm are packed_tile.cuh's, shared with the shard tiles of plocal2d.cu.
// After an RB-GS sweep the closing black half-sweep zeroes the black
// residual (exactly in exact arithmetic), so the down leg restricts the red
// residual only and the norm can sum the red plane only, as on the TPU.
//
// The legs (packed2d_legs.cuh). What bounds them: device memory, 12-13
// bytes a point in float32 (u and b in, u' and the quarter-size coarse
// residual out, or x, b and the correction in and x' out: 0.0652 ms at
// 4095^2 on an H100), if the work a point does between its loads and its
// stores costs less than that. A first port (a 32 x 64 tile a block with a
// halo of 2 nu + 2 rows, loaded, smoothed half-sweep by half-sweep with a
// barrier between, stored) ran at 16-23% of the bound: the halo made every
// pass 1.4-1.6 times the core, every pass divided a flat index by the
// tile's pitch, and nothing overlapped a block's loads with its work.
//
// The design: the TPU kernels stream full-width row bands; here each warp
// streams one strip of 32 lanes (its core plus hp halo lanes a side) down a
// segment of rows, one row a step, in registers. Each lane keeps a window
// of rows of both planes of u (or x) and b (kWin, a power of two) and loads
// rows kAhead steps before it needs them. In step t row t arrives (the up
// leg adds P e to it from the coarse rows it keeps), smoothing stage k (a
// half-sweep or a Jacobi sweep) works on row t - 1 - k, the down leg's
// residual on row t - K - 1 and its full weighting on the coarse row of
// fine row t - K - 2, and the finished row is stored. Stages run in this
// order within a step, so a stage finds the row below it done earlier in
// the same step, and RB-GS updates in place in a sequential sweep's order.
// The up and down neighbours are registers of the same lane, the side
// neighbour a shuffle; the loop over a window's steps is unrolled, so every
// window slot and every row's parity is a compile-time constant, and one
// kernel is compiled for each stage count; in RB-GS a window's steps run
// without row tests where all their rows lie inside the unit, which lets
// the compiler schedule across stages. No shared memory, no barrier;
// rows are recomputed only at segment ends and lanes at strip edges. The
// launch geometry (packed2d.py's leg_geometry, held against the emulated
// schedule and against packed2d_legs.cuh's constants by the CPU tests) is
// passed in as 7 ints; the launchers refuse one whose strip and halo do
// not fill a warp or whose rows start odd. Every lane of a warp runs
// every shuffle: row tests are the same for the whole warp, and lane tests
// select a result after it.
#include "packed2d_legs.cuh"

namespace {

// The whole padded grid as a packed array (packed_tile.cuh's kernels).
mg::PRect whole(int n) { return mg::PRect{n + 2, n + 2, 0, 0}; }

template <typename T>
int launch_resnorm(const void* u, const void* b, void* partial, void* out,
                   int n, double h, double sigma, int red_only, int blocks,
                   void* stream) {
  return mg::launch_presnorm<T>(u, b, partial, out, whole(n),
                                mg::Interior{n}, 1, n + 1, 0, n + 2, h,
                                sigma, red_only, blocks, stream);
}

// The residual on both planes, ghosts and pad lanes 0, so whole-array dots
// over packed grids (the CG recurrence) are interior dots.
template <typename T>
int launch_residual(const void* u, const void* b, void* r, int n, double h,
                    double sigma, void* stream) {
  return mg::launch_presidual<T>(u, b, r, whole(n), mg::Interior{n}, h,
                                 sigma, true, stream);
}

}  // namespace

extern "C" {

int mg_packed2d_down_f32(const void* u, const void* b, void* u_out, void* rc,
                         int n, double h, double sigma, int kind, double omega,
                         int sweeps, int packed_coarse, const int* geom,
                         void* stream) {
  return launch_down<float, kMaxDownStages>(u, b, u_out, rc, Whole{n}, h,
                                            sigma, kind, omega, sweeps,
                                            packed_coarse, geom, stream);
}

int mg_packed2d_down_f64(const void* u, const void* b, void* u_out, void* rc,
                         int n, double h, double sigma, int kind, double omega,
                         int sweeps, int packed_coarse, const int* geom,
                         void* stream) {
  return launch_down<double, kMaxDownStages>(u, b, u_out, rc, Whole{n}, h,
                                             sigma, kind, omega, sweeps,
                                             packed_coarse, geom, stream);
}

int mg_packed2d_resnorm_f32(const void* u, const void* b, void* partial,
                            void* out, int n, double h, double sigma,
                            int red_only, int blocks, void* stream) {
  return launch_resnorm<float>(u, b, partial, out, n, h, sigma, red_only,
                               blocks, stream);
}

int mg_packed2d_resnorm_f64(const void* u, const void* b, void* partial,
                            void* out, int n, double h, double sigma,
                            int red_only, int blocks, void* stream) {
  return launch_resnorm<double>(u, b, partial, out, n, h, sigma, red_only,
                                blocks, stream);
}

int mg_packed2d_residual_f32(const void* u, const void* b, void* r, int n,
                             double h, double sigma, void* stream) {
  return launch_residual<float>(u, b, r, n, h, sigma, stream);
}

int mg_packed2d_residual_f64(const void* u, const void* b, void* r, int n,
                             double h, double sigma, void* stream) {
  return launch_residual<double>(u, b, r, n, h, sigma, stream);
}

}  // extern "C"

// The fused RB-GS sweeps of the packed2d tier: packed2d_legs.cuh's sweep
// stream on the whole packed grid (Whole), a kernel for each stage count,
// in a file of its own so that it compiles beside the legs.
//
// Replaces the TPU kernel multigridcmt_tpu/kernels/packed2d.py:
//   rbgs_sweep -> packed2d_rbgs (sweep_kernel, :305)
// the smoothing of a packed level whose leg has more sweeps than a fused
// leg takes (RB-GS V(4,4): one 4-sweep launch a down leg), and the kernel
// of the smoother figure (one sweep at 4095^2).
//
// What bounds it: device memory, u and b in and u' out, 12 bytes a point
// in float32 whatever the sweep count (0.0601 ms at 4095^2 on an H100), if
// the 6 flops a point a sweep cost less. A first port (a 32 x 64
// shared-memory tile a block with a halo of 2 nu rows, a barrier a
// half-sweep) ran at 11% of it at nu = 4: the halo made each block load
// 1.9 times its core, and the half-sweeps waited on each other.
//
// The design is the up leg's row stream without its coarse operand
// (packed2d.cu's note): each warp streams a 32-lane strip down a segment of
// rows, half-sweep k one row behind half-sweep k - 1, every stage in
// registers, no shared memory and no barrier; rows are recomputed only at
// segment ends (2 nu a side) and lanes at strip edges (nu a side). Sums
// run in packed_tile.cuh's order (nsum), as in the legs. The geometry is
// packed2d.py's leg_geometry("sweep", ...): the up leg's.
#include "packed2d_legs.cuh"

extern "C" {

// u, b, out: packed (2, n+2, (n+3)/2); sweeps RB-GS sweeps (2 sweeps
// stages); geometry: packed2d.leg_geometry's 7 ints.
int mg_packed2d_rbgs_f32(const void* u, const void* b, void* out, int n,
                         double h, double sigma, int sweeps, const int* geom,
                         void* stream) {
  return launch_sweep<float, kMaxUpStages, false>(
      u, b, out, Whole{n}, h, sigma, mg::kRbgs, 1.0, sweeps, geom, stream);
}

int mg_packed2d_rbgs_f64(const void* u, const void* b, void* out, int n,
                         double h, double sigma, int sweeps, const int* geom,
                         void* stream) {
  return launch_sweep<double, kMaxUpStages, false>(
      u, b, out, Whole{n}, h, sigma, mg::kRbgs, 1.0, sweeps, geom, stream);
}

}  // extern "C"

// The whole V-cycle legs of the unpacked 2D levels: one launch, one pass
// over the fine grid, per leg. This file instantiates the down leg,
// fused2d_up.cu and fused2d_up_f64.cu the up leg, so that the three
// compile in parallel: packed2d_legs.cuh's row-streaming down_kernel and
// up_kernel on the unpacked frame (Unpacked), a kernel for each stage
// count.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/fused2d.py:
//   smooth_residual_restrict -> fused2d_down (down_kernel, :289)
//   prolong_add_smooth       -> fused2d_up   (up_kernel, :479)
//
// What bounds them on the card: device-memory traffic, if the work a point
// does between its loads and its stores costs less: read u and b, write u'
// and the quarter-size coarse residual (down), or read x, b and the
// quarter-size correction and write x' (up), 12-13 bytes a point in
// float32 (0.0163 ms at 2047^2 on an H100).
//
// The design is packed2d.cu's row stream (see its note): each warp streams
// a strip of 32 lanes down a segment of rows, every stage in registers one
// row apart, no shared memory and no barrier. The colour-packed grid holds
// a row's two colours in two planes; here the same frame lane l holds
// columns 2l and 2l + 1 of the logical grid, which are adjacent in memory,
// and the colour-c point of row i is the one at column 2l + ((c + i) & 1),
// so the stages' algebra is the packed legs' unchanged. The row pitch
// n + 2 is odd: a lane's two points form one aligned pair on even rows
// only, where it loads and stores them as one access (two scalar ones on
// odd rows; the fine arrays must start on a pair, which fused2d.py
// ensures), and the last lane's phase-1 point (column n + 2) reads 0 and
// is not stored. Three things differ from the packed legs: the down leg's
// residual is taken at every interior point (the black one too, as JAX's
// fused2d kernel does), each stencil is summed in the plain versions'
// order (gs_value, residual_of), and the coarse grids are always logical.
// The launch geometry is packed2d.py's leg_geometry on this frame
// (fused2d.py passes its rows and lanes, and its own least segment).
#include "packed2d_legs.cuh"

extern "C" {

// u, b, u_out: (n+2)^2; rc: ((n-1)/2 + 2)^2; geometry:
// packed2d.leg_geometry's 7 ints.
int mg_fused2d_down_f32(const void* u, const void* b, void* u_out, void* rc,
                        int n, double h, double sigma, int kind, double omega,
                        int sweeps, const int* geom, void* stream) {
  return launch_down<float, kMaxDownStages>(
      u, b, u_out, rc, Unpacked{n}, h, sigma, kind, omega, sweeps, 0, geom,
      stream);
}

int mg_fused2d_down_f64(const void* u, const void* b, void* u_out, void* rc,
                        int n, double h, double sigma, int kind, double omega,
                        int sweeps, const int* geom, void* stream) {
  return launch_down<double, kMaxDownStages>(
      u, b, u_out, rc, Unpacked{n}, h, sigma, kind, omega, sweeps, 0, geom,
      stream);
}

}  // extern "C"

// The fused RB-GS and Jacobi sweeps of the unpacked 2D levels in float32:
// packed2d_legs.cuh's sweep stream on the logical padded grid (Unpacked), a
// kernel for each kind and stage count; stencil2d_sweep_f64.cu holds the
// float64 ones, so that the two compile in parallel.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/stencil2d.py:
//   rbgs_sweep, jacobi_sweep -> stencil2d_sweep (sweep_kernel, :284, :295)
// the smoothing of a level whose leg has more sweeps than a fused leg takes
// (RB-GS V(4,4): one 4-sweep launch a down leg at 2047...255; Jacobi V(8,8):
// one 8-sweep launch at 1023...255).
//
// What bounds them: device memory, u and b in and u' out, 12 bytes a point
// in float32 whatever the sweep count (0.0150 ms at 2047^2 on an H100), if
// the 6 (RB-GS) or 10 (Jacobi) flops a point a sweep cost less; at 1023^2
// and below, too few rows fill the card, and a unit's rows run in turn
// (fused2d.MIN_SEG). A first port (a 32 x 64 shared-memory tile a block
// with a halo of 2 nu (RB-GS) or nu (Jacobi) rings, a barrier a stage) ran
// at 4.5-12% of the bound.
//
// The design is packed2d_sweep.cu's, the up leg's row stream without its
// coarse operand, on fused2d.cu's unpacked frame: lane l holds columns 2l
// and 2l + 1 (one aligned pair on even rows; the arrays must start on a
// pair, which stencil2d.py ensures), and each stencil is summed in the
// plain versions' order (gs_value, residual_of), so that at sigma = 0 and h
// a power of two the RB-GS sweeps round as the plain path does. Ghosts keep
// u's values. The geometry is packed2d.py's leg_geometry("sweep", ...) on
// this frame (stencil2d.py passes fused2d's rows, lanes and least segment).
#include "packed2d_legs.cuh"

extern "C" {

// u, b, out: (n+2)^2; kind: mg::Kind; geometry: packed2d.leg_geometry's 7
// ints.
int mg_stencil2d_sweep_f32(const void* u, const void* b, void* out, int n,
                           double h, double sigma, int kind, double omega,
                           int sweeps, const int* geom, void* stream) {
  return launch_sweep<float, kMaxUpStages, true>(
      u, b, out, Unpacked{n}, h, sigma, kind, omega, sweeps, geom, stream);
}

}  // extern "C"

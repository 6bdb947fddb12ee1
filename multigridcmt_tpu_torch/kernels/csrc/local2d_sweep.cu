// The local2d RB-GS and Jacobi sweeps in float32: packed2d_legs.cuh's sweep
// stream on a shard's unpacked extended tile (the UTile frame), a kernel for
// each kind and stage count; local2d_sweep_f64.cu holds the float64 ones, so
// that the two compile in parallel with the leg files.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/local2d.py:
//   rbgs_sweep, jacobi_sweep -> local2d_sweep (sweep_kernel on a UTile
//                               frame, :263, :278)
// the smoothing of a sharded level whose leg has more sweeps than the whole
// local2d legs take (config 5's composed routes: RB-GS V(4,4), one 4-sweep
// launch a leg; Jacobi V(8,8), one 8-sweep launch).
//
// What bounds them: device memory, u and b in and u' out, 12 bytes a point
// in float32 whatever the sweep count (0.0603 ms at config 5's 4095^2 tile,
// 4112 x 4097, on an H100), if the 6 (RB-GS) or 10 (Jacobi) flops a point
// a sweep cost less; on the tiles of 1023^2 and below too few rows fill the
// card, and a unit's rows run in turn (local2d.MIN_SEG). A first port (a
// 32 x 64 shared-memory tile a block with a halo of 2 nu (RB-GS) or nu
// (Jacobi) rings, a barrier a stage) ran at 9-15% of the bound.
//
// The design is stencil2d_sweep.cu's, the up leg's row stream without its
// coarse operand, on local2d_legs.cu's unpacked tile frame: global rows from
// the tile's first row (the row above an odd one streamed as zeros, so that
// every unit starts on an even row), updates only off the tile's outer ring
// and inside the global interior (the ghosts keep u's values), each stencil
// summed and the Jacobi step rounded as the plain versions do (so that at
// sigma = 0 and h a power of two the sweeps round as local2d's plain
// versions, bit for bit), and paired accesses on the odd rows where
// utile_frame finds them aligned. The sweeps take any offsets, odd or even,
// as the wrappers do: the frame derives its first row and its pairing from
// them. The frame's coarse tile is empty: the sweep stream never reads it.
// The geometry is packed2d.py's leg_geometry("sweep", ...) on this frame
// (local2d.leg_geometry).
#include "packed2d_legs.cuh"

extern "C" {

// u, b, out: the R x C tile at global (row_off, col_off); kind: mg::Kind;
// geometry: local2d.leg_geometry("sweep", ...)'s 7 ints.
int mg_local2d_sweep_f32(const void* u, const void* b, void* out, int R,
                         int C, int n, int row_off, int col_off, double h,
                         double sigma, int kind, double omega, int sweeps,
                         const int* geom, void* stream) {
  const UTile f = utile_frame(mg::Rect{R, C, row_off, col_off},
                              mg::Rect{0, 0, 0, 0}, n, 0, 0, 0, 0,
                              on_pairs<float>(u, b, out));
  return launch_sweep<float, kMaxUpStages, true>(u, b, out, f, h, sigma, kind,
                                                 omega, sweeps, geom, stream);
}

}  // extern "C"

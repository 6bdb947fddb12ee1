// Colour-packed shard-local kernels on one rank's halo-extended tile: the
// residual and the operator apply and the fused residual norm of the
// sharded solve's convergence check here; the whole down and up legs in
// plocal2d_legs.cu and plocal2d_legs_f64.cu, on packed2d_legs.cuh's row
// stream.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/plocal2d.py:
//   residual, apply_op  -> plocal2d_residual (mg::presidual_kernel, one
//                          body with or without the b stream)
//   down_leg            -> plocal2d_down     (down_kernel on a Tile frame)
//   up_leg              -> plocal2d_up       (up_kernel on a Tile frame)
//   residual_norm_sq    -> plocal2d_resnorm  (mg::presnorm_partial,
//                          mg::sum_partials)
// (the residual's, the apply's and the norm's bfloat16 modes in
// plocal2d_bf16.cu, the legs' in plocal2d_legs_bf16.cu and
// plocal2d_up_bf16_f32.cu)
//
// A tile is local2d.cu's extended tile (an R x C rectangle of the global
// padded grid at global (row_off, col_off), kernels/local2d.py) stored
// colour-packed: mg::PRect{R, C, row_off, col_off}, two planes of R x
// (C+1)/2 lanes (packed_tile.cuh says how lanes hold points). The phase of
// a row comes from the global row and column offsets, so a block
// decomposition's odd col_off flips it. As in local2d.cu, a point is
// updated only if it is interior to the global grid and off the tile's
// outer ring (mg::tile_inner), and coarse data crosses in local2d's
// unpacked extended convention (mg::Rect): the down leg writes the full
// weighting on the coarse tile's owned box and 0 elsewhere, the up leg
// reads the correction as 0 off the coarse tile. After an RB-GS sweep the
// down leg restricts the red residual only, as the TPU kernel does.
//
// What bounds them on the card: device-memory traffic (a leg reads u and b
// and writes u' and the quarter-size coarse tile, 13 bytes a point in
// float32; the residual 12, the apply 8, the norm 8 or, red only, 6). The
// norm counts each owned point once: its first pass walks the owned rows
// and lanes, not overlapping windows.
//
// The legs run packed2d.cu's design (a warp streams a 32-lane strip down a
// segment of rows in registers; packed2d.cu's note) on the Tile frame of
// packed2d_legs.cuh, in global rows and the frame's lanes:
//  * rows: the tile's first row, row_off, is odd (d m + 1 - HALO_ROWS), but
//    the stream's slots and parities assume units start on an even global
//    row; the first segment starts one row above the tile and streams that
//    row as zeros (one step more for that segment, no extra kernels to
//    build), the others start on even rows. A coarse point's fine row is
//    even in global rows, odd in the tile.
//  * columns: on a block tile (col_off odd) the array's lanes start on an
//    odd global column; the frame's lanes start one column to the left, so
//    each frame lane reads its phase-0 point from the array lane before
//    its phase-1 point's (the loads of one plane move by one lane) and the
//    restriction and prolongation pair lanes and phases as on the whole
//    grid. The frame has one lane more than the array.
//  * the updated points: the global interior off the tile's ring, in rows
//    and columns (rank 0's tile starts 7 rows above the grid).
//  * every output entry once: u' over the whole tile (ghost and ring rows
//    as smoothed or kept, pad lanes as loaded, 0); rc's owned box by the
//    restriction, the rest of the coarse tile (its ghost bands, which map
//    to no fine row of the tile in part, and a block tile's columns off
//    the owned box) zeroed by all the launch's warps before they stream.
//  * the up leg reads e on the coarse tile at (coarse_offset(row_off),
//    ccol), 0 off it, and adds P e at every global-interior point, the
//    tile's ring included; both legs take local2d's sweep caps (6 stages),
//    fewer than the whole grid's up leg (8).
//  * the geometry: plocal2d.leg_geometry (packed2d's, on the tile's rows
//    from row_off and the frame's lanes), cached for each card; the
//    launchers refuse one that does not cover the frame.
#include "packed_tile.cuh"

extern "C" {

// has_b: 1 the residual b - (A - sigma I) u, 0 the apply (A - sigma I) u
// (b unused).
int mg_plocal2d_residual_f32(const void* u, const void* b, void* out, int R,
                             int C, int n, int row_off, int col_off, double h,
                             double sigma, int has_b, void* stream) {
  const mg::PRect a{R, C, row_off, col_off};
  return mg::launch_presidual<float>(u, b, out, a, mg::tile_inner(a, n), h,
                                     sigma, has_b, stream);
}

int mg_plocal2d_residual_f64(const void* u, const void* b, void* out, int R,
                             int C, int n, int row_off, int col_off, double h,
                             double sigma, int has_b, void* stream) {
  const mg::PRect a{R, C, row_off, col_off};
  return mg::launch_presidual<double>(u, b, out, a, mg::tile_inner(a, n), h,
                                      sigma, has_b, stream);
}

// The owned box [qlo, qhi) x [slo, shi) is in tile rows and (unpacked)
// tile columns.
int mg_plocal2d_resnorm_f32(const void* u, const void* b, void* partial,
                            void* out, int R, int C, int n, int row_off,
                            int col_off, int qlo, int qhi, int slo, int shi,
                            double h, double sigma, int red_only, int blocks,
                            void* stream) {
  const mg::PRect a{R, C, row_off, col_off};
  return mg::launch_presnorm<float>(u, b, partial, out, a,
                                    mg::tile_inner(a, n), qlo, qhi, slo, shi,
                                    h, sigma, red_only, blocks, stream);
}

int mg_plocal2d_resnorm_f64(const void* u, const void* b, void* partial,
                            void* out, int R, int C, int n, int row_off,
                            int col_off, int qlo, int qhi, int slo, int shi,
                            double h, double sigma, int red_only, int blocks,
                            void* stream) {
  const mg::PRect a{R, C, row_off, col_off};
  return mg::launch_presnorm<double>(u, b, partial, out, a,
                                     mg::tile_inner(a, n), qlo, qhi, slo, shi,
                                     h, sigma, red_only, blocks, stream);
}

}  // extern "C"

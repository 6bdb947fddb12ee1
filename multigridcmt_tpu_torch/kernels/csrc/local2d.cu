// The shard-local 2D residual on one rank's halo-extended tile. The sweeps
// are local2d_sweep.cu's, the down and up legs local2d_legs.cu's.
//
// Replaces the TPU kernel multigridcmt_tpu/kernels/local2d.py:
//   residual -> local2d_residual (local_residual_kernel)
//
// A tile is a rectangle of the global padded grid (mg::Rect): R x C points,
// row-major, whose point (0, 0) has global index (goy, gox)
// (kernels/local2d.py says how a rank's extended tile sits in the grid).
// Offsets are arguments, so one build serves every rank. A point's residual
// is taken only if it is interior to the global grid and off the tile's
// outer ring (mg::tile_inner); elsewhere it is 0.
//
// What bounds it on the card: device-memory traffic, u and b in and r out,
// 12 bytes a point in float32 for ~8 flops; one thread a point, the
// neighbours' reads shared through L1.
#include "common.cuh"

namespace {

constexpr int BX = 32;        // block columns
constexpr int BY = 8;         // block rows

// r = b - (A - sigma I) u on the points upd sets, 0 elsewhere on the tile.
template <typename T>
__global__ void __launch_bounds__(BX * BY)
local_residual_kernel(const T* __restrict__ u, const T* __restrict__ b,
                      T* __restrict__ r, mg::Rect a, mg::InteriorBox upd,
                      mg::Coef<T> c) {
  const int lx = blockIdx.x * BX + threadIdx.x;
  const int ly = blockIdx.y * BY + threadIdx.y;
  if (ly >= a.R || lx >= a.C) return;
  const size_t k = static_cast<size_t>(ly) * a.C + lx;
  r[k] = upd(a.goy + ly, a.gox + lx) ? mg::residual_at(u + k, b[k], a.C, c)
                                     : T(0);
}

template <typename T>
int launch_residual(const void* u, const void* b, void* r, mg::Rect a, int n,
                    double h, double sigma, void* stream) {
  const dim3 grid((a.C + BX - 1) / BX, (a.R + BY - 1) / BY);
  local_residual_kernel<T><<<grid, dim3(BX, BY), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b), static_cast<T*>(r),
      a, mg::tile_inner(a, n), mg::Coef<T>::make(h, sigma, 1.0));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// u, b, r: the R x C tile at global (row_off, col_off).
int mg_local2d_residual_f32(const void* u, const void* b, void* r, int R,
                            int C, int n, int row_off, int col_off, double h,
                            double sigma, void* stream) {
  return launch_residual<float>(u, b, r, mg::Rect{R, C, row_off, col_off}, n,
                                h, sigma, stream);
}

int mg_local2d_residual_f64(const void* u, const void* b, void* r, int R,
                            int C, int n, int row_off, int col_off, double h,
                            double sigma, void* stream) {
  return launch_residual<double>(u, b, r, mg::Rect{R, C, row_off, col_off},
                                 n, h, sigma, stream);
}

}  // extern "C"

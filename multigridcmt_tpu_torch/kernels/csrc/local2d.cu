// Shard-local 2D kernels on one rank's halo-extended tile: fused smoother
// sweeps and the residual. The down and up legs are local2d_legs.cu's.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/local2d.py:
//   rbgs_sweep, jacobi_sweep, residual -> local2d_sweep (local_sweep_kernel,
//                                         local_residual_kernel)
//
// A tile is a rectangle of the global padded grid (mg::Rect): R x C points,
// row-major, whose point (0, 0) has global index (goy, gox)
// (kernels/local2d.py says how a rank's extended tile sits in the grid).
// Offsets are arguments, so one build serves every rank. These are
// common.cuh's shared-memory tile kernels on such a tile, over its
// helpers, which work in global indices: interior and red/black colour
// come from them (the colour by `& 1`, the floor parity of a negative
// index as well). A point is updated only if it is interior to the global
// grid and off the tile's outer ring (mg::tile_inner; the ring keeps its
// values).
//
// What bounds them on the card: device-memory traffic, 12 bytes a point a
// sweep launch in float32 for ~6 flops a point a sweep. Every
// intermediate sweep stays in shared memory; each block loads its tile of
// u and b with a halo that covers the sweeps' staleness and writes its
// core.
#include "common.cuh"

namespace {

constexpr int TX = 64;        // core columns per block (even)
constexpr int TY = 32;        // core rows per block (even)
constexpr int THREADS = 256;
constexpr int BX = 32;        // residual block
constexpr int BY = 8;
constexpr int kResidual = 2;  // third mode of local2d_sweep

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

// u' = smooth^sweeps(u), halo H = sweep_halo(kind, sweeps).
template <typename T>
__global__ void __launch_bounds__(THREADS)
local_sweep_kernel(const T* __restrict__ u, const T* __restrict__ b,
                   T* __restrict__ out, mg::Rect a, mg::InteriorBox upd,
                   mg::Coef<T> c, int kind, int sweeps, int H) {
  extern __shared__ unsigned char smem_raw[];
  const int RX = TX + 2 * H;
  const int RY = TY + 2 * H;
  // Global indices may be negative: int arithmetic, not blockIdx's
  // unsigned.
  const int y0 = a.goy + static_cast<int>(blockIdx.y) * TY;
  const int x0 = a.gox + static_cast<int>(blockIdx.x) * TX;
  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + RY * RX;
  T* vs = bs + RY * RX;       // Jacobi ping-pong (RB-GS: unused)

  mg::load_tile(u, us, RY, RX, y0 - H, x0 - H, a);
  mg::load_tile(b, bs, RY, RX, y0 - H, x0 - H, a);
  __syncthreads();
  const T* w = mg::smooth_tile(us, vs, bs, RY, RX, y0 - H, x0 - H, upd, kind,
                               sweeps, c);
  mg::store_core<TY, TX>(w, out, RX, H, y0, x0, a);
}

size_t window_bytes(size_t elem, int kind, int H) {
  const size_t tile = static_cast<size_t>(TY + 2 * H) * (TX + 2 * H);
  return elem * (kind == mg::kJacobi ? 3 : 2) * tile;
}

template <typename T>
int launch_sweep(const void* u, const void* b, void* out, mg::Rect a, int n,
                 double h, double sigma, int mode, double omega, int sweeps,
                 void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const mg::Coef<T> c = mg::Coef<T>::make(h, sigma, omega);
  if (mode == kResidual) {
    const dim3 grid((a.C + BX - 1) / BX, (a.R + BY - 1) / BY);
    local_residual_kernel<T><<<grid, dim3(BX, BY), 0, st>>>(
        static_cast<const T*>(u), static_cast<const T*>(b),
        static_cast<T*>(out), a, mg::tile_inner(a, n), c);
    return static_cast<int>(cudaGetLastError());
  }
  const int H = mg::sweep_halo(mode, sweeps);
  const size_t bytes = window_bytes(sizeof(T), mode, H);
  const int err = mg::set_smem(local_sweep_kernel<T>, bytes);
  if (err != 0) return err;
  const dim3 grid((a.C + TX - 1) / TX, (a.R + TY - 1) / TY);
  local_sweep_kernel<T><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(out), a, mg::tile_inner(a, n), c, mode, sweeps, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mode: 0 Jacobi sweeps, 1 RB-GS sweeps, 2 the residual (sweeps unused).
int mg_local2d_sweep_f32(const void* u, const void* b, void* out, int R,
                         int C, int n, int row_off, int col_off, double h,
                         double sigma, int mode, double omega, int sweeps,
                         void* stream) {
  return launch_sweep<float>(u, b, out, mg::Rect{R, C, row_off, col_off}, n,
                             h, sigma, mode, omega, sweeps, stream);
}

int mg_local2d_sweep_f64(const void* u, const void* b, void* out, int R,
                         int C, int n, int row_off, int col_off, double h,
                         double sigma, int mode, double omega, int sweeps,
                         void* stream) {
  return launch_sweep<double>(u, b, out, mg::Rect{R, C, row_off, col_off},
                              n, h, sigma, mode, omega, sweeps, stream);
}

}  // extern "C"

// Shard-local 2D kernels on one rank's halo-extended tile: fused smoother
// sweeps and the residual, the whole down leg and the whole up leg.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/local2d.py:
//   rbgs_sweep, jacobi_sweep, residual -> local2d_sweep (local_sweep_kernel,
//                                         local_residual_kernel)
//   down_leg                           -> local2d_down  (local_down_kernel)
//   up_leg                             -> local2d_up    (local_up_kernel)
//
// A tile is a rectangle of the global padded grid (mg::Rect): R x C points,
// row-major, whose point (0, 0) has global index (goy, gox)
// (kernels/local2d.py says how a rank's extended tile sits in the grid).
// Offsets are arguments, so one build serves every rank. These are
// common.cuh's shared-memory tile kernels on such a tile, over its
// helpers, which work in global indices: interior and red/black colour
// come from them (the colour by `& 1`, the floor parity of a negative
// index as well). Two things differ. A point is updated only
// if it is interior to the global grid and off the tile's outer ring
// (mg::InteriorBox; the ring keeps its values). And the coarse tile of a
// leg has its own origin: the down leg writes the full weighting on the
// coarse tile's owned box and 0 elsewhere (its ghosts are exchanged by the
// caller), and the up leg reads the correction as 0 off the coarse tile.
//
// What bounds them on the card: the same as the single-device legs
// (fused2d.cu) and sweeps (stencil2d_sweep.cu): device-memory traffic, 12
// bytes a point a sweep launch in float32 for ~6 flops a point a sweep. Every
// intermediate sweep, the residual and the restriction stay in shared
// memory; each block loads its tile of u and b with a halo that covers the
// sweeps' staleness and writes its core.
//
// The down leg's blocks are laid out on the coarse tile: a block owns a
// TY/2 x TX/2 box of coarse points and the TY x TX fine points that belong
// to them (fine points 2I and 2I + 1 of coarse I, in global indices), so
// every coarse value has one writer and every fine point one writer.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int TX = 64;        // core columns per block (even)
constexpr int TY = 32;        // core rows per block (even)
constexpr int THREADS = 256;
constexpr int BX = 32;        // residual block
constexpr int BY = 8;
constexpr int kResidual = 2;  // third mode of local2d_sweep

// The points a kernel on tile a sets: interior to the n x n grid and off
// the tile's outer ring.
mg::InteriorBox inner(const mg::Rect& a, int n) {
  return mg::InteriorBox{n, a.goy + 1, a.goy + a.R - 2, a.gox + 1,
                         a.gox + a.C - 2};
}

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

// Down leg: u' = smooth^sweeps(u); rc = R (b - (A - sigma I) u') where
// keep holds on the coarse tile ca, 0 elsewhere. Halo H = sweep_halo + 2.
template <typename T>
__global__ void __launch_bounds__(THREADS)
local_down_kernel(const T* __restrict__ u, const T* __restrict__ b,
                  T* __restrict__ u_out, T* __restrict__ rc, mg::Rect a,
                  mg::InteriorBox upd, mg::Rect ca, mg::InteriorBox keep,
                  mg::Coef<T> c, int kind, int sweeps, int H) {
  extern __shared__ unsigned char smem_raw[];
  const int RX = TX + 2 * H;
  const int RY = TY + 2 * H;
  // The block's first coarse point is global (ca.goy + q0, ca.gox + s0);
  // its fine core starts at that point's centre.
  const int y0 = 2 * (ca.goy + static_cast<int>(blockIdx.y) * (TY / 2));
  const int x0 = 2 * (ca.gox + static_cast<int>(blockIdx.x) * (TX / 2));
  const int gy0 = y0 - H;
  const int gx0 = x0 - H;

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + RY * RX;
  T* rs = bs + RY * RX;               // residual on the core plus one ring
  T* vs = rs + (TY + 2) * (TX + 2);   // Jacobi ping-pong (RB-GS: unused)

  mg::load_tile(u, us, RY, RX, gy0, gx0, a);
  mg::load_tile(b, bs, RY, RX, gy0, gx0, a);
  __syncthreads();
  const T* w = mg::smooth_tile(us, vs, bs, RY, RX, gy0, gx0, upd, kind,
                               sweeps, c);
  mg::core_residual<TY, TX>(w, bs, rs, RX, H, gy0, gx0, upd, c);
  mg::store_core<TY, TX>(w, u_out, RX, H, y0, x0, a);
  __syncthreads();
  mg::restrict_core<TY, TX>(rs, rc, y0, x0, ca, keep, false);
}

// Up leg: x' = smooth^sweeps(x + P e), P e added at every interior point of
// the window, e the coarse tile ca. Halo H = sweep_halo.
template <typename T>
__global__ void __launch_bounds__(THREADS)
local_up_kernel(const T* __restrict__ x, const T* __restrict__ e,
                const T* __restrict__ b, T* __restrict__ out, mg::Rect a,
                mg::InteriorBox upd, mg::Rect ca, mg::Coef<T> c, int kind,
                int sweeps, int H) {
  extern __shared__ unsigned char smem_raw[];
  const int RX = TX + 2 * H;
  const int RY = TY + 2 * H;
  const int y0 = a.goy + static_cast<int>(blockIdx.y) * TY;
  const int x0 = a.gox + static_cast<int>(blockIdx.x) * TX;
  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + RY * RX;
  T* vs = bs + RY * RX;       // Jacobi ping-pong (RB-GS: unused)

  mg::load_tile_prolonged(x, mg::TileView<T>{e, ca}, b, us, bs, RY, RX,
                          y0 - H, x0 - H, a, upd.n);
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
        static_cast<T*>(out), a, inner(a, n), c);
    return static_cast<int>(cudaGetLastError());
  }
  const int H = mg::sweep_halo(mode, sweeps);
  const size_t bytes = window_bytes(sizeof(T), mode, H);
  const int err = mg::set_smem(local_sweep_kernel<T>, bytes);
  if (err != 0) return err;
  const dim3 grid((a.C + TX - 1) / TX, (a.R + TY - 1) / TY);
  local_sweep_kernel<T><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(out), a, inner(a, n), c, mode, sweeps, H);
  return static_cast<int>(cudaGetLastError());
}

// ca's owned box [qlo, qhi) x [slo, shi) is in coarse tile indices.
template <typename T>
int launch_down(const void* u, const void* b, void* u_out, void* rc,
                mg::Rect a, mg::Rect ca, int n, int qlo, int qhi, int slo,
                int shi, double h, double sigma, int kind, double omega,
                int sweeps, void* stream) {
  const int H = mg::sweep_halo(kind, sweeps) + 2;
  const size_t bytes = window_bytes(sizeof(T), kind, H) +
                       sizeof(T) * static_cast<size_t>(TY + 2) * (TX + 2);
  const int err = mg::set_smem(local_down_kernel<T>, bytes);
  if (err != 0) return err;
  const mg::InteriorBox keep{(n - 1) / 2, ca.goy + qlo, ca.goy + qhi - 1,
                             ca.gox + slo, ca.gox + shi - 1};
  // Enough coarse boxes to cover the coarse tile and, through their fine
  // cores (which start at tile row 2 ca.goy - a.goy <= 0), the fine tile.
  const int sy = 2 * ca.goy - a.goy;
  const int sx = 2 * ca.gox - a.gox;
  const int by = std::max((ca.R + TY / 2 - 1) / (TY / 2),
                          (a.R - sy + TY - 1) / TY);
  const int bx = std::max((ca.C + TX / 2 - 1) / (TX / 2),
                          (a.C - sx + TX - 1) / TX);
  local_down_kernel<T><<<dim3(bx, by), THREADS, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(u_out), static_cast<T*>(rc), a, inner(a, n), ca, keep,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up(const void* x, const void* e, const void* b, void* out,
              mg::Rect a, mg::Rect ca, int n, double h, double sigma,
              int kind, double omega, int sweeps, void* stream) {
  const int H = mg::sweep_halo(kind, sweeps);
  const size_t bytes = window_bytes(sizeof(T), kind, H);
  const int err = mg::set_smem(local_up_kernel<T>, bytes);
  if (err != 0) return err;
  const dim3 grid((a.C + TX - 1) / TX, (a.R + TY - 1) / TY);
  local_up_kernel<T><<<grid, THREADS, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<const T*>(b), static_cast<T*>(out), a, inner(a, n), ca,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H);
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

int mg_local2d_down_f32(const void* u, const void* b, void* u_out, void* rc,
                        int R, int C, int Rc, int Cc, int n, int row_off,
                        int col_off, int crow, int ccol, int qlo, int qhi,
                        int slo, int shi, double h, double sigma, int kind,
                        double omega, int sweeps, void* stream) {
  return launch_down<float>(u, b, u_out, rc, mg::Rect{R, C, row_off, col_off},
                            mg::Rect{Rc, Cc, crow, ccol}, n, qlo, qhi, slo,
                            shi, h, sigma, kind, omega, sweeps, stream);
}

int mg_local2d_down_f64(const void* u, const void* b, void* u_out, void* rc,
                        int R, int C, int Rc, int Cc, int n, int row_off,
                        int col_off, int crow, int ccol, int qlo, int qhi,
                        int slo, int shi, double h, double sigma, int kind,
                        double omega, int sweeps, void* stream) {
  return launch_down<double>(u, b, u_out, rc,
                             mg::Rect{R, C, row_off, col_off},
                             mg::Rect{Rc, Cc, crow, ccol}, n, qlo, qhi, slo,
                             shi, h, sigma, kind, omega, sweeps, stream);
}

int mg_local2d_up_f32(const void* x, const void* e, const void* b, void* out,
                      int R, int C, int Rc, int Cc, int n, int row_off,
                      int col_off, int crow, int ccol, double h, double sigma,
                      int kind, double omega, int sweeps, void* stream) {
  return launch_up<float>(x, e, b, out, mg::Rect{R, C, row_off, col_off},
                          mg::Rect{Rc, Cc, crow, ccol}, n, h, sigma, kind,
                          omega, sweeps, stream);
}

int mg_local2d_up_f64(const void* x, const void* e, const void* b, void* out,
                      int R, int C, int Rc, int Cc, int n, int row_off,
                      int col_off, int crow, int ccol, double h, double sigma,
                      int kind, double omega, int sweeps, void* stream) {
  return launch_up<double>(x, e, b, out, mg::Rect{R, C, row_off, col_off},
                           mg::Rect{Rc, Cc, crow, ccol}, n, h, sigma, kind,
                           omega, sweeps, stream);
}

}  // extern "C"

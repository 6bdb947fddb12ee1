// Colour-packed shard-local kernels on one rank's halo-extended tile: the
// residual and the operator apply, the whole down leg, the whole up leg and
// the fused residual norm of the sharded solve's convergence check.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/plocal2d.py:
//   residual, apply_op  -> plocal2d_residual (mg::presidual_kernel, one
//                          body with or without the b stream)
//   down_leg            -> plocal2d_down     (plocal_down_kernel)
//   up_leg              -> plocal2d_up       (plocal_up_kernel)
//   residual_norm_sq    -> plocal2d_resnorm  (mg::presnorm_partial,
//                          mg::sum_partials)
//
// A tile is local2d.cu's extended tile (an R x C rectangle of the global
// padded grid at global (row_off, col_off), kernels/local2d.py) stored
// colour-packed: mg::PRect{R, C, row_off, col_off}, two planes of R x
// (C+1)/2 lanes (packed_tile.cuh says how lanes hold points). The phase of
// a row comes from the global row and column offsets, so a block
// decomposition's odd col_off flips it; the neighbour algebra, loads, stores
// and smoothing are packed_tile.cuh's, shared with packed2d.cu. As in
// local2d.cu, a point is updated only if it is interior to the global grid
// and off the tile's outer ring (mg::InteriorBox), and coarse data crosses
// in local2d's unpacked extended convention (mg::Rect): the down leg writes
// the full weighting on the coarse tile's owned box and 0 elsewhere, the up
// leg reads the correction as 0 off the coarse tile. After an RB-GS sweep
// the down leg restricts the red residual only, as the TPU kernel does.
//
// What bounds them on the card: device-memory traffic, as packed2d.cu's
// legs (a leg reads u and b and writes u' and the quarter-size coarse tile,
// 13 bytes a point in float32; the residual 12, the apply 8, the norm 8 or,
// red only, 6); sweeps, the residual and the restriction run from shared
// memory.
//
// The down leg's blocks are laid out on the coarse tile as in local2d.cu: a
// block owns a TY/2 x TX/2 box of coarse points and the TY x TX fine points
// that belong to them, so every coarse value and every fine point has one
// writer. On a block tile the fine core starts on an odd column of the
// array (col_off is odd), in the middle of a lane; the block loads one lane
// more than its halo needs and stores only its core's points
// (mg::store_pcore). The norm counts each owned point once: its first pass
// walks the owned rows and lanes, not overlapping windows.
#include <algorithm>

#include "packed_tile.cuh"

namespace {

constexpr int TX = 64;        // core fine columns per block (even)
constexpr int TY = 32;        // core rows per block (even)
constexpr int TXP = TX / 2;   // core lanes per block
constexpr int THREADS = 256;

// The points a kernel on tile a sets: interior to the n x n grid and off
// the tile's outer ring.
mg::InteriorBox inner(const mg::PRect& a, int n) {
  return mg::InteriorBox{n, a.goy + 1, a.goy + a.R - 2, a.gox + 1,
                         a.gox + a.C - 2};
}

// Down leg: u' = smooth^sweeps(u); rc = R (b - (A - sigma I) u') where keep
// holds on the coarse tile ca, 0 elsewhere, the black residual taken as 0
// after an RB-GS sweep. Halo H = sweep_halo + 2 fine rings, HP = ceil(H/2)
// lanes a side and one more lane (the core may start mid-lane).
template <typename T>
__global__ void __launch_bounds__(THREADS)
plocal_down_kernel(const T* __restrict__ u, const T* __restrict__ b,
                   T* __restrict__ u_out, T* __restrict__ rc, mg::PRect a,
                   mg::InteriorBox upd, mg::Rect ca, mg::InteriorBox keep,
                   mg::Coef<T> cf, int kind, int sweeps, int H, int HP) {
  extern __shared__ unsigned char smem_raw[];
  const int RY = TY + 2 * H;
  const int RXP = TXP + 2 * HP + 1;
  const int plane = RY * RXP;
  // The block's first coarse point is global (ca.goy + q0, ca.gox + s0);
  // its fine core starts at that point's centre (global indices may be
  // negative: int arithmetic, not blockIdx's unsigned).
  const int y0 = 2 * (ca.goy + static_cast<int>(blockIdx.y) * (TY / 2));
  const int x0 = 2 * (ca.gox + static_cast<int>(blockIdx.x) * (TX / 2));
  const int gy0 = y0 - H;
  // First array lane of the tile: its column 2 gp0 of the array (global
  // gx0) is x0 - H or x0 - H - 1 (>> is the floor halving here).
  const int gp0 = (x0 - H - a.gox) >> 1;
  const int gx0 = a.gox + 2 * gp0;

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + 2 * plane;
  T* rs = bs + 2 * plane;             // residual on the core plus one ring
  T* vs = rs + (TY + 2) * (TX + 2);   // Jacobi ping-pong (RB-GS: unused)

  mg::load_ptile(u, us, RY, RXP, gy0, gp0, a);
  mg::load_ptile(b, bs, RY, RXP, gy0, gp0, a);
  __syncthreads();
  const T* w = mg::smooth_ptile(us, vs, bs, RY, RXP, gy0, gx0, upd, kind,
                                sweeps, cf);
  mg::core_presidual<TY, TX>(w, bs, rs, RY, RXP, gy0, gx0, y0, x0, upd,
                             kind == mg::kRbgs && sweeps >= 1, cf);
  mg::store_pcore<TY, TX>(w, u_out, RY, RXP, gy0, gp0, y0, x0, a);
  __syncthreads();
  mg::restrict_core<TY, TX>(rs, rc, y0, x0, ca, keep, false);
}

// Up leg: x' = smooth^sweeps(x + P e), P e added at every interior point of
// the window, e the coarse tile ca. Blocks own TY rows and TXP lanes of the
// array (whole lanes: the core starts on an even array column); halo H =
// sweep_halo rings, HP = ceil(H/2) lanes.
template <typename T>
__global__ void __launch_bounds__(THREADS)
plocal_up_kernel(const T* __restrict__ x, const T* __restrict__ e,
                 const T* __restrict__ b, T* __restrict__ out, mg::PRect a,
                 mg::InteriorBox upd, mg::Rect ca, mg::Coef<T> cf, int kind,
                 int sweeps, int H, int HP) {
  extern __shared__ unsigned char smem_raw[];
  const int RY = TY + 2 * H;
  const int RXP = TXP + 2 * HP;
  const int plane = RY * RXP;
  const int y0 = a.goy + static_cast<int>(blockIdx.y) * TY;
  const int p0 = static_cast<int>(blockIdx.x) * TXP;
  const int gy0 = y0 - H;
  const int gp0 = p0 - HP;
  const int gx0 = a.gox + 2 * gp0;

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + 2 * plane;
  T* vs = bs + 2 * plane;     // Jacobi ping-pong planes (RB-GS: unused)

  mg::load_ptile_prolonged(x, mg::TileView<T>{e, ca}, b, us, bs, RY, RXP,
                           gy0, gp0, a, upd.n);
  __syncthreads();
  const T* w = mg::smooth_ptile(us, vs, bs, RY, RXP, gy0, gx0, upd, kind,
                                sweeps, cf);
  mg::store_pcore<TY, TX>(w, out, RY, RXP, gy0, gp0, y0, a.gox + 2 * p0, a);
}

size_t leg_bytes(size_t elem, int kind, size_t plane) {
  return elem * (kind == mg::kJacobi ? 6 : 4) * plane;
}

// ca's owned box [qlo, qhi) x [slo, shi) is in coarse tile indices.
template <typename T>
int launch_down(const void* u, const void* b, void* u_out, void* rc,
                mg::PRect a, mg::Rect ca, int n, int qlo, int qhi, int slo,
                int shi, double h, double sigma, int kind, double omega,
                int sweeps, void* stream) {
  const int H = mg::sweep_halo(kind, sweeps) + 2;
  const int HP = (H + 1) / 2;
  const size_t plane = static_cast<size_t>(TY + 2 * H) * (TXP + 2 * HP + 1);
  const size_t bytes = leg_bytes(sizeof(T), kind, plane) +
                       sizeof(T) * static_cast<size_t>(TY + 2) * (TX + 2);
  const int err = mg::set_smem(plocal_down_kernel<T>, bytes);
  if (err != 0) return err;
  const mg::InteriorBox keep{(n - 1) / 2, ca.goy + qlo, ca.goy + qhi - 1,
                             ca.gox + slo, ca.gox + shi - 1};
  // Enough coarse boxes to cover the coarse tile and, through their fine
  // cores (which start at tile row 2 ca.goy - a.goy <= 0), the fine array
  // with its pad column (2 lanes() columns).
  const int sy = 2 * ca.goy - a.goy;
  const int sx = 2 * ca.gox - a.gox;
  const int by = std::max((ca.R + TY / 2 - 1) / (TY / 2),
                          (a.R - sy + TY - 1) / TY);
  const int bx = std::max((ca.C + TX / 2 - 1) / (TX / 2),
                          (2 * a.lanes() - sx + TX - 1) / TX);
  plocal_down_kernel<T><<<dim3(bx, by), THREADS, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(u_out), static_cast<T*>(rc), a, inner(a, n), ca, keep,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H, HP);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up(const void* x, const void* e, const void* b, void* out,
              mg::PRect a, mg::Rect ca, int n, double h, double sigma,
              int kind, double omega, int sweeps, void* stream) {
  const int H = mg::sweep_halo(kind, sweeps);
  const int HP = (H + 1) / 2;
  const size_t plane = static_cast<size_t>(TY + 2 * H) * (TXP + 2 * HP);
  const size_t bytes = leg_bytes(sizeof(T), kind, plane);
  const int err = mg::set_smem(plocal_up_kernel<T>, bytes);
  if (err != 0) return err;
  const dim3 grid((a.lanes() + TXP - 1) / TXP, (a.R + TY - 1) / TY);
  plocal_up_kernel<T><<<grid, THREADS, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<const T*>(b), static_cast<T*>(out), a, inner(a, n), ca,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H, HP);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// has_b: 1 the residual b - (A - sigma I) u, 0 the apply (A - sigma I) u
// (b unused).
int mg_plocal2d_residual_f32(const void* u, const void* b, void* out, int R,
                             int C, int n, int row_off, int col_off, double h,
                             double sigma, int has_b, void* stream) {
  const mg::PRect a{R, C, row_off, col_off};
  return mg::launch_presidual<float>(u, b, out, a, inner(a, n), h, sigma,
                                     has_b, stream);
}

int mg_plocal2d_residual_f64(const void* u, const void* b, void* out, int R,
                             int C, int n, int row_off, int col_off, double h,
                             double sigma, int has_b, void* stream) {
  const mg::PRect a{R, C, row_off, col_off};
  return mg::launch_presidual<double>(u, b, out, a, inner(a, n), h, sigma,
                                      has_b, stream);
}

int mg_plocal2d_down_f32(const void* u, const void* b, void* u_out, void* rc,
                         int R, int C, int Rc, int Cc, int n, int row_off,
                         int col_off, int crow, int ccol, int qlo, int qhi,
                         int slo, int shi, double h, double sigma, int kind,
                         double omega, int sweeps, void* stream) {
  return launch_down<float>(u, b, u_out, rc,
                            mg::PRect{R, C, row_off, col_off},
                            mg::Rect{Rc, Cc, crow, ccol}, n, qlo, qhi, slo,
                            shi, h, sigma, kind, omega, sweeps, stream);
}

int mg_plocal2d_down_f64(const void* u, const void* b, void* u_out, void* rc,
                         int R, int C, int Rc, int Cc, int n, int row_off,
                         int col_off, int crow, int ccol, int qlo, int qhi,
                         int slo, int shi, double h, double sigma, int kind,
                         double omega, int sweeps, void* stream) {
  return launch_down<double>(u, b, u_out, rc,
                             mg::PRect{R, C, row_off, col_off},
                             mg::Rect{Rc, Cc, crow, ccol}, n, qlo, qhi, slo,
                             shi, h, sigma, kind, omega, sweeps, stream);
}

int mg_plocal2d_up_f32(const void* x, const void* e, const void* b, void* out,
                       int R, int C, int Rc, int Cc, int n, int row_off,
                       int col_off, int crow, int ccol, double h,
                       double sigma, int kind, double omega, int sweeps,
                       void* stream) {
  return launch_up<float>(x, e, b, out, mg::PRect{R, C, row_off, col_off},
                          mg::Rect{Rc, Cc, crow, ccol}, n, h, sigma, kind,
                          omega, sweeps, stream);
}

int mg_plocal2d_up_f64(const void* x, const void* e, const void* b, void* out,
                       int R, int C, int Rc, int Cc, int n, int row_off,
                       int col_off, int crow, int ccol, double h,
                       double sigma, int kind, double omega, int sweeps,
                       void* stream) {
  return launch_up<double>(x, e, b, out, mg::PRect{R, C, row_off, col_off},
                           mg::Rect{Rc, Cc, crow, ccol}, n, h, sigma, kind,
                           omega, sweeps, stream);
}

// The owned box [qlo, qhi) x [slo, shi) is in tile rows and (unpacked)
// tile columns.
int mg_plocal2d_resnorm_f32(const void* u, const void* b, void* partial,
                            void* out, int R, int C, int n, int row_off,
                            int col_off, int qlo, int qhi, int slo, int shi,
                            double h, double sigma, int red_only, int blocks,
                            void* stream) {
  const mg::PRect a{R, C, row_off, col_off};
  return mg::launch_presnorm<float>(u, b, partial, out, a, inner(a, n), qlo,
                                    qhi, slo, shi, h, sigma, red_only, blocks,
                                    stream);
}

int mg_plocal2d_resnorm_f64(const void* u, const void* b, void* partial,
                            void* out, int R, int C, int n, int row_off,
                            int col_off, int qlo, int qhi, int slo, int shi,
                            double h, double sigma, int red_only, int blocks,
                            void* stream) {
  const mg::PRect a{R, C, row_off, col_off};
  return mg::launch_presnorm<double>(u, b, partial, out, a, inner(a, n), qlo,
                                     qhi, slo, shi, h, sigma, red_only,
                                     blocks, stream);
}

}  // extern "C"

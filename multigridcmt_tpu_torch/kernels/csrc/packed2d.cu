// Colour-packed kernels for the finest 2D levels: the two whole-leg kernels,
// the fused residual norm of the convergence check, the residual and the
// fused RB-GS sweeps.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/packed2d.py:
//   smooth_residual_restrict -> packed2d_down     (down_kernel)
//   prolong_add_smooth       -> packed2d_up       (up_kernel)
//   residual_norm_sq         -> packed2d_resnorm  (mg::presnorm_partial,
//                                                 mg::sum_partials)
//   residual                 -> packed2d_residual (mg::presidual_kernel)
//   rbgs_sweep               -> packed2d_rbgs     (rbgs_kernel)
//
// Layout: packed_tile.cuh's, the whole padded grid of P = n+2 (odd) points
// a side as the rectangle at (0, 0) (mg::PRect{P, P, 0, 0}): two planes
// (2, P, cp), cp = (P+1)/2, each row packed along lanes with a row-parity
// offset, as in the TPU module:
//   R[i][l] = u[i][2l + (i&1)]          B[i][l] = u[i][2l + 1 - (i&1)]
// A row's lane past its last point of that colour is a pad and stays 0. The
// neighbour algebra, the tile loads and stores, the smoothing, the residual
// and the norm are packed_tile.cuh's, shared with the shard tiles of
// plocal2d.cu.
//
// What bounds them on the card: as fused2d.cu, the device-memory traffic
// of a leg at the large levels (u and b in, u' and the quarter-size coarse
// residual out, or x, b and the correction in and x' out; 12-13 bytes a
// point in float32); the sweeps run from shared memory. What packing does
// about the rest: each half-sweep runs one thread per point of its colour
// over unit-stride shared-memory lanes (the unpacked kernel reads and
// writes at a stride of two points, which splits a warp's float32 accesses
// over twice the banks' words), and a colour's lanes load contiguously.
// After an RB-GS sweep the closing black half-sweep zeroes the black
// residual (exactly in exact arithmetic), so the down leg restricts the red
// residual only and the norm can sum the red plane only, as on the TPU.
//
// Tiling as in fused2d.cu: a block owns TY rows and TX/2 lanes (TX fine
// columns) whose first row and column are even, so every coarse point has
// one writer. The row halo is H rings; the lane halo is HP = ceil(H/2)
// lanes, 2 HP >= H columns, so a tile starts on an even column and its
// lanes hold whole column pairs. Inputs and outputs never alias.
#include "packed_tile.cuh"

namespace {

constexpr int TX = 64;        // core fine columns per block (even)
constexpr int TY = 32;        // core rows per block (even)
constexpr int TXP = TX / 2;   // core lanes per block
constexpr int THREADS = 256;

int down_halo(int kind, int sweeps) {
  return mg::sweep_halo(kind, sweeps) + 2;
}

// Down leg: u' = smooth^sweeps(u); rc = R (b - (A - sigma I) u'), with the
// black residual taken as 0 after an RB-GS sweep. rc is written in the
// logical (nc+2)^2 layout, or packed when packed_coarse is set.
template <typename T>
__global__ void __launch_bounds__(THREADS)
down_kernel(const T* __restrict__ u, const T* __restrict__ b,
            T* __restrict__ u_out, T* __restrict__ rc, int n,
            mg::Coef<T> cf, int kind, int sweeps, int H, int HP,
            int packed_coarse) {
  extern __shared__ unsigned char smem_raw[];
  const mg::PRect grid{n + 2, n + 2, 0, 0};
  const mg::Interior upd{n};
  const int RY = TY + 2 * H;
  const int RXP = TXP + 2 * HP;
  const int plane = RY * RXP;
  const int y0 = blockIdx.y * TY;
  const int p0 = blockIdx.x * TXP;
  const int x0 = 2 * p0;
  const int gy0 = y0 - H;
  const int gp0 = p0 - HP;
  const int gx0 = 2 * gp0;

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + 2 * plane;
  T* rs = bs + 2 * plane;     // residual on the core plus one ring
  T* vs = rs + (TY + 2) * (TX + 2);   // Jacobi ping-pong (RB-GS: unused)

  mg::load_ptile(u, us, RY, RXP, gy0, gp0, grid);
  mg::load_ptile(b, bs, RY, RXP, gy0, gp0, grid);
  __syncthreads();

  const T* w = mg::smooth_ptile(us, vs, bs, RY, RXP, gy0, gx0, upd, kind,
                                sweeps, cf);
  mg::core_presidual<TY, TX>(w, bs, rs, RY, RXP, gy0, gx0, y0, x0, upd,
                             kind == mg::kRbgs && sweeps >= 1, cf);
  mg::store_pcore<TY, TX>(w, u_out, RY, RXP, gy0, gp0, y0, x0, grid);
  __syncthreads();
  const int nc = (n - 1) / 2;
  mg::restrict_core<TY, TX>(rs, rc, y0, x0, mg::Rect::square(nc + 2),
                            mg::Interior{nc}, packed_coarse);
}

// Up leg: x' = smooth^sweeps(x + P e); e logical or packed (a template
// parameter, so that the coarse reads of the load loop carry no branch).
template <typename T, bool PACKED_E>
__global__ void __launch_bounds__(THREADS)
up_kernel(const T* __restrict__ x, const T* __restrict__ e,
          const T* __restrict__ b, T* __restrict__ out, int n,
          mg::Coef<T> cf, int kind, int sweeps, int H, int HP) {
  extern __shared__ unsigned char smem_raw[];
  const mg::PRect grid{n + 2, n + 2, 0, 0};
  const int Pc = (n - 1) / 2 + 2;
  const int RY = TY + 2 * H;
  const int RXP = TXP + 2 * HP;
  const int plane = RY * RXP;
  const int y0 = blockIdx.y * TY;
  const int p0 = blockIdx.x * TXP;
  const int gy0 = y0 - H;
  const int gp0 = p0 - HP;
  const mg::CoarseView<T> ev{e, Pc, (Pc + 1) / 2, PACKED_E};

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + 2 * plane;
  T* vs = bs + 2 * plane;     // Jacobi ping-pong planes (RB-GS: unused)

  mg::load_ptile_prolonged(x, ev, b, us, bs, RY, RXP, gy0, gp0, grid, n);
  __syncthreads();
  const T* w = mg::smooth_ptile(us, vs, bs, RY, RXP, gy0, 2 * gp0,
                                mg::Interior{n}, kind, sweeps, cf);
  mg::store_pcore<TY, TX>(w, out, RY, RXP, gy0, gp0, y0, 2 * p0, grid);
}

// RB-GS: u' = smooth^sweeps(u) on packed grids, halo H = 2 sweeps rows and
// HP = sweeps lanes (2 HP columns). Ghosts and pad lanes are never updated
// (not interior), so they keep u's zeros.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rbgs_kernel(const T* __restrict__ u, const T* __restrict__ b,
            T* __restrict__ out, int n, mg::Coef<T> cf, int sweeps, int H,
            int HP) {
  extern __shared__ unsigned char smem_raw[];
  const mg::PRect grid{n + 2, n + 2, 0, 0};
  const int RY = TY + 2 * H;
  const int RXP = TXP + 2 * HP;
  const int y0 = blockIdx.y * TY;
  const int p0 = blockIdx.x * TXP;
  const int gy0 = y0 - H;
  const int gp0 = p0 - HP;

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + 2 * RY * RXP;

  mg::load_ptile(u, us, RY, RXP, gy0, gp0, grid);
  mg::load_ptile(b, bs, RY, RXP, gy0, gp0, grid);
  __syncthreads();
  const T* w = mg::smooth_ptile(us, us, bs, RY, RXP, gy0, 2 * gp0,
                                mg::Interior{n}, mg::kRbgs, sweeps, cf);
  mg::store_pcore<TY, TX>(w, out, RY, RXP, gy0, gp0, y0, 2 * p0, grid);
}

dim3 leg_grid(int n) {
  const int P = n + 2;
  const int cp = (P + 1) / 2;
  return dim3((cp + TXP - 1) / TXP, (P + TY - 1) / TY);
}

template <typename T>
int launch_down(const void* u, const void* b, void* u_out, void* rc, int n,
                double h, double sigma, int kind, double omega, int sweeps,
                int packed_coarse, void* stream) {
  const int H = down_halo(kind, sweeps);
  const int HP = (H + 1) / 2;
  const size_t plane = static_cast<size_t>(TY + 2 * H) * (TXP + 2 * HP);
  const size_t bytes =
      sizeof(T) * ((kind == mg::kJacobi ? 6 : 4) * plane +
                   static_cast<size_t>(TY + 2) * (TX + 2));
  const int err = mg::set_smem(down_kernel<T>, bytes);
  if (err != 0) return err;
  down_kernel<T><<<leg_grid(n), THREADS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(u_out), static_cast<T*>(rc), n,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H, HP,
      packed_coarse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up(const void* x, const void* e, const void* b, void* out, int n,
              double h, double sigma, int kind, double omega, int sweeps,
              int packed_e, void* stream) {
  const int H = mg::sweep_halo(kind, sweeps);
  const int HP = (H + 1) / 2;
  const size_t plane = static_cast<size_t>(TY + 2 * H) * (TXP + 2 * HP);
  const size_t bytes = sizeof(T) * (kind == mg::kJacobi ? 6 : 4) * plane;
  const auto kernel = packed_e ? up_kernel<T, true> : up_kernel<T, false>;
  const int err = mg::set_smem(kernel, bytes);
  if (err != 0) return err;
  kernel<<<leg_grid(n), THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<const T*>(b), static_cast<T*>(out), n,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H, HP);
  return static_cast<int>(cudaGetLastError());
}

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

template <typename T>
int launch_rbgs(const void* u, const void* b, void* out, int n, double h,
                double sigma, int sweeps, void* stream) {
  const int H = mg::sweep_halo(mg::kRbgs, sweeps);
  const int HP = (H + 1) / 2;
  const size_t bytes =
      sizeof(T) * 4 * static_cast<size_t>(TY + 2 * H) * (TXP + 2 * HP);
  const int err = mg::set_smem(rbgs_kernel<T>, bytes);
  if (err != 0) return err;
  rbgs_kernel<T><<<leg_grid(n), THREADS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(out), n, mg::Coef<T>::make(h, sigma, 1.0), sweeps, H,
      HP);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mg_packed2d_down_f32(const void* u, const void* b, void* u_out, void* rc,
                         int n, double h, double sigma, int kind, double omega,
                         int sweeps, int packed_coarse, void* stream) {
  return launch_down<float>(u, b, u_out, rc, n, h, sigma, kind, omega,
                            sweeps, packed_coarse, stream);
}

int mg_packed2d_down_f64(const void* u, const void* b, void* u_out, void* rc,
                         int n, double h, double sigma, int kind, double omega,
                         int sweeps, int packed_coarse, void* stream) {
  return launch_down<double>(u, b, u_out, rc, n, h, sigma, kind, omega,
                             sweeps, packed_coarse, stream);
}

int mg_packed2d_up_f32(const void* x, const void* e, const void* b, void* out,
                       int n, double h, double sigma, int kind, double omega,
                       int sweeps, int packed_e, void* stream) {
  return launch_up<float>(x, e, b, out, n, h, sigma, kind, omega, sweeps,
                          packed_e, stream);
}

int mg_packed2d_up_f64(const void* x, const void* e, const void* b, void* out,
                       int n, double h, double sigma, int kind, double omega,
                       int sweeps, int packed_e, void* stream) {
  return launch_up<double>(x, e, b, out, n, h, sigma, kind, omega, sweeps,
                           packed_e, stream);
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

int mg_packed2d_rbgs_f32(const void* u, const void* b, void* out, int n,
                         double h, double sigma, int sweeps, void* stream) {
  return launch_rbgs<float>(u, b, out, n, h, sigma, sweeps, stream);
}

int mg_packed2d_rbgs_f64(const void* u, const void* b, void* out, int n,
                         double h, double sigma, int sweeps, void* stream) {
  return launch_rbgs<double>(u, b, out, n, h, sigma, sweeps, stream);
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

// Whole-leg fused V-cycle kernels for the 2D Poisson problem: one launch,
// one pass over the fine grid, per leg.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/fused2d.py:
//   smooth_residual_restrict -> fused2d_down (down_kernel)
//   prolong_add_smooth       -> fused2d_up   (up_kernel)
//
// What bounds them on the card: the fine grid does not fit in L2 at the
// large levels (67 MB per float32 array at 4095^2), so the floor is the
// device-memory traffic of one leg: read u and b, write u' and the
// quarter-size coarse residual (down), or read x, b and the quarter-size
// correction and write x' (up), 12-13 bytes a point in float32. The
// smoothing sweeps, ~10 flops a point a sweep, run from shared memory.
// The design keeps all intermediate sweeps, the residual and the
// restriction out of device memory: each block loads its tile of u and b
// with a halo once, works on it in shared memory, and writes only its core.
//
// Tiling. A block owns a TY x TX core of fine points whose first row and
// column are even, so fine point 2I of coarse point I (transfer.py) lies
// in exactly one core and every coarse value has one writer. The halo
// covers the staleness of the in-tile sweeps (see common.cuh): RB-GS makes
// 2 rings stale a sweep, Jacobi 1, the residual needs one more ring and
// the full weighting one more. Neighbouring blocks read their halos from
// the input arrays, so the outputs never alias the inputs.
#include "common.cuh"

namespace {

constexpr int TX = 64;        // core columns per block (even)
constexpr int TY = 32;        // core rows per block (even)
constexpr int THREADS = 256;

// Halo rings a leg needs: the sweeps', plus on the down leg one ring for
// the residual and one for the full weighting.
int down_halo(int kind, int sweeps) {
  return mg::sweep_halo(kind, sweeps) + 2;
}

// Down leg: u' = smooth^sweeps(u); rc = R (b - (A - sigma I) u').
template <typename T>
__global__ void __launch_bounds__(THREADS)
down_kernel(const T* __restrict__ u, const T* __restrict__ b,
            T* __restrict__ u_out, T* __restrict__ rc, int n, mg::Coef<T> c,
            int kind, int sweeps, int H) {
  extern __shared__ unsigned char smem_raw[];
  const mg::Rect grid = mg::Rect::square(n + 2);
  const int nc = (n - 1) / 2;
  const mg::Interior upd{n};
  const int RX = TX + 2 * H;
  const int RY = TY + 2 * H;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int gy0 = y0 - H;
  const int gx0 = x0 - H;

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + RY * RX;
  T* rs = bs + RY * RX;       // residual on the core plus one ring
  T* vs = rs + (TY + 2) * (TX + 2);   // Jacobi ping-pong (RB-GS: unused)

  mg::load_tile(u, us, RY, RX, gy0, gx0, grid);
  mg::load_tile(b, bs, RY, RX, gy0, gx0, grid);
  __syncthreads();

  const T* w = mg::smooth_tile(us, vs, bs, RY, RX, gy0, gx0, upd, kind,
                               sweeps, c);
  mg::core_residual<TY, TX>(w, bs, rs, RX, H, gy0, gx0, upd, c);
  mg::store_core<TY, TX>(w, u_out, RX, H, y0, x0, grid);
  __syncthreads();
  mg::restrict_core<TY, TX>(rs, rc, y0, x0, mg::Rect::square(nc + 2),
                            mg::Interior{nc}, false);
}

// Up leg: x' = smooth^sweeps(x + P e).
template <typename T>
__global__ void __launch_bounds__(THREADS)
up_kernel(const T* __restrict__ x, const T* __restrict__ e,
          const T* __restrict__ b, T* __restrict__ out, int n, mg::Coef<T> c,
          int kind, int sweeps, int H) {
  extern __shared__ unsigned char smem_raw[];
  const mg::Rect grid = mg::Rect::square(n + 2);
  const int Pc = (n - 1) / 2 + 2;
  const int RX = TX + 2 * H;
  const int RY = TY + 2 * H;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int gy0 = y0 - H;
  const int gx0 = x0 - H;
  const mg::CoarseView<T> ev{e, Pc, (Pc + 1) / 2, false};

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + RY * RX;
  T* vs = bs + RY * RX;       // Jacobi ping-pong buffer (RB-GS: unused)

  mg::load_tile_prolonged(x, ev, b, us, bs, RY, RX, gy0, gx0, grid, n);
  __syncthreads();

  const T* w = mg::smooth_tile(us, vs, bs, RY, RX, gy0, gx0, mg::Interior{n},
                               kind, sweeps, c);
  mg::store_core<TY, TX>(w, out, RX, H, y0, x0, grid);
}

dim3 leg_grid(int n) {
  const int P = n + 2;
  return dim3((P + TX - 1) / TX, (P + TY - 1) / TY);
}

template <typename T>
int launch_down(const void* u, const void* b, void* u_out, void* rc, int n,
                double h, double sigma, int kind, double omega, int sweeps,
                void* stream) {
  const int H = down_halo(kind, sweeps);
  const size_t tile = static_cast<size_t>(TY + 2 * H) * (TX + 2 * H);
  const size_t bytes =
      sizeof(T) * ((kind == mg::kJacobi ? 3 : 2) * tile +
                   static_cast<size_t>(TY + 2) * (TX + 2));
  const int err = mg::set_smem(down_kernel<T>, bytes);
  if (err != 0) return err;
  down_kernel<T><<<leg_grid(n), THREADS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(u_out), static_cast<T*>(rc), n,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up(const void* x, const void* e, const void* b, void* out, int n,
              double h, double sigma, int kind, double omega, int sweeps,
              void* stream) {
  const int H = mg::sweep_halo(kind, sweeps);
  const size_t tile = static_cast<size_t>(TY + 2 * H) * (TX + 2 * H);
  const size_t bytes = sizeof(T) * (kind == mg::kJacobi ? 3 : 2) * tile;
  const int err = mg::set_smem(up_kernel<T>, bytes);
  if (err != 0) return err;
  up_kernel<T><<<leg_grid(n), THREADS, bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<const T*>(b), static_cast<T*>(out), n,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mg_fused2d_down_f32(const void* u, const void* b, void* u_out, void* rc,
                        int n, double h, double sigma, int kind, double omega,
                        int sweeps, void* stream) {
  return launch_down<float>(u, b, u_out, rc, n, h, sigma, kind, omega,
                            sweeps, stream);
}

int mg_fused2d_down_f64(const void* u, const void* b, void* u_out, void* rc,
                        int n, double h, double sigma, int kind, double omega,
                        int sweeps, void* stream) {
  return launch_down<double>(u, b, u_out, rc, n, h, sigma, kind, omega,
                             sweeps, stream);
}

int mg_fused2d_up_f32(const void* x, const void* e, const void* b, void* out,
                      int n, double h, double sigma, int kind, double omega,
                      int sweeps, void* stream) {
  return launch_up<float>(x, e, b, out, n, h, sigma, kind, omega, sweeps,
                          stream);
}

int mg_fused2d_up_f64(const void* x, const void* e, const void* b, void* out,
                      int n, double h, double sigma, int kind, double omega,
                      int sweeps, void* stream) {
  return launch_up<double>(x, e, b, out, n, h, sigma, kind, omega, sweeps,
                           stream);
}

}  // extern "C"

// The 2D 5-point Poisson kernels on the logical padded layout: the residual
// and the fused smoother sweeps.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/stencil2d.py:
//   residual                   -> stencil2d_residual (residual_kernel)
//   rbgs_sweep, jacobi_sweep   -> stencil2d_sweep    (sweep_kernel)
//
// Residual r = b - (A - sigma I) u. On the card it is bound by memory: it
// reads u and b and writes r, 12 bytes a point in float32, for ~8 flops.
// One thread per point, with neighbouring threads on neighbouring columns,
// so each warp's loads of a row coalesce; the four neighbour loads hit in
// L1/L2. Ghosts get 0.
//
// Sweeps: up to 4 RB-GS or 8 Jacobi sweeps in one pass, the schedules that
// exceed a fused leg's cap (fused2d.py). Bound by memory as well: u and b
// in, u' out, 12 bytes a point in float32 whatever the sweep count, for ~6
// flops a point a sweep. Each block loads its tile of u and b with a halo
// of 2 rings a sweep (RB-GS) or 1 (Jacobi), runs the sweeps in shared
// memory (common.cuh) and writes its core, so the intermediate sweeps never
// reach device memory; the halo is read twice, from L2. Colour comes from
// global padded indices, so tiles agree on it across their seams. The
// output never aliases the input; ghosts keep u's values (zero).
#include "common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

constexpr int TX = 64;        // sweep core columns per block (even)
constexpr int TY = 32;        // sweep core rows per block (even)
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(BX * BY)
residual_kernel(const T* __restrict__ u, const T* __restrict__ b,
                T* __restrict__ r, int n, mg::Coef<T> c) {
  const int P = n + 2;
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= P || j >= P) return;
  const size_t k = static_cast<size_t>(i) * P + j;
  r[k] = mg::interior(i, j, n) ? mg::residual_at(u + k, b[k], P, c) : T(0);
}

// u' = smooth^sweeps(u) of `kind`, halo H = sweep_halo(kind, sweeps).
template <typename T>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const T* __restrict__ u, const T* __restrict__ b,
             T* __restrict__ out, int n, mg::Coef<T> c, int kind, int sweeps,
             int H) {
  extern __shared__ unsigned char smem_raw[];
  const mg::Rect grid = mg::Rect::square(n + 2);
  const int RX = TX + 2 * H;
  const int RY = TY + 2 * H;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int gy0 = y0 - H;
  const int gx0 = x0 - H;

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + RY * RX;
  T* vs = bs + RY * RX;       // Jacobi ping-pong buffer (RB-GS: unused)

  mg::load_tile(u, us, RY, RX, gy0, gx0, grid);
  mg::load_tile(b, bs, RY, RX, gy0, gx0, grid);
  __syncthreads();
  const T* w = mg::smooth_tile(us, vs, bs, RY, RX, gy0, gx0, mg::Interior{n},
                               kind, sweeps, c);
  mg::store_core<TY, TX>(w, out, RX, H, y0, x0, grid);
}

template <typename T>
int launch_residual(const void* u, const void* b, void* r, int n, double h,
                    double sigma, void* stream) {
  const int P = n + 2;
  const dim3 grid((P + BX - 1) / BX, (P + BY - 1) / BY);
  residual_kernel<T><<<grid, dim3(BX, BY), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(r), n, mg::Coef<T>::make(h, sigma, 1.0));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sweep(const void* u, const void* b, void* out, int n, double h,
                 double sigma, int kind, double omega, int sweeps,
                 void* stream) {
  const int P = n + 2;
  const int H = mg::sweep_halo(kind, sweeps);
  const size_t tile = static_cast<size_t>(TY + 2 * H) * (TX + 2 * H);
  const size_t bytes = sizeof(T) * (kind == mg::kJacobi ? 3 : 2) * tile;
  const int err = mg::set_smem(sweep_kernel<T>, bytes);
  if (err != 0) return err;
  const dim3 grid((P + TX - 1) / TX, (P + TY - 1) / TY);
  sweep_kernel<T><<<grid, THREADS, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(out), n, mg::Coef<T>::make(h, sigma, omega), kind,
      sweeps, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mg_stencil2d_residual_f32(const void* u, const void* b, void* r, int n,
                              double h, double sigma, void* stream) {
  return launch_residual<float>(u, b, r, n, h, sigma, stream);
}

int mg_stencil2d_residual_f64(const void* u, const void* b, void* r, int n,
                              double h, double sigma, void* stream) {
  return launch_residual<double>(u, b, r, n, h, sigma, stream);
}

int mg_stencil2d_sweep_f32(const void* u, const void* b, void* out, int n,
                           double h, double sigma, int kind, double omega,
                           int sweeps, void* stream) {
  return launch_sweep<float>(u, b, out, n, h, sigma, kind, omega, sweeps,
                             stream);
}

int mg_stencil2d_sweep_f64(const void* u, const void* b, void* out, int n,
                           double h, double sigma, int kind, double omega,
                           int sweeps, void* stream) {
  return launch_sweep<double>(u, b, out, n, h, sigma, kind, omega, sweeps,
                              stream);
}

const char* mg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

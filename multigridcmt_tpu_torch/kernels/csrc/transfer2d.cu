// The inter-grid transfers fused with their neighbours, on the logical
// padded layout: the composed V-cycle legs' halves (Chebyshev smoothing,
// or more sweeps than a fused leg takes).
//
// Replace the TPU kernels multigridcmt_tpu/kernels/transfer2d.py:
//   residual_restrict -> transfer2d_residual_restrict (rr_kernel)
//   prolong_add       -> transfer2d_prolong_add       (prolong_add_kernel)
//
// What bounds them on the card: device-memory bytes. residual_restrict
// reads u and b and writes only the quarter-size coarse grid (9 bytes a
// fine point in float32, for ~20 flops); the fine residual never reaches
// device memory. prolong_add reads x and the quarter-size correction and
// writes x + P e (9 bytes a fine point, ~4 flops).
//
// residual_restrict tiles as common.cuh's shared-memory tiles: a block
// owns a TY x TX core whose first row and column are even, so every coarse
// point has one writer (the last block's rows and columns past the coarse
// grid's ghost write nothing), loads u and b with a halo of 2 rings, forms
// the residual on the core plus one ring in shared memory and applies the
// full weighting there (common.cuh).
// prolong_add is one thread per fine point: x + prolong_at(e) on the
// interior, x on the ghosts; the coarse reads of neighbouring threads hit
// in L1/L2.
#include "common.cuh"

namespace {

constexpr int TX = 64;        // residual_restrict core columns (even)
constexpr int TY = 32;        // residual_restrict core rows (even)
constexpr int THREADS = 256;
constexpr int HALO = 2;       // the residual's ring and the weighting's
constexpr int BX = 32;        // prolong_add block
constexpr int BY = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rr_kernel(const T* __restrict__ u, const T* __restrict__ b,
          T* __restrict__ rc, int n, mg::Coef<T> c) {
  constexpr int RX = TX + 2 * HALO;
  constexpr int RY = TY + 2 * HALO;
  extern __shared__ unsigned char smem_raw[];
  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + RY * RX;
  T* rs = bs + RY * RX;       // residual on the core plus one ring
  const mg::Rect grid = mg::Rect::square(n + 2);
  const int nc = (n - 1) / 2;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int gy0 = y0 - HALO;
  const int gx0 = x0 - HALO;

  mg::load_tile(u, us, RY, RX, gy0, gx0, grid);
  mg::load_tile(b, bs, RY, RX, gy0, gx0, grid);
  __syncthreads();
  mg::core_residual<TY, TX>(us, bs, rs, RX, HALO, gy0, gx0, mg::Interior{n},
                            c);
  __syncthreads();
  mg::restrict_core<TY, TX>(rs, rc, y0, x0, mg::Rect::square(nc + 2),
                            mg::Interior{nc});
}

template <typename T>
__global__ void __launch_bounds__(BX * BY)
prolong_add_kernel(const T* __restrict__ x, const T* __restrict__ e,
                   T* __restrict__ out, int n) {
  const int P = n + 2;
  const int Pc = (n - 1) / 2 + 2;
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= P || j >= P) return;
  const mg::CoarseView<T> ev{e, Pc};
  const size_t k = static_cast<size_t>(i) * P + j;
  const T xv = x[k];
  out[k] = mg::interior(i, j, n) ? xv + mg::prolong_at(ev, i, j) : xv;
}

template <typename T>
int launch_rr(const void* u, const void* b, void* rc, int n, double h,
              void* stream) {
  const int P = n + 2;
  const size_t bytes =
      sizeof(T) * (2 * (TY + 2 * HALO) * (TX + 2 * HALO) +
                   (TY + 2) * (TX + 2));
  const int err = mg::set_smem(rr_kernel<T>, bytes);
  if (err != 0) return err;
  const dim3 grid((P + TX - 1) / TX, (P + TY - 1) / TY);
  rr_kernel<T><<<grid, THREADS, bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(rc), n, mg::Coef<T>::make(h, 0.0, 1.0));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_prolong_add(const void* x, const void* e, void* out, int n,
                       void* stream) {
  const int P = n + 2;
  const dim3 grid((P + BX - 1) / BX, (P + BY - 1) / BY);
  prolong_add_kernel<T><<<grid, dim3(BX, BY), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mg_transfer2d_residual_restrict_f32(const void* u, const void* b,
                                        void* rc, int n, double h,
                                        void* stream) {
  return launch_rr<float>(u, b, rc, n, h, stream);
}

int mg_transfer2d_residual_restrict_f64(const void* u, const void* b,
                                        void* rc, int n, double h,
                                        void* stream) {
  return launch_rr<double>(u, b, rc, n, h, stream);
}

int mg_transfer2d_prolong_add_f32(const void* x, const void* e, void* out,
                                  int n, void* stream) {
  return launch_prolong_add<float>(x, e, out, n, stream);
}

int mg_transfer2d_prolong_add_f64(const void* x, const void* e, void* out,
                                  int n, void* stream) {
  return launch_prolong_add<double>(x, e, out, n, stream);
}

}  // extern "C"

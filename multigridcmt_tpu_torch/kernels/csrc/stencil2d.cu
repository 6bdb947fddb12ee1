// The 2D 5-point Poisson residual on the logical padded layout (the fused
// smoother sweeps are in stencil2d_sweep.cu and stencil2d_sweep_f64.cu).
//
// Replaces the TPU kernel multigridcmt_tpu/kernels/stencil2d.py:
//   residual -> stencil2d_residual (residual_kernel, :304)
//
// Residual r = b - (A - sigma I) u. On the card it is bound by memory: it
// reads u and b and writes r, 12 bytes a point in float32, for ~8 flops.
// One thread per point, with neighbouring threads on neighbouring columns,
// so each warp's loads of a row coalesce; the four neighbour loads hit in
// L1/L2. Ghosts get 0.
#include "common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

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

const char* mg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

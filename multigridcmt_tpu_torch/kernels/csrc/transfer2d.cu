// The inter-grid transfers fused with their neighbours, on the logical
// padded layout: the composed V-cycle legs' halves (Chebyshev smoothing,
// or more sweeps than a fused leg takes).
//
// Replace the TPU kernels multigridcmt_tpu/kernels/transfer2d.py:
//   residual_restrict -> transfer2d_residual_restrict
//                        (packed2d_legs.cuh residual_restrict_kernel)
//   prolong_add       -> transfer2d_prolong_add (prolong_add_kernel)
//
// What bounds them on the card: device-memory bytes. residual_restrict
// reads u and b and writes only the quarter-size coarse grid (9 bytes a
// fine point in float32, for ~20 flops); the fine residual never reaches
// device memory. prolong_add reads x and the quarter-size correction and
// writes x + P e (9 bytes a fine point, ~4 flops).
//
// residual_restrict is the row stream of the fused2d down leg on the
// unpacked frame (fused2d.cu's note) with no smoothing stage and the store
// of u' compiled out: each warp streams a strip of 32 lanes (two adjacent
// columns a lane) down a segment of rows in registers, forms the residual
// one row behind its loads and the full weighting one row behind that, as
// the plain versions sum them (residual_of, then rows first and columns
// second), so at h = 2^-k it rounds as restrict(residual(u, b)) does, bit
// for bit. Its geometry is the zero-sweep down leg's (fused2d.leg_geometry
// at nu = 0, from transfer2d.py); u and b must start on a pair of
// elements, which transfer2d.py ensures.
// prolong_add is one thread per fine point: x + prolong_at(e) on the
// interior, x on the ghosts; the coarse reads of neighbouring threads hit
// in L1/L2.
#include "packed2d_legs.cuh"

namespace {

constexpr int BX = 32;        // prolong_add block
constexpr int BY = 8;

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

// u, b: (n+2)^2, starting on a pair; rc: ((n-1)/2 + 2)^2; geometry:
// packed2d.leg_geometry's 7 ints of the zero-sweep down leg on the
// unpacked frame.
int mg_transfer2d_residual_restrict_f32(const void* u, const void* b,
                                        void* rc, int n, double h,
                                        const int* geom, void* stream) {
  return launch_residual_restrict<float>(u, b, rc, Unpacked{n}, h, geom,
                                         stream);
}

int mg_transfer2d_residual_restrict_f64(const void* u, const void* b,
                                        void* rc, int n, double h,
                                        const int* geom, void* stream) {
  return launch_residual_restrict<double>(u, b, rc, Unpacked{n}, h, geom,
                                          stream);
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

// The native bfloat16 modes of the 2D stencil kernels that still take a
// thread a point: the residual and the RB-GS and Jacobi sweeps of a shard's
// tile on bfloat16 grids, every operation rounded to bfloat16 as the JAX
// package computes them (kernels/native_bf16.py states the rule and the
// order). The row stream runs the other native modes: the fused2d legs
// (fused2d_native_bf16.cu), a whole grid's RB-GS and Jacobi sweeps
// (stencil2d_sweep_native_bf16.cu, stencil2d_jacobi_native_bf16.cu) and the
// residual restriction (transfer2d_native_bf16.cu); the prolongation-add
// has a block kernel of its own (transfer2d_prolong_native_bf16.cu).
//
// Replaces the bfloat16 modes of the TPU kernels
//   multigridcmt_tpu/kernels/stencil2d.py: residual (:304)
//   multigridcmt_tpu/kernels/local2d.py: rbgs_sweep (:263), jacobi_sweep
//     (:278), residual (:289)
// -> native2d_residual (native_residual_kernel) and native2d_sweep
// (native_rbgs_kernel, native_jacobi_kernel). A whole (n+2)^2 grid is the
// tile at global (0, 0) (its sweeps run the stream).
//
// Arithmetic: each + - x of the source is one float32 operation with its
// rounding mode explicit (__fadd_rn, __fsub_rn, __fmul_rn: nvcc contracts
// no two of them into an FMA) whose result is rounded to bfloat16 to
// nearest even at once. Since 24 >= 2 * 8 + 2, the float32 result rounded
// to bfloat16 is the correctly rounded bfloat16 result of the operation, so
// the kernel's bits equal those of the plain version's bfloat16 PyTorch ops.
// The constants (h^2, 1/h^2, sigma, 1/(4 - sigma h^2), omega/(4/h^2 -
// sigma)) come from the host, already rounded.
//
// Design: simple and right first. One thread a point (32 x 8 blocks, a
// warp on a row's neighbouring columns); the RB-GS sweeps launch once a
// colour a sweep (the first launch reads u and writes every point of u',
// the updated red ones and copies of the rest; the others update one
// colour of u' in place, whose neighbours are of the other colour), the
// Jacobi sweeps once a sweep (u, then u' and a scratch grid in turns, so
// that the last sweep writes u'). What bounds it on the card: device
// memory, each launch reading the grid and b and writing its points: 2
// nu (RB-GS) or nu (Jacobi) passes where the row-streaming sweeps
// (packed2d_legs.cuh) make one. Of what is left here a bfloat16 solve
// (config.dtype bfloat16, kernels on) runs the residual (its convergence
// check); a tile's sweeps run on no path (direct calls) and are the next
// to move onto the stream (UTile with Nb), the residual after them.
#include "common.cuh"

namespace {

constexpr int BX = 32;        // block columns
constexpr int BY = 8;         // block rows

using bf16 = __nv_bfloat16;

// The level's scalars, each a bfloat16 value held in float32.
struct Consts {
  float h2, inv_h2, sig, inv_den, coef;
};

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float add(float a, float b) {
  return rnd(__fadd_rn(a, b));
}
__device__ __forceinline__ float sub(float a, float b) {
  return rnd(__fsub_rn(a, b));
}
__device__ __forceinline__ float mul(float a, float b) {
  return rnd(__fmul_rn(a, b));
}
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}

// ((b - au) + sig u) with au = ((((4 u - up) - down) - left) - right) *
// inv_h2, at the point whose centre is p (row pitch C).
__device__ __forceinline__ float residual_at(const bf16* p, float bv, int C,
                                             const Consts& c) {
  const float v = ld(p);
  float t = mul(4.0f, v);
  t = sub(t, ld(p - C));
  t = sub(t, ld(p + C));
  t = sub(t, ld(p - 1));
  t = sub(t, ld(p + 1));
  return add(sub(bv, mul(t, c.inv_h2)), mul(c.sig, v));
}

// ((((h2 b + up) + down) + left) + right) * inv_den.
__device__ __forceinline__ float gs_at(const bf16* p, float bv, int C,
                                       const Consts& c) {
  float t = mul(c.h2, bv);
  t = add(t, ld(p - C));
  t = add(t, ld(p + C));
  t = add(t, ld(p - 1));
  t = add(t, ld(p + 1));
  return mul(t, c.inv_den);
}

// r = b - (A - sigma I) u on the points upd sets, +0 elsewhere.
__global__ void __launch_bounds__(BX * BY)
native_residual_kernel(const bf16* __restrict__ u,
                       const bf16* __restrict__ b, bf16* __restrict__ r,
                       mg::Rect a, mg::InteriorBox upd, Consts c) {
  const int lx = blockIdx.x * BX + threadIdx.x;
  const int ly = blockIdx.y * BY + threadIdx.y;
  if (ly >= a.R || lx >= a.C) return;
  const size_t k = static_cast<size_t>(ly) * a.C + lx;
  r[k] = __float2bfloat16_rn(
      upd(a.goy + ly, a.gox + lx) ? residual_at(u + k, ld(b + k), a.C, c)
                                  : 0.0f);
}

// One colour's Gauss-Seidel update (red: global row + col even) from src
// into dst; with `copy` the other points are copied from src (src != dst),
// else dst is src and only the colour's points are written.
__global__ void __launch_bounds__(BX * BY)
native_rbgs_kernel(const bf16* src, const bf16* __restrict__ b, bf16* dst,
                   mg::Rect a, mg::InteriorBox upd, Consts c, int colour,
                   bool copy) {
  const int lx = blockIdx.x * BX + threadIdx.x;
  const int ly = blockIdx.y * BY + threadIdx.y;
  if (ly >= a.R || lx >= a.C) return;
  const int gy = a.goy + ly, gx = a.gox + lx;
  const size_t k = static_cast<size_t>(ly) * a.C + lx;
  if (upd(gy, gx) && ((gy + gx) & 1) == colour) {
    dst[k] = __float2bfloat16_rn(gs_at(src + k, ld(b + k), a.C, c));
  } else if (copy) {
    dst[k] = src[k];
  }
}

// One Jacobi sweep, src into dst (src != dst): u + coef * r on the points
// upd sets, a copy elsewhere.
__global__ void __launch_bounds__(BX * BY)
native_jacobi_kernel(const bf16* __restrict__ src,
                     const bf16* __restrict__ b, bf16* __restrict__ dst,
                     mg::Rect a, mg::InteriorBox upd, Consts c) {
  const int lx = blockIdx.x * BX + threadIdx.x;
  const int ly = blockIdx.y * BY + threadIdx.y;
  if (ly >= a.R || lx >= a.C) return;
  const size_t k = static_cast<size_t>(ly) * a.C + lx;
  if (upd(a.goy + ly, a.gox + lx)) {
    const float res = residual_at(src + k, ld(b + k), a.C, c);
    dst[k] = __float2bfloat16_rn(add(ld(src + k), mul(c.coef, res)));
  } else {
    dst[k] = src[k];
  }
}

dim3 grid_of(const mg::Rect& a) {
  return dim3((a.C + BX - 1) / BX, (a.R + BY - 1) / BY);
}

}  // namespace

extern "C" {

// u, b, r: the R x C tile at global (row_off, col_off) of the n x n grid
// (a whole grid: R = C = n + 2 at (0, 0)); inv_h2, sig: bfloat16 values.
int mg_native2d_residual_bf16(const void* u, const void* b, void* r, int R,
                              int C, int n, int row_off, int col_off,
                              double inv_h2, double sig, void* stream) {
  const mg::Rect a{R, C, row_off, col_off};
  const Consts c{0.0f, static_cast<float>(inv_h2), static_cast<float>(sig),
                 0.0f, 0.0f};
  native_residual_kernel<<<grid_of(a), dim3(BX, BY), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(u), static_cast<const bf16*>(b),
      static_cast<bf16*>(r), a, mg::tile_inner(a, n), c);
  return static_cast<int>(cudaGetLastError());
}

// u, b, out, tmp: tiles as above (tmp: Jacobi's scratch for sweeps > 1,
// else unused); the five constants bfloat16 values; kind: mg::Kind.
int mg_native2d_sweep_bf16(const void* u, const void* b, void* out,
                           void* tmp, int R, int C, int n, int row_off,
                           int col_off, double h2, double inv_h2, double sig,
                           double inv_den, double coef, int kind, int sweeps,
                           void* stream) {
  const mg::Rect a{R, C, row_off, col_off};
  const mg::InteriorBox upd = mg::tile_inner(a, n);
  const Consts c{static_cast<float>(h2), static_cast<float>(inv_h2),
                 static_cast<float>(sig), static_cast<float>(inv_den),
                 static_cast<float>(coef)};
  const auto s = static_cast<cudaStream_t>(stream);
  const bf16* bb = static_cast<const bf16*>(b);
  bf16* o = static_cast<bf16*>(out);
  const bf16* src = static_cast<const bf16*>(u);
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    if (kind == mg::kRbgs) {
      native_rbgs_kernel<<<grid_of(a), dim3(BX, BY), 0, s>>>(
          src, bb, o, a, upd, c, 0, sweep == 0);
      const int e1 = static_cast<int>(cudaGetLastError());
      if (e1) return e1;
      native_rbgs_kernel<<<grid_of(a), dim3(BX, BY), 0, s>>>(
          o, bb, o, a, upd, c, 1, false);
      src = o;
    } else {
      bf16* dst = (sweeps - 1 - sweep) % 2 == 0 ? o : static_cast<bf16*>(tmp);
      native_jacobi_kernel<<<grid_of(a), dim3(BX, BY), 0, s>>>(
          src, bb, dst, a, upd, c);
      src = dst;
    }
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return 0;
}

}  // extern "C"

// Shared pieces of the Poisson kernels (stencil2d.cu, local2d.cu, and
// through packed_tile.cuh packed2d.cu, plocal2d.cu, transfer2d.cu and the
// row-streaming legs; stencil3d.cuh takes Coef, the storage rule and the
// words of two bfloat16). No
// kernel of the port works on a shared-memory tile of a grid any more: the
// smoothers, legs and the residual-restriction stream rows through
// registers (packed2d_legs.cuh), the residuals and prolong_add take a
// thread a point.
//
// Grids are the logical padded layout of the Python package: an
// (n+2) x (n+2) row-major array whose one-cell ghost ring is zero
// (homogeneous Dirichlet). The row pitch n+2 is odd, so rows are not
// 16-byte aligned and every access is a scalar load or store. A shard's
// tile (local2d.cu, local2d_legs.cu, local2d_sweep.cu) is a rectangle of
// that grid with its own origin (Rect); the helpers below work in global
// indices on either.
//
// The arithmetic mirrors the TPU kernels term for term
// (multigridcmt_tpu/kernels/stencil2d.py: _gs_vals, _residual_vals):
//   GS update   (h^2 b + up + down + left + right) * 1/(4 - sigma h^2)
//   residual    b - (4u - up - down - left - right) * 1/h^2 + sigma u
// nvcc contracts a*b+c into one FMA by default, so results differ from the
// plain PyTorch versions by a few ulp; the tests state tolerances for it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace mg {

// Storage and compute (the TPU modules' _cdt rule, packed2d.py:74-90): a
// kernel computes in T; its grids may be stored in a narrower S (bfloat16,
// with T float). Every value is widened to T where it is used, every store
// rounds to S, to nearest even as XLA's convert does; with S = T both are
// the identity. The kernels keep what they load in S until then (the 3D
// z-march's rings, stencil3d.cuh; the row stream's rows in flight,
// packed2d_legs.cuh): a widening issued right at its load waits for the
// load there, which made their bfloat16 modes slower than float32 on the
// card (PERF.md).
template <typename S>
constexpr bool kBf16 = std::is_same<S, __nv_bfloat16>::value;

// v, stored as S, in T.
template <typename T, typename S>
__device__ __forceinline__ T widen(S v) {
  if constexpr (kBf16<S>) {
    return __bfloat162float(v);
  } else {
    return static_cast<T>(v);
  }
}

// v rounded to the storage type S.
template <typename S, typename T>
__device__ __forceinline__ S narrow(T v) {
  if constexpr (kBf16<S>) {
    return __float2bfloat16_rn(v);
  } else {
    return static_cast<S>(v);
  }
}

// v as a store to S leaves it, in T.
template <typename S, typename T>
__device__ __forceinline__ T stored(T v) {
  if constexpr (kBf16<S>) {
    return widen<T>(narrow<S>(v));
  } else {
    return v;
  }
}

// A word of two bfloat16 (the 3D paired march, stencil3d.cuh; the paired
// packed residual, packed_tile.cuh; the row stream's rings,
// packed2d_legs.cuh): the bfloat16 in its low or its high half, widened ...
__device__ __forceinline__ float low_f(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float high_f(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// ... and lo and hi rounded to bfloat16 (to nearest even, as narrow) in one
// word, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned v;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(v) : "f"(hi), "f"(lo));
  return v;
}

enum Kind { kJacobi = 0, kRbgs = 1 };

// Per-level scalars, computed once on the host in the kernel's type T so
// that every thread uses the same rounded values.
template <typename T>
struct Coef {
  T h2;       // h^2
  T inv_h2;   // 1/h^2
  T sig;      // sigma (shift of A - sigma I)
  T inv_den;  // 1/(d - sigma h^2), the GS denominator (d = 2 ndim)
  T jscale;   // omega / (d/h^2 - sigma), the Jacobi step

  static Coef make(double h, double sigma, double omega, int d = 4) {
    Coef c;
    c.h2 = T(h * h);
    c.inv_h2 = T(1.0 / (h * h));
    c.sig = T(sigma);
    c.inv_den = T(1) / (T(d) - c.sig * c.h2);
    c.jscale = T(omega) / (T(d) * c.inv_h2 - c.sig);
    return c;
  }
};

__device__ __forceinline__ bool interior(int i, int j, int n) {
  return i >= 1 && i <= n && j >= 1 && j <= n;
}

// The points a smoother or residual sets: those interior to the n x n
// grid ...
struct Interior {
  int n;
  __device__ __forceinline__ bool operator()(int i, int j) const {
    return interior(i, j, n);
  }
};

// ... and on a shard's tile only those inside the closed box [ylo, yhi] x
// [xlo, xhi] as well: the tile's points off its outer ring (local2d.cu).
struct InteriorBox {
  int n, ylo, yhi, xlo, xhi;
  __device__ __forceinline__ bool operator()(int i, int j) const {
    return interior(i, j, n) && i >= ylo && i <= yhi && j >= xlo && j <= xhi;
  }
};

// The points a kernel on the tile a (a Rect below, or packed_tile.cuh's
// PRect: R x C points from global (goy, gox)) of the n x n grid sets:
// interior to the grid and off the tile's outer ring.
template <class Rc>
inline InteriorBox tile_inner(const Rc& a, int n) {
  return InteriorBox{n, a.goy + 1, a.goy + a.R - 2, a.gox + 1,
                     a.gox + a.C - 2};
}

// An array in device memory holding the R x C points of a padded grid
// whose first point has global index (goy, gox), row pitch C: a whole
// P x P grid (square) or one rank's tile of it.
struct Rect {
  int R, C, goy, gox;

  __host__ __device__ static Rect square(int P) {
    return Rect{P, P, 0, 0};
  }
  __device__ __forceinline__ bool holds(int i, int j) const {
    return i >= goy && i < goy + R && j >= gox && j < gox + C;
  }
  __device__ __forceinline__ size_t at(int i, int j) const {
    return static_cast<size_t>(i - goy) * C + (j - gox);
  }
};

// A coarse (nc+2)^2 grid in device memory (the logical padded layout, Pc =
// nc + 2), read point by point.
template <typename T>
struct CoarseView {
  const T* __restrict__ e;
  int Pc;

  __device__ __forceinline__ T operator()(int I, int J) const {
    return e[static_cast<size_t>(I) * Pc + J];
  }
};

// Bilinear prolongation of the coarse correction (a CoarseView) at
// interior fine (i, j): rows first, then columns, as in
// transfer.prolong. Fine 2I takes coarse I; an odd fine index averages its
// two coarse neighbours.
template <typename T>
__device__ __forceinline__ T prolong_at(const CoarseView<T>& e, int i,
                                        int j) {
  const int I = i >> 1;
  const int J = j >> 1;
  const bool odd_i = i & 1;
  const T a = odd_i ? T(0.5) * (e(I, J) + e(I + 1, J)) : e(I, J);
  if (!(j & 1)) return a;
  const T d = odd_i ? T(0.5) * (e(I, J + 1) + e(I + 1, J + 1)) : e(I, J + 1);
  return T(0.5) * (a + d);
}

// b - (A - sigma I) u at the point whose centre is p (row pitch `pitch`).
template <typename T>
__device__ __forceinline__ T residual_at(const T* p, T bval, int pitch,
                                         const Coef<T>& c) {
  const T v = p[0];
  const T au = (T(4) * v - p[-pitch] - p[pitch] - p[-1] - p[1]) * c.inv_h2;
  return bval - au + c.sig * v;
}

}  // namespace mg

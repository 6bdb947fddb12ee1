// Colour-packed arrays: the neighbour algebra and the whole-array residual
// and norm kernels shared by packed2d.cu (a whole packed grid) and
// plocal2d.cu (a shard's packed extended tile); the row-streaming legs and
// sweeps (packed2d_legs.cuh) take PRect and the phase rule.
//
// A colour-packed array (PRect) holds the R x C points of a rectangle of the
// padded grid whose first point has global index (goy, gox) as two planes of
// R x CP lanes, CP = (C+1)/2: plane 0 the red points ((i+j) even in global
// indices), plane 1 the black ones. Lane l of a row holds the rectangle's
// columns 2l and 2l+1, one of each colour: the colour-c point of lane l in
// global row i lies in rectangle column 2l + p, global column gox + 2l + p,
// with the phase
//   p = (c + i + gox) & 1          (& 1: the floor parity of a negative index)
// A whole grid (packed2d.cu) is the rectangle at (0, 0), so p = (c + i) & 1
// as in the TPU module multigridcmt_tpu/kernels/packed2d.py; a shard's tile
// (plocal2d.cu) has its global offsets, and an odd column offset flips the
// phase (the TPU module plocal2d.py calls it cpar). With C odd, the lane past
// a row's last point of one colour is a pad, which no kernel updates.
//
// The four neighbours of a colour-c point at (i, l) with phase p are the
// other colour's (i-1, l), (i+1, l), (i, l), and (i, l-1) if p = 0 or
// (i, l+1) if p = 1. Sums run in the TPU module's order, ((up + down) + same
// lane) + side lane.
//
// Storage and compute: a kernel computes in T; its arrays, a whole packed
// grid's or a tile's, may be stored in a narrower S (common.cuh's storage
// rule).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace mg {

struct PRect {
  int R, C, goy, gox;

  __host__ __device__ int lanes() const { return (C + 1) / 2; }
};

// Phase of colour c in global row gy of an array whose column 0 is global
// gx0.
__device__ __forceinline__ int pphase(int c, int gy, int gx0) {
  return (c + gy + gx0) & 1;
}

// Sum of the four neighbours of the point at lane index k of its plane, read
// from the other colour's plane o (row pitch `pitch` lanes, index type I,
// storage S), in T.
template <typename T, typename S, typename I>
__device__ __forceinline__ T nsum(const S* o, I k, I pitch, int p) {
  return ((widen<T>(o[k - pitch]) + widen<T>(o[k + pitch])) +
          widen<T>(o[k])) +
         widen<T>(o[p ? k + 1 : k - 1]);
}

// b - (A - sigma I) u at lane index k of plane uc (other plane uo), both
// stored in S, computed in T.
template <typename T, typename S, typename I>
__device__ __forceinline__ T presidual(const S* uc, const S* uo, T bval,
                                       I k, I pitch, int p,
                                       const Coef<T>& cf) {
  const T v = widen<T>(uc[k]);
  return bval - (T(4) * v - nsum<T>(uo, k, pitch, p)) * cf.inv_h2 +
         cf.sig * v;
}

// Sum of `v` over a block of NT threads, valid in thread 0.
template <int NT>
__device__ double block_sum(double v) {
  __shared__ double warp_sums[NT / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < NT / 32 ? warp_sums[threadIdx.x] : 0.0;
  if (threadIdx.x < 32) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  }
  return v;
}

// ---------------------------------------------------------------------------
// Kernels on a whole packed array, one thread a lane: the residual (or the
// operator apply) and the residual norm. Bound by memory: u's two planes
// and b read (the apply: u only), r written; the four neighbour reads of a
// lane hit in L1/L2.
// ---------------------------------------------------------------------------

constexpr int kLaneThreads = 256;

// r = b - (A - sigma I) u (HAS_B) or (A - sigma I) u on both planes of the
// array a; 0 where `upd` fails (ghosts, a tile's ring, pad lanes), so a dot
// over whole arrays is a dot over the points upd sets. u, b and r are
// stored in S, r computed in T.
template <typename T, bool HAS_B, typename Upd, typename S = T>
__global__ void __launch_bounds__(kLaneThreads)
presidual_kernel(const S* __restrict__ u, const S* __restrict__ b,
                 S* __restrict__ out, PRect a, Upd upd, Coef<T> cf) {
  const int cp = a.lanes();
  const size_t plane = static_cast<size_t>(a.R) * cp;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= 2 * plane) return;
  const int c = idx >= plane;
  const size_t k = idx - c * plane;
  const int i = static_cast<int>(k / cp);
  const int l = static_cast<int>(k - static_cast<size_t>(i) * cp);
  const int gy = a.goy + i;
  const int p = pphase(c, gy, a.gox);
  T r = T(0);
  if (upd(gy, a.gox + 2 * l + p)) {
    const T v = widen<T>(u[idx]);
    const T au = (T(4) * v - nsum<T>(u + (1 - c) * plane, k,
                                     static_cast<size_t>(cp), p)) *
                 cf.inv_h2;
    r = HAS_B ? widen<T>(b[idx]) - au + cf.sig * v : au - cf.sig * v;
  }
  out[idx] = narrow<S>(r);
}

// ---------------------------------------------------------------------------
// The residual of a whole packed grid stored in bfloat16 on words of two
// lanes (presidual_pairs_kernel; launch_presidual takes it for
// packed2d_bf16.cu's residual where the layout pairs, presidual_pairs, and
// presidual_kernel elsewhere). With cp odd (n = 3 mod 4, every n =
// 2^k - 1) the rows of the two planes start on alternate parities: plane
// c's row i starts on an even index iff (c + i) is even, which is the
// row's phase p. So a thread takes the lanes
// a = 2f + p and a + 1 of its row, one aligned word of u, b and r, and of
// the other plane o: rows i - 1 and i + 1 start as its row does (one word
// each, the lanes above and below), row i the other way (the words at
// lanes a - 1 and a + 1, which hold the same and the side lanes of both
// points). A row has (cp - 1) / 2 such words; its odd lane (the last, a
// pad or ghost, when p = 0; lane 0 when p = 1) is the first thread's, a
// scalar point. Rows 0 and n + 1 are ghosts: zero, no loads. The block's
// row comes from the grid (blockIdx.y = 2 i + c: the two planes' rows i
// side by side, so u's rows are read from device memory once), its lane
// from blockIdx.x: no division. Arithmetic is presidual_kernel's, point
// for point; each output point is rounded once (pack_bf16).
// ---------------------------------------------------------------------------

constexpr int kPairThreads = 256;

// Whether the whole packed (n+2)^2 grid a with arrays u, b and r pairs
// its lanes into words: cp odd, every array on a word, and its 2 (n + 2)
// rows within a grid's y extent (packed2d.py counts by the same rule).
inline bool presidual_pairs(const void* u, const void* b, const void* out,
                            const PRect& a) {
  return (a.lanes() & 1) && 2 * a.R <= 65535 &&
         reinterpret_cast<uintptr_t>(u) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 4 == 0;
}

// b - (A - sigma I) u at a point of value v and neighbour values up, down,
// same and side, as presidual_kernel computes it.
__device__ __forceinline__ float presidual_point(float v, float bv, float up,
                                                 float down, float same,
                                                 float side,
                                                 const Coef<float>& cf) {
  const float au =
      (4.0f * v - (((up + down) + same) + side)) * cf.inv_h2;
  return bv - au + cf.sig * v;
}

template <typename S>
__global__ void __launch_bounds__(kPairThreads)
presidual_pairs_kernel(const S* __restrict__ u, const S* __restrict__ b,
                       S* __restrict__ out, PRect a, int n, Coef<float> cf) {
  static_assert(kBf16<S>, "words of two bfloat16");
  const int cp = a.lanes();
  const int c = blockIdx.y & 1;
  const int i = blockIdx.y >> 1;
  const int p = (c + i) & 1;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const int words = (cp - 1) / 2;
  if (f >= words) return;
  const size_t plane = static_cast<size_t>(a.R) * cp;
  const size_t row = c * plane + static_cast<size_t>(i) * cp;
  const size_t orow = (1 - c) * plane + static_cast<size_t>(i) * cp;
  const unsigned* U = reinterpret_cast<const unsigned*>(u);
  const unsigned* B = reinterpret_cast<const unsigned*>(b);
  const int l = 2 * f + p;   // the word's first lane
  const bool inner = i >= 1 && i <= n;
  float r0 = 0.0f, r1 = 0.0f;
  if (inner) {
    const unsigned w = __ldg(U + (row + l) / 2);
    const unsigned wb = __ldg(B + (row + l) / 2);
    const unsigned up = __ldg(U + (orow - cp + l) / 2);
    const unsigned dn = __ldg(U + (orow + cp + l) / 2);
    const unsigned lo = __ldg(U + (orow + l - 1) / 2);   // lanes l-1, l
    const unsigned hi = __ldg(U + (orow + l + 1) / 2);   // lanes l+1, l+2
    // Columns 2l + p and 2l + 2 + p.
    if (2 * l + p >= 1 && 2 * l + p <= n) {
      r0 = presidual_point(low_f(w), low_f(wb), low_f(up), low_f(dn),
                           high_f(lo), p ? low_f(hi) : low_f(lo), cf);
    }
    if (2 * l + 2 + p <= n) {
      r1 = presidual_point(high_f(w), high_f(wb), high_f(up), high_f(dn),
                           low_f(hi), p ? high_f(hi) : high_f(lo), cf);
    }
  }
  reinterpret_cast<unsigned*>(out)[(row + l) / 2] = pack_bf16(r0, r1);
  if (f != 0) return;
  // The row's odd lane: the last (column 2 cp - 2 = n + 1, a ghost) when
  // p = 0, lane 0 (column 1) when p = 1.
  float r = 0.0f;
  if (p && inner && n >= 1) {
    r = presidual_point(widen<float>(u[row]), widen<float>(b[row]),
                        widen<float>(u[orow - cp]), widen<float>(u[orow + cp]),
                        widen<float>(u[orow]), widen<float>(u[orow + 1]), cf);
  }
  out[row + (p ? 0 : cp - 1)] = narrow<S>(r);
}

// Residual norm, first pass: each block sums r^2 over a grid-stride share
// of the points of rows [qlo, qhi) and array columns [slo, shi) where `upd`
// holds, in the first `planes` planes (1: red only), into
// partial[blockIdx.x], in float64; each point is visited once. u and b are
// stored in S, each load widened to T, and r is computed in T, as the
// plain versions compute it; no residual array is written.
template <typename T, typename Upd, typename S = T>
__global__ void __launch_bounds__(kLaneThreads)
presnorm_partial(const S* __restrict__ u, const S* __restrict__ b,
                 double* __restrict__ partial, PRect a, Upd upd, int qlo,
                 int qhi, int slo, int shi, Coef<T> cf, int planes) {
  const int cp = a.lanes();
  const size_t plane = static_cast<size_t>(a.R) * cp;
  const size_t per_plane = static_cast<size_t>(qhi - qlo) * cp;
  double acc = 0.0;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < planes * per_plane;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = idx >= per_plane;
    const size_t r = idx - c * per_plane;
    const int i = qlo + static_cast<int>(r / cp);
    const int l = static_cast<int>(r - static_cast<size_t>(i - qlo) * cp);
    const int gy = a.goy + i;
    const int p = pphase(c, gy, a.gox);
    const int lx = 2 * l + p;
    if (lx < slo || lx >= shi || !upd(gy, a.gox + lx)) continue;
    const size_t k = static_cast<size_t>(i) * cp + l;
    const T res = presidual<T>(u + c * plane, u + (1 - c) * plane,
                               widen<T>(b[c * plane + k]), k,
                               static_cast<size_t>(cp), p, cf);
    acc += static_cast<double>(res) * static_cast<double>(res);
  }
  const double total = block_sum<kLaneThreads>(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// A residual norm's second pass: one block of NT threads sums the first
// pass's float64 partials in a fixed order, so the result does not depend on
// the blocks' timing.
template <typename T, int NT>
__global__ void __launch_bounds__(NT)
sum_partials(const double* __restrict__ partial, int count,
             T* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += partial[i];
  const double total = block_sum<NT>(acc);
  if (threadIdx.x == 0) out[0] = static_cast<T>(total);
}

// Launch presidual_pairs_kernel on the whole packed grid a (S =
// bfloat16, a pairing layout); returns cudaGetLastError().
template <typename S>
int launch_presidual_pairs(const void* u, const void* b, void* out,
                           const PRect& a, int n, double h, double sigma,
                           void* stream) {
  const int words = (a.lanes() - 1) / 2;
  const dim3 grid((words + kPairThreads - 1) / kPairThreads, 2 * a.R);
  presidual_pairs_kernel<S><<<grid, kPairThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(u), static_cast<const S*>(b),
      static_cast<S*>(out), a, n, Coef<float>::make(h, sigma, 1.0));
  return static_cast<int>(cudaGetLastError());
}

// Launch presidual_kernel on the array a (stored in S, computed in T);
// returns cudaGetLastError(). The residual of a whole grid (upd Interior)
// stored in bfloat16 takes presidual_pairs_kernel where the layout pairs.
template <typename T, typename Upd, typename S = T>
int launch_presidual(const void* u, const void* b, void* out, const PRect& a,
                     const Upd& upd, double h, double sigma, bool has_b,
                     void* stream) {
  if constexpr (kBf16<S> && std::is_same<Upd, Interior>::value) {
    if (has_b && presidual_pairs(u, b, out, a)) {
      return launch_presidual_pairs<S>(u, b, out, a, upd.n, h, sigma,
                                       stream);
    }
  }
  const size_t total = 2 * static_cast<size_t>(a.R) * a.lanes();
  const unsigned blocks =
      static_cast<unsigned>((total + kLaneThreads - 1) / kLaneThreads);
  const auto kernel = has_b ? presidual_kernel<T, true, Upd, S>
                            : presidual_kernel<T, false, Upd, S>;
  kernel<<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(u), static_cast<const S*>(b),
      static_cast<S*>(out), a, upd, Coef<T>::make(h, sigma, 1.0));
  return static_cast<int>(cudaGetLastError());
}

// Both passes of the residual norm over rows [qlo, qhi) and columns
// [slo, shi) of the array a (`blocks` partials in `partial`), the sum into
// out[0] in T (float32 for bfloat16 storage S, as the TPU kernel's); returns
// the first launch error.
template <typename T, typename Upd, typename S = T>
int launch_presnorm(const void* u, const void* b, void* partial, void* out,
                    const PRect& a, const Upd& upd, int qlo, int qhi,
                    int slo, int shi, double h, double sigma, int red_only,
                    int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  presnorm_partial<T, Upd, S><<<blocks, kLaneThreads, 0, s>>>(
      static_cast<const S*>(u), static_cast<const S*>(b),
      static_cast<double*>(partial), a, upd, qlo, qhi, slo, shi,
      Coef<T>::make(h, sigma, 1.0), red_only ? 1 : 2);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  sum_partials<T, kLaneThreads><<<1, kLaneThreads, 0, s>>>(
      static_cast<const double*>(partial), blocks, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mg

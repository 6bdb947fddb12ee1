// The z-march of the 3D 7-point Poisson kernels: the residual, a
// weighted-Jacobi sweep and a red-black Gauss-Seidel sweep, instantiated by
// stencil3d.cu (float32, float64) and stencil3d_bf16.cu (bfloat16
// storage). They replace the three modes of the one TPU kernel in
// multigridcmt_tpu/kernels/stencil3d.py (its pallas_call):
//   residual     -> pass_kernel, kResidual
//   jacobi_sweep -> pass_kernel, kJacobi (a launch a sweep)
//   rbgs_sweep   -> rbgs_kernel (a launch a sweep, one pass, like the TPU
//                   kernel's two-colour pipeline)
//
// Grids are stacks of p planes of r x c points, row-major, c = n+2: the
// logical padded (n+2)^3 grid of a level, or a slab or pencil stack whose
// plane 0 is global plane goff and row 0 global row roff. The rules, as in
// the TPU kernel (_valid, red_plane):
//   * a plane is valid if it is not the stack's first or last and its
//     global index g+goff lies in [1, n]; every output plane that is not
//     valid is zero (within a sweep its points keep u, for the black
//     points' reads);
//   * in a valid plane a point is updated if its global row and column lie
//     in [1, n] and its row is not the stack's first or last (its four
//     in-plane neighbours are in the stack); elsewhere the residual is 0
//     and the sweeps keep u;
//   * red means (g+goff) + (y+roff) + x even.
// Arithmetic in the TPU kernel's order: the neighbour sum
// ((z-1 + z+1) + y-1 + y+1 + x-1 + x+1); residual b - (6u - sum)/h^2 +
// sigma u; Gauss-Seidel (h^2 b + sum) * 1/(6 - sigma h^2); Jacobi u +
// omega/(6/h^2 - sigma) * residual. nvcc contracts a*b+c into FMAs, so
// results differ from the plain versions by a few ulp.
//
// Storage (the TPU kernel's _cdt rule, stencil3d.py:126-133): each kernel
// computes in T (float32 or float64); u and b are stored in S and the
// output in O. S = O = T is the float32/float64 code. S = bfloat16 (T =
// float) is the fine level of a mixed cycle: every load widens to float,
// the RB-GS sweep rounds each red value to bfloat16 before the black stage
// reads it (the TPU kernel's red ring is of the storage dtype), and each
// output point is rounded once, on its store. O = float with S = bfloat16
// is the residual's output (always float32: it feeds the coarse levels)
// and the sweeps' out_dtype; their red points are then the rounded values,
// widened, and their black points float32.
//
// What bounds them on the card: device-memory traffic. Each kernel reads u
// and b once and writes one grid, 12 bytes a point in float32 against
// ~10-16 flops; at 511^3 a grid is 540 MB, far past the 50 MB L2. On an
// H100 at 511^3 float32 the residual and Jacobi run at ~83% of that bound
// and the sweep at ~60% (PERF.md): the sweep's halo makes its warps load
// ~16 bytes a point (u on 12 rows and 32 columns for 8 x 28 owned
// points), and its ~160 registers leave 12 warps an SM to cover the loads'
// latency.
//
// The design, a z-march by warps. A unit of work is one warp: a strip of
// 32 columns (one a lane) by a band of rows (kRbgsRows*, kPassRows*),
// marching along z over a chunk of planes (stencil3d.py's march_geometry
// computes the strips, bands and chunks). Each lane keeps its column's rows
// of the planes it needs in registers (as stored), in rings of kSlots planes
// whose slots are fixed at compile time (the z-loop is unrolled by kSlots),
// so nothing lives in shared memory and no barrier is taken: the
// y-neighbours are registers, the x-neighbours warp shuffles. The loads of
// a plane are issued a step before it is used, so each warp keeps a
// plane's rows of u and b in flight while it computes; a whole-warp load
// reads 32 neighbouring columns (the rows are not 16-byte aligned, c being
// odd, nor in bfloat16 4-byte aligned, so each lane loads one scalar). The
// halo (H columns each side, H rows above and below, the planes just past a
// chunk) is read again by the neighbouring unit, mostly from L2, since
// neighbouring units run at the same time.
//
// The RB-GS sweep is one pass, the TPU kernel's two-colour pipeline laid
// out for units that run in parallel: at the step of plane z a warp
// red-updates plane z+1 from the original u of planes z, z+1, z+2 (a red
// point's neighbours are all black, not yet touched), then black-updates
// plane z from the red-updated planes z-1, z, z+1 (a black point's
// neighbours are all red, all updated): exact Gauss-Seidel order. The red
// values are computed on a one-point ring around the unit's core (from u
// on a two-point ring, H = 2), and on the planes just below and above its
// chunk, from the original u: since out never aliases u, no unit needs a
// value another unit wrote, and each output point has one writer.
#pragma once

#include "common.cuh"

namespace {

// The march's constants; kernels/stencil3d.py's MARCH_* are these (a CPU
// test reads them here).
constexpr int kLanes = 32;         // columns of a strip: one warp
constexpr int kWarps = 4;          // warps (independent units) a block
constexpr int kSlots = 4;          // planes of each register ring
constexpr int kRbgsRowsF32 = 8;    // rows of a band: the RB-GS sweep
constexpr int kRbgsRowsF64 = 4;
constexpr int kPassRowsF32 = 8;    // the residual and Jacobi
constexpr int kPassRowsF64 = 8;

enum Mode { kResidual = 0, kJacobi = 1 };

struct Stack {
  int p, r, c, n, goff, roff;
};

// The launch geometry, passed as 5 ints in this order. Warp w of block bx
// works on unit bx * kWarps + w: strip sx = unit % strips, band sy =
// (unit / strips) % bands, chunk sz = unit / (strips * bands). It owns
// columns [sx * width, sx * width + width) (its lanes start H before,
// width + 2H <= kLanes), rows [sy * R, sy * R + R) (R the kernel's rows)
// and planes [sz * chunk, sz * chunk + chunk), each clipped to the stack.
struct Geom {
  int strips, bands, chunks, width, chunk;
};

// A band's rows by compute type T (bfloat16 storage computes in float and
// takes float's rows).
template <typename T>
struct Rows;
template <>
struct Rows<float> {
  static constexpr int rbgs = kRbgsRowsF32;
  static constexpr int pass = kPassRowsF32;
};
template <>
struct Rows<double> {
  static constexpr int rbgs = kRbgsRowsF64;
  static constexpr int pass = kPassRowsF64;
};

// A warp's unit, with H rows and columns of halo and R core rows: region
// row j of a lane is stack row y0 - H + j, j in [0, R + 2H).
template <int H, int R>
struct Unit {
  int x;              // this lane's column
  int y0;             // the first core row
  int z0, z1;         // the chunk's planes
  int par;            // (y0 - H + roff + x) & 1: the colour parity of row 0
  unsigned rows;      // bit j: region row j and the column lie in the stack
  unsigned upd;       // bit j: the point is updated in a valid plane
  unsigned mine;      // bit j: this lane stores region row j
  bool ok;            // the warp has a unit

  __device__ Unit(const Stack& s, const Geom& g) {
    const int lane = threadIdx.x % kLanes;
    const int unit = blockIdx.x * kWarps + threadIdx.x / kLanes;
    const int sx = unit % g.strips;
    const int sy = (unit / g.strips) % g.bands;
    const int sz = unit / (g.strips * g.bands);
    ok = sz < g.chunks;
    x = sx * g.width - H + lane;
    y0 = sy * R;
    z0 = sz * g.chunk;
    z1 = min(z0 + g.chunk, s.p);
    par = (y0 - H + s.roff + x) & 1;
    const bool col = lane < g.width + 2 * H && x >= 0 && x < s.c;
    const bool core = lane >= H && lane < H + g.width && x < s.c;
    rows = upd = mine = 0u;
#pragma unroll
    for (int j = 0; j < R + 2 * H; ++j) {
      const int y = y0 - H + j;
      const int gy = y + s.roff;
      if (col && y >= 0 && y < s.r) rows |= 1u << j;
      if (col && y >= 1 && y <= s.r - 2 && gy >= 1 && gy <= s.n && x >= 1 &&
          x <= s.n) {
        upd |= 1u << j;
      }
      if (core && j >= H && j < H + R && y < s.r) mine |= 1u << j;
    }
  }
};

__device__ __forceinline__ bool plane_valid(int q, const Stack& s) {
  const int g = q + s.goff;
  return q >= 1 && q <= s.p - 2 && g >= 1 && g <= s.n;
}

// Bit j: region row j is red in plane q (row 0's parity par).
__device__ __forceinline__ unsigned red_rows(int q, const Stack& s,
                                             int par) {
  return ((q + s.goff + par) & 1) ? 0xAAAAAAAAu : 0x55555555u;
}

// v[i] = a at plane q, region row j0 + i of this lane's column, as stored;
// 0 off the stack, for rows outside `mask` and for planes outside
// [0, qend). The rings keep the storage type and widen each value where it
// is used, a step after its load was issued: a widening at the load would
// wait for the load there and leave its latency bare.
template <int H, int R, int N, typename S>
__device__ __forceinline__ void load_rows(S (&v)[N], const S* __restrict__ a,
                                          const Stack& s, const Unit<H, R>& t,
                                          int q, int qend, int j0,
                                          unsigned mask) {
  const bool zin = q >= 0 && q < min(qend, s.p);
  const long long base =
      (static_cast<long long>(q) * s.r + (t.y0 - H + j0)) * s.c + t.x;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = (zin && ((mask >> (j0 + i)) & 1u))
               ? a[base + static_cast<long long>(i) * s.c]
               : S{};
  }
}

// The x-neighbours of this lane's value: lane - 1's and lane + 1's. A
// warp's edge lanes read their own value; they are halo columns, whose
// results no owned point reads.
template <typename T>
__device__ __forceinline__ T left_of(T v) {
  return __shfl_up_sync(0xffffffffu, v, 1);
}
template <typename T>
__device__ __forceinline__ T right_of(T v) {
  return __shfl_down_sync(0xffffffffu, v, 1);
}

// ---------------------------------------------------------------------------
// The RB-GS sweep (H = 2). Rings: u (R + 4 region rows), b and the
// red-updated planes (R + 2 rows: region rows 1 .. R + 2, the core and a
// one-row ring). Plane q lives in slot (q - z0) & 3 of each ring. u's and
// b's rings hold S, the red ring T.
// ---------------------------------------------------------------------------

template <typename T, int R, typename S, typename O>
struct RbgsMarch {
  static constexpr int H = 2;
  static constexpr int NU = R + 2 * H;
  static constexpr int NR = R + 2;

  // A ring value (as stored) in T.
  static __device__ __forceinline__ T wide(S v) { return mg::widen<T>(v); }

  const S* __restrict__ u;
  const S* __restrict__ b;
  O* __restrict__ out;
  Stack s;
  mg::Coef<T> cf;
  Unit<H, R> t;
  unsigned bmask;     // rows of b worth loading: the red ring's lanes
  S uu[kSlots][NU];
  S bb[kSlots][NR];
  T rr[kSlots][NR];

  __device__ RbgsMarch(const S* u_, const S* b_, O* out_, const Stack& s_,
                       const Geom& g, const mg::Coef<T>& cf_)
      : u(u_), b(b_), out(out_), s(s_), cf(cf_), t(s_, g) {
    const int lane = threadIdx.x % kLanes;
    bmask = (lane >= 1 && lane <= g.width + 2) ? t.rows : 0u;
  }

  // Plane z1 + 1 is the last u plane a chunk reads, z1 the last b plane.
  template <int Z>
  __device__ __forceinline__ void load_u(int q) {
    load_rows(uu[Z], u, s, t, q, t.z1 + 2, 0, t.rows);
  }

  template <int Z>
  __device__ __forceinline__ void load_b(int q) {
    load_rows(bb[Z], b, s, t, q, t.z1 + 1, 1, bmask);
  }

  // The red-updated plane q into slot D from u's slots L, M, U (planes
  // q - 1, q, q + 1) and b's slot D, each red value as stored in S (the TPU
  // kernel keeps its red ring in the storage dtype).
  template <int D, int L, int M, int U>
  __device__ __forceinline__ void red(int q) {
    const unsigned upd =
        plane_valid(q, s) ? (t.upd & red_rows(q, s, t.par)) : 0u;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const T cur = wide(uu[M][i + 1]);
      const T left = left_of(cur);
      const T right = right_of(cur);
      const T sum = ((((wide(uu[L][i + 1]) + wide(uu[U][i + 1])) +
                       wide(uu[M][i])) + wide(uu[M][i + 2])) + left) + right;
      const T gs = (cf.h2 * wide(bb[D][i]) + sum) * cf.inv_den;
      rr[D][i] = ((upd >> (i + 1)) & 1u) ? mg::stored<S>(gs) : cur;
    }
  }

  // Plane q's black update from the red ring's slots L, M, U (planes
  // q - 1, q, q + 1) and b's slot M; stores the unit's core rows.
  template <int L, int M, int U>
  __device__ __forceinline__ void black(int q) {
    const bool valid = plane_valid(q, s);
    const unsigned upd = valid ? (t.upd & ~red_rows(q, s, t.par)) : 0u;
    const long long base =
        (static_cast<long long>(q) * s.r + t.y0) * s.c + t.x;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = i + 1;   // the red ring's row of core row i
      const T cur = rr[M][k];
      const T left = left_of(cur);
      const T right = right_of(cur);
      const T sum = ((((rr[L][k] + rr[U][k]) + rr[M][k - 1]) +
                      rr[M][k + 1]) + left) + right;
      const T gs = (cf.h2 * wide(bb[M][k]) + sum) * cf.inv_den;
      T v = ((upd >> (i + H)) & 1u) ? gs : cur;
      if (!valid) v = T(0);
      if ((t.mine >> (i + H)) & 1u) {
        out[base + static_cast<long long>(i) * s.c] = mg::narrow<O>(v);
      }
    }
  }

  // The step of plane z = z0 + 4m + K: load u(z + 3) and b(z + 2) for the
  // next step, red-update plane z + 1, black-update plane z.
  template <int K>
  __device__ __forceinline__ void step(int z) {
    load_u<(K + 3) & 3>(z + 3);
    load_b<(K + 2) & 3>(z + 2);
    red<(K + 1) & 3, K, (K + 1) & 3, (K + 2) & 3>(z + 1);
    black<(K + 3) & 3, K, (K + 1) & 3>(z);
  }

  __device__ __forceinline__ void run() {
    const int z0 = t.z0;
    load_u<2>(z0 - 2);
    load_u<3>(z0 - 1);
    load_u<0>(z0);
    load_u<1>(z0 + 1);
    load_b<3>(z0 - 1);
    load_b<0>(z0);
    red<3, 2, 3, 0>(z0 - 1);
    load_u<2>(z0 + 2);   // u(z0 - 2)'s slot, free from here on
    load_b<1>(z0 + 1);
    red<0, 3, 0, 1>(z0);
    for (int z = z0; z < t.z1; z += kSlots) {
      step<0>(z);
      if (z + 1 == t.z1) break;
      step<1>(z + 1);
      if (z + 2 == t.z1) break;
      step<2>(z + 2);
      if (z + 3 == t.z1) break;
      step<3>(z + 3);
    }
  }
};

template <typename T, int R, typename S, typename O>
__global__ void __launch_bounds__(kWarps * kLanes)
rbgs_kernel(const S* __restrict__ u, const S* __restrict__ b,
            O* __restrict__ out, Stack s, Geom g, mg::Coef<T> cf) {
  RbgsMarch<T, R, S, O> m(u, b, out, s, g, cf);
  if (!m.t.ok) return;   // a whole warp: no lane of it shuffles
  m.run();
}

// ---------------------------------------------------------------------------
// The residual and Jacobi (H = 1): one pass from u's ring (R + 2 region
// rows) and b's (the R core rows).
// ---------------------------------------------------------------------------

template <typename T, int R, int MODE, typename S, typename O>
struct PassMarch {
  static constexpr int H = 1;
  static constexpr int NU = R + 2 * H;

  // A ring value (as stored) in T.
  static __device__ __forceinline__ T wide(S v) { return mg::widen<T>(v); }

  const S* __restrict__ u;
  const S* __restrict__ b;
  O* __restrict__ out;
  Stack s;
  mg::Coef<T> cf;
  Unit<H, R> t;
  S uu[kSlots][NU];
  S bb[kSlots][R];

  __device__ PassMarch(const S* u_, const S* b_, O* out_, const Stack& s_,
                       const Geom& g, const mg::Coef<T>& cf_)
      : u(u_), b(b_), out(out_), s(s_), cf(cf_), t(s_, g) {}

  template <int Z>
  __device__ __forceinline__ void load_u(int q) {
    load_rows(uu[Z], u, s, t, q, t.z1 + 1, 0, t.rows);
  }

  template <int Z>
  __device__ __forceinline__ void load_b(int q) {
    load_rows(bb[Z], b, s, t, q, t.z1, H, t.mine);
  }

  // Plane q from u's slots L, M, U (planes q - 1, q, q + 1) and b's M.
  template <int L, int M, int U>
  __device__ __forceinline__ void apply(int q) {
    const bool valid = plane_valid(q, s);
    const unsigned upd = valid ? t.upd : 0u;
    const long long base =
        (static_cast<long long>(q) * s.r + t.y0) * s.c + t.x;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = i + H;   // u's row of core row i
      const T cur = wide(uu[M][k]);
      const T left = left_of(cur);
      const T right = right_of(cur);
      const T sum = ((((wide(uu[L][k]) + wide(uu[U][k])) +
                       wide(uu[M][k - 1])) + wide(uu[M][k + 1])) + left) +
                    right;
      T v = MODE == kResidual ? T(0) : cur;
      if ((upd >> k) & 1u) {
        const T res = wide(bb[M][i]) - (T(6) * cur - sum) * cf.inv_h2 +
                      cf.sig * cur;
        v = MODE == kResidual ? res : cur + cf.jscale * res;
      }
      if (!valid) v = T(0);
      if ((t.mine >> k) & 1u) {
        out[base + static_cast<long long>(i) * s.c] = mg::narrow<O>(v);
      }
    }
  }

  // The step of plane z = z0 + 4m + K: load u(z + 2) and b(z + 1) for the
  // next step, then plane z.
  template <int K>
  __device__ __forceinline__ void step(int z) {
    load_u<(K + 2) & 3>(z + 2);
    load_b<(K + 1) & 3>(z + 1);
    apply<(K + 3) & 3, K, (K + 1) & 3>(z);
  }

  __device__ __forceinline__ void run() {
    const int z0 = t.z0;
    load_u<3>(z0 - 1);
    load_u<0>(z0);
    load_u<1>(z0 + 1);
    load_b<0>(z0);
    for (int z = z0; z < t.z1; z += kSlots) {
      step<0>(z);
      if (z + 1 == t.z1) break;
      step<1>(z + 1);
      if (z + 2 == t.z1) break;
      step<2>(z + 2);
      if (z + 3 == t.z1) break;
      step<3>(z + 3);
    }
  }
};

template <typename T, int R, int MODE, typename S, typename O>
__global__ void __launch_bounds__(kWarps * kLanes)
pass_kernel(const S* __restrict__ u, const S* __restrict__ b,
            O* __restrict__ out, Stack s, Geom g, mg::Coef<T> cf) {
  PassMarch<T, R, MODE, S, O> m(u, b, out, s, g, cf);
  if (!m.t.ok) return;
  m.run();
}

// The geometry must be the one march_geometry computes for these rows and
// halo: every point owned once, by whole strips, bands and chunks.
bool geom_fits(const Stack& s, const Geom& g, int rows, int halo) {
  return g.strips >= 1 && g.bands >= 1 && g.chunks >= 1 && g.width >= 1 &&
         g.chunk >= 1 && g.width + 2 * halo <= kLanes &&
         static_cast<long long>(g.strips) * g.width >= s.c &&
         static_cast<long long>(g.strips - 1) * g.width < s.c &&
         static_cast<long long>(g.bands) * rows >= s.r &&
         static_cast<long long>(g.bands - 1) * rows < s.r &&
         static_cast<long long>(g.chunks) * g.chunk >= s.p &&
         static_cast<long long>(g.chunks - 1) * g.chunk < s.p;
}

template <typename S, typename O, typename Kernel, typename T>
int launch(Kernel kernel, const void* u, const void* b, void* out,
           const Stack& s, const int* geom, int rows, int halo,
           const mg::Coef<T>& cf, void* stream) {
  const Geom g{geom[0], geom[1], geom[2], geom[3], geom[4]};
  if (!geom_fits(s, g, rows, halo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units =
      static_cast<long long>(g.strips) * g.bands * g.chunks;
  const unsigned blocks = static_cast<unsigned>((units + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(u), static_cast<const S*>(b), static_cast<O*>(out),
      s, g, cf);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S = T, typename O = T>
int residual(const void* u, const void* b, void* out, int p, int r, int c,
             int n, double h, double sigma, int goff, int roff,
             const int* geom, void* stream) {
  constexpr int R = Rows<T>::pass;
  return launch<S, O>(pass_kernel<T, R, kResidual, S, O>, u, b, out,
                Stack{p, r, c, n, goff, roff}, geom, R, 1,
                mg::Coef<T>::make(h, sigma, 1.0, 6), stream);
}

template <typename T, typename S = T, typename O = T>
int jacobi(const void* u, const void* b, void* out, int p, int r, int c,
           int n, double h, double sigma, double omega, int goff, int roff,
           const int* geom, void* stream) {
  constexpr int R = Rows<T>::pass;
  return launch<S, O>(pass_kernel<T, R, kJacobi, S, O>, u, b, out,
                Stack{p, r, c, n, goff, roff}, geom, R, 1,
                mg::Coef<T>::make(h, sigma, omega, 6), stream);
}

template <typename T, typename S = T, typename O = T>
int rbgs(const void* u, const void* b, void* out, int p, int r, int c, int n,
         double h, double sigma, int goff, int roff, const int* geom,
         void* stream) {
  constexpr int R = Rows<T>::rbgs;
  return launch<S, O>(rbgs_kernel<T, R, S, O>, u, b, out,
                      Stack{p, r, c, n, goff, roff}, geom, R, 2,
                      mg::Coef<T>::make(h, sigma, 1.0, 6), stream);
}

}  // namespace

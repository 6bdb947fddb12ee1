// The z-march of the 3D 7-point Poisson kernels: the residual, a
// weighted-Jacobi sweep and a red-black Gauss-Seidel sweep, instantiated by
// stencil3d.cu (float32, float64) and stencil3d_bf16.cu (bfloat16
// storage). They replace the three modes of the one TPU kernel in
// multigridcmt_tpu/kernels/stencil3d.py (its pallas_call):
//   residual     -> pass_kernel, kResidual
//   jacobi_sweep -> pass_kernel, kJacobi (a launch a sweep); storing
//                   bfloat16 from bfloat16, jacobi_pairs_kernel where the
//                   layout pairs (below)
//   rbgs_sweep   -> rbgs_kernel (a launch a sweep, one pass, like the TPU
//                   kernel's two-colour pipeline); with bfloat16 storage,
//                   rbgs_pairs_kernel where the layout pairs (below)
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
// latency. The march is latency-bound: its rate follows the bytes an SM
// keeps in flight. So the bfloat16 sweep on the scalar march, with half
// the bytes a load, ran 0.79 ms, 2% slower than float32's 0.77 (30% of
// its bound); on words (rbgs_pairs_kernel, below: 2 points a lane, 4-row
// bands, 128 registers, 16 warps an SM) it runs 0.41 ms storing bfloat16
// and 0.47 storing float32, 59% and 68% of their bounds, on an H100 at
// 700 W (PERF.md). Likewise the bfloat16 Jacobi sweep: 0.52 ms on the
// scalar march (47%), 0.34 ms on words (jacobi_pairs_kernel, 4-row bands,
// 92-94 registers: 72%); 8-row bands held 144-148 registers, 12 warps an
// SM, and ran 0.40 ms.
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
// odd, so each lane loads one scalar; the bfloat16 sweeps' paired marches
// below pair them into 4-byte words where the layout allows). The
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

#include <cstdint>

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
};

// The RB-GS sweep's schedule (RbgsMarch's and PairMarch's). The step of
// plane z = z0 + 4m + K: load u(z + 3) and b(z + 2) for the next step,
// red-update plane z + 1, black-update plane z.
template <int K, typename March>
__device__ __forceinline__ void rbgs_step(March& m, int z) {
  m.template load_u<(K + 3) & 3>(z + 3);
  m.template load_b<(K + 2) & 3>(z + 2);
  m.template red<(K + 1) & 3, K, (K + 1) & 3, (K + 2) & 3>(z + 1);
  m.template black<(K + 3) & 3, K, (K + 1) & 3>(z);
}

template <typename March>
__device__ __forceinline__ void rbgs_run(March& m) {
  const int z0 = m.t.z0;
  m.template load_u<2>(z0 - 2);
  m.template load_u<3>(z0 - 1);
  m.template load_u<0>(z0);
  m.template load_u<1>(z0 + 1);
  m.template load_b<3>(z0 - 1);
  m.template load_b<0>(z0);
  m.template red<3, 2, 3, 0>(z0 - 1);
  m.template load_u<2>(z0 + 2);   // u(z0 - 2)'s slot, free from here on
  m.template load_b<1>(z0 + 1);
  m.template red<0, 3, 0, 1>(z0);
  for (int z = z0; z < m.t.z1; z += kSlots) {
    rbgs_step<0>(m, z);
    if (z + 1 == m.t.z1) break;
    rbgs_step<1>(m, z + 1);
    if (z + 2 == m.t.z1) break;
    rbgs_step<2>(m, z + 2);
    if (z + 3 == m.t.z1) break;
    rbgs_step<3>(m, z + 3);
  }
}

template <typename T, int R, typename S, typename O>
__global__ void __launch_bounds__(kWarps * kLanes)
rbgs_kernel(const S* __restrict__ u, const S* __restrict__ b,
            O* __restrict__ out, Stack s, Geom g, mg::Coef<T> cf) {
  RbgsMarch<T, R, S, O> m(u, b, out, s, g, cf);
  if (!m.t.ok) return;   // a whole warp: no lane of it shuffles
  rbgs_run(m);
}

// ---------------------------------------------------------------------------
// The RB-GS sweep with u and b stored in bfloat16, on words of two points
// (rbgs_pairs_kernel; stencil3d_bf16.cu's entry points launch it where the
// layout pairs, rbgs_pairs, and rbgs_kernel elsewhere). It runs the
// scalar march's schedule (rbgs_run: the same steps, slots and planes) and
// keeps its arithmetic point for point, but a lane holds an aligned 32-bit
// word of each row: two points, the low one red. With r and c odd an element's
// index has the parity of z + y + x, so with goff + roff even every
// word-aligned pair starts on a red point: in a row whose first index is
// even (s = 0) word w holds columns 2w and 2w + 1, in one whose first index
// is odd (s = 1) columns 2w - 1 and 2w; s = (z + y) & 1 alternates with the
// row and the plane. A row's end word can straddle two rows (column c - 1
// and the next row's column 0 when s = 0, the last row's column c - 1 and
// column 0 when s = 1): both are ghost columns, never updated and never a
// neighbour of an updated point; the lane stores only its own row's half.
//
// The neighbours of a lane's points lie in its word or the next one's:
//   red (low) at x = 2w - s: x - 1 is word w - 1's black, x + 1 its own
//     black; the points above, below and in the planes beside it are its
//     own word's black if s = 0, word w - 1's if s = 1;
//   black (high) at x + 1: x its own red, x + 2 word w + 1's red; the four
//     others word w + 1's red if s = 0, its own if s = 1.
// The sums keep the scalar march's order, ((((z-1 + z+1) + y-1) + y+1) +
// x-1) + x+1, so a partial sum of the other lane's values is formed there
// and shuffled: a red point takes one shuffle, a black one one (s = 1) or
// two (s = 0). Rings: u, b and the red-updated planes as words (the red
// ring's low halves the red values rounded to bfloat16, its high halves u's
// black values), widened where they are read; each output word is rounded
// once (pack_bf16; the red half is exact already).
//
// A strip is kLanes words, kLanes - 2 of them owned (lanes 1 .. 30: 60
// columns); lane 0's word and lane 31's are the halo, H = 2 columns each
// side. Bands of kPairRows rows and chunks of an even number of planes,
// with y0 even, give every region row and plane its s at compile time (the
// slot of a plane fixes its parity).
// ---------------------------------------------------------------------------

constexpr int kPairRows = 4;  // rows of a band: the paired marches (even)

// The paired march's unit, with H rows of halo above and below R core
// rows (H = 2 the RB-GS sweep's, H = 1 the Jacobi sweep's). Lane l of strip
// sx holds word w = sx * (kLanes - 2) - 1 + l of every row: columns 2w - s
// and 2w + 1 - s. Region row j of a lane is stack row y0 - H + j; with y0
// and z0 even a row of a plane with (q - z0) & 1 = sp has s = row_s(sp, j):
// (sp + H + j) & 1 where r is odd, (H + j) & 1 where r is even (c odd: a
// row's first element has the parity of q r + y).
template <int R, int H_ = 2, bool ROdd = true>
struct PairUnit {
  static_assert(R % 2 == 0, "the paired march's bands start on even rows");
  static constexpr int H = H_;

  static __host__ __device__ constexpr int row_s(int sp, int j) {
    return ((ROdd ? sp : 0) + H + j) & 1;
  }

  int w;                 // this lane's word of a row
  int y0;                // the first core row
  int z0, z1;            // the chunk's planes
  unsigned rows;         // bit j: region row j in the stack, w in its row
  unsigned tail;         // bit j: region row j is the stack's last row and
                         // w its last word (past the array's end there)
  unsigned lo_upd[2];    // bit j, plane parity sp: the low point of region
                         // row j is updated in a valid plane (the red one
                         // in the RB-GS sweep)
  unsigned hi_upd[2];    // ... the high (black) point
  unsigned mine;         // bit j: this lane stores region row j
  bool first, last;      // w is its row's first word, its last
  bool ok;               // the warp has a unit

  __device__ PairUnit(const Stack& s, const Geom& g) {
    const int lane = threadIdx.x % kLanes;
    const int unit = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
    const int sx = unit % g.strips;
    const int sy = (unit / g.strips) % g.bands;
    const int sz = unit / (g.strips * g.bands);
    const int wlast = (s.c - 1) / 2;
    ok = sz < g.chunks;
    w = sx * (kLanes - 2) - 1 + lane;
    y0 = sy * R;
    z0 = sz * g.chunk;
    z1 = min(z0 + g.chunk, s.p);
    first = w == 0;
    last = w == wlast;
    const bool col = w >= 0 && w <= wlast;
    // Whether the low or high point of the word lies in [1, n], by s.
    bool lo_in[2], hi_in[2];
#pragma unroll
    for (int sh = 0; sh < 2; ++sh) {
      lo_in[sh] = 2 * w - sh >= 1 && 2 * w - sh <= s.n;
      hi_in[sh] = 2 * w + 1 - sh >= 1 && 2 * w + 1 - sh <= s.n;
    }
    rows = tail = mine = 0u;
    lo_upd[0] = lo_upd[1] = hi_upd[0] = hi_upd[1] = 0u;
#pragma unroll
    for (int j = 0; j < R + 2 * H; ++j) {
      const int y = y0 - H + j;
      const int gy = y + s.roff;
      if (col && y >= 0 && y < s.r) rows |= 1u << j;
      if (last && y == s.r - 1) tail |= 1u << j;
      if (y >= 1 && y <= s.r - 2 && gy >= 1 && gy <= s.n) {
#pragma unroll
        for (int sp = 0; sp < 2; ++sp) {
          if (lo_in[row_s(sp, j)]) lo_upd[sp] |= 1u << j;
          if (hi_in[row_s(sp, j)]) hi_upd[sp] |= 1u << j;
        }
      }
      if (lane >= 1 && lane <= kLanes - 2 && col && j >= H && j < H + R &&
          y < s.r) {
        mine |= 1u << j;
      }
    }
  }
};

// v[i] = a's word at plane q, region row j0 + i of this lane (an aligned
// 32-bit load, unwidened); 0 off the stack, for rows outside `mask` and for
// planes outside [0, qend); in the stack's last plane its last row's last
// word, which may end past the array, is 0 (no point reads it: that plane
// is never updated). SP is the plane's parity.
template <int SP, typename Unit, int N>
__device__ __forceinline__ void load_words(unsigned (&v)[N],
                                           const __nv_bfloat16* __restrict__ a,
                                           const Stack& s, const Unit& t,
                                           int q, int qend, int j0,
                                           unsigned mask) {
  const bool zin = q >= 0 && q < min(qend, s.p);
  if (q == s.p - 1) mask &= ~t.tail;
  const long long base =
      (static_cast<long long>(q) * s.r + (t.y0 - Unit::H + j0)) * s.c +
      2 * t.w;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int sh = Unit::row_s(SP, j0 + i);
    v[i] = (zin && ((mask >> (j0 + i)) & 1u))
               ? __ldg(reinterpret_cast<const unsigned*>(
                     a + (base + static_cast<long long>(i) * s.c - sh)))
               : 0u;
  }
}

// The bfloat16 of x as a word's low half.
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Store a word's two points lo, hi at element e (even) of out, or only the
// half in this row (lo when the word straddles into the next row, hi when
// it straddles from the previous one); each rounded to O once.
template <typename O>
__device__ __forceinline__ void store_pair(O* __restrict__ out, long long e,
                                           float lo, float hi, bool lo_only,
                                           bool hi_only) {
  if (lo_only) {
    out[e] = mg::narrow<O>(lo);
  } else if (hi_only) {
    out[e + 1] = mg::narrow<O>(hi);
  } else if constexpr (mg::kBf16<O>) {
    *reinterpret_cast<unsigned*>(out + e) = mg::pack_bf16(lo, hi);
  } else {
    *reinterpret_cast<float2*>(out + e) = make_float2(lo, hi);
  }
}

template <int R, typename O>
struct PairMarch {
  static constexpr int H = 2;
  static constexpr int NU = R + 2 * H;
  static constexpr int NR = R + 2;

  const __nv_bfloat16* __restrict__ u;
  const __nv_bfloat16* __restrict__ b;
  O* __restrict__ out;
  Stack s;
  mg::Coef<float> cf;
  PairUnit<R> t;
  unsigned bmask;     // rows of b worth loading: the red ring's lanes
  unsigned uu[kSlots][NU];
  unsigned bb[kSlots][NR];
  unsigned rr[kSlots][NR];

  __device__ PairMarch(const __nv_bfloat16* u_, const __nv_bfloat16* b_,
                       O* out_, const Stack& s_, const Geom& g,
                       const mg::Coef<float>& cf_)
      : u(u_), b(b_), out(out_), s(s_), cf(cf_), t(s_, g) {
    bmask = threadIdx.x % kLanes >= 1 ? t.rows : 0u;
  }

  // Plane z1 + 1 is the last u plane a chunk reads, z1 the last b plane;
  // slot Z holds planes of parity Z & 1.
  template <int Z>
  __device__ __forceinline__ void load_u(int q) {
    load_words<Z & 1>(uu[Z], u, s, t, q, t.z1 + 2, 0, t.rows);
  }

  template <int Z>
  __device__ __forceinline__ void load_b(int q) {
    load_words<Z & 1>(bb[Z], b, s, t, q, t.z1 + 1, 1, bmask);
  }

  // The red-updated plane q into slot D from u's slots L, M, U (planes
  // q - 1, q, q + 1) and b's slot D: each word's low half the red value
  // rounded to bfloat16 (or u's where it is not updated), its high half
  // u's black value.
  template <int D, int L, int M, int U>
  __device__ __forceinline__ void red(int q) {
    const unsigned upd = plane_valid(q, s) ? t.lo_upd[D & 1] : 0u;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const unsigned cur = uu[M][i + 1];
      const float right = mg::high_f(cur);
      const float vert = ((mg::high_f(uu[L][i + 1]) +
                           mg::high_f(uu[U][i + 1])) +
                          mg::high_f(uu[M][i])) +
                         mg::high_f(uu[M][i + 2]);
      // Region row i + 1: s = 0, the vertical neighbours are this word's,
      // x - 1 word w - 1's; s = 1, all five word w - 1's.
      const float sum = ((D + i + 1) & 1) == 0
                            ? (vert + left_of(right)) + right
                            : left_of(vert + right) + right;
      const float gs = (cf.h2 * mg::low_f(bb[D][i]) + sum) * cf.inv_den;
      rr[D][i] = ((upd >> (i + 1)) & 1u)
                     ? (cur & 0xffff0000u) | bf16_bits(gs)
                     : cur;
    }
  }

  // Plane q's black update from the red ring's slots L, M, U (planes
  // q - 1, q, q + 1) and b's slot M; stores the unit's core rows.
  template <int L, int M, int U>
  __device__ __forceinline__ void black(int q) {
    const bool valid = plane_valid(q, s);
    const unsigned upd = valid ? t.hi_upd[M & 1] : 0u;
    const long long base =
        (static_cast<long long>(q) * s.r + t.y0) * s.c + 2 * t.w;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = i + 1;   // the red ring's row of core row i
      const int sh = (M + i) & 1;   // region row i + 2's s
      const unsigned cur = rr[M][k];
      const float left = mg::low_f(cur);
      const float right = right_of(left);
      const float vert = ((mg::low_f(rr[L][k]) + mg::low_f(rr[U][k])) +
                          mg::low_f(rr[M][k - 1])) +
                         mg::low_f(rr[M][k + 1]);
      // s = 0: the vertical neighbours are word w + 1's; s = 1 this one's.
      const float sum =
          ((sh == 0 ? right_of(vert) : vert) + left) + right;
      const float gs = (cf.h2 * mg::high_f(bb[M][k]) + sum) * cf.inv_den;
      float hi = ((upd >> (i + H)) & 1u) ? gs : mg::high_f(cur);
      float lo = left;
      if (!valid) lo = hi = 0.0f;
      if ((t.mine >> (i + H)) & 1u) {
        store_pair(out, base + static_cast<long long>(i) * s.c - sh, lo, hi,
                   sh == 0 && t.last, sh == 1 && t.first);
      }
    }
  }
};

template <typename O>
__global__ void __launch_bounds__(kWarps * kLanes)
rbgs_pairs_kernel(const __nv_bfloat16* __restrict__ u,
                  const __nv_bfloat16* __restrict__ b, O* __restrict__ out,
                  Stack s, Geom g, mg::Coef<float> cf) {
  PairMarch<kPairRows, O> m(u, b, out, s, g, cf);
  if (!m.t.ok) return;   // a whole warp: no lane of it shuffles
  rbgs_run(m);
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
};

// The pass's schedule (PassMarch's and JacobiPairMarch's). The step of
// plane z = z0 + 4m + K: load u(z + 2) and b(z + 1) for the next step,
// then plane z.
template <int K, typename March>
__device__ __forceinline__ void pass_step(March& m, int z) {
  m.template load_u<(K + 2) & 3>(z + 2);
  m.template load_b<(K + 1) & 3>(z + 1);
  m.template apply<(K + 3) & 3, K, (K + 1) & 3>(z);
}

template <typename March>
__device__ __forceinline__ void pass_run(March& m) {
  const int z0 = m.t.z0;
  m.template load_u<3>(z0 - 1);
  m.template load_u<0>(z0);
  m.template load_u<1>(z0 + 1);
  m.template load_b<0>(z0);
  for (int z = z0; z < m.t.z1; z += kSlots) {
    pass_step<0>(m, z);
    if (z + 1 == m.t.z1) break;
    pass_step<1>(m, z + 1);
    if (z + 2 == m.t.z1) break;
    pass_step<2>(m, z + 2);
    if (z + 3 == m.t.z1) break;
    pass_step<3>(m, z + 3);
  }
}

template <typename T, int R, int MODE, typename S, typename O>
__global__ void __launch_bounds__(kWarps * kLanes)
pass_kernel(const S* __restrict__ u, const S* __restrict__ b,
            O* __restrict__ out, Stack s, Geom g, mg::Coef<T> cf) {
  PassMarch<T, R, MODE, S, O> m(u, b, out, s, g, cf);
  if (!m.t.ok) return;
  pass_run(m);
}

// ---------------------------------------------------------------------------
// The Jacobi sweep with u, b and out stored in bfloat16, on words of two
// points (jacobi_pairs_kernel; stencil3d_bf16.cu's mg_stencil3d_jacobi_bf16
// launches it where the layout pairs, jacobi_pairs, and pass_kernel
// elsewhere). It runs PassMarch's schedule (pass_run: the same steps,
// slots and planes) and keeps its arithmetic point for point, on
// PairUnit's words (H = 1): a lane holds an aligned 32-bit word of each
// row, both points updated.
// Jacobi has no colour, so any offsets pair: only c odd is needed, which
// makes a row's first element have the parity s of q r + y. With r odd
// (whole grids, slab stacks) s flips with the row and the plane; with r even
// (pencil stacks) only with the row. The march is instantiated for both
// (ROdd), so that a slot and a region row fix s at compile time.
//
// The neighbours of the word's points, low x = 2w - s and high x + 1: x - 1
// of the low point is word w - 1's high half, x + 1 of the high point word
// w + 1's low half, the others in the word. A neighbouring row or plane
// with the same s holds the point in the same half of word w; one with the
// other s in the other half: the low point's is word w's high half where
// s = 0 and word w - 1's where s = 1, the high point's word w + 1's low
// half where s = 0 and its own where s = 1. With r odd all four vertical
// neighbours have the other s; with r even the planes' have the same. The
// sums keep PassMarch's order, ((((z-1 + z+1) + y-1) + y+1) + x-1) + x+1:
// where a sum needs another lane's values in its middle, that lane forms
// the partial sum (taking this lane's leading terms by a shuffle) and
// shuffles it back. A word takes 2 (r odd, s = 1) to 4 (r even, s = 0)
// shuffles against the scalar march's 4 for its two points. Each output
// word is rounded once (pack_bf16); a row's end word straddling two rows
// stores its own row's half (store_pair).
// ---------------------------------------------------------------------------

template <int R, bool ROdd>
struct JacobiPairMarch {
  using Unit = PairUnit<R, 1, ROdd>;
  static constexpr int H = 1;
  static constexpr int NU = R + 2 * H;

  const __nv_bfloat16* __restrict__ u;
  const __nv_bfloat16* __restrict__ b;
  __nv_bfloat16* __restrict__ out;
  Stack s;
  mg::Coef<float> cf;
  Unit t;
  unsigned uu[kSlots][NU];
  unsigned bb[kSlots][R];

  __device__ JacobiPairMarch(const __nv_bfloat16* u_,
                             const __nv_bfloat16* b_, __nv_bfloat16* out_,
                             const Stack& s_, const Geom& g,
                             const mg::Coef<float>& cf_)
      : u(u_), b(b_), out(out_), s(s_), cf(cf_), t(s_, g) {}

  // Slot Z holds planes of parity Z & 1.
  template <int Z>
  __device__ __forceinline__ void load_u(int q) {
    load_words<Z & 1>(uu[Z], u, s, t, q, t.z1 + 1, 0, t.rows);
  }

  template <int Z>
  __device__ __forceinline__ void load_b(int q) {
    load_words<Z & 1>(bb[Z], b, s, t, q, t.z1, H, t.mine);
  }

  // A point's Jacobi value from its neighbour sum, as PassMarch's.
  __device__ __forceinline__ float point(float cur, float sum, float bv,
                                         bool upd) const {
    float v = cur;
    if (upd) {
      const float res = bv - (6.0f * cur - sum) * cf.inv_h2 + cf.sig * cur;
      v = cur + cf.jscale * res;
    }
    return v;
  }

  // Plane q from u's slots L, M, U (planes q - 1, q, q + 1) and b's M.
  template <int L, int M, int U>
  __device__ __forceinline__ void apply(int q) {
    const bool valid = plane_valid(q, s);
    const unsigned lo_upd = valid ? t.lo_upd[M & 1] : 0u;
    const unsigned hi_upd = valid ? t.hi_upd[M & 1] : 0u;
    const long long base =
        (static_cast<long long>(q) * s.r + t.y0) * s.c + 2 * t.w;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = i + H;   // u's row of core row i
      const int sh = Unit::row_s(M & 1, k);
      const unsigned cur = uu[M][k];
      const unsigned zm = uu[L][k], zp = uu[U][k];
      const unsigned ym = uu[M][k - 1], yp = uu[M][k + 1];
      const float clo = mg::low_f(cur), chi = mg::high_f(cur);
      float slo, shi;   // the low and high points' neighbour sums
      if constexpr (ROdd) {
        // Every vertical neighbour in the other half: the low point's in
        // word w (s = 0) or w - 1 (s = 1), the high point's in w + 1 or w.
        const float vhi = ((mg::high_f(zm) + mg::high_f(zp)) +
                           mg::high_f(ym)) + mg::high_f(yp);
        const float vlo = ((mg::low_f(zm) + mg::low_f(zp)) +
                           mg::low_f(ym)) + mg::low_f(yp);
        if (sh == 0) {
          slo = (vhi + left_of(chi)) + chi;
          shi = (right_of(vlo) + clo) + right_of(clo);
        } else {
          slo = left_of(vhi + chi) + chi;
          shi = (vlo + clo) + right_of(clo);
        }
      } else {
        // The planes' neighbours in the same half of word w, the rows'
        // in the other half.
        if (sh == 0) {
          slo = ((((mg::low_f(zm) + mg::low_f(zp)) + mg::high_f(ym)) +
                  mg::high_f(yp)) + left_of(chi)) + chi;
          shi = (right_of((left_of(mg::high_f(zm) + mg::high_f(zp)) +
                           mg::low_f(ym)) + mg::low_f(yp)) + clo) +
                right_of(clo);
        } else {
          slo = left_of(((right_of(mg::low_f(zm) + mg::low_f(zp)) +
                          mg::high_f(ym)) + mg::high_f(yp)) + chi) + chi;
          shi = ((((mg::high_f(zm) + mg::high_f(zp)) + mg::low_f(ym)) +
                  mg::low_f(yp)) + clo) + right_of(clo);
        }
      }
      const unsigned bw = bb[M][i];
      float lo = point(clo, slo, mg::low_f(bw), (lo_upd >> k) & 1u);
      float hi = point(chi, shi, mg::high_f(bw), (hi_upd >> k) & 1u);
      if (!valid) lo = hi = 0.0f;
      if ((t.mine >> k) & 1u) {
        store_pair(out, base + static_cast<long long>(i) * s.c - sh, lo, hi,
                   sh == 0 && t.last, sh == 1 && t.first);
      }
    }
  }
};

template <bool ROdd>
__global__ void __launch_bounds__(kWarps * kLanes)
jacobi_pairs_kernel(const __nv_bfloat16* __restrict__ u,
                    const __nv_bfloat16* __restrict__ b,
                    __nv_bfloat16* __restrict__ out, Stack s, Geom g,
                    mg::Coef<float> cf) {
  JacobiPairMarch<kPairRows, ROdd> m(u, b, out, s, g, cf);
  if (!m.t.ok) return;   // a whole warp: no lane of it shuffles
  pass_run(m);
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

// Whether a bfloat16 sweep on stack s pairs its points into words (the
// paired march's layout rule): r and c odd and goff + roff even (every
// word-aligned pair starts on a red point), u and b on a word and out on a
// pair of O (every array's words at the same indices). kernels/stencil3d.py
// decides by the same rule, to pass the variant's geometry and count it.
template <typename O>
bool rbgs_pairs(const void* u, const void* b, const void* out,
                const Stack& s) {
  return (s.r & 1) && (s.c & 1) && ((s.goff + s.roff) & 1) == 0 &&
         reinterpret_cast<uintptr_t>(u) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(out) % (2 * sizeof(O)) == 0;
}

// Whether a bfloat16 Jacobi sweep storing bfloat16 pairs its points into
// words (the paired Jacobi march's layout rule): c odd and u, b and out each
// on a word. No offset or parity of r matters: Jacobi has no colour.
// kernels/stencil3d.py decides by the same rule.
bool jacobi_pairs(const void* u, const void* b, const void* out,
                  const Stack& s) {
  return (s.c & 1) && reinterpret_cast<uintptr_t>(u) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 4 == 0;
}

// A paired march's geometry must be march_geometry's for it: strips of
// kLanes - 2 owned words (width: their 2 (kLanes - 2) columns), bands of
// kPairRows rows, chunks of an even number of planes; each owned once.
bool pair_geom_fits(const Stack& s, const Geom& g) {
  const long long words = (s.c + 1) / 2;
  const int owned = kLanes - 2;
  return g.strips >= 1 && g.bands >= 1 && g.chunks >= 1 &&
         g.width == 2 * owned && g.chunk >= 2 && g.chunk % 2 == 0 &&
         static_cast<long long>(g.strips) * owned >= words &&
         static_cast<long long>(g.strips - 1) * owned < words &&
         static_cast<long long>(g.bands) * kPairRows >= s.r &&
         static_cast<long long>(g.bands - 1) * kPairRows < s.r &&
         static_cast<long long>(g.chunks) * g.chunk >= s.p &&
         static_cast<long long>(g.chunks - 1) * g.chunk < s.p;
}

// A paired march on stack s (bfloat16 u and b, output O); the geometry
// must be its own, or the launch returns cudaErrorInvalidValue.
template <typename O, typename Kernel>
int launch_pairs(Kernel kernel, const void* u, const void* b, void* out,
                 const Stack& s, const int* geom, const mg::Coef<float>& cf,
                 void* stream) {
  const Geom g{geom[0], geom[1], geom[2], geom[3], geom[4]};
  if (!pair_geom_fits(s, g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units =
      static_cast<long long>(g.strips) * g.bands * g.chunks;
  const unsigned blocks = static_cast<unsigned>((units + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(u),
      static_cast<const __nv_bfloat16*>(b), static_cast<O*>(out), s, g, cf);
  return static_cast<int>(cudaGetLastError());
}

// A Jacobi sweep; with bfloat16 storage and output the paired march where
// the layout pairs (jacobi_pairs), the scalar one elsewhere.
template <typename T, typename S = T, typename O = T>
int jacobi(const void* u, const void* b, void* out, int p, int r, int c,
           int n, double h, double sigma, double omega, int goff, int roff,
           const int* geom, void* stream) {
  constexpr int R = Rows<T>::pass;
  const Stack s{p, r, c, n, goff, roff};
  const auto cf = mg::Coef<T>::make(h, sigma, omega, 6);
  if constexpr (mg::kBf16<S> && mg::kBf16<O>) {
    if (jacobi_pairs(u, b, out, s)) {
      return (r & 1) ? launch_pairs<O>(jacobi_pairs_kernel<true>, u, b, out,
                                       s, geom, cf, stream)
                     : launch_pairs<O>(jacobi_pairs_kernel<false>, u, b, out,
                                       s, geom, cf, stream);
    }
  }
  return launch<S, O>(pass_kernel<T, R, kJacobi, S, O>, u, b, out, s, geom,
                      R, 1, cf, stream);
}

// An RB-GS sweep; with bfloat16 storage the paired march where the layout
// pairs (rbgs_pairs), the scalar one elsewhere.
template <typename T, typename S = T, typename O = T>
int rbgs(const void* u, const void* b, void* out, int p, int r, int c, int n,
         double h, double sigma, int goff, int roff, const int* geom,
         void* stream) {
  constexpr int R = Rows<T>::rbgs;
  if constexpr (mg::kBf16<S>) {
    const Stack s{p, r, c, n, goff, roff};
    if (rbgs_pairs<O>(u, b, out, s)) {
      return launch_pairs<O>(rbgs_pairs_kernel<O>, u, b, out, s, geom,
                             mg::Coef<float>::make(h, sigma, 1.0, 6), stream);
    }
  }
  return launch<S, O>(rbgs_kernel<T, R, S, O>, u, b, out,
                      Stack{p, r, c, n, goff, roff}, geom, R, 2,
                      mg::Coef<T>::make(h, sigma, 1.0, 6), stream);
}

}  // namespace

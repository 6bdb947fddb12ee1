// The row-streaming legs and sweeps: down_kernel, up_kernel, sweep_kernel
// (the up leg's stream without its coarse operand) and
// residual_restrict_kernel (the down leg's without its smoothing and its
// fine store), the four frames they run on, their launch geometry and
// launchers.
// packed2d.cu instantiates the down leg on the whole packed grid,
// packed2d_up.cu and packed2d_up_f64.cu the up leg, packed2d_sweep.cu the
// RB-GS sweeps; plocal2d_legs.cu and plocal2d_legs_f64.cu both legs on a
// shard's packed tile; fused2d.cu the down leg, fused2d_up.cu and
// fused2d_up_f64.cu the up leg, stencil2d_sweep.cu and
// stencil2d_sweep_f64.cu the RB-GS and Jacobi sweeps on the unpacked
// grid; local2d_legs.cu and local2d_legs_f64.cu both legs,
// local2d_sweep.cu and local2d_sweep_f64.cu the RB-GS and Jacobi sweeps,
// on a shard's unpacked tile (a kernel for each stage count; the files
// compile in parallel); transfer2d.cu the residual-restriction on the
// unpacked grid; packed2d_bf16.cu, packed2d_up_bf16.cu,
// packed2d_up_bf16_f32.cu and packed2d_sweep_bf16.cu the whole packed
// grid's legs and sweeps with bfloat16 storage (a storage type S beside
// the compute type T), local2d_legs_bf16.cu, local2d_up_bf16_f32.cu,
// plocal2d_legs_bf16.cu and plocal2d_up_bf16_f32.cu the tile legs so (S =
// T everywhere else); fused2d_native_bf16.cu and fused2d_up_native_bf16.cu
// the native bfloat16 legs (T = Nb, below), stencil2d_sweep_native_bf16.cu
// and stencil2d_jacobi_native_bf16.cu the native RB-GS and Jacobi sweeps
// and transfer2d_native_bf16.cu the native residual restriction on the
// unpacked grid. packed2d.cu's note says what
// they replace and how they work; plocal2d.cu's what the tile frame adds,
// fused2d.cu's what the unpacked one does, local2d_legs.cu's how the
// unpacked tile joins the two, packed2d_sweep.cu's what the sweeps do,
// packed2d_bf16.cu's what bfloat16 storage changes, local2d_legs_bf16.cu's
// what it changes on a tile.
#pragma once

#include <cstdint>
#include <type_traits>

#include "packed_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// The row-streaming legs (down_kernel, up_kernel, sweep_kernel,
// residual_restrict_kernel).
// packed2d.py's leg_geometry computes the launch geometry; its LEG_*
// constants are these (tests/test_torch_packed.py reads them here).
// ---------------------------------------------------------------------------

constexpr int kWarp = 32;      // lanes of a strip: one warp
constexpr int kLegWarps = 4;   // warps (independent strips) a block
constexpr int kAhead = 4;      // rows loaded ahead of the row worked on
constexpr int kWin = 16;       // the register window of rows (power of 2)
constexpr int kCoarseWin = 8;  // the up leg's window of coarse rows
constexpr int kRounded = 4;    // bfloat16: the down leg's rows of u' as
                               // stored (3 live, power of 2)

// A leg's launch geometry, passed as 7 ints in this order. Warp w of block
// bx works on unit bx * kLegWarps + w, strip sx = unit % strips and segment
// sy = unit / strips: lanes [sx * strip, sx * strip + strip) of the frame
// (its kWarp lanes start hp before, strip + 2 hp = kWarp) and rows
// [rb + sy * seg, rb + sy * seg + seg) (seg even) clipped to the frame,
// streaming rows from top above (top even) to bottom below, clipped to
// [rb, the frame's end); rb is the even global row at or above the frame's
// first.
struct LegGeom {
  int strips, segs, strip, seg, hp, top, bottom;
};

// The frames. Rows are global rows in all four; the streamed rows of a
// unit start on an even one, so a row's parity is its step's. Lanes are the
// frame's: lane l holds the points of global columns gx0 + 2l and
// gx0 + 2l + 1 (phases 0 and 1), gx0 even, so the colour-c point of global
// row i has phase (c + i) & 1 in every frame.
//
// Whole: the packed (n+2)^2 grid of packed2d.cu; array row i, array lane l.
struct Whole {
  int n;
};

// Tile: one rank's packed extended tile a (plocal2d.cu): rows
// [a.goy, a.goy + a.R) of the array's rows, a.goy odd; the points a stage
// updates, upd (the global interior off the tile's ring); the coarse tile
// ca in local2d's unpacked extended convention and its owned box keep
// (global coarse indices; keep.n is nc). gx0 = a.gox - (a.gox & 1): with an
// odd column offset (a block tile) frame lane l holds array lane l - 1's
// phase-1 point and array lane l's phase-0 point, one lane more than the
// array has; with an even one (a row tile, a.gox = 0) frame and array
// lanes are the same. The row above the tile, a.goy - 1, is streamed as a
// zero row by the first segment, so its rows start even too.
struct Tile {
  int n;
  mg::PRect a;
  mg::InteriorBox upd;
  mg::Rect ca;
  mg::InteriorBox keep;
};

// Unpacked: the logical (n+2)^2 grid of fused2d.cu, row pitch P = n + 2;
// lane l's two points, columns 2l and 2l + 1, are adjacent in memory. P is
// odd, so the last lane's phase-1 point would be column P, the next row's
// first point (past the array on the last row): it reads 0 and is never
// stored. On an even row a lane's two points start at an even index: one
// aligned pair, since the launchers take fine arrays that start on a pair
// (on_pairs).
struct Unpacked {
  int n;
};

// UTile: one rank's unpacked extended tile a (local2d_legs.cu): R x C
// points of the global grid from (a.goy, a.gox), row pitch C; upd, ca and
// keep as Tile has them. The legs' tiles start on an odd row, as Tile's;
// the sweeps (local2d_sweep.cu, whose frame has an empty coarse tile) take
// any offsets: on an even a.goy the first segment starts on the tile's
// first row and no zero row is streamed. Lane l holds global columns
// gx0 + 2l and gx0 + 2l + 1 as Unpacked does, gx0 = a.gox - (a.gox & 1),
// at array index (i - a.goy) C + (gx - a.gox); with an odd column offset
// (a block tile) lane 0's phase-0 point, column a.gox - 1, lies off the
// array. A lane's two points are one aligned pair where their index is
// even. Only the odd rows take paired accesses, a choice made at compile
// time: `odd_pairs` says whether the odd rows' pairs are aligned (on a row
// tile, C odd, a.gox 0 and a.goy odd as every sharded tile's, they are; on
// a block tile, C even and a.gox odd, no row's are; utile_frame derives it
// from any offsets) and the fine arrays start on a pair (of their storage
// type: 4 bytes in bfloat16). A test of both
// parities at run time made the up leg slower, and no pairs at all cost it
// registers (PERF.md).
struct UTile {
  int n;
  mg::Rect a;
  mg::InteriorBox upd;
  mg::Rect ca;
  mg::InteriorBox keep;
  int odd_pairs;
};

template <class Fr>
constexpr bool kIsTile = std::is_same<Fr, Tile>::value;
template <class Fr>
constexpr bool kIsUnpacked = std::is_same<Fr, Unpacked>::value;
template <class Fr>
constexpr bool kIsUTile = std::is_same<Fr, UTile>::value;
// What a frame takes from which: a shard's tile (Tile, UTile) has the
// tile's rows (global, from its first row; the row above an odd one
// streamed as zeros), its upd box and a coarse tile with its owned box; an
// unpacked array (Unpacked, UTile) sums each stencil in the plain versions'
// order (gs_value, residual_of, jacobi_step) and takes the full residual in
// the down leg.
template <class Fr>
constexpr bool kOnTile = kIsTile<Fr> || kIsUTile<Fr>;
template <class Fr>
constexpr bool kPlainOrder = kIsUnpacked<Fr> || kIsUTile<Fr>;
// The down leg's residual after an RB-GS sweep: the red points only on the
// packed frames (the closing black half-sweep zeroes the black one in exact
// arithmetic; the JAX packed kernels drop it), every interior point on the
// unpacked ones (as JAX's fused2d and local2d kernels compute it).
template <class Fr>
constexpr bool kRedOnly = !kPlainOrder<Fr>;

__host__ __device__ __forceinline__ int frame_lanes(const Whole& f) {
  return (f.n + 3) / 2;
}
__host__ __device__ __forceinline__ int frame_lanes(const Unpacked& f) {
  return (f.n + 3) / 2;
}
template <class Fr, std::enable_if_t<kOnTile<Fr>, int> = 0>
__host__ __device__ __forceinline__ int frame_lanes(const Fr& f) {
  return (f.a.C + (f.a.gox & 1) + 1) / 2;
}

// The side neighbour of the colour-c point at phase p: the other colour's
// value v of lane x + 1 (p = 1) or x - 1 (p = 0). A warp's edge lanes read
// their own value, which only non-updatable points would use.
template <typename T>
__device__ __forceinline__ T side_of(T v, int p) {
  return p ? __shfl_down_sync(0xffffffffu, v, 1)
           : __shfl_up_sync(0xffffffffu, v, 1);
}

// ---------------------------------------------------------------------------
// The native bfloat16 arithmetic (T = Nb: the fused2d legs' native mode,
// fused2d_native_bf16.cu and fused2d_up_native_bf16.cu, the sweeps' and the
// residual restriction's, stencil2d_sweep_native_bf16.cu,
// stencil2d_jacobi_native_bf16.cu and transfer2d_native_bf16.cu, on the
// unpacked frame with bfloat16 storage): the
// TPU kernels' own bfloat16 mode, every operation rounded to bfloat16
// (kernels/native_bf16.py states the rule and JAX's order). An Nb is a bfloat16
// value held in a float; each + - x is one float32 operation with its rounding
// explicit (__fadd_rn, __fsub_rn, __fmul_rn: never contracted into an FMA),
// rounded to bfloat16 at once. Since 24 >= 2 * 8 + 2 the float32 result rounded
// to bfloat16 is the correctly rounded bfloat16 result, so the stream's bits
// equal those of the plain version's bfloat16 PyTorch ops, and gs_value,
// residual_of and jacobi_step keep their plain-order expressions on this type.
// The constants (h^2, 1/h^2, sigma, 1/(4 - sigma h^2), omega/(4/h^2 - sigma))
// come from the host, already rounded in JAX's order (native_coef), not from
// mg::Coef::make. The transfers take JAX's order (weigh, average).
// ---------------------------------------------------------------------------
struct Nb {
  float f;
  Nb() = default;
  __host__ __device__ explicit constexpr Nb(float v) : f(v) {}
};

template <typename T>
constexpr bool kNative = std::is_same<T, Nb>::value;

// v rounded to bfloat16, held in a float: one cvt of v and 0 into a word of
// two bfloat16, v's in the high half (to nearest even, NaN stays NaN).
__device__ __forceinline__ Nb nb_round(float v) {
  unsigned w;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(v), "f"(0.0f));
  return Nb(__uint_as_float(w));
}
__device__ __forceinline__ Nb operator+(Nb a, Nb b) {
  return nb_round(__fadd_rn(a.f, b.f));
}
__device__ __forceinline__ Nb operator-(Nb a, Nb b) {
  return nb_round(__fsub_rn(a.f, b.f));
}
__device__ __forceinline__ Nb operator*(Nb a, Nb b) {
  return nb_round(__fmul_rn(a.f, b.f));
}

__device__ __forceinline__ Nb side_of(Nb v, int p) {
  return Nb(side_of(v.f, p));
}

// Full weighting of three points, (0.25 a + 0.5 m) + 0.25 z, each
// operation rounded (native_bf16.py's _full_weight).
__device__ __forceinline__ Nb weigh(Nb a, Nb m, Nb z) {
  return (Nb(0.25f) * a + Nb(0.5f) * m) + Nb(0.25f) * z;
}

// The interpolation's average of two bfloat16 values, 0.5 a + 0.5 b in
// float32 (both products exact), rounded once (native_bf16.py's
// _interpolate): rounding a + b first could overflow where this does not.
__device__ __forceinline__ Nb average(float a, float b) {
  return nb_round(__fadd_rn(__fmul_rn(0.5f, a), __fmul_rn(0.5f, b)));
}

// The level's scalars as the host rounded them.
inline mg::Coef<Nb> native_coef(double h2, double inv_h2, double sig,
                                double inv_den, double coef) {
  return mg::Coef<Nb>{Nb(static_cast<float>(h2)),
                      Nb(static_cast<float>(inv_h2)),
                      Nb(static_cast<float>(sig)),
                      Nb(static_cast<float>(inv_den)),
                      Nb(static_cast<float>(coef))};
}

// Two Nb values in one word of two bfloat16, lo in the low half (their
// floats' high halves: one byte permute), and back.
__device__ __forceinline__ unsigned nb_pair(Nb lo, Nb hi) {
  return __byte_perm(__float_as_uint(lo.f), __float_as_uint(hi.f), 0x7632);
}
__device__ __forceinline__ Nb nb_low(unsigned w) { return Nb(mg::low_f(w)); }
__device__ __forceinline__ Nb nb_high(unsigned w) { return Nb(mg::high_f(w)); }

// + - x of two pairs of bfloat16 in one sm_90 bfloat16x2 instruction, each
// half the exact result rounded once to bfloat16, to nearest even: the
// bits of the Nb operation on each half (Nb's float32 step before its
// rounding changes nothing, 24 >= 2 * 8 + 2), without the conversion that
// Nb's rounding issues (a cvt, on a pipe of an eighth of the float32
// adds' rate on an H100, which bounded the native Jacobi stream; PERF.md).
// Explicit .rn: no contraction into an FMA.
__device__ __forceinline__ unsigned bf2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_sub(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The per-warp position of a leg's unit and its fixed tests.
template <class Fr>
struct Unit {
  int gl;          // this lane's frame lane
  int J;           // global coarse column of its phase-0 point (gx0/2 + gl)
  int at[2];       // the array lane (UTile: column) of its phase-p point
  int y0, y1;      // owned rows
  int ys, ye;      // streamed rows
  int lo, hi;      // rows the smoothing updates (interior, off the ends)
  bool ok[2];      // its phase-p point lies in the array
  bool core;       // the lane is owned
  bool st[2];      // core and ok[p]: the lane stores its phase-p point
  bool upd[2];     // phase p: the column is updatable and off the edges
  bool pr;         // UTile: in odd rows the lane's two points lie in the
                   // array as one aligned pair

  __device__ Unit(const LegGeom& g, int unit, const Fr& f) {
    const int lane = threadIdx.x % kWarp;
    const int sx = unit % g.strips;
    const int sy = unit / g.strips;
    gl = sx * g.strip - g.hp + lane;
    core = lane >= g.hp && lane < g.hp + g.strip && gl < frame_lanes(f);
    pr = false;
    if constexpr (kOnTile<Fr>) {
      const int end = f.a.goy + f.a.R;
      const int rb = f.a.goy & ~1;
      const int yu = rb + sy * g.seg;
      const int xs = f.a.gox & 1;
      y0 = max(yu, f.a.goy);
      y1 = min(yu + g.seg, end);
      ys = max(rb, yu - g.top);
      ye = min(end, y1 + g.bottom);
      lo = max(ys + 1, max(f.upd.ylo, 1));
      hi = min(ye - 2, min(f.upd.yhi, f.n));
      J = ((f.a.gox - xs) >> 1) + gl;
      for (int p = 0; p < 2; ++p) {
        const int lx = 2 * lane + p;
        const int gx = 2 * J + p;
        if constexpr (kIsUTile<Fr>) {
          at[p] = gx - f.a.gox;
          ok[p] = at[p] >= 0 && at[p] < f.a.C;
        } else {
          at[p] = gl - (xs & (1 - p));
          ok[p] = at[p] >= 0 && at[p] < f.a.lanes();
        }
        st[p] = core && ok[p];
        upd[p] = lx >= 1 && lx <= 2 * kWarp - 2 && gx >= 1 && gx <= f.n &&
                 gx >= f.upd.xlo && gx <= f.upd.xhi;
      }
      if constexpr (kIsUTile<Fr>) pr = f.odd_pairs && ok[0] && ok[1];
    } else {
      const int P = f.n + 2;
      y0 = sy * g.seg;
      y1 = min(y0 + g.seg, P);
      ys = max(0, y0 - g.top);
      ye = min(P, y1 + g.bottom);
      lo = max(ys + 1, 1);
      hi = min(ye - 2, f.n);
      J = gl;
      const bool in = gl >= 0 && gl < frame_lanes(f);
      for (int p = 0; p < 2; ++p) {
        const int lx = 2 * lane + p;
        const int gx = 2 * gl + p;
        at[p] = gl;
        // Unpacked: column gx lies in the row (gx = P is off it).
        ok[p] = in && (!kIsUnpacked<Fr> || gx <= f.n + 1);
        st[p] = core && ok[p];
        upd[p] = lx >= 1 && lx <= 2 * kWarp - 2 && gx >= 1 && gx <= f.n;
      }
    }
  }
};

// The Gauss-Seidel value and the residual of a point of colour value x and
// right-hand side bv from its neighbours: up and down (rows i -/+ 1), mid
// (the lane's point of the other phase) and side (the shuffled one); at
// phase p the left neighbour is side (p = 0) or mid (p = 1), the right one
// the other. The packed frames add up + down + mid + side first. The
// unpacked frame adds them in the plain versions' order
// (smoothers._gs_update, laplacian.residual), so that at sigma = 0 and h a
// power of two (every product then exact) its legs round as the plain path
// does, bit for bit; so does the unpacked tile (local2d's plain versions
// sum in the same order).
template <class Fr, typename T>
__device__ __forceinline__ T gs_value(T bv, T up, T dn, T mid, T side, int p,
                                      const mg::Coef<T>& cf) {
  if constexpr (kPlainOrder<Fr>) {
    const T left = p ? mid : side;
    const T right = p ? side : mid;
    return ((((cf.h2 * bv + up) + dn) + left) + right) * cf.inv_den;
  } else {
    return (cf.h2 * bv + (((up + dn) + mid) + side)) * cf.inv_den;
  }
}

// Without SHIFT (the native residual restriction, native_bf16.py's
// shift=False: transfer2d's residual has no sigma u term) the unpacked
// frame's residual ends at b - au. At sigma = 0 the term is not a no-op
// in bfloat16 bits: -0 + 0 u is +0 where u > 0, and 0 u is NaN where u is
// +-Inf.
template <class Fr, typename T, bool SHIFT = true>
__device__ __forceinline__ T residual_of(T bv, T x, T up, T dn, T mid,
                                         T side, int p,
                                         const mg::Coef<T>& cf) {
  if constexpr (kPlainOrder<Fr>) {
    const T left = p ? mid : side;
    const T right = p ? side : mid;
    if constexpr (SHIFT) {
      return bv - ((((T(4) * x - up) - dn) - left) - right) * cf.inv_h2 +
             cf.sig * x;
    } else {
      return bv - ((((T(4) * x - up) - dn) - left) - right) * cf.inv_h2;
    }
  } else {
    return bv - (T(4) * x - (((up + dn) + mid) + side)) * cf.inv_h2 +
           cf.sig * x;
  }
}

// The Jacobi step x + jscale r. The unpacked frames round the product and
// the sum apart, as the plain version's two tensor operations do (nvcc
// would contract them into one FMA; __fmul_rn is never contracted), so
// that at sigma = 0 and h a power of two its Jacobi stages round as the
// plain path does too.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ Nb mul_rn(Nb a, Nb b) { return a * b; }

template <class Fr, typename T>
__device__ __forceinline__ T jacobi_step(T x, T r, const mg::Coef<T>& cf) {
  if constexpr (kPlainOrder<Fr>) {
    return x + mul_rn(cf.jscale, r);
  } else {
    return x + cf.jscale * r;
  }
}

// One native Jacobi stage on row slot s, both points of a lane at once:
// colour c at phase p_c = (c + p0) & 1 (p0: colour 0's, a constant once
// the stages are unrolled), its residual and step (residual_of,
// jacobi_step on Nb: u + coef r, r = (b - au) + sig u, au = ((((4 u - up)
// - down) - left) - right) * inv_h2) computed on the word of the two
// colours' values, each operation one bfloat16x2 instruction. The window
// keeps Nb values: the operands are paired (a byte permute each), the
// result split.
__device__ __forceinline__ void jacobi_pair(const Nb (&src)[2][kWin],
                                            const Nb (&B)[2][kWin],
                                            Nb (&out)[2][kWin], int p0, int s,
                                            int sm, int sp, bool live,
                                            const Unit<Unpacked>& w,
                                            const mg::Coef<Nb>& cf) {
  const int p1 = 1 - p0;
  // Colour c's neighbours in its row are the other colour's points: mid
  // (the lane's own) and side (the shuffled one).
  const Nb side0 = side_of(src[1][s], p0);
  const Nb side1 = side_of(src[0][s], p1);
  const unsigned x = nb_pair(src[0][s], src[1][s]);
  const unsigned left = nb_pair(p0 ? src[1][s] : side0,
                                p1 ? src[0][s] : side1);
  const unsigned right = nb_pair(p0 ? side0 : src[1][s],
                                 p1 ? side1 : src[0][s]);
  const unsigned four = nb_pair(Nb(4.0f), Nb(4.0f));
  unsigned t = bf2_mul(four, x);
  t = bf2_sub(t, nb_pair(src[1][sm], src[0][sm]));
  t = bf2_sub(t, nb_pair(src[1][sp], src[0][sp]));
  t = bf2_sub(t, left);
  t = bf2_sub(t, right);
  t = bf2_mul(t, nb_pair(cf.inv_h2, cf.inv_h2));
  unsigned r = bf2_sub(nb_pair(B[0][s], B[1][s]), t);
  r = bf2_add(r, bf2_mul(nb_pair(cf.sig, cf.sig), x));
  const unsigned y = bf2_add(x, bf2_mul(nb_pair(cf.jscale, cf.jscale), r));
  out[0][s] = live && w.upd[p0] ? nb_low(y) : src[0][s];
  out[1][s] = live && w.upd[p1] ? nb_high(y) : src[1][s];
}

// The smoothing stages of one step. In step t (row t loaded, v = t - ys
// mod kWin, so that every window slot below is a compile-time constant and
// the rows' parities are v's: ys is even) stage k works on row t - 1 - k,
// in order of k: RB-GS half-sweep k (colour k & 1) in place on U, or Jacobi
// sweep k from stage k - 1 (U for k = 0) into J[k]. Stage k reads rows
// i - 1 .. i + 1 of stage k - 1's result: row i + 1 it got earlier in this
// step, the others in earlier steps, and stage k + 1 overwrites none of
// them before stage k has read them; so this is a sequential sweep's order.
// A point is updated where `upd` holds for its phase and its row lies in
// [lo, hi] (a test made only where EDGE): each stage makes one more ring of
// the unit's tile stale, which the halos cover. Jacobi copies every other
// point; it writes its row in every step, also off [ys, ye) (a value no
// stage or store of the unit reads), so that a stage's window holds only
// the 3 rows the next stage reads: skipping the write would keep the slot's
// row of kWin steps before live, all kWin rows of every stage (at K = 8
// in float32 that took 255 registers and spilled; PERF.md). PAIRED (the
// native Jacobi sweep stream, T = Nb) runs a Jacobi stage's two points as
// pairs of bfloat16 (jacobi_pair): the same operations, order and bits.
template <typename T, int KIND, int K, int v, bool EDGE, class Fr,
          bool PAIRED = false>
__device__ __forceinline__ void smooth_step(T (&U)[2][kWin],
                                            const T (&B)[2][kWin],
                                            T (&J)[K > 0 ? K : 1][2][kWin],
                                            int t, const Unit<Fr>& w,
                                            const mg::Coef<T>& cf) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t - 1 - k;
    const int s = (v - 1 - k) & (kWin - 1);
    const int sm = (s - 1) & (kWin - 1);
    const int sp = (s + 1) & (kWin - 1);
    const bool live = !EDGE || (i >= w.lo && i <= w.hi);
    if (KIND == mg::kRbgs) {
      const int c = k & 1;
      const int o = 1 - c;
      const int p = (c + v - 1 - k) & 1;
      if (!live) continue;
      const T mid = U[o][s];
      const T side = side_of(mid, p);
      const T nv = gs_value<Fr>(B[c][s], U[o][sm], U[o][sp], mid, side, p, cf);
      if (w.upd[p]) U[c][s] = nv;
    } else if constexpr (PAIRED) {
      T(&src)[2][kWin] = k == 0 ? U : J[k > 0 ? k - 1 : 0];
      jacobi_pair(src, B, J[k], (v - 1 - k) & 1, s, sm, sp, live, w, cf);
    } else {
      T(&src)[2][kWin] = k == 0 ? U : J[k > 0 ? k - 1 : 0];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int o = 1 - c;
        const int p = (c + v - 1 - k) & 1;
        const T x = src[c][s];
        const T mid = src[o][s];
        const T side = side_of(mid, p);
        const T r = residual_of<Fr>(B[c][s], x, src[o][sm], src[o][sp], mid,
                                    side, p, cf);
        J[k][c][s] = live && w.upd[p] ? jacobi_step<Fr>(x, r, cf) : x;
      }
    }
  }
}

// Load both planes of row i (parity par) of the packed array g at this lane
// into a0, a1; points off the array, and the row above a tile, read 0; rows
// past ye are not loaded (no step reads them). The tests on rows are made
// only where EDGE. A lane's two points lie in the two planes, so every
// load is one element wide: a warp's 32 lanes read 32 consecutive elements
// of each plane. These are the loads of full-precision storage (S = T);
// bfloat16 storage keeps its rows unwidened (load_raw, below).
template <bool EDGE, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ g, T& a0,
                                         T& a1, int i, int par,
                                         const Unit<Whole>& w,
                                         const Whole& f) {
  if (EDGE && i >= w.ye) return;
  const int P = f.n + 2;
  const int cp = frame_lanes(f);
  const bool ok = w.ok[0];
  const size_t at = static_cast<size_t>(i) * cp + (ok ? w.gl : 0);
  a0 = ok ? __ldg(g + at) : T(0);
  a1 = ok ? __ldg(g + at + static_cast<size_t>(P) * cp) : T(0);
}

template <bool EDGE, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ g, T& a0,
                                         T& a1, int i, int par,
                                         const Unit<Tile>& w,
                                         const Tile& f) {
  if (EDGE && i >= w.ye) return;
  const int cp = f.a.lanes();
  const bool in = !EDGE || i >= f.a.goy;
  const size_t row = static_cast<size_t>(in ? i - f.a.goy : 0);
  const int p0 = par & 1;   // the phase of colour 0 (plane 0) in row i
  const bool k0 = in && w.ok[p0];
  const bool k1 = in && w.ok[1 - p0];
  a0 = k0 ? __ldg(g + row * cp + w.at[p0]) : T(0);
  a1 = k1 ? __ldg(g + (static_cast<size_t>(f.a.R) + row) * cp +
                  w.at[1 - p0])
          : T(0);
}

// Two points of type T as one 8- or 16-byte access (4 bytes in bfloat16:
// UTile's storage type).
template <typename T>
using Pair = std::conditional_t<
    std::is_same<T, float>::value, float2,
    std::conditional_t<std::is_same<T, double>::value, double2,
                       __nv_bfloat162>>;

// The pair of T at p (aligned on a Pair<T>) as x, y.
template <typename T>
__device__ __forceinline__ void ldg_pair(const T* p, T& x, T& y) {
  const Pair<T> v = __ldg(reinterpret_cast<const Pair<T>*>(p));
  x = v.x;
  y = v.y;
}

// x, y stored as one pair of S at p (aligned on a Pair<S>), each rounded
// to S.
template <typename S, typename T>
__device__ __forceinline__ void st_pair(S* p, T x, T y) {
  if constexpr (mg::kBf16<S>) {
    *reinterpret_cast<Pair<S>*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    *reinterpret_cast<Pair<S>*>(p) = Pair<S>{x, y};
  }
}

// Whether the arrays a, b and c start on a pair of T (the unpacked frame's
// fine arrays must; UTile pairs its rows only where they do).
template <typename T>
bool on_pairs(const void* a, const void* b, const void* c) {
  const auto bits = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(c);
  return bits % sizeof(Pair<T>) == 0;
}

// Unpacked: colour c of row i is the point at column 2 gl + ((c + i) & 1).
// On an even row a lane whose two points both lie in the row loads them as
// one pair; else two scalar loads, whose 64 points a warp covers the same
// sectors: they add L1 requests, not device-memory bytes. Without the
// pairs the up leg takes more registers, fewer warps an SM, and runs slower
// (PERF.md).
template <bool EDGE, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ g, T& a0,
                                         T& a1, int i, int par,
                                         const Unit<Unpacked>& w,
                                         const Unpacked& f) {
  if (EDGE && i >= w.ye) return;
  const int p0 = par & 1;   // the phase of colour 0 in row i
  const long long at = static_cast<long long>(i) * (f.n + 2) + 2 * w.gl;
  if (p0 == 0 && w.ok[1]) {
    const Pair<T> v = __ldg(reinterpret_cast<const Pair<T>*>(g + at));
    a0 = v.x;
    a1 = v.y;
  } else {
    a0 = w.ok[p0] ? __ldg(g + at + p0) : T(0);
    a1 = w.ok[1 - p0] ? __ldg(g + at + 1 - p0) : T(0);
  }
}

// UTile: colour c of row i is the point at column at[(c + i) & 1]; the row
// above the tile reads 0, as on Tile. On an odd row (a compile-time fact in
// every call) a lane whose two points are an aligned pair (pr) loads them
// as one access; else two scalar ones (full-precision storage; bfloat16
// storage: load_raw).
template <bool EDGE, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ g, T& a0,
                                         T& a1, int i, int par,
                                         const Unit<UTile>& w,
                                         const UTile& f) {
  if (EDGE && i >= w.ye) return;
  const bool in = !EDGE || i >= f.a.goy;
  const int p0 = par & 1;   // the phase of colour 0 in row i
  const long long row =
      static_cast<long long>(in ? i - f.a.goy : 0) * f.a.C;
  if (in && p0 == 1 && w.pr) {
    // Colour 0 of an odd row is the lane's phase-1 point.
    ldg_pair(g + row + w.at[0], a1, a0);
  } else {
    a0 = in && w.ok[p0] ? __ldg(g + row + w.at[p0]) : T(0);
    a1 = in && w.ok[1 - p0] ? __ldg(g + row + w.at[1 - p0]) : T(0);
  }
}

// A step's load of row i: load_row, but for Jacobi a row past ye reads 0
// rather than keeping the slot's row of kWin steps before, which no stage
// reads: that ends the old row's life, so U holds only the rows stage 0
// reads (RB-GS stages read nearly every slot of U anyway).
template <int KIND, bool EDGE, typename T, typename S, class Fr>
__device__ __forceinline__ void load_next(const S* __restrict__ g, T& a0,
                                          T& a1, int i, int par,
                                          const Unit<Fr>& w, const Fr& f) {
  if (KIND == mg::kJacobi && EDGE && i >= w.ye) {
    a0 = T(0);
    a1 = T(0);
    return;
  }
  load_row<EDGE>(g, a0, a1, i, par, w, f);
}

// ---------------------------------------------------------------------------
// Bfloat16 storage (S = __nv_bfloat16, T = float): the rows in flight stay
// in S. A row is loaded kAhead steps before the step that first reads it.
// Widened right at its load, the widening sits a few instructions after the
// load (a median 7 in the packed down leg's SASS) and waits for it there,
// leaving the prefetch's latency bare. So a load lands in a ring of raw
// rows (Raw: the 16-bit words, zero-extended in 32-bit registers) and is
// widened into the float window in the step that first reads it, kAhead
// steps on (a median 631 instructions after the load); widening is exact,
// so no result moves. The ring holds the registers the window's rows in
// flight held. On an H100 at 700 W, nu = 2, 4095^2 and S1's tiles
// (PERF.md): widened at the load the modes took 1.27-1.53x their float32
// twins' chained time on 55-75% of the bytes, with the rings 0.75-0.89x
// (the packed down leg 0.1421 -> 0.0784 ms against float32's 0.1045),
// 35-56% of their bounds.
// ---------------------------------------------------------------------------

// A row as loaded: a lane's two words, w0 and w1 (colours 0 and 1 on the
// packed frames; phases 0 and 1 on UTile, whose paired odd rows keep the
// 32-bit pair in w0 as it came, phase 0 in its low half, and w1 0).
struct Raw {
  unsigned w0, w1;
};

// The bfloat16 at p through the read-only cache, zero-extended to 32 bits
// (ptxas folds the extension into the 16-bit load).
__device__ __forceinline__ unsigned ldg_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// The aligned pair of bfloat16 at p as one word (p[0] in its low half).
__device__ __forceinline__ unsigned ldg_pair_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

// Words of two bfloat16 (common.cuh).
using mg::high_f;
using mg::low_f;
using mg::pack_bf16;

// load_row with S bfloat16, into r unwidened: the same addresses, tests and
// zeros.
template <bool EDGE>
__device__ __forceinline__ void load_raw(const __nv_bfloat16* __restrict__ g,
                                         Raw& r, int i, int par,
                                         const Unit<Whole>& w,
                                         const Whole& f) {
  if (EDGE && i >= w.ye) return;
  const int P = f.n + 2;
  const int cp = frame_lanes(f);
  const bool ok = w.ok[0];
  const size_t at = static_cast<size_t>(i) * cp + (ok ? w.gl : 0);
  r.w0 = ok ? ldg_bits(g + at) : 0u;
  r.w1 = ok ? ldg_bits(g + at + static_cast<size_t>(P) * cp) : 0u;
}

template <bool EDGE>
__device__ __forceinline__ void load_raw(const __nv_bfloat16* __restrict__ g,
                                         Raw& r, int i, int par,
                                         const Unit<Tile>& w,
                                         const Tile& f) {
  if (EDGE && i >= w.ye) return;
  const int cp = f.a.lanes();
  const bool in = !EDGE || i >= f.a.goy;
  const size_t row = static_cast<size_t>(in ? i - f.a.goy : 0);
  const int p0 = par & 1;
  r.w0 = in && w.ok[p0] ? ldg_bits(g + row * cp + w.at[p0]) : 0u;
  r.w1 = in && w.ok[1 - p0]
             ? ldg_bits(g + (static_cast<size_t>(f.a.R) + row) * cp +
                        w.at[1 - p0])
             : 0u;
}

template <bool EDGE>
__device__ __forceinline__ void load_raw(const __nv_bfloat16* __restrict__ g,
                                         Raw& r, int i, int par,
                                         const Unit<UTile>& w,
                                         const UTile& f) {
  if (EDGE && i >= w.ye) return;
  const bool in = !EDGE || i >= f.a.goy;
  const long long row =
      static_cast<long long>(in ? i - f.a.goy : 0) * f.a.C;
  if (in && (par & 1) == 1 && w.pr) {
    r.w0 = ldg_pair_bits(g + row + w.at[0]);
    r.w1 = 0u;
  } else {
    r.w0 = in && w.ok[0] ? ldg_bits(g + row + w.at[0]) : 0u;
    r.w1 = in && w.ok[1] ? ldg_bits(g + row + w.at[1]) : 0u;
  }
}

// Unpacked (the native mode): phases as on UTile, the pair on the even
// rows, where a lane whose two points lie in the row loads them as one
// aligned word (the launcher takes arrays that start on a 4-byte pair).
template <bool EDGE>
__device__ __forceinline__ void load_raw(const __nv_bfloat16* __restrict__ g,
                                         Raw& r, int i, int par,
                                         const Unit<Unpacked>& w,
                                         const Unpacked& f) {
  if (EDGE && i >= w.ye) return;
  const long long at = static_cast<long long>(i) * (f.n + 2) + 2 * w.gl;
  if ((par & 1) == 0 && w.ok[1]) {
    r.w0 = ldg_pair_bits(g + at);
    r.w1 = 0u;
  } else {
    r.w0 = w.ok[0] ? ldg_bits(g + at) : 0u;
    r.w1 = w.ok[1] ? ldg_bits(g + at + 1) : 0u;
  }
}

// Row r (parity par) widened into both colours a0, a1 (W: float, or Nb on
// the native frame).
template <class Fr, typename W>
__device__ __forceinline__ void widen_raw(const Raw& r, W& a0, W& a1,
                                          int par) {
  if constexpr (kIsUTile<Fr> || kIsUnpacked<Fr>) {
    // On the paired parity (UTile's odd rows, Unpacked's even ones) phase
    // 1 is the pair's high half or w1's low one: the other is 0.
    constexpr int pq = kIsUTile<Fr> ? 1 : 0;
    const float ph0 = low_f(r.w0);
    const float ph1 =
        (par & 1) == pq
            ? __uint_as_float((r.w0 & 0xffff0000u) | (r.w1 << 16))
            : low_f(r.w1);
    a0 = W((par & 1) ? ph1 : ph0);
    a1 = W((par & 1) ? ph0 : ph1);
  } else {
    a0 = low_f(r.w0);
    a1 = low_f(r.w1);
  }
}

// Bfloat16 storage: rows ys .. ys + kAhead - 1 into the rings ru, rb (a
// row the unit does not stream stays 0).
template <class Fr>
__device__ __forceinline__ void prime_raw(const __nv_bfloat16* __restrict__ u,
                                          const __nv_bfloat16* __restrict__ b,
                                          Raw (&ru)[kAhead], Raw (&rb)[kAhead],
                                          const Unit<Fr>& w, const Fr& f) {
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    ru[a] = rb[a] = Raw{0u, 0u};
    load_raw<true>(u, ru[a], w.ys + a, a, w, f);
    load_raw<true>(b, rb[a], w.ys + a, a, w, f);
  }
}

// Bfloat16 storage, step t (v = t - ys mod kWin): row t leaves the rings
// for the windows U and B, widened in the step that first reads it (stage
// 0 and the down leg's zero-stage residual read row t, the up leg adds P e
// to it; B's row is first read a step later), then row t + kAhead is
// loaded into its ring slot (v mod kAhead, a compile-time constant as the
// window's). The widening is unconditional, also in a chunk with row
// tests: a row past ye, which was not loaded, takes the slot's stale words
// (no step reads it), so no window slot carries an old row through a
// chunk, which would keep every slot of U and B live there (with the test
// the RB-GS legs took 140-160 registers, 12 warps an SM; PERF.md).
template <int v, bool EDGE, class Fr, typename W>
__device__ __forceinline__ void feed_raw(const __nv_bfloat16* __restrict__ u,
                                         const __nv_bfloat16* __restrict__ b,
                                         Raw (&ru)[kAhead], Raw (&rb)[kAhead],
                                         W (&U)[2][kWin], W (&B)[2][kWin],
                                         int t, const Unit<Fr>& w,
                                         const Fr& f) {
  static_assert(kWin % kAhead == 0 && (kAhead & (kAhead - 1)) == 0,
                "the rings' slots follow the window's");
  constexpr int q = v & (kAhead - 1);
  constexpr int s = v & (kWin - 1);
  widen_raw<Fr>(ru[q], U[0][s], U[1][s], v);
  widen_raw<Fr>(rb[q], B[0][s], B[1][s], v);
  load_raw<EDGE>(u, ru[q], t + kAhead, v + kAhead, w, f);
  load_raw<EDGE>(b, rb[q], t + kAhead, v + kAhead, w, f);
}

// The bfloat16 store of row i (parity par) from its rounded word q (phase
// 0 in the low half, as pack_bf16 makes it): store_row's addresses and
// owners, with no rounding left to do.
__device__ __forceinline__ void st_bits(__nv_bfloat16* p, unsigned v) {
  *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(v);
}

__device__ __forceinline__ void store_raw(__nv_bfloat16* __restrict__ g,
                                          unsigned q, int i, int par,
                                          const Unit<Whole>& w,
                                          const Whole& f) {
  const int P = f.n + 2;
  const int cp = frame_lanes(f);
  const int p0 = par & 1;   // colour 0's phase: its half of q
  if (w.core) {
    st_bits(g + static_cast<size_t>(i) * cp + w.gl, p0 ? q >> 16 : q);
    st_bits(g + (static_cast<size_t>(P) + i) * cp + w.gl, p0 ? q : q >> 16);
  }
}

__device__ __forceinline__ void store_raw(__nv_bfloat16* __restrict__ g,
                                          unsigned q, int i, int par,
                                          const Unit<Tile>& w,
                                          const Tile& f) {
  const int cp = f.a.lanes();
  const size_t row = static_cast<size_t>(i - f.a.goy);
  const int p0 = par & 1;
  if (w.st[p0]) st_bits(g + row * cp + w.at[p0], p0 ? q >> 16 : q);
  if (w.st[1 - p0]) {
    st_bits(g + (static_cast<size_t>(f.a.R) + row) * cp + w.at[1 - p0],
            p0 ? q : q >> 16);
  }
}

__device__ __forceinline__ void store_raw(__nv_bfloat16* __restrict__ g,
                                          unsigned q, int i, int par,
                                          const Unit<UTile>& w,
                                          const UTile& f) {
  const long long row = static_cast<long long>(i - f.a.goy) * f.a.C;
  if ((par & 1) == 1 && w.core && w.pr) {
    *reinterpret_cast<unsigned*>(g + row + w.at[0]) = q;
  } else {
    if (w.st[0]) st_bits(g + row + w.at[0], q);
    if (w.st[1]) st_bits(g + row + w.at[1], q >> 16);
  }
}

// Colour c of the row at step offset rv (its parity) from the down leg's
// ring Q of rounded rows (slot rv mod kRounded), widened.
template <int rv>
__device__ __forceinline__ float stored_colour(const unsigned (&Q)[kRounded],
                                               int c) {
  constexpr int slot = rv & (kRounded - 1);
  return ((c + rv) & 1) ? high_f(Q[slot]) : low_f(Q[slot]);
}

// Store both planes of row i (parity par) at this lane, where it owns them
// (on the whole packed grid and a shard's tile rounded to its storage type
// S).
template <typename T, typename S>
__device__ __forceinline__ void store_row(S* __restrict__ g, T a0, T a1,
                                          int i, int par,
                                          const Unit<Whole>& w,
                                          const Whole& f) {
  const int P = f.n + 2;
  const int cp = frame_lanes(f);
  if (w.core) {
    g[static_cast<size_t>(i) * cp + w.gl] = mg::narrow<S>(a0);
    g[(static_cast<size_t>(P) + i) * cp + w.gl] = mg::narrow<S>(a1);
  }
}

template <typename T, typename S>
__device__ __forceinline__ void store_row(S* __restrict__ g, T a0, T a1,
                                          int i, int par,
                                          const Unit<Tile>& w,
                                          const Tile& f) {
  const int cp = f.a.lanes();
  const size_t row = static_cast<size_t>(i - f.a.goy);
  const int p0 = par & 1;
  if (w.st[p0]) g[row * cp + w.at[p0]] = mg::narrow<S>(a0);
  if (w.st[1 - p0]) {
    g[(static_cast<size_t>(f.a.R) + row) * cp + w.at[1 - p0]] =
        mg::narrow<S>(a1);
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ g, T a0, T a1,
                                          int i, int par,
                                          const Unit<Unpacked>& w,
                                          const Unpacked& f) {
  const long long at = static_cast<long long>(i) * (f.n + 2) + 2 * w.gl;
  const int p0 = par & 1;
  if (p0 == 0 && w.st[1]) {
    *reinterpret_cast<Pair<T>*>(g + at) = Pair<T>{a0, a1};
  } else {
    if (w.st[p0]) g[at + p0] = a0;
    if (w.st[1 - p0]) g[at + 1 - p0] = a1;
  }
}

// The native mode's store on Unpacked: the same addresses and owners, each
// value already a bfloat16 one (the conversions round nothing); an even
// row's pair as one word.
__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ g,
                                          Nb a0, Nb a1, int i, int par,
                                          const Unit<Unpacked>& w,
                                          const Unpacked& f) {
  const long long at = static_cast<long long>(i) * (f.n + 2) + 2 * w.gl;
  const int p0 = par & 1;
  if (p0 == 0 && w.st[1]) {
    *reinterpret_cast<unsigned*>(g + at) = pack_bf16(a0.f, a1.f);
  } else {
    if (w.st[p0]) g[at + p0] = __float2bfloat16_rn(a0.f);
    if (w.st[1 - p0]) g[at + 1 - p0] = __float2bfloat16_rn(a1.f);
  }
}

template <typename T, typename S>
__device__ __forceinline__ void store_row(S* __restrict__ g, T a0, T a1,
                                          int i, int par,
                                          const Unit<UTile>& w,
                                          const UTile& f) {
  const long long row = static_cast<long long>(i - f.a.goy) * f.a.C;
  const int p0 = par & 1;
  if (p0 == 1 && w.core && w.pr) {
    st_pair(g + row + w.at[0], a1, a0);
  } else {
    if (w.st[p0]) g[row + w.at[p0]] = mg::narrow<S>(a0);
    if (w.st[1 - p0]) g[row + w.at[1 - p0]] = mg::narrow<S>(a1);
  }
}

// The full weighting fw at coarse (I, w.J): written by a core lane, as 0
// off the coarse interior; on the whole grid (packed or not) logical
// (nc+2)^2, or packed when packed_coarse is set; on a tile only inside the
// owned box keep, in the coarse tile ca (zero_coarse_frame writes the
// rest).
template <typename T, class Fr, std::enable_if_t<!kOnTile<Fr>, int> = 0>
__device__ __forceinline__ void put_coarse(T* __restrict__ rc, int I, T fw,
                                           const Unit<Fr>& w, const Fr& f,
                                           int packed_coarse) {
  const int nc = (f.n - 1) / 2;
  const int cp = frame_lanes(f);
  const int cpc = (cp + 1) / 2;
  const int Jc = w.gl;
  if (w.core) {
    const T val = I >= 1 && I <= nc && Jc >= 1 && Jc <= nc ? fw : T(0);
    if (packed_coarse) {
      rc[(static_cast<size_t>((I + Jc) & 1) * cp + I) * cpc + (Jc >> 1)] =
          val;
    } else {
      rc[static_cast<size_t>(I) * cp + Jc] = val;
    }
  }
}

// The native mode's coarse point: the logical bfloat16 (nc+2)^2 grid.
__device__ __forceinline__ void put_coarse(__nv_bfloat16* __restrict__ rc,
                                           int I, Nb fw,
                                           const Unit<Unpacked>& w,
                                           const Unpacked& f, int) {
  const int nc = (f.n - 1) / 2;
  const int Jc = w.gl;
  if (w.core) {
    const bool in = I >= 1 && I <= nc && Jc >= 1 && Jc <= nc;
    rc[static_cast<size_t>(I) * frame_lanes(f) + Jc] =
        __float2bfloat16_rn(in ? fw.f : 0.0f);
  }
}

template <typename T, class Fr, std::enable_if_t<kOnTile<Fr>, int> = 0>
__device__ __forceinline__ void put_coarse(T* __restrict__ rc, int I, T fw,
                                           const Unit<Fr>& w, const Fr& f,
                                           int) {
  const mg::InteriorBox& k = f.keep;
  if (w.core && I >= k.ylo && I <= k.yhi && w.J >= k.xlo && w.J <= k.xhi) {
    rc[f.ca.at(I, w.J)] = mg::interior(I, w.J, k.n) ? fw : T(0);
  }
}

// Zero the coarse tile off its owned box, the warps of the launch sharing
// its entries (each once): the rows above the box, the rows below it, and
// the columns either side of it in its rows.
template <typename T, class Fr>
__device__ void zero_coarse_frame(T* __restrict__ rc, const Fr& f, int unit,
                                  int units) {
  const mg::Rect& c = f.ca;
  const int qlo = f.keep.ylo - c.goy;
  const int qhi = f.keep.yhi + 1 - c.goy;
  const int slo = f.keep.xlo - c.gox;
  const int shi = f.keep.xhi + 1 - c.gox;
  const int above = qlo * c.C;
  const int bands = above + (c.R - qhi) * c.C;
  const int side = c.C - (shi - slo);
  const int total = bands + (qhi - qlo) * side;
  for (int k = unit * kWarp + threadIdx.x % kWarp; k < total;
       k += units * kWarp) {
    int q, s;
    if (k < bands) {
      const int r = k < above ? k : k - above + qhi * c.C;
      q = r / c.C;
      s = r - q * c.C;
    } else {
      const int r = k - bands;
      q = qlo + r / side;
      s = r - (q - qlo) * side;
      if (s >= slo) s += shi - slo;
    }
    rc[static_cast<size_t>(q) * c.C + s] = T(0);
  }
}

// Apply f(v) for v = 0 .. kWin - 1 with v a compile-time constant.
template <int v, typename F>
__device__ __forceinline__ void each_step(F&& f) {
  if constexpr (v < kWin) {
    f(std::integral_constant<int, v>{});
    each_step<v + 1>(f);
  }
}

// A chunk of kWin steps as f(v, EDGE) for v = 0 .. kWin - 1. Where every
// row the chunk loads, smooths, stores or restricts lies inside the unit
// (`steady`), and STEADY allows it, the chunk runs with EDGE false: no row
// tests, so each step is one block of code the compiler can schedule
// across stages (at 4095^2, nu = 2, on an H100 at 700 W: the down leg
// 0.142 -> 0.111 ms, the up leg 0.109 -> 0.102 ms; PERF.md). Else every
// step tests its rows. Jacobi keeps one copy of the steps (half the
// kernels' code to compile; it is off the main path).
template <bool STEADY, typename F>
__device__ __forceinline__ void chunk(bool steady, F&& f) {
  if (STEADY && steady) {
    each_step<0>([&](auto vc) { f(vc, std::false_type{}); });
  } else {
    each_step<0>([&](auto vc) { f(vc, std::true_type{}); });
  }
}

// Down leg: u' = smooth^K(u); rc = R (b - (A - sigma I) u'), on the packed
// frames the black residual taken as 0 after an RB-GS sweep (kRedOnly). rc
// is written in the logical (nc+2)^2 layout, or packed when packed_coarse
// is set (the whole packed grid), or as the tile's coarse tile. K counts
// stages: RB-GS half-sweeps or Jacobi sweeps. Lags: stage k at t - 1 - k,
// the residual and the store at t - (K + 1), the restriction of fine row
// t - K - 2 (its residual rows t - K - 3 .. t - K - 1 done). STORE false
// compiles the store of u' out (residual_restrict_kernel: u_out unused).
// u, b and u' are stored in S (bfloat16 storage on the whole packed grid
// and a shard's tile, T float; else S = T), rc in T; the residual is taken
// of u' as stored (rounded to S), so that the coarse correction targets the
// u' that goes up, as the TPU kernels take it (packed2d.py:678-683,
// local2d.py:454-457, plocal2d.py:366-376). With S bfloat16 each row of u'
// is rounded once, in the step it leaves the last stage (row t - K), into
// a ring Q of rounded rows that the residuals of rows i - 1 .. i + 1 and
// the store read; the window keeps it unrounded: the last stage of the next
// step still reads it. The native mode (T Nb, S and the coarse type C
// bfloat16) needs no ring: every value in flight is a bfloat16 one, so the
// residual reads the window and the store rounds nothing; its restriction
// weighs in JAX's order (weigh). SHIFT false drops the residual's sigma u
// term (residual_of; the native residual restriction).
template <typename T, int KIND, int K, bool STORE, class Fr, typename S = T,
          typename C = T, bool SHIFT = true>
__device__ __forceinline__ void down_stream(const S* __restrict__ u,
                                            const S* __restrict__ b,
                                            S* __restrict__ u_out,
                                            C* __restrict__ rc, const Fr& f,
                                            const mg::Coef<T>& cf,
                                            int packed_coarse,
                                            const LegGeom& g) {
  const int unit = blockIdx.x * kLegWarps + threadIdx.x / kWarp;
  if (unit >= g.strips * g.segs) return;
  if constexpr (kOnTile<Fr>) zero_coarse_frame(rc, f, unit, g.strips * g.segs);
  constexpr int OUT = K + 1;
  constexpr bool RED_ONLY = kRedOnly<Fr> && KIND == mg::kRbgs && K > 0;
  const Unit<Fr> w(g, unit, f);
  const int last_even = (w.y1 & 1) ? w.y1 - 1 : w.y1 - 2;
  const int t_end = last_even + OUT + 1;

  T U[2][kWin], B[2][kWin], R[2][kWin];
  T J[K > 0 ? K : 1][2][kWin];
  // Bfloat16 storage: the rows in flight of u and b, and rows of u' as
  // stored.
  [[maybe_unused]] Raw ru[kAhead], rb[kAhead];
  [[maybe_unused]] unsigned Q[kRounded];
  if constexpr (mg::kBf16<S>) {
    prime_raw(u, b, ru, rb, w, f);
  } else {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      load_row<true>(u, U[0][a], U[1][a], w.ys + a, a, w, f);
      load_row<true>(b, B[0][a], B[1][a], w.ys + a, a, w, f);
    }
  }
  T(&F)[2][kWin] = (KIND == mg::kJacobi && K > 0) ? J[K > 0 ? K - 1 : 0] : U;

  for (int t0 = w.ys; t0 <= t_end; t0 += kWin) {
    // Every row this chunk loads, smooths, stores or restricts inside the
    // unit: no row tests.
    const bool steady = t0 - OUT >= w.lo && t0 - OUT - 1 >= w.y0 &&
                        t0 + kWin - 2 <= w.hi && t0 + kWin - 1 - OUT < w.y1 &&
                        t0 + kWin - 1 + kAhead < w.ye;
    chunk<KIND == mg::kRbgs>(steady, [&](auto vc, auto edge) {
      constexpr int v = decltype(vc)::value;
      constexpr bool EDGE = decltype(edge)::value;
      const int t = t0 + v;
      if constexpr (mg::kBf16<S>) {
        feed_raw<v, EDGE>(u, b, ru, rb, U, B, t, w, f);
      } else {
        constexpr int sa = (v + kAhead) & (kWin - 1);
        load_next<KIND, EDGE>(u, U[0][sa], U[1][sa], t + kAhead, v + kAhead,
                              w, f);
        load_next<KIND, EDGE>(b, B[0][sa], B[1][sa], t + kAhead, v + kAhead,
                              w, f);
      }

      smooth_step<T, KIND, K, v, EDGE>(U, B, J, t, w, cf);

      // Residual of row i (0 off the points the smoothing updates, and at
      // the black ones with RED_ONLY) and the store of u'.
      const int i = t - OUT;
      constexpr int s = (v - OUT) & (kWin - 1);
      constexpr int sm = (s - 1) & (kWin - 1);
      constexpr int sp = (s + 1) & (kWin - 1);
      const bool live = !EDGE || (i >= w.lo && i <= w.hi);
      if constexpr (mg::kBf16<S> && !kNative<T>) {
        // Row t - K leaves the last stage: rounded once, phase 0 low.
        constexpr int sq = (v - K) & (kWin - 1);
        constexpr int c0 = (v - K) & 1;   // the colour at phase 0
        Q[(v - K) & (kRounded - 1)] = pack_bf16(F[c0][sq], F[1 - c0][sq]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (RED_ONLY && c == 1) {
            R[c][s] = T(0);
            continue;
          }
          const int o = 1 - c;
          const int p = (c + v - OUT) & 1;
          const T x = stored_colour<v - OUT>(Q, c);
          const T mid = stored_colour<v - OUT>(Q, o);
          const T side = side_of(mid, p);
          const T r = residual_of<Fr, T, SHIFT>(
              B[c][s], x, stored_colour<v - OUT - 1>(Q, o),
              stored_colour<v - OUT + 1>(Q, o), mid, side, p, cf);
          R[c][s] = live && w.upd[p] ? r : T(0);
        }
        if constexpr (STORE) {
          if (!EDGE || (i >= w.y0 && i < w.y1)) {
            store_raw(u_out, Q[(v - OUT) & (kRounded - 1)], i, v - OUT, w,
                      f);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (RED_ONLY && c == 1) {
            R[c][s] = T(0);
            continue;
          }
          const int o = 1 - c;
          const int p = (c + v - OUT) & 1;
          const T x = F[c][s];
          const T mid = F[o][s];
          const T side = side_of(mid, p);
          const T r = residual_of<Fr, T, SHIFT>(B[c][s], x, F[o][sm],
                                                F[o][sp], mid, side, p, cf);
          R[c][s] = live && w.upd[p] ? r : T(0);
        }
        if constexpr (STORE) {
          if (!EDGE || (i >= w.y0 && i < w.y1)) {
            store_row(u_out, F[0][s], F[1][s], i, v - OUT, w, f);
          }
        }
      }

      // Full weighting at coarse (I, J), fine row j = 2I, from the
      // residual rows j - 1 .. j + 1; rows first, then columns, as
      // transfer.restrict. Fine columns 2J and 2J + 1 are this
      // lane's phases 0 and 1 (colour (phase + row) & 1); 2J - 1 is lane
      // x - 1's phase 1, whose column sum comes by shuffle.
      const int j = t - OUT - 1;
      constexpr int sj = (v - OUT - 1) & (kWin - 1);
      if (((v - OUT - 1) & 1) == 0 && (!EDGE || (j >= w.y0 && j < w.y1))) {
        constexpr int r0 = (sj - 1) & (kWin - 1);
        constexpr int r2 = (sj + 1) & (kWin - 1);
        constexpr int c0 = (v - OUT) & 1;      // phase 0 in rows j +- 1
        constexpr int c1 = 1 - c0;             // phase 0 in row j
        if constexpr (kNative<T>) {
          const T t1 = weigh(R[c0][r0], R[c1][sj], R[c0][r2]);
          const T t2 = weigh(R[c1][r0], R[c0][sj], R[c1][r2]);
          put_coarse(rc, j >> 1, weigh(side_of(t2, 0), t1, t2), w, f,
                     packed_coarse);
        } else {
          const T t1 = T(0.25) * (R[c0][r0] + T(2) * R[c1][sj] + R[c0][r2]);
          const T t2 = T(0.25) * (R[c1][r0] + T(2) * R[c0][sj] + R[c1][r2]);
          const T t0v = __shfl_up_sync(0xffffffffu, t2, 1);
          put_coarse(rc, j >> 1, T(0.25) * (t0v + T(2) * t1 + t2), w, f,
                     packed_coarse);
        }
      }
    });
  }
}

template <typename T, int KIND, int K, class Fr, typename S = T>
__global__ void __launch_bounds__(kLegWarps * kWarp)
down_kernel(const S* __restrict__ u, const S* __restrict__ b,
            S* __restrict__ u_out, T* __restrict__ rc, Fr f,
            mg::Coef<T> cf, int packed_coarse, LegGeom g) {
  down_stream<T, KIND, K, true, Fr, S>(u, b, u_out, rc, f, cf, packed_coarse,
                                       g);
}

// rc = R (b - A u) on the unpacked grid (transfer2d.cu): the down leg's
// stream with no smoothing stage and no store of u', so it reads u and b
// once and writes only the coarse grid. A kernel of its own name, so that a
// profiler tells it from the zero-sweep down leg.
template <typename T>
__global__ void __launch_bounds__(kLegWarps * kWarp)
residual_restrict_kernel(const T* __restrict__ u, const T* __restrict__ b,
                         T* __restrict__ rc, Unpacked f, mg::Coef<T> cf,
                         LegGeom g) {
  down_stream<T, mg::kRbgs, 0, false, Unpacked, T>(u, b, nullptr, rc, f, cf,
                                                   0, g);
}

// Coarse point (I, J) of e; 0 off e. The whole grid's e is (Pc x Pc
// points, logical or, on the packed grid, packed), a tile's its coarse
// tile ca (logical).
template <typename T, bool PACKED_E, class Fr,
          std::enable_if_t<!kOnTile<Fr>, int> = 0>
__device__ __forceinline__ T coarse_at(const T* __restrict__ e, int I, int J,
                                       const Fr& f) {
  const int Pc = frame_lanes(f);
  const bool ok = I >= 0 && I < Pc && J >= 0 && J < Pc;
  const int cpc = (Pc + 1) / 2;
  const size_t at = PACKED_E ? (static_cast<size_t>((I + J) & 1) * Pc + I) *
                                       cpc + (J >> 1)
                             : static_cast<size_t>(I) * Pc + J;
  return ok ? __ldg(e + at) : T(0);
}

template <typename T, bool PACKED_E, class Fr,
          std::enable_if_t<kOnTile<Fr>, int> = 0>
__device__ __forceinline__ T coarse_at(const T* __restrict__ e, int I, int J,
                                       const Fr& f) {
  return f.ca.holds(I, J) ? __ldg(e + f.ca.at(I, J)) : T(0);
}

// The up leg's coarse window entry at (I, J): coarse_at's value; on the
// native frame (a logical bfloat16 e) its bits zero-extended, widened where
// the prolongation reads them (a widening at the load would wait for it
// there, as the rings' note says).
template <typename T, bool PACKED_E, class Fr, typename C>
__device__ __forceinline__ auto coarse_word(const C* __restrict__ e, int I,
                                            int J, const Fr& f) {
  if constexpr (kNative<T>) {
    const int Pc = frame_lanes(f);
    const bool ok = I >= 0 && I < Pc && J >= 0 && J < Pc;
    return ok ? ldg_bits(e + static_cast<size_t>(I) * Pc + J) : 0u;
  } else {
    return coarse_at<T, PACKED_E>(e, I, J, f);
  }
}

// Up leg, x' = smooth^K(x + P e), and the sweep stream, x' = smooth^K(x)
// (PROLONG false: no coarse operand; its window, loads and add are
// compiled out, the rest is shared as it is). e logical or packed (a
// template parameter, so the coarse loads carry no branch; only the whole
// packed grid takes a packed e). P e is added to row t in step t, from
// coarse rows t >> 1 and (t + 1) >> 1 (loaded with the fine rows, each lane
// its columns J and J + 1), as prolong_at (common.cuh) computes it, at
// every global-interior point; stage k works on row t - 1 - k; the store
// on row t - K. x and b are stored in S, the coarse e in T, x' in O
// (bfloat16 storage on the whole packed grid and a shard's tile: S
// bfloat16, T float, O bfloat16 or, at the top level of a mixed cycle,
// float; else all T). The native mode (T Nb; S, O and e's type C bfloat16)
// interpolates in JAX's order (average) and rounds x + P e.
template <typename T, int KIND, int K, bool PACKED_E, bool PROLONG, class Fr,
          typename S = T, typename O = S, typename C = T, bool PAIRED = false>
__device__ __forceinline__ void up_stream(const S* __restrict__ xin,
                                          const C* __restrict__ e,
                                          const S* __restrict__ b,
                                          O* __restrict__ out, const Fr& f,
                                          const mg::Coef<T>& cf,
                                          const LegGeom& g) {
  const int unit = blockIdx.x * kLegWarps + threadIdx.x / kWarp;
  if (unit >= g.strips * g.segs) return;
  constexpr int OUT = K;
  const int n = f.n;
  const Unit<Fr> w(g, unit, f);
  const int t_end = w.y1 - 1 + OUT;

  // The coarse window (native: e's bits, as coarse_word gives them).
  using CW = std::conditional_t<kNative<T>, unsigned, T>;
  T U[2][kWin], B[2][kWin];
  CW E0[kCoarseWin], E1[kCoarseWin];
  T J[K > 0 ? K : 1][2][kWin];
  [[maybe_unused]] Raw ru[kAhead], rb[kAhead];   // bfloat16: rows in flight
  // Rows ys .. ys + kAhead - 1 and the coarse rows they need.
  if constexpr (mg::kBf16<S>) {
    prime_raw(xin, b, ru, rb, w, f);
  } else {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      load_row<true>(xin, U[0][a], U[1][a], w.ys + a, a, w, f);
      load_row<true>(b, B[0][a], B[1][a], w.ys + a, a, w, f);
    }
  }
  if constexpr (PROLONG) {
#pragma unroll
    for (int m = 0; m <= kAhead / 2; ++m) {
      E0[m] = coarse_word<T, PACKED_E>(e, (w.ys >> 1) + m, w.J, f);
      E1[m] = coarse_word<T, PACKED_E>(e, (w.ys >> 1) + m, w.J + 1, f);
    }
  }
  T(&F)[2][kWin] = (KIND == mg::kJacobi && K > 0) ? J[K > 0 ? K - 1 : 0] : U;

  for (int t0 = w.ys; t0 <= t_end; t0 += kWin) {
    // Every row this chunk loads, prolongs, smooths or stores inside the
    // unit: no row tests.
    const bool steady = (!PROLONG || (t0 >= 1 && t0 + kWin - 1 <= n)) &&
                        t0 - K >= w.lo && t0 + kWin - 2 <= w.hi &&
                        t0 - OUT >= w.y0 && t0 + kWin - 1 - OUT < w.y1 &&
                        t0 + kWin - 1 + kAhead < w.ye;
    chunk<KIND == mg::kRbgs>(steady, [&](auto vc, auto edge) {
      constexpr int v = decltype(vc)::value;
      constexpr bool EDGE = decltype(edge)::value;
      const int t = t0 + v;
      if constexpr (mg::kBf16<S>) {
        feed_raw<v, EDGE>(xin, b, ru, rb, U, B, t, w, f);
      } else {
        constexpr int sa = (v + kAhead) & (kWin - 1);
        load_next<KIND, EDGE>(xin, U[0][sa], U[1][sa], t + kAhead,
                              v + kAhead, w, f);
        load_next<KIND, EDGE>(b, B[0][sa], B[1][sa], t + kAhead, v + kAhead,
                              w, f);
      }
      if constexpr (PROLONG && ((v + kAhead) & 1) == 1) {
        // Row t + kAhead is odd: it needs coarse row (t + kAhead + 1) / 2.
        constexpr int m = ((v + kAhead + 1) >> 1) & (kCoarseWin - 1);
        if (!EDGE || t + kAhead < w.ye) {
          const int I = (t + kAhead + 1) >> 1;
          E0[m] = coarse_word<T, PACKED_E>(e, I, w.J, f);
          E1[m] = coarse_word<T, PACKED_E>(e, I, w.J + 1, f);
        }
      }

      // x + P e on row t.
      if constexpr (PROLONG) {
        constexpr int s = v & (kWin - 1);
        constexpr int m0 = (v >> 1) & (kCoarseWin - 1);
        constexpr int m1 = ((v >> 1) + 1) & (kCoarseWin - 1);
        if (!EDGE || (t < w.ye && t >= 1 && t <= n)) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int p = (c + v) & 1;
            const int gx = 2 * w.J + p;
            T a, d;
            if constexpr (kNative<T>) {
              // Rows first, then columns, each average rounded once.
              if constexpr ((v & 1) == 1) {
                a = average(low_f(E0[m0]), low_f(E0[m1]));
                d = average(low_f(E1[m0]), low_f(E1[m1]));
              } else {
                a = T(low_f(E0[m0]));
                d = T(low_f(E1[m0]));
              }
              const T pe = p ? average(a.f, d.f) : a;
              if (gx >= 1 && gx <= n) U[c][s] = U[c][s] + pe;
            } else {
              if constexpr ((v & 1) == 1) {
                a = T(0.5) * (E0[m0] + E0[m1]);
                d = T(0.5) * (E1[m0] + E1[m1]);
              } else {
                a = E0[m0];
                d = E1[m0];
              }
              const T pe = p ? T(0.5) * (a + d) : a;
              if (gx >= 1 && gx <= n) U[c][s] = U[c][s] + pe;
            }
          }
        }
      }

      smooth_step<T, KIND, K, v, EDGE, Fr, PAIRED>(U, B, J, t, w, cf);

      const int i = t - OUT;
      constexpr int so = (v - OUT) & (kWin - 1);
      if (!EDGE || (i >= w.y0 && i < w.y1)) {
        store_row(out, F[0][so], F[1][so], i, v - OUT, w, f);
      }
    });
  }
}

template <typename T, int KIND, int K, bool PACKED_E, class Fr,
          typename S = T, typename O = S>
__global__ void __launch_bounds__(kLegWarps * kWarp)
up_kernel(const S* __restrict__ xin, const T* __restrict__ e,
          const S* __restrict__ b, O* __restrict__ out, Fr f,
          mg::Coef<T> cf, LegGeom g) {
  up_stream<T, KIND, K, PACKED_E, true, Fr, S, O>(xin, e, b, out, f, cf, g);
}

// The sweep stream: out = smooth^K(u), K >= 1 stages, on the up leg's
// rows, lanes and lags. A kernel of its own name, so that a profiler tells
// the sweeps from the legs on the same frame.
template <typename T, int KIND, int K, class Fr, typename S = T>
__global__ void __launch_bounds__(kLegWarps * kWarp)
sweep_kernel(const S* __restrict__ u, const S* __restrict__ b,
             S* __restrict__ out, Fr f, mg::Coef<T> cf, LegGeom g) {
  up_stream<T, KIND, K, false, false, Fr, S, S, T>(u, nullptr, b, out, f,
                                                   cf, g);
}

// The most stages a leg takes, each count its own kernel: a whole grid's
// (packed2d.py and fused2d.py: RB-GS 2 max_*_sweeps, Jacobi max_*_sweeps;
// the sweep stream kMaxUpStages: packed2d.max_fused_sweeps and
// stencil2d.max_fused_sweeps, and local2d.max_fused_sweeps on a tile) and
// a tile's legs' (local2d.py's caps, both legs).
constexpr int kMaxDownStages = 6;
constexpr int kMaxUpStages = 8;
constexpr int kMaxTileStages = 6;

// The geometry as the kernels take it, or false if it breaks the rules
// above or does not cover the frame's rows and lanes.
template <class Fr, std::enable_if_t<!kOnTile<Fr>, int> = 0>
bool covers(const LegGeom& g, const Fr& f) {
  return g.strips * g.strip >= frame_lanes(f) && g.segs * g.seg >= f.n + 2;
}

template <class Fr, std::enable_if_t<kOnTile<Fr>, int> = 0>
bool covers(const LegGeom& g, const Fr& f) {
  return g.strips * g.strip >= frame_lanes(f) &&
         g.segs * g.seg >= f.a.R + (f.a.goy & 1);
}

template <class Fr>
bool leg_geom(const int* v, const Fr& f, LegGeom* g) {
  *g = LegGeom{v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
  return g->strips > 0 && g->segs > 0 && g->strip > 0 && g->top % 2 == 0 &&
         g->seg > 0 && g->seg % 2 == 0 && g->strip + 2 * g->hp == kWarp &&
         covers(*g, f);
}

unsigned leg_blocks(const LegGeom& g) {
  return static_cast<unsigned>((g.strips * g.segs + kLegWarps - 1) /
                               kLegWarps);
}

template <typename T, typename S, int KIND, int MAXK, class Fr, int K = 0>
int launch_down_k(int stages, const S* u, const S* b, S* u_out, T* rc,
                  const Fr& f, const mg::Coef<T>& cf, int packed_coarse,
                  const LegGeom& g, cudaStream_t stream) {
  if constexpr (K > MAXK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (stages != K) {
      return launch_down_k<T, S, KIND, MAXK, Fr,
                           K + (KIND == mg::kRbgs ? 2 : 1)>(
          stages, u, b, u_out, rc, f, cf, packed_coarse, g, stream);
    }
    down_kernel<T, KIND, K, Fr, S><<<leg_blocks(g), kLegWarps * kWarp, 0,
                                     stream>>>(u, b, u_out, rc, f, cf,
                                               packed_coarse, g);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, typename S, typename O, int KIND, bool PACKED_E,
          int MAXK, class Fr, int K = 0>
int launch_up_k(int stages, const S* x, const T* e, const S* b, O* out,
                const Fr& f, const mg::Coef<T>& cf, const LegGeom& g,
                cudaStream_t stream) {
  if constexpr (K > MAXK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (stages != K) {
      return launch_up_k<T, S, O, KIND, PACKED_E, MAXK, Fr,
                         K + (KIND == mg::kRbgs ? 2 : 1)>(
          stages, x, e, b, out, f, cf, g, stream);
    }
    up_kernel<T, KIND, K, PACKED_E, Fr, S, O>
        <<<leg_blocks(g), kLegWarps * kWarp, 0, stream>>>(x, e, b, out, f,
                                                          cf, g);
    return static_cast<int>(cudaGetLastError());
  }
}

// Smoothing stages of a leg: RB-GS half-sweeps or Jacobi sweeps.
int leg_stages(int kind, int sweeps) {
  return kind == mg::kRbgs ? 2 * sweeps : sweeps;
}

// The down leg on frame f (a whole grid: kMaxDownStages; a tile:
// kMaxTileStages); on the unpacked frame u, b and u_out must start on a
// pair of T. u, b and u_out are stored in S (bfloat16 on the whole packed
// grid and a shard's tile; the unpacked grid's levels run in full
// precision in every mixed cycle), rc in T.
template <typename T, int MAXK, class Fr, typename S = T>
int launch_down(const void* u, const void* b, void* u_out, void* rc,
                const Fr& f, double h, double sigma, int kind, double omega,
                int sweeps, int packed_coarse, const int* geom,
                void* stream) {
  static_assert(std::is_same<S, T>::value || !kIsUnpacked<Fr>,
                "no narrow storage on the unpacked grid");
  const int K = leg_stages(kind, sweeps);
  LegGeom g;
  if (!leg_geom(geom, f, &g) ||
      (kIsUnpacked<Fr> && !on_pairs<T>(u, b, u_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto cf = mg::Coef<T>::make(h, sigma, omega);
  const auto s = static_cast<cudaStream_t>(stream);
  const S* ut = static_cast<const S*>(u);
  const S* bt = static_cast<const S*>(b);
  S* ot = static_cast<S*>(u_out);
  T* rt = static_cast<T*>(rc);
  return kind == mg::kRbgs
             ? launch_down_k<T, S, mg::kRbgs, MAXK>(K, ut, bt, ot, rt, f, cf,
                                                    packed_coarse, g, s)
             : launch_down_k<T, S, mg::kJacobi, MAXK>(K, ut, bt, ot, rt, f,
                                                      cf, packed_coarse, g,
                                                      s);
}

// R (b - A u) on the unpacked frame f: the down leg's geometry at K = 0
// (halos of 2 rows above, 1 below and 1 lane, which the launcher checks);
// u and b must start on a pair of T. sigma is 0, as in the JAX kernel.
template <typename T>
int launch_residual_restrict(const void* u, const void* b, void* rc,
                             const Unpacked& f, double h, const int* geom,
                             void* stream) {
  LegGeom g;
  if (!leg_geom(geom, f, &g) || g.top < 2 || g.bottom < 1 || g.hp < 1 ||
      !on_pairs<T>(u, b, u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  residual_restrict_kernel<T>
      <<<leg_blocks(g), kLegWarps * kWarp, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(u), static_cast<const T*>(b),
          static_cast<T*>(rc), f, mg::Coef<T>::make(h, 0.0, 1.0), g);
  return static_cast<int>(cudaGetLastError());
}

// The up leg on frame f; e logical or, on the whole packed grid, packed;
// on the unpacked frame x, b and out must start on a pair of T. x and b
// are stored in S, e in T, out in O (S bfloat16 and O bfloat16 or float on
// the whole packed grid and a shard's tile only).
template <typename T, int MAXK, class Fr, typename S = T, typename O = S>
int launch_up(const void* x, const void* e, const void* b, void* out,
              const Fr& f, double h, double sigma, int kind, double omega,
              int sweeps, int packed_e, const int* geom, void* stream) {
  static_assert((std::is_same<S, T>::value && std::is_same<O, T>::value) ||
                    !kIsUnpacked<Fr>,
                "no narrow storage on the unpacked grid");
  const int K = leg_stages(kind, sweeps);
  LegGeom g;
  if (!leg_geom(geom, f, &g) ||
      (kIsUnpacked<Fr> && !on_pairs<T>(x, b, out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto cf = mg::Coef<T>::make(h, sigma, omega);
  const auto s = static_cast<cudaStream_t>(stream);
  const S* xt = static_cast<const S*>(x);
  const T* et = static_cast<const T*>(e);
  const S* bt = static_cast<const S*>(b);
  O* ot = static_cast<O*>(out);
  if constexpr (!std::is_same<Fr, Whole>::value) {
    return kind == mg::kRbgs
               ? launch_up_k<T, S, O, mg::kRbgs, false, MAXK>(
                     K, xt, et, bt, ot, f, cf, g, s)
               : launch_up_k<T, S, O, mg::kJacobi, false, MAXK>(
                     K, xt, et, bt, ot, f, cf, g, s);
  } else {
    if (kind == mg::kRbgs) {
      return packed_e ? launch_up_k<T, S, O, mg::kRbgs, true, MAXK>(
                            K, xt, et, bt, ot, f, cf, g, s)
                      : launch_up_k<T, S, O, mg::kRbgs, false, MAXK>(
                            K, xt, et, bt, ot, f, cf, g, s);
    }
    return packed_e ? launch_up_k<T, S, O, mg::kJacobi, true, MAXK>(
                          K, xt, et, bt, ot, f, cf, g, s)
                    : launch_up_k<T, S, O, mg::kJacobi, false, MAXK>(
                          K, xt, et, bt, ot, f, cf, g, s);
  }
}

template <typename T, typename S, int KIND, int MAXK, class Fr,
          int K = (KIND == mg::kRbgs ? 2 : 1)>
int launch_sweep_k(int stages, const S* u, const S* b, S* out, const Fr& f,
                   const mg::Coef<T>& cf, const LegGeom& g,
                   cudaStream_t stream) {
  if constexpr (K > MAXK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (stages != K) {
      return launch_sweep_k<T, S, KIND, MAXK, Fr,
                            K + (KIND == mg::kRbgs ? 2 : 1)>(
          stages, u, b, out, f, cf, g, stream);
    }
    sweep_kernel<T, KIND, K, Fr, S>
        <<<leg_blocks(g), kLegWarps * kWarp, 0, stream>>>(u, b, out, f, cf,
                                                          g);
    return static_cast<int>(cudaGetLastError());
  }
}

// The sweep stream on frame f: out = smooth^K(u), K = leg_stages(kind,
// sweeps) from 1 to MAXK, on the up leg's geometry (halos of K rows and
// ceil(K/2) lanes, which the launcher checks); JACOBI: whether the Jacobi
// kernels are compiled (the packed grid runs RB-GS only). On the unpacked
// frame u, b and out must start on a pair of T. u, b and out are stored in
// S (bfloat16 on the whole packed grid only).
template <typename T, int MAXK, bool JACOBI, class Fr, typename S = T>
int launch_sweep(const void* u, const void* b, void* out, const Fr& f,
                 double h, double sigma, int kind, double omega, int sweeps,
                 const int* geom, void* stream) {
  static_assert(std::is_same<S, T>::value || std::is_same<Fr, Whole>::value,
                "narrow storage on the whole packed grid only");
  const int K = leg_stages(kind, sweeps);
  LegGeom g;
  const bool kind_ok = kind == mg::kRbgs || (JACOBI && kind == mg::kJacobi);
  if (!kind_ok || K < 1 || !leg_geom(geom, f, &g) || g.top < K ||
      g.bottom < K || 2 * g.hp < K ||
      (kIsUnpacked<Fr> && !on_pairs<T>(u, b, out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto cf = mg::Coef<T>::make(h, sigma, omega);
  const auto s = static_cast<cudaStream_t>(stream);
  const S* ut = static_cast<const S*>(u);
  const S* bt = static_cast<const S*>(b);
  S* ot = static_cast<S*>(out);
  if constexpr (JACOBI) {
    if (kind == mg::kJacobi) {
      return launch_sweep_k<T, S, mg::kJacobi, MAXK>(K, ut, bt, ot, f, cf, g,
                                                     s);
    }
  }
  return launch_sweep_k<T, S, mg::kRbgs, MAXK>(K, ut, bt, ot, f, cf, g, s);
}

// ---------------------------------------------------------------------------
// The native bfloat16 legs on the unpacked frame (fused2d_native_bf16.cu,
// fused2d_up_native_bf16.cu): the down and up streams with T = Nb and
// every array bfloat16 (u, b, u', the coarse rc and e), kernels of their
// own names, so that a profiler tells them from the float legs.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

template <int KIND, int K>
__global__ void __launch_bounds__(kLegWarps * kWarp)
native_down_kernel(const bf16* __restrict__ u, const bf16* __restrict__ b,
                   bf16* __restrict__ u_out, bf16* __restrict__ rc,
                   Unpacked f, mg::Coef<Nb> cf, LegGeom g) {
  down_stream<Nb, KIND, K, true, Unpacked, bf16, bf16>(u, b, u_out, rc, f,
                                                       cf, 0, g);
}

template <int KIND, int K>
__global__ void __launch_bounds__(kLegWarps * kWarp)
native_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ e,
                 const bf16* __restrict__ b, bf16* __restrict__ out,
                 Unpacked f, mg::Coef<Nb> cf, LegGeom g) {
  up_stream<Nb, KIND, K, false, true, Unpacked, bf16, bf16, bf16>(
      x, e, b, out, f, cf, g);
}

// The kernel of `stages` stages (K counts as launch_down_k's and
// launch_up_k's), up to MAXK.
template <bool DOWN, int KIND, int MAXK, int K = 0>
int launch_native_k(int stages, const bf16* u, const bf16* e, const bf16* b,
                    bf16* out, bf16* rc, const Unpacked& f,
                    const mg::Coef<Nb>& cf, const LegGeom& g,
                    cudaStream_t stream) {
  if constexpr (K > MAXK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (stages != K) {
      return launch_native_k<DOWN, KIND, MAXK,
                             K + (KIND == mg::kRbgs ? 2 : 1)>(
          stages, u, e, b, out, rc, f, cf, g, stream);
    }
    if constexpr (DOWN) {
      native_down_kernel<KIND, K><<<leg_blocks(g), kLegWarps * kWarp, 0,
                                    stream>>>(u, b, out, rc, f, cf, g);
    } else {
      native_up_kernel<KIND, K><<<leg_blocks(g), kLegWarps * kWarp, 0,
                                  stream>>>(u, e, b, out, f, cf, g);
    }
    return static_cast<int>(cudaGetLastError());
  }
}

// The native down leg (DOWN: u, b -> u' = out and rc; e unused) or up leg
// (x = u, e, b -> x' = out; rc unused) on the unpacked (n+2)^2 grid, with
// the host's constants cf; u, b and out must start on a pair of bfloat16
// (4 bytes), as the even rows' paired accesses need.
template <bool DOWN>
int launch_native(const void* u, const void* e, const void* b, void* out,
                  void* rc, const Unpacked& f, const mg::Coef<Nb>& cf,
                  int kind, int sweeps, const int* geom, void* stream) {
  constexpr int MAXK = DOWN ? kMaxDownStages : kMaxUpStages;
  LegGeom g;
  if (!leg_geom(geom, f, &g) || !on_pairs<bf16>(u, b, out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = leg_stages(kind, sweeps);
  const auto s = static_cast<cudaStream_t>(stream);
  const bf16* ut = static_cast<const bf16*>(u);
  const bf16* et = static_cast<const bf16*>(e);
  const bf16* bt = static_cast<const bf16*>(b);
  bf16* ot = static_cast<bf16*>(out);
  bf16* rt = static_cast<bf16*>(rc);
  return kind == mg::kRbgs
             ? launch_native_k<DOWN, mg::kRbgs, MAXK>(K, ut, et, bt, ot, rt,
                                                      f, cf, g, s)
             : launch_native_k<DOWN, mg::kJacobi, MAXK>(K, ut, et, bt, ot,
                                                        rt, f, cf, g, s);
}

// The owned box [qlo, qhi) x [slo, shi) (coarse tile indices) of the
// coarse tile ca of the n x n grid, in global coarse indices.
mg::InteriorBox owned_box(const mg::Rect& ca, int n, int qlo, int qhi,
                          int slo, int shi) {
  return mg::InteriorBox{(n - 1) / 2, ca.goy + qlo, ca.goy + qhi - 1,
                         ca.gox + slo, ca.gox + shi - 1};
}

// The tile frame of a leg on the packed tile a of the n x n grid, with the
// coarse tile ca and its owned box [qlo, qhi) x [slo, shi).
Tile tile_frame(const mg::PRect& a, const mg::Rect& ca, int n, int qlo,
                int qhi, int slo, int shi) {
  return Tile{n, a, mg::tile_inner(a, n), ca,
              owned_box(ca, n, qlo, qhi, slo, shi)};
}

// The unpacked tile frame of a leg or sweep on the tile a, as tile_frame
// (a sweep passes an empty coarse tile, which its stream never reads);
// `paired`: the fine arrays all start on a pair of their storage type
// (on_pairs), without which no row takes paired accesses.
UTile utile_frame(const mg::Rect& a, const mg::Rect& ca, int n, int qlo,
                  int qhi, int slo, int shi, bool paired) {
  // A lane's phase-0 point in an odd row i lies at index
  // (i - goy) C + 2l - (gox & 1): even for every lane, or odd for every one.
  const bool odd = ((((1 - a.goy) & a.C) ^ a.gox) & 1) == 0;
  return UTile{n, a, mg::tile_inner(a, n), ca,
               owned_box(ca, n, qlo, qhi, slo, shi), paired && odd};
}

}  // namespace

// 3D 7-point Poisson kernels: the residual, a weighted-Jacobi sweep and a
// red-black Gauss-Seidel sweep.
//
// Replace the three modes of the one TPU kernel in
// multigridcmt_tpu/kernels/stencil3d.py (its pallas_call):
//   residual     -> mg_stencil3d_residual  (one launch, MODE kResidual)
//   jacobi_sweep -> mg_stencil3d_jacobi    (one launch a sweep, kJacobi)
//   rbgs_sweep   -> mg_stencil3d_rbgs      (two launches a sweep: kRed from
//                                           u into tmp, then kBlack from tmp
//                                           into out)
//
// Grids are stacks of p planes of r x c points, row-major, c = n+2: the
// logical padded (n+2)^3 grid of a level, or a slab or pencil stack whose
// plane 0 is global plane goff and row 0 global row roff. The rules, as in
// the TPU kernel (_valid, red_plane):
//   * a plane is valid if it is not the stack's first or last and its
//     global index g+goff lies in [1, n]; every output plane that is not
//     valid is zero (the red pass keeps u there, for the black pass's
//     reads);
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
// What bounds them on the card: device-memory traffic. Each pass reads u
// and b and writes one grid, 12 bytes a point in float32 against ~10
// flops; at 511^3 a grid is 540 MB, far past the 50 MB L2. The design
// reads each input byte about once: a block owns a 32 x 8 (x, y) column of
// the stack and marches along z over a chunk of planes, keeping planes z-1,
// z and z+1 of its points in registers and plane z's tile with a one-point
// ring in shared memory for the in-plane neighbours; only the ring (80
// points a 256-point tile) and the chunk's two end planes are read twice.
// The TPU kernel's plane-block DMA ring, its rolls and its one-pass
// two-colour pipeline exist for VMEM and the TPU's DMA engine and are not
// carried over; the RB-GS sweep here takes two passes (a red pass that
// writes a whole grid, then a black pass), twice the bytes of one.
#include "common.cuh"

namespace {

constexpr int BX = 32;     // threads (points) along x
constexpr int BY = 8;      // threads (rows) along y
constexpr int ZC = 64;     // planes a block marches over

enum Mode { kResidual = 0, kJacobi = 1, kRed = 2, kBlack = 3 };

struct Stack {
  int p, r, c, n, goff, roff;
};

template <typename T>
__device__ __forceinline__ T load_or_zero(const T* __restrict__ u, size_t base,
                                          int y, int x, const Stack& s) {
  return (y >= 0 && y < s.r && x >= 0 && x < s.c)
             ? u[base + static_cast<size_t>(y) * s.c + x]
             : T(0);
}

// out = f(src, b) on every point of the block's column of the stack, for
// planes [z0, min(z0 + ZC, p)). src is u, or the red pass's output for the
// black pass; out never aliases src.
template <typename T, int MODE>
__global__ void __launch_bounds__(BX * BY)
stencil3d_kernel(const T* __restrict__ src, const T* __restrict__ b,
                 T* __restrict__ out, Stack s, mg::Coef<T> cf) {
  __shared__ T tile[BY + 2][BX + 2];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x = blockIdx.x * BX + tx;
  const int y = blockIdx.y * BY + ty;
  const int z0 = blockIdx.z * ZC;
  const int z1 = min(z0 + ZC, s.p);
  const bool in = x < s.c && y < s.r;
  const size_t plane = static_cast<size_t>(s.r) * s.c;
  const size_t xy = static_cast<size_t>(y) * s.c + x;
  const int gy = y + s.roff;
  const bool inplane = in && y >= 1 && y <= s.r - 2 && gy >= 1 &&
                       gy <= s.n && x >= 1 && x <= s.n;

  T below = (in && z0 >= 1) ? src[(z0 - 1) * plane + xy] : T(0);
  T cur = in ? src[z0 * plane + xy] : T(0);
  for (int z = z0; z < z1; ++z) {
    const size_t base = z * plane;
    const T above = (in && z + 1 < s.p) ? src[base + plane + xy] : T(0);
    __syncthreads();   // the previous plane's tile reads are done
    tile[ty + 1][tx + 1] = cur;
    if (tx == 0) tile[ty + 1][0] = load_or_zero(src, base, y, x - 1, s);
    if (tx == BX - 1) tile[ty + 1][BX + 1] = load_or_zero(src, base, y, x + 1, s);
    if (ty == 0) tile[0][tx + 1] = load_or_zero(src, base, y - 1, x, s);
    if (ty == BY - 1) tile[BY + 1][tx + 1] = load_or_zero(src, base, y + 1, x, s);
    __syncthreads();
    if (in) {
      const int gz = z + s.goff;
      const bool zvalid = z >= 1 && z <= s.p - 2 && gz >= 1 && gz <= s.n;
      const bool red = ((gz + gy + x) & 1) == 0;
      bool update = zvalid && inplane;
      if (MODE == kRed) update = update && red;
      if (MODE == kBlack) update = update && !red;
      T v = MODE == kResidual ? T(0) : cur;
      if (update) {
        const T sum = ((((below + above) + tile[ty][tx + 1]) +
                        tile[ty + 2][tx + 1]) + tile[ty + 1][tx]) +
                      tile[ty + 1][tx + 2];
        const T bval = b[base + xy];
        if (MODE == kRed || MODE == kBlack) {
          v = (cf.h2 * bval + sum) * cf.inv_den;
        } else {
          const T res = bval - (T(6) * cur - sum) * cf.inv_h2 + cf.sig * cur;
          v = MODE == kResidual ? res : cur + cf.jscale * res;
        }
      }
      if (MODE != kRed && !zvalid) v = T(0);
      out[base + xy] = v;
    }
    below = cur;
    cur = above;
  }
}

template <typename T, int MODE>
int launch(const void* src, const void* b, void* out, const Stack& s,
           const mg::Coef<T>& cf, cudaStream_t stream) {
  const dim3 grid((s.c + BX - 1) / BX, (s.r + BY - 1) / BY,
                  (s.p + ZC - 1) / ZC);
  stencil3d_kernel<T, MODE><<<grid, dim3(BX, BY), 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(b),
      static_cast<T*>(out), s, cf);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int residual(const void* u, const void* b, void* out, int p, int r, int c,
             int n, double h, double sigma, int goff, int roff,
             void* stream) {
  return launch<T, kResidual>(u, b, out, Stack{p, r, c, n, goff, roff},
                              mg::Coef<T>::make(h, sigma, 1.0, 6),
                              static_cast<cudaStream_t>(stream));
}

template <typename T>
int jacobi(const void* u, const void* b, void* out, int p, int r, int c,
           int n, double h, double sigma, double omega, int goff, int roff,
           void* stream) {
  return launch<T, kJacobi>(u, b, out, Stack{p, r, c, n, goff, roff},
                            mg::Coef<T>::make(h, sigma, omega, 6),
                            static_cast<cudaStream_t>(stream));
}

// One RB-GS sweep: red points of u into tmp (everything else copied),
// then black points of tmp into out (invalid planes zeroed). A red point's
// neighbours are all black and a black point's all red, so each pass reads
// only values the other pass wrote or kept: exact Gauss-Seidel order.
template <typename T>
int rbgs(const void* u, const void* b, void* tmp, void* out, int p, int r,
         int c, int n, double h, double sigma, int goff, int roff,
         void* stream) {
  const Stack s{p, r, c, n, goff, roff};
  const auto cf = mg::Coef<T>::make(h, sigma, 1.0, 6);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch<T, kRed>(u, b, tmp, s, cf, st);
  if (err != 0) return err;
  return launch<T, kBlack>(tmp, b, out, s, cf, st);
}

}  // namespace

extern "C" {

int mg_stencil3d_residual_f32(const void* u, const void* b, void* out, int p,
                              int r, int c, int n, double h, double sigma,
                              int goff, int roff, void* stream) {
  return residual<float>(u, b, out, p, r, c, n, h, sigma, goff, roff, stream);
}

int mg_stencil3d_residual_f64(const void* u, const void* b, void* out, int p,
                              int r, int c, int n, double h, double sigma,
                              int goff, int roff, void* stream) {
  return residual<double>(u, b, out, p, r, c, n, h, sigma, goff, roff,
                          stream);
}

int mg_stencil3d_jacobi_f32(const void* u, const void* b, void* out, int p,
                            int r, int c, int n, double h, double sigma,
                            double omega, int goff, int roff, void* stream) {
  return jacobi<float>(u, b, out, p, r, c, n, h, sigma, omega, goff, roff,
                       stream);
}

int mg_stencil3d_jacobi_f64(const void* u, const void* b, void* out, int p,
                            int r, int c, int n, double h, double sigma,
                            double omega, int goff, int roff, void* stream) {
  return jacobi<double>(u, b, out, p, r, c, n, h, sigma, omega, goff, roff,
                        stream);
}

int mg_stencil3d_rbgs_f32(const void* u, const void* b, void* tmp, void* out,
                          int p, int r, int c, int n, double h, double sigma,
                          int goff, int roff, void* stream) {
  return rbgs<float>(u, b, tmp, out, p, r, c, n, h, sigma, goff, roff,
                     stream);
}

int mg_stencil3d_rbgs_f64(const void* u, const void* b, void* tmp, void* out,
                          int p, int r, int c, int n, double h, double sigma,
                          int goff, int roff, void* stream) {
  return rbgs<double>(u, b, tmp, out, p, r, c, n, h, sigma, goff, roff,
                      stream);
}

}  // extern "C"

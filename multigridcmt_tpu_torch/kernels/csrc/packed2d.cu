// Colour-packed kernels for the finest 2D levels: the two whole-leg kernels,
// the fused residual norm of the convergence check, the residual and the
// fused RB-GS sweeps.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/packed2d.py:
//   smooth_residual_restrict -> packed2d_down     (down_kernel)
//   prolong_add_smooth       -> packed2d_up       (up_kernel)
//   residual_norm_sq         -> packed2d_resnorm  (resnorm_partial, _final)
//   residual                 -> packed2d_residual (residual_kernel)
//   rbgs_sweep               -> packed2d_rbgs     (rbgs_kernel)
//
// Layout. A padded grid of P = n+2 (odd) points a side is stored as two
// planes (2, P, cp), cp = (P+1)/2: plane 0 holds the red points ((i+j)
// even), plane 1 the black ones, each row packed along lanes with a
// row-parity offset, as in the TPU module:
//   R[i][l] = u[i][2l + (i&1)]          B[i][l] = u[i][2l + 1 - (i&1)]
// A row's lane past its last point of that colour is a pad and stays 0.
// A point of colour c at (i, l) lies in column 2l + p, p = (c + i) & 1, and
// its four neighbours are the other colour's (i-1, l), (i+1, l), (i, l) and
// (i, l-1) if p = 0 or (i, l+1) if p = 1. Sums run in the TPU module's
// order, ((up + down) + same lane) + side lane.
//
// What bounds them on the card: as fused2d.cu, the device-memory traffic
// of a leg at the large levels (u and b in, u' and the quarter-size coarse
// residual out, or x, b and the correction in and x' out; 12-13 bytes a
// point in float32); the sweeps run from shared memory. What packing does
// about the rest: each half-sweep runs one thread per point of its colour
// over unit-stride shared-memory lanes (the unpacked kernel reads and
// writes at a stride of two points, which splits a warp's float32 accesses
// over twice the banks' words), and a colour's lanes load contiguously.
// After an RB-GS sweep the closing black half-sweep zeroes the black
// residual (exactly in exact arithmetic), so the down leg restricts the red
// residual only and the norm can sum the red plane only, as on the TPU.
//
// Tiling as in fused2d.cu: a block owns TY rows and TX/2 lanes (TX fine
// columns) whose first row and column are even, so every coarse point has
// one writer. The row halo is H rings; the lane halo is HP = ceil(H/2)
// lanes, 2 HP >= H columns, so a tile starts on an even column and its
// lanes hold whole column pairs. Inputs and outputs never alias.
#include "common.cuh"

namespace {

constexpr int TX = 64;        // core fine columns per block (even)
constexpr int TY = 32;        // core rows per block (even)
constexpr int TXP = TX / 2;   // core lanes per block
constexpr int THREADS = 256;
constexpr int RN_THREADS = 256;

int down_halo(int kind, int sweeps) {
  return mg::sweep_halo(kind, sweeps) + 2;
}

// Load both planes of the RY x RXP lane tile at (gy0, gp0) of a packed
// (2, P, cp) grid into s (plane c at s + c * RY * RXP); off-grid reads 0.
template <typename T>
__device__ void load_ptile(const T* __restrict__ g, T* s, int RY, int RXP,
                           int gy0, int gp0, int P, int cp) {
  const int plane = RY * RXP;
  for (int idx = threadIdx.x; idx < 2 * plane; idx += blockDim.x) {
    const int c = idx >= plane;
    const int k = idx - c * plane;
    const int ly = k / RXP;
    const int gy = gy0 + ly;
    const int gp = gp0 + k - ly * RXP;
    s[idx] = (gy >= 0 && gy < P && gp >= 0 && gp < cp)
                 ? g[(static_cast<size_t>(c) * P + gy) * cp + gp]
                 : T(0);
  }
}

// Write the TY x TXP core lanes of both planes of tile s (halos H, HP).
template <typename T>
__device__ void store_pcore(const T* s, T* __restrict__ g, int RY, int RXP,
                            int H, int HP, int y0, int p0, int P, int cp) {
  const int plane = RY * RXP;
  for (int idx = threadIdx.x; idx < 2 * TY * TXP; idx += blockDim.x) {
    const int c = idx >= TY * TXP;
    const int k = idx - c * TY * TXP;
    const int cy = k / TXP;
    const int cl = k - cy * TXP;
    const int gy = y0 + cy;
    const int gp = p0 + cl;
    if (gy < P && gp < cp) {
      g[(static_cast<size_t>(c) * P + gy) * cp + gp] =
          s[c * plane + (H + cy) * RXP + HP + cl];
    }
  }
}

// Sum of the four neighbours of the point at lane index k of its plane,
// read from the other colour's plane o (row pitch `pitch` lanes). I is int
// in shared-memory tiles (32-bit address arithmetic) and size_t in device
// memory.
template <typename T, typename I>
__device__ __forceinline__ T nsum(const T* o, I k, I pitch, int p) {
  return ((o[k - pitch] + o[k + pitch]) + o[k]) + o[p ? k + 1 : k - 1];
}

// b - (A - sigma I) u at lane index k of plane uc (other plane uo).
template <typename T, typename I>
__device__ __forceinline__ T presidual(const T* uc, const T* uo, T bval,
                                       I k, I pitch, int p,
                                       const mg::Coef<T>& cf) {
  const T v = uc[k];
  return bval - (T(4) * v - nsum(uo, k, pitch, p)) * cf.inv_h2 + cf.sig * v;
}

// True if the colour-c point at tile lane index k (row ly, lane l) may be
// updated: interior to the grid and off the tile's outer ring of fine
// points, so that its four neighbours are in the tile. Sets *p.
__device__ __forceinline__ bool updatable(int c, int k, int RY, int RXP,
                                          int gy0, int gx0, int n, int* p) {
  const int ly = k / RXP;
  const int l = k - ly * RXP;
  const int gy = gy0 + ly;
  *p = (c + gy) & 1;
  const int lx = 2 * l + *p;
  return ly >= 1 && ly <= RY - 2 && lx >= 1 && lx <= 2 * RXP - 2 &&
         mg::interior(gy, gx0 + lx, n);
}

// One RB-GS half-sweep of colour c, in place on plane c of s.
template <typename T>
__device__ void half_sweep(T* s, const T* bs, int RY, int RXP, int gy0,
                           int gx0, int n, int c, const mg::Coef<T>& cf) {
  const int plane = RY * RXP;
  T* uc = s + c * plane;
  const T* uo = s + (1 - c) * plane;
  const T* bc = bs + c * plane;
  for (int k = threadIdx.x; k < plane; k += blockDim.x) {
    int p;
    if (!updatable(c, k, RY, RXP, gy0, gx0, n, &p)) continue;
    uc[k] = (cf.h2 * bc[k] + nsum(uo, k, RXP, p)) * cf.inv_den;
  }
}

// One weighted-Jacobi sweep of both planes from s into t.
template <typename T>
__device__ void jacobi(const T* s, T* t, const T* bs, int RY, int RXP,
                       int gy0, int gx0, int n, const mg::Coef<T>& cf) {
  const int plane = RY * RXP;
  for (int idx = threadIdx.x; idx < 2 * plane; idx += blockDim.x) {
    const int c = idx >= plane;
    const int k = idx - c * plane;
    T v = s[idx];
    int p;
    if (updatable(c, k, RY, RXP, gy0, gx0, n, &p)) {
      v = v + cf.jscale * presidual(s + c * plane, s + (1 - c) * plane,
                                    bs[idx], k, RXP, p, cf);
    }
    t[idx] = v;
  }
}

// `sweeps` smoother sweeps on the packed tile; returns the buffer holding
// the result. Staleness grows as in common.cuh's unpacked smoothing.
template <typename T>
__device__ T* smooth_ptile(T* s, T* t, const T* bs, int RY, int RXP, int gy0,
                           int gx0, int n, int kind, int sweeps,
                           const mg::Coef<T>& cf) {
  if (kind == mg::kRbgs) {
    for (int i = 0; i < sweeps; ++i) {
      half_sweep(s, bs, RY, RXP, gy0, gx0, n, 0, cf);
      __syncthreads();
      half_sweep(s, bs, RY, RXP, gy0, gx0, n, 1, cf);
      __syncthreads();
    }
    return s;
  }
  for (int i = 0; i < sweeps; ++i) {
    jacobi(s, t, bs, RY, RXP, gy0, gx0, n, cf);
    __syncthreads();
    T* tmp = s;
    s = t;
    t = tmp;
  }
  return s;
}

// Down leg: u' = smooth^sweeps(u); rc = R (b - (A - sigma I) u'), with the
// black residual taken as 0 after an RB-GS sweep. rc is written in the
// logical (nc+2)^2 layout, or packed when packed_coarse is set.
template <typename T>
__global__ void __launch_bounds__(THREADS)
down_kernel(const T* __restrict__ u, const T* __restrict__ b,
            T* __restrict__ u_out, T* __restrict__ rc, int n,
            mg::Coef<T> cf, int kind, int sweeps, int H, int HP,
            int packed_coarse) {
  extern __shared__ unsigned char smem_raw[];
  const int P = n + 2;
  const int cp = (P + 1) / 2;
  const int RY = TY + 2 * H;
  const int RXP = TXP + 2 * HP;
  const int plane = RY * RXP;
  const int RSX = TX + 2;     // residual tile: the core plus one ring
  const int RSY = TY + 2;
  const int y0 = blockIdx.y * TY;
  const int p0 = blockIdx.x * TXP;
  const int x0 = 2 * p0;
  const int gy0 = y0 - H;
  const int gx0 = 2 * (p0 - HP);

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + 2 * plane;
  T* rs = bs + 2 * plane;
  T* vs = rs + RSY * RSX;     // Jacobi ping-pong planes (RB-GS: unused)

  load_ptile(u, us, RY, RXP, gy0, p0 - HP, P, cp);
  load_ptile(b, bs, RY, RXP, gy0, p0 - HP, P, cp);
  __syncthreads();

  const T* w = smooth_ptile(us, vs, bs, RY, RXP, gy0, gx0, n, kind, sweeps,
                            cf);
  const bool red_only = kind == mg::kRbgs && sweeps >= 1;

  // Residual on the core plus one ring, in fine (unpacked) coordinates.
  for (int idx = threadIdx.x; idx < RSY * RSX; idx += blockDim.x) {
    const int a = idx / RSX;
    const int ly = H - 1 + a;
    const int lx = 2 * HP - 1 + idx - a * RSX;
    const int gy = gy0 + ly;
    T r = T(0);
    if (mg::interior(gy, gx0 + lx, n)) {
      const int c = (gy + lx) & 1;        // gx0 is even
      if (!(red_only && c)) {
        const int k = ly * RXP + (lx >> 1);
        r = presidual(w + c * plane, w + (1 - c) * plane, bs[c * plane + k],
                      k, RXP, lx & 1, cf);
      }
    }
    rs[idx] = r;
  }
  store_pcore(w, u_out, RY, RXP, H, HP, y0, p0, P, cp);
  __syncthreads();
  const int nc = (n - 1) / 2;
  mg::restrict_core<TY, TX>(rs, rc, y0, x0, mg::Rect::square(nc + 2),
                            mg::Interior{nc}, packed_coarse);
}

// Up leg: x' = smooth^sweeps(x + P e); e logical or packed (a template
// parameter, so that the coarse reads of the load loop carry no branch).
template <typename T, bool PACKED_E>
__global__ void __launch_bounds__(THREADS)
up_kernel(const T* __restrict__ x, const T* __restrict__ e,
          const T* __restrict__ b, T* __restrict__ out, int n,
          mg::Coef<T> cf, int kind, int sweeps, int H, int HP) {
  extern __shared__ unsigned char smem_raw[];
  const int P = n + 2;
  const int cp = (P + 1) / 2;
  const int Pc = (n - 1) / 2 + 2;
  const int RY = TY + 2 * H;
  const int RXP = TXP + 2 * HP;
  const int plane = RY * RXP;
  const int y0 = blockIdx.y * TY;
  const int p0 = blockIdx.x * TXP;
  const int gy0 = y0 - H;
  const int gp0 = p0 - HP;
  const mg::CoarseView<T> ev{e, Pc, (Pc + 1) / 2, PACKED_E};

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + 2 * plane;
  T* vs = bs + 2 * plane;     // Jacobi ping-pong planes (RB-GS: unused)

  for (int idx = threadIdx.x; idx < 2 * plane; idx += blockDim.x) {
    const int c = idx >= plane;
    const int k = idx - c * plane;
    const int ly = k / RXP;
    const int gy = gy0 + ly;
    const int gp = gp0 + k - ly * RXP;
    T xv = T(0);
    T bv = T(0);
    if (gy >= 0 && gy < P && gp >= 0 && gp < cp) {
      const size_t g = (static_cast<size_t>(c) * P + gy) * cp + gp;
      xv = x[g];
      bv = b[g];
      const int gx = 2 * gp + ((c + gy) & 1);
      if (mg::interior(gy, gx, n)) xv = xv + mg::prolong_at(ev, gy, gx);
    }
    us[idx] = xv;
    bs[idx] = bv;
  }
  __syncthreads();

  const T* w = smooth_ptile(us, vs, bs, RY, RXP, gy0, 2 * gp0, n, kind,
                            sweeps, cf);
  store_pcore(w, out, RY, RXP, H, HP, y0, p0, P, cp);
}

// RB-GS: u' = smooth^sweeps(u) on packed grids, halo H = 2 sweeps rows and
// HP = sweeps lanes (2 HP columns). Ghosts and pad lanes are never updated
// (not interior), so they keep u's zeros.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rbgs_kernel(const T* __restrict__ u, const T* __restrict__ b,
            T* __restrict__ out, int n, mg::Coef<T> cf, int sweeps, int H,
            int HP) {
  extern __shared__ unsigned char smem_raw[];
  const int P = n + 2;
  const int cp = (P + 1) / 2;
  const int RY = TY + 2 * H;
  const int RXP = TXP + 2 * HP;
  const int y0 = blockIdx.y * TY;
  const int p0 = blockIdx.x * TXP;
  const int gy0 = y0 - H;
  const int gp0 = p0 - HP;

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + 2 * RY * RXP;

  load_ptile(u, us, RY, RXP, gy0, gp0, P, cp);
  load_ptile(b, bs, RY, RXP, gy0, gp0, P, cp);
  __syncthreads();
  const T* w = smooth_ptile(us, us, bs, RY, RXP, gy0, 2 * gp0, n, mg::kRbgs,
                            sweeps, cf);
  store_pcore(w, out, RY, RXP, H, HP, y0, p0, P, cp);
}

// Sum of `v` over the block, valid in thread 0.
__device__ double block_sum(double v) {
  __shared__ double warp_sums[RN_THREADS / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < RN_THREADS / 32 ? warp_sums[threadIdx.x] : 0.0;
  if (threadIdx.x < 32) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  }
  return v;
}

// Residual norm, first pass: each block sums r^2 over a grid-stride share
// of the interior points of the first `planes` planes (1: red only) into
// partial[blockIdx.x], in float64. r is computed in T, as the plain version
// computes it; no residual array is written.
template <typename T>
__global__ void __launch_bounds__(RN_THREADS)
resnorm_partial(const T* __restrict__ u, const T* __restrict__ b,
                double* __restrict__ partial, int n, mg::Coef<T> cf,
                int planes) {
  const int P = n + 2;
  const int cp = (P + 1) / 2;
  const size_t plane = static_cast<size_t>(P) * cp;
  const size_t per_plane = static_cast<size_t>(n) * cp;   // interior rows
  double acc = 0.0;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < planes * per_plane;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = idx >= per_plane;
    const size_t r = idx - c * per_plane;
    const int i = 1 + static_cast<int>(r / cp);
    const int l = static_cast<int>(r - static_cast<size_t>(i - 1) * cp);
    const int p = (c + i) & 1;
    const int j = 2 * l + p;
    if (j < 1 || j > n) continue;
    const size_t k = static_cast<size_t>(i) * cp + l;
    const T res = presidual(u + c * plane, u + (1 - c) * plane,
                            b[c * plane + k], k, static_cast<size_t>(cp), p,
                            cf);
    acc += static_cast<double>(res) * static_cast<double>(res);
  }
  const double total = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// Residual norm, second pass: one block sums the partials in a fixed
// order, so the result does not depend on the blocks' timing.
template <typename T>
__global__ void __launch_bounds__(RN_THREADS)
resnorm_final(const double* __restrict__ partial, int count,
              T* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += partial[i];
  const double total = block_sum(acc);
  if (threadIdx.x == 0) out[0] = static_cast<T>(total);
}

// Packed residual r = b - (A - sigma I) u, both planes, one thread a lane.
// Ghost rows, ghost columns and pad lanes get 0, so whole-array dots over
// packed grids (the CG recurrence) are interior dots. Bound by memory: u
// both planes and b read, r written, 12 bytes a point in float32; the four
// neighbour reads of a lane hit in L1/L2.
template <typename T>
__global__ void __launch_bounds__(RN_THREADS)
residual_kernel(const T* __restrict__ u, const T* __restrict__ b,
                T* __restrict__ r, int n, mg::Coef<T> cf) {
  const int P = n + 2;
  const int cp = (P + 1) / 2;
  const size_t plane = static_cast<size_t>(P) * cp;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= 2 * plane) return;
  const int c = idx >= plane;
  const size_t k = idx - c * plane;
  const int i = static_cast<int>(k / cp);
  const int l = static_cast<int>(k - static_cast<size_t>(i) * cp);
  const int p = (c + i) & 1;
  T res = T(0);
  if (mg::interior(i, 2 * l + p, n)) {
    res = presidual(u + c * plane, u + (1 - c) * plane, b[idx], k,
                    static_cast<size_t>(cp), p, cf);
  }
  r[idx] = res;
}

dim3 leg_grid(int n) {
  const int P = n + 2;
  const int cp = (P + 1) / 2;
  return dim3((cp + TXP - 1) / TXP, (P + TY - 1) / TY);
}

template <typename T>
int launch_down(const void* u, const void* b, void* u_out, void* rc, int n,
                double h, double sigma, int kind, double omega, int sweeps,
                int packed_coarse, void* stream) {
  const int H = down_halo(kind, sweeps);
  const int HP = (H + 1) / 2;
  const size_t plane = static_cast<size_t>(TY + 2 * H) * (TXP + 2 * HP);
  const size_t bytes =
      sizeof(T) * ((kind == mg::kJacobi ? 6 : 4) * plane +
                   static_cast<size_t>(TY + 2) * (TX + 2));
  const int err = mg::set_smem(down_kernel<T>, bytes);
  if (err != 0) return err;
  down_kernel<T><<<leg_grid(n), THREADS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(u_out), static_cast<T*>(rc), n,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H, HP,
      packed_coarse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up(const void* x, const void* e, const void* b, void* out, int n,
              double h, double sigma, int kind, double omega, int sweeps,
              int packed_e, void* stream) {
  const int H = mg::sweep_halo(kind, sweeps);
  const int HP = (H + 1) / 2;
  const size_t plane = static_cast<size_t>(TY + 2 * H) * (TXP + 2 * HP);
  const size_t bytes = sizeof(T) * (kind == mg::kJacobi ? 6 : 4) * plane;
  const auto kernel = packed_e ? up_kernel<T, true> : up_kernel<T, false>;
  const int err = mg::set_smem(kernel, bytes);
  if (err != 0) return err;
  kernel<<<leg_grid(n), THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<const T*>(b), static_cast<T*>(out), n,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H, HP);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_resnorm(const void* u, const void* b, void* partial, void* out,
                   int n, double h, double sigma, int red_only, int blocks,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  resnorm_partial<T><<<blocks, RN_THREADS, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<double*>(partial), n, mg::Coef<T>::make(h, sigma, 1.0),
      red_only ? 1 : 2);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  resnorm_final<T><<<1, RN_THREADS, 0, s>>>(
      static_cast<const double*>(partial), blocks, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_residual(const void* u, const void* b, void* r, int n, double h,
                    double sigma, void* stream) {
  const int P = n + 2;
  const size_t total = 2 * static_cast<size_t>(P) * ((P + 1) / 2);
  const unsigned blocks =
      static_cast<unsigned>((total + RN_THREADS - 1) / RN_THREADS);
  residual_kernel<T><<<blocks, RN_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(r), n, mg::Coef<T>::make(h, sigma, 1.0));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rbgs(const void* u, const void* b, void* out, int n, double h,
                double sigma, int sweeps, void* stream) {
  const int H = mg::sweep_halo(mg::kRbgs, sweeps);
  const int HP = (H + 1) / 2;
  const size_t bytes =
      sizeof(T) * 4 * static_cast<size_t>(TY + 2 * H) * (TXP + 2 * HP);
  const int err = mg::set_smem(rbgs_kernel<T>, bytes);
  if (err != 0) return err;
  rbgs_kernel<T><<<leg_grid(n), THREADS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(out), n, mg::Coef<T>::make(h, sigma, 1.0), sweeps, H,
      HP);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mg_packed2d_down_f32(const void* u, const void* b, void* u_out, void* rc,
                         int n, double h, double sigma, int kind, double omega,
                         int sweeps, int packed_coarse, void* stream) {
  return launch_down<float>(u, b, u_out, rc, n, h, sigma, kind, omega,
                            sweeps, packed_coarse, stream);
}

int mg_packed2d_down_f64(const void* u, const void* b, void* u_out, void* rc,
                         int n, double h, double sigma, int kind, double omega,
                         int sweeps, int packed_coarse, void* stream) {
  return launch_down<double>(u, b, u_out, rc, n, h, sigma, kind, omega,
                             sweeps, packed_coarse, stream);
}

int mg_packed2d_up_f32(const void* x, const void* e, const void* b, void* out,
                       int n, double h, double sigma, int kind, double omega,
                       int sweeps, int packed_e, void* stream) {
  return launch_up<float>(x, e, b, out, n, h, sigma, kind, omega, sweeps,
                          packed_e, stream);
}

int mg_packed2d_up_f64(const void* x, const void* e, const void* b, void* out,
                       int n, double h, double sigma, int kind, double omega,
                       int sweeps, int packed_e, void* stream) {
  return launch_up<double>(x, e, b, out, n, h, sigma, kind, omega, sweeps,
                           packed_e, stream);
}

int mg_packed2d_resnorm_f32(const void* u, const void* b, void* partial,
                            void* out, int n, double h, double sigma,
                            int red_only, int blocks, void* stream) {
  return launch_resnorm<float>(u, b, partial, out, n, h, sigma, red_only,
                               blocks, stream);
}

int mg_packed2d_resnorm_f64(const void* u, const void* b, void* partial,
                            void* out, int n, double h, double sigma,
                            int red_only, int blocks, void* stream) {
  return launch_resnorm<double>(u, b, partial, out, n, h, sigma, red_only,
                                blocks, stream);
}

int mg_packed2d_rbgs_f32(const void* u, const void* b, void* out, int n,
                         double h, double sigma, int sweeps, void* stream) {
  return launch_rbgs<float>(u, b, out, n, h, sigma, sweeps, stream);
}

int mg_packed2d_rbgs_f64(const void* u, const void* b, void* out, int n,
                         double h, double sigma, int sweeps, void* stream) {
  return launch_rbgs<double>(u, b, out, n, h, sigma, sweeps, stream);
}

int mg_packed2d_residual_f32(const void* u, const void* b, void* r, int n,
                             double h, double sigma, void* stream) {
  return launch_residual<float>(u, b, r, n, h, sigma, stream);
}

int mg_packed2d_residual_f64(const void* u, const void* b, void* r, int n,
                             double h, double sigma, void* stream) {
  return launch_residual<double>(u, b, r, n, h, sigma, stream);
}

}  // extern "C"

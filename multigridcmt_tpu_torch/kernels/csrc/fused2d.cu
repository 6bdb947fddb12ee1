// Whole-leg fused V-cycle kernels for the 2D Poisson problem: one launch,
// one pass over the fine grid, per leg.
//
// Replace the TPU kernels multigridcmt_tpu/kernels/fused2d.py:
//   smooth_residual_restrict -> fused2d_down (down_kernel)
//   prolong_add_smooth       -> fused2d_up   (up_kernel)
//
// What bounds them on the card: the fine grid does not fit in L2 at the
// large levels (67 MB per float32 array at 4095^2), so the floor is the
// device-memory traffic of one leg: read u and b, write u' and the
// quarter-size coarse residual (down), or read x, b and the quarter-size
// correction and write x' (up), 12-13 bytes a point in float32. The
// smoothing sweeps, ~10 flops a point a sweep, run from shared memory.
// The design keeps all intermediate sweeps, the residual and the
// restriction out of device memory: each block loads its tile of u and b
// with a halo once, works on it in shared memory, and writes only its core.
//
// Tiling. A block owns a TY x TX core of fine points whose first row and
// column are even, so fine point 2I of coarse point I (transfer.py) lies
// in exactly one core and every coarse value has one writer. The halo
// covers the staleness of the in-tile sweeps (see common.cuh): RB-GS makes
// 2 rings stale a sweep, Jacobi 1, the residual needs one more ring and
// the full weighting one more. Neighbouring blocks read their halos from
// the input arrays, so the outputs never alias the inputs.
#include "common.cuh"

namespace {

constexpr int TX = 64;        // core columns per block (even)
constexpr int TY = 32;        // core rows per block (even)
constexpr int THREADS = 256;

// Halo rings a leg needs for `sweeps` sweeps of `kind`.
int down_halo(int kind, int sweeps) {
  return (kind == mg::kRbgs ? 2 * sweeps : sweeps) + 2;
}
int up_halo(int kind, int sweeps) {
  return kind == mg::kRbgs ? 2 * sweeps : sweeps;
}

// Load the RY x RX tile at global (gy0, gx0) of a P x P grid; points off
// the grid read as 0.
template <typename T>
__device__ void load_tile(const T* __restrict__ g, T* s, int RY, int RX,
                          int gy0, int gx0, int P) {
  for (int idx = threadIdx.x; idx < RY * RX; idx += blockDim.x) {
    const int ly = idx / RX;
    const int gy = gy0 + ly;
    const int gx = gx0 + idx - ly * RX;
    s[idx] = (gy >= 0 && gy < P && gx >= 0 && gx < P)
                 ? g[static_cast<size_t>(gy) * P + gx]
                 : T(0);
  }
}

// Write the TY x TX core of tile `s` (halo H) to the grid at (y0, x0).
template <typename T>
__device__ void store_core(const T* s, T* __restrict__ g, int RX, int H,
                           int y0, int x0, int P) {
  for (int idx = threadIdx.x; idx < TY * TX; idx += blockDim.x) {
    const int cy = idx / TX;
    const int cx = idx - cy * TX;
    const int gy = y0 + cy;
    const int gx = x0 + cx;
    if (gy < P && gx < P) {
      g[static_cast<size_t>(gy) * P + gx] = s[(H + cy) * RX + H + cx];
    }
  }
}

// Down leg: u' = smooth^sweeps(u); rc = R (b - (A - sigma I) u').
template <typename T>
__global__ void __launch_bounds__(THREADS)
down_kernel(const T* __restrict__ u, const T* __restrict__ b,
            T* __restrict__ u_out, T* __restrict__ rc, int n, mg::Coef<T> c,
            int kind, int sweeps, int H) {
  extern __shared__ unsigned char smem_raw[];
  const int P = n + 2;
  const int nc = (n - 1) / 2;
  const int Pc = nc + 2;
  const int RX = TX + 2 * H;
  const int RY = TY + 2 * H;
  const int RSX = TX + 2;     // residual tile: the core plus one ring
  const int RSY = TY + 2;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int gy0 = y0 - H;
  const int gx0 = x0 - H;

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + RY * RX;
  T* rs = bs + RY * RX;
  T* vs = rs + RSY * RSX;     // Jacobi ping-pong buffer (RB-GS: unused)

  load_tile(u, us, RY, RX, gy0, gx0, P);
  load_tile(b, bs, RY, RX, gy0, gx0, P);
  __syncthreads();

  const T* w = mg::smooth_tile(us, vs, bs, RY, RX, gy0, gx0, n, kind, sweeps,
                               c);

  // Residual on the core plus one ring (zero off the interior).
  for (int idx = threadIdx.x; idx < RSY * RSX; idx += blockDim.x) {
    const int a = idx / RSX;
    const int col = idx - a * RSX;
    const int ly = H - 1 + a;
    const int lx = H - 1 + col;
    const int k = ly * RX + lx;
    rs[idx] = mg::interior(gy0 + ly, gx0 + lx, n)
                  ? mg::residual_at(w + k, bs[k], RX, c)
                  : T(0);
  }
  store_core(w, u_out, RX, H, y0, x0, P);
  __syncthreads();

  // Full weighting [1 2 1; 2 4 2; 1 2 1]/16 at the coarse points this block
  // owns, rows first then columns as in transfer.restrict. Coarse I sits at
  // fine 2I = y0 + 2q, which is row 2q+1 of the residual tile.
  for (int idx = threadIdx.x; idx < (TY / 2) * (TX / 2); idx += blockDim.x) {
    const int q = idx / (TX / 2);
    const int s = idx - q * (TX / 2);
    const int I = y0 / 2 + q;
    const int J = x0 / 2 + s;
    if (I >= Pc || J >= Pc) continue;
    T val = T(0);
    if (mg::interior(I, J, nc)) {
      const T* r0 = rs + (2 * q) * RSX + 2 * s;
      const T* r1 = r0 + RSX;
      const T* r2 = r1 + RSX;
      const T t0 = T(0.25) * (r0[0] + T(2) * r1[0] + r2[0]);
      const T t1 = T(0.25) * (r0[1] + T(2) * r1[1] + r2[1]);
      const T t2 = T(0.25) * (r0[2] + T(2) * r1[2] + r2[2]);
      val = T(0.25) * (t0 + T(2) * t1 + t2);
    }
    rc[static_cast<size_t>(I) * Pc + J] = val;
  }
}

// Up leg: x' = smooth^sweeps(x + P e).
template <typename T>
__global__ void __launch_bounds__(THREADS)
up_kernel(const T* __restrict__ x, const T* __restrict__ e,
          const T* __restrict__ b, T* __restrict__ out, int n, mg::Coef<T> c,
          int kind, int sweeps, int H) {
  extern __shared__ unsigned char smem_raw[];
  const int P = n + 2;
  const int Pc = (n - 1) / 2 + 2;
  const int RX = TX + 2 * H;
  const int RY = TY + 2 * H;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int gy0 = y0 - H;
  const int gx0 = x0 - H;
  const mg::CoarseView<T> ev{e, Pc, (Pc + 1) / 2, false};

  T* us = reinterpret_cast<T*>(smem_raw);
  T* bs = us + RY * RX;
  T* vs = bs + RY * RX;       // Jacobi ping-pong buffer (RB-GS: unused)

  for (int idx = threadIdx.x; idx < RY * RX; idx += blockDim.x) {
    const int ly = idx / RX;
    const int gy = gy0 + ly;
    const int gx = gx0 + idx - ly * RX;
    T xv = T(0);
    T bv = T(0);
    if (gy >= 0 && gy < P && gx >= 0 && gx < P) {
      const size_t k = static_cast<size_t>(gy) * P + gx;
      xv = x[k];
      bv = b[k];
      if (mg::interior(gy, gx, n)) xv = xv + mg::prolong_at(ev, gy, gx);
    }
    us[idx] = xv;
    bs[idx] = bv;
  }
  __syncthreads();

  const T* w = mg::smooth_tile(us, vs, bs, RY, RX, gy0, gx0, n, kind, sweeps,
                               c);
  store_core(w, out, RX, H, y0, x0, P);
}

dim3 leg_grid(int n) {
  const int P = n + 2;
  return dim3((P + TX - 1) / TX, (P + TY - 1) / TY);
}

template <typename T>
int launch_down(const void* u, const void* b, void* u_out, void* rc, int n,
                double h, double sigma, int kind, double omega, int sweeps,
                void* stream) {
  const int H = down_halo(kind, sweeps);
  const size_t tile = static_cast<size_t>(TY + 2 * H) * (TX + 2 * H);
  const size_t bytes =
      sizeof(T) * ((kind == mg::kJacobi ? 3 : 2) * tile +
                   static_cast<size_t>(TY + 2) * (TX + 2));
  const int err = mg::set_smem(down_kernel<T>, bytes);
  if (err != 0) return err;
  down_kernel<T><<<leg_grid(n), THREADS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(u_out), static_cast<T*>(rc), n,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up(const void* x, const void* e, const void* b, void* out, int n,
              double h, double sigma, int kind, double omega, int sweeps,
              void* stream) {
  const int H = up_halo(kind, sweeps);
  const size_t tile = static_cast<size_t>(TY + 2 * H) * (TX + 2 * H);
  const size_t bytes = sizeof(T) * (kind == mg::kJacobi ? 3 : 2) * tile;
  const int err = mg::set_smem(up_kernel<T>, bytes);
  if (err != 0) return err;
  up_kernel<T><<<leg_grid(n), THREADS, bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<const T*>(b), static_cast<T*>(out), n,
      mg::Coef<T>::make(h, sigma, omega), kind, sweeps, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mg_fused2d_down_f32(const void* u, const void* b, void* u_out, void* rc,
                        int n, double h, double sigma, int kind, double omega,
                        int sweeps, void* stream) {
  return launch_down<float>(u, b, u_out, rc, n, h, sigma, kind, omega,
                            sweeps, stream);
}

int mg_fused2d_down_f64(const void* u, const void* b, void* u_out, void* rc,
                        int n, double h, double sigma, int kind, double omega,
                        int sweeps, void* stream) {
  return launch_down<double>(u, b, u_out, rc, n, h, sigma, kind, omega,
                             sweeps, stream);
}

int mg_fused2d_up_f32(const void* x, const void* e, const void* b, void* out,
                      int n, double h, double sigma, int kind, double omega,
                      int sweeps, void* stream) {
  return launch_up<float>(x, e, b, out, n, h, sigma, kind, omega, sweeps,
                          stream);
}

int mg_fused2d_up_f64(const void* x, const void* e, const void* b, void* out,
                      int n, double h, double sigma, int kind, double omega,
                      int sweeps, void* stream) {
  return launch_up<double>(x, e, b, out, n, h, sigma, kind, omega, sweeps,
                           stream);
}

}  // extern "C"

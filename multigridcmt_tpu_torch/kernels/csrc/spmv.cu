// Banded (DIA) sparse matrix-vector product on the packed layout.
//
// Replaces the TPU kernel multigridcmt_tpu/kernels/spmv.py (spmv_packed,
// its pallas_call): spmv_packed -> mg_spmv_dia, in float32 and float64 and
// in the TPU kernel's native bfloat16 mode (mg_spmv_dia_bf16: every product
// and sum rounded to bfloat16; the float32 and float64 code is unchanged).
//
// Layout (kernels/spmv.py): x and y are (H + R + H) x 128 row-major, the
// logical element i at flat position H*128 + i, the H-row skirts zero; the
// diagonals are (ndiag, R*128), d[k][i] = A[i, i + off_k], zero for i >= N.
// The kernel computes, for every flat position t of y,
//   y[t] = sum_k d[k][t - H*128] * x[t + off_k]     if H*128 <= t < (H+R)*128
//   y[t] = 0                                         on the skirts,
// summing in offsets order from 0 (nvcc contracts each step into an FMA,
// so results differ from the plain version by an ulp a term). H*128 exceeds
// every |off_k| (spmv.halo_rows), so x[t + off_k] never leaves the array;
// the entries of d that would reach past row 0 or N are zero by assembly,
// which makes the skirt reads harmless, and rows i >= N come out 0.
//
// What bounds it on the card: device-memory bytes. Each output element
// reads ndiag diagonal values and ndiag x values and writes one value,
// (ndiag + 2) * itemsize bytes of compulsory traffic for 2 * ndiag flops:
// at 4095^2 float32 (5 diagonals, R = 131,016) 469.6 MB, 0.140 ms at
// 3.35 TB/s. The design reads each byte about once: one thread an output
// element, so each diagonal is read with full coalescing; the x reads of
// the offsets -1, 0, +1 fall in the same cache lines, and those of +-n
// (+-n^2 in 3D) were fetched by blocks that ran just before or run just
// after, and hit in L2. The offsets are a device array of run-time values
// (the TPU kernel bakes them in at trace time), read through the read-only
// cache: every thread of a warp reads the same one. Indices are 64-bit.
// The TPU kernel's DMA tiles, lane rotates and skirt windows are layout
// devices of VMEM and the TPU's lanes, and are not carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
spmv_dia_kernel(const T* __restrict__ d, const T* __restrict__ x,
                const long long* __restrict__ offsets, T* __restrict__ y,
                int ndiag, long long len, long long skirt) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (t >= len + 2 * skirt) return;
  const long long i = t - skirt;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // The native bfloat16 mode: each product and each sum rounded to
    // bfloat16 (nearest even) at once, in offsets order from +0, as the
    // TPU kernel computes in bfloat16 itself. One float32 operation with
    // an explicit rounding mode (no FMA) rounded to bfloat16 is the
    // correctly rounded bfloat16 result (24 >= 2 * 8 + 2).
    float acc = 0.0f;
    if (i >= 0 && i < len) {
      for (int k = 0; k < ndiag; ++k) {
        const float p = __bfloat162float(__float2bfloat16_rn(__fmul_rn(
            __bfloat162float(d[k * len + i]),
            __bfloat162float(x[t + __ldg(offsets + k)]))));
        acc = __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, p)));
      }
    }
    y[t] = __float2bfloat16_rn(acc);
  } else {
    T acc = T(0);
    if (i >= 0 && i < len) {
      for (int k = 0; k < ndiag; ++k) {
        acc += d[k * len + i] * x[t + __ldg(offsets + k)];
      }
    }
    y[t] = acc;
  }
}

template <typename T>
int launch(const void* d, const void* x, const void* offsets, void* y,
           int ndiag, long long len, long long skirt, void* stream) {
  const long long total = len + 2 * skirt;
  const long long blocks = (total + THREADS - 1) / THREADS;
  spmv_dia_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d), static_cast<const T*>(x),
      static_cast<const long long*>(offsets), static_cast<T*>(y), ndiag, len,
      skirt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// len = R*128 (the packed core), skirt = H*128; x and y hold
// len + 2*skirt elements.
int mg_spmv_dia_f32(const void* d, const void* x, const void* offsets,
                    void* y, int ndiag, long long len, long long skirt,
                    void* stream) {
  return launch<float>(d, x, offsets, y, ndiag, len, skirt, stream);
}

int mg_spmv_dia_f64(const void* d, const void* x, const void* offsets,
                    void* y, int ndiag, long long len, long long skirt,
                    void* stream) {
  return launch<double>(d, x, offsets, y, ndiag, len, skirt, stream);
}

int mg_spmv_dia_bf16(const void* d, const void* x, const void* offsets,
                     void* y, int ndiag, long long len, long long skirt,
                     void* stream) {
  return launch<__nv_bfloat16>(d, x, offsets, y, ndiag, len, skirt, stream);
}

}  // extern "C"

// Block-sparse (blocked-ELL) matrix product with a transposed multivector.
//
// Replaces the TPU kernel multigridcmt_tpu/kernels/bell.py (spmm, its
// pallas_call): spmm -> mg_bell_spmm.
//
// Operands (kernels/bell.py): data (nbr, kmax, 128, 128) with
// data[i][k][r][c] = A[128 i + r, 128 cols[i][k] + c]; cols (nbr, kmax)
// int32; Xt (m, ldx) row-major, one vector a row; Yt (m, nbr*128). It
// computes
//   Yt[j][128 i + r] = sum_k sum_c Xt[j][128 cols[i][k] + c] * data[i][k][r][c]
// for every block row i, zero padding blocks included (as the TPU kernel
// multiplies them), accumulating in T: float32 for float32 storage, float64
// for float64 (JAX's _cdt). The TPU kernel asks for Precision.HIGHEST, so
// this is plain FMA (DFMA) arithmetic, never TF32 tensor-core products.
//
// What bounds it on the card: arithmetic. At the SpMV bench's shape (64 x
// 64 blocks, density 0.15, seed 1: kmax 18, 18.87M stored values, m = 128)
// it does 2 * 18.87M * 128 = 4.83 GFLOP on 84 MB: 0.072 ms at the 67
// TFLOP/s of float32 outside the tensor cores, 0.025 ms at 3.35 TB/s. The
// design keeps operands close to the FMA units: a block of 128 threads owns
// one block row i and a tile of MT = 32 vectors, and walks k (the TPU's
// sequential grid axis becomes this loop) and the 128 block columns c in
// steps of KC = 32, staging the A block's 128 x KC slice and the X tile's
// MT x KC slice in shared memory; each thread accumulates a 4 x 8 register
// tile (4 vectors, 8 block rows), 32 FMAs for every 12 shared-memory reads.
// Both slices are stored transposed (c outermost, padded by one), so the
// coalesced global reads along c and the compute reads along r are free of
// bank conflicts. The m-tile is the fastest grid index, so the blocks that
// share an A block run together and all but the first read it from L2;
// tiling m also fills the card (64 block rows x 4 tiles = 256 blocks on 132
// SMs at m = 128). Indices are 64-bit. Not done yet: a double-buffered
// (cp.async/TMA) pipeline and larger register tiles.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;      // block rows r
constexpr int BN = 128;      // block columns c
constexpr int MT = 32;       // vectors (rows of Xt) a block
constexpr int KC = 32;       // block columns staged a step
constexpr int THREADS = 128;
constexpr int TX = 16;       // threads along r: r = tx + TX * q
constexpr int TR = BM / TX;  // 8 block rows a thread
constexpr int TJ = MT / (THREADS / TX);  // 4 vectors a thread

template <typename T>
__global__ void __launch_bounds__(THREADS)
bell_spmm_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                 const T* __restrict__ xt, T* __restrict__ yt, int kmax,
                 int m, int mtiles, long long ldx) {
  __shared__ T as[KC][BM + 1];   // A slice, as[cc][r]
  __shared__ T xs[KC][MT + 1];   // X slice, xs[cc][j]
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long i = blockIdx.x / mtiles;
  const int j0 = (blockIdx.x % mtiles) * MT;
  const long long ldy = static_cast<long long>(gridDim.x / mtiles) * BM;

  T acc[TJ][TR];
#pragma unroll
  for (int p = 0; p < TJ; ++p)
#pragma unroll
    for (int q = 0; q < TR; ++q) acc[p][q] = T(0);

  for (int k = 0; k < kmax; ++k) {
    const long long blk = i * kmax + k;
    const T* a = data + blk * (BM * BN);
    const T* x = xt + static_cast<long long>(cols[blk]) * BN;
    for (int c0 = 0; c0 < BN; c0 += KC) {
      __syncthreads();   // the previous step's reads of as/xs are done
#pragma unroll
      for (int s = 0; s < BM * KC / THREADS; ++s) {
        const int e = tid + s * THREADS;
        const int r = e / KC;
        const int cc = e % KC;
        as[cc][r] = a[r * BN + c0 + cc];
      }
#pragma unroll
      for (int s = 0; s < MT * KC / THREADS; ++s) {
        const int e = tid + s * THREADS;
        const int j = e / KC;
        const int cc = e % KC;
        xs[cc][j] = j0 + j < m ? x[(j0 + j) * ldx + c0 + cc] : T(0);
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < KC; ++cc) {
        T av[TR];
        T xv[TJ];
#pragma unroll
        for (int q = 0; q < TR; ++q) av[q] = as[cc][tx + TX * q];
#pragma unroll
        for (int p = 0; p < TJ; ++p) xv[p] = xs[cc][ty * TJ + p];
#pragma unroll
        for (int p = 0; p < TJ; ++p)
#pragma unroll
          for (int q = 0; q < TR; ++q) acc[p][q] += xv[p] * av[q];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < TJ; ++p) {
    const int j = j0 + ty * TJ + p;
    if (j >= m) continue;
    T* row = yt + j * ldy + i * BM;
#pragma unroll
    for (int q = 0; q < TR; ++q) row[tx + TX * q] = acc[p][q];
  }
}

template <typename T>
int launch(const void* data, const void* cols, const void* xt, void* yt,
           long long nbr, long long kmax, long long m, long long ldx,
           void* stream) {
  const long long mtiles = (m + MT - 1) / MT;
  bell_spmm_kernel<T><<<static_cast<unsigned>(nbr * mtiles), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(cols),
      static_cast<const T*>(xt), static_cast<T*>(yt),
      static_cast<int>(kmax), static_cast<int>(m),
      static_cast<int>(mtiles), ldx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// data (nbr, kmax, 128, 128), cols (nbr, kmax) int32, xt (m, ldx) with
// ldx >= 128 * (the largest block column + 1), yt (m, nbr*128).
int mg_bell_spmm_f32(const void* data, const void* cols, const void* xt,
                     void* yt, long long nbr, long long kmax, long long m,
                     long long ldx, void* stream) {
  return launch<float>(data, cols, xt, yt, nbr, kmax, m, ldx, stream);
}

int mg_bell_spmm_f64(const void* data, const void* cols, const void* xt,
                     void* yt, long long nbr, long long kmax, long long m,
                     long long ldx, void* stream) {
  return launch<double>(data, cols, xt, yt, nbr, kmax, m, ldx, stream);
}

}  // extern "C"

// Block-sparse (blocked-ELL) matrix product with a transposed multivector.
//
// Replaces the TPU kernel multigridcmt_tpu/kernels/bell.py (spmm, its
// pallas_call): spmm -> mg_bell_spmm (float32, float64 and, with bfloat16
// storage, bfloat16).
//
// Operands (kernels/bell.py): data (nbr, kmax, 128, 128) with
// data[i][k][r][c] = A[128 i + r, 128 cols[i][k] + c]; cols (nbr, kmax)
// int32, in any order; Xt (m, ldx) row-major, one vector a row; Yt (m,
// nbr*128); data, Xt and Yt stored in S. It computes
//   Yt[j][128 i + r] = sum_k sum_c Xt[j][128 cols[i][k] + c] * data[i][k][r][c]
// accumulating in T: float32 for float32 and bfloat16 storage, float64 for
// float64 (JAX's _cdt, bell.py:54-59). The TPU kernel asks for
// Precision.HIGHEST, so this is plain FFMA (DFMA) arithmetic, never TF32
// tensor-core products. With S bfloat16 each staged value is widened to
// float32 where it is used (a product of two bfloat16 is exact in float32
// barring under- or overflow, so each FFMA rounds once, as the TPU
// kernel's float32 accumulation of exact products), and each Yt value is
// rounded to bfloat16 once, at its store (bell.py:195).
//
// What bounds it on the card: arithmetic. At the SpMV bench's shape (64 x
// 64 blocks, density 0.15, seed 1: kmax 18, 1152 stored blocks of which
// 679 populated, m = 128) the populated blocks take 2 * 679 * 128^3 = 2.85
// GFLOP: 0.0425 ms at the 67 TFLOP/s of float32 outside the tensor cores,
// against 75.5 MB of stored blocks (0.0225 ms at 3.35 TB/s), which a kernel
// must read to know a block is zero. At m = 8 (the SpMV carrier) those
// bytes bound it. In bfloat16 the same FFMAs run on half the bytes; its
// bound is the bytes, or the operations at the tensor cores' bfloat16
// rate, which this kernel does not use (ROADMAP.md).
//
// The design. A CTA of 256 threads owns one block row i and a tile of MT
// vectors (the m-tile, chosen from m: 8, 32, or 128 in float32 and bfloat16
// and 32 in float64), and a share of the block row's work: the block row's
// stored blocks, each walked in slices of 128 bytes of block columns (KC =
// 32 in float32, 16 in float64, 64 in bfloat16), form one walk of kmax * 128
// / KC slices, which the CL CTAs of a thread-block cluster split, rank q
// taking slices q, q + CL, ... (CL a power of two up to kMaxCluster, grown
// while the launch has fewer than kCtasPerSm CTAs an SM). Striding slices
// rather than blocks gives the ranks of a block row equal shares of its
// populated blocks (which bell_from_scipy stores first), so no rank idles at
// the cluster's barrier while another finishes a block. A slice, the A
// block's 128 x KC columns and the X tile's MT x KC, is copied to shared
// memory by cp.async, 16 bytes a copy, rows as in device memory at a pitch
// of 9 16-byte chunks (the reads of 8 consecutive rows' chunks fall in 8
// bank groups), into a ring of kStages slices, so the loads of the next
// slices overlap the FMAs of this one. Each thread accumulates a TR x 8
// register tile in T (TR = 8 block rows with a float accumulator at MT =
// 128, else 4), rows rg + RG p and vectors jg + JG t, 16 bytes of columns a
// step: its 8 vectors' chunks held, then each row's chunk, 4 (float32) or 8
// (bfloat16) FMAs a row and vector; at TR = 8 that is 16 16-byte shared
// loads for 256 FFMAs in float32, 512 in bfloat16. The staged slices are S,
// the partial tiles below T: shared memory is sized for each in its own
// type. Where RG x JG groups do not fill the CTA (small m-tiles), CS groups
// split each slice's columns and are summed in order at the end.
//
// Zero padding blocks (bell_from_scipy pads a block row to kmax with zero
// blocks at block column 0) cost no FMAs: after a slice lands, each thread
// tests the chunks it copied, and the CTA votes (__syncthreads_or) whether
// any A value of the slice is nonzero or any X value non-finite; it skips
// the slice's FMAs only when neither holds. Then every skipped product is
// an exact zero (the accumulators start at +0 and can never be -0), so
// the result is what multiplying every stored block gives, NaN and Inf
// in X included (0 * Inf is NaN, as in the plain version and JAX). The
// test reads the data, never cols: a user-built BELL need not be sorted.
//
// The cluster's partial tiles are summed through distributed shared
// memory: each CTA stores its tile in its own shared memory, the cluster
// syncs, and rank q sums a 1/CL share of the output tile over the ranks in
// rank order (and the CS groups in order) and writes it; no float atomics
// and no second launch, so a run repeats bit for bit. Indices are 64-bit.
// kernels/bell.py's launch_geometry mirrors the m-tile and cluster rules
// (a CPU test reads the constants below).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 128;            // block rows r
constexpr int BN = 128;            // block columns c
constexpr int kThreads = 256;      // threads a CTA
constexpr int kSliceBytes = 128;   // bytes of block columns a slice
constexpr int kStages = 3;         // the cp.async ring of slices
constexpr int kMaxCluster = 8;     // CTAs a block row's walk splits over
constexpr int kCtasPerSm = 4;      // the cluster split aims at this many
constexpr int kMTileSmall = 8;     // m-tiles: m <= 8 ...
constexpr int kMTileMid = 32;      // ... m <= 32 (float64: every m > 8) ...
constexpr int kMTileF32 = 128;     // ... a float accumulator, m > 32
constexpr int kTileRowsWide = 8;   // a thread's block rows at that m-tile
constexpr int kTileRows = 4;       // ... and at the others
constexpr int kTileVectors = 8;    // a thread's vectors

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};
template <>
struct Vec16<__nv_bfloat16> {
  using type = uint4;
};

// Element e of a 16-byte vector, in the accumulator's type (a bfloat16
// widened to float).
__device__ __forceinline__ float part(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ double part(const double2& v, int e) {
  return e == 0 ? v.x : v.y;
}
__device__ __forceinline__ float part(const uint4& v, int e) {
  const unsigned w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return e & 1 ? mg::high_f(w) : mg::low_f(w);
}

// The geometry of an (accumulator type, storage type, m-tile) instance.
template <typename T, typename S, int MT>
struct Geo {
  static constexpr int B = static_cast<int>(sizeof(S));  // bytes a value
  static constexpr bool WIDE = sizeof(T) == 4 && MT == kMTileF32;
  static constexpr int CTAS_PER_SM = WIDE || sizeof(T) == 8 ? 1 : 2;
  static constexpr int V = 16 / B;              // elements of 16 bytes
  static constexpr int KC = kSliceBytes / B;    // block columns a slice
  static constexpr int CPR = KC / V;            // 16-byte chunks a row
  static constexpr int PITCH = KC + V;          // staged row pitch
  static constexpr int SLICES = BN / KC;        // slices a block
  static constexpr int TR = WIDE ? kTileRowsWide : kTileRows;
  static constexpr int TJ = kTileVectors;
  static constexpr int RG = BM / TR;            // thread groups along r
  static constexpr int JG = MT / TJ;            // ... along j
  static constexpr int CS = kThreads / (RG * JG);  // ... along c
  static constexpr int CC = KC / CS;            // a group's columns a slice
  static constexpr int STAGE = (BM + MT) * PITCH;  // S elements a slice
  static constexpr int AC = BM * CPR / kThreads;  // A chunks a thread
  static constexpr int XC = MT * CPR;           // X chunks of the CTA
  static constexpr int PP = BM + 1;             // partial tile pitch
  static constexpr int PART = CS * MT * PP;     // T elements of the partials
  static constexpr int RING_BYTES = kStages * STAGE * B;
  static constexpr int PART_BYTES = PART * static_cast<int>(sizeof(T));
  static constexpr int SMEM =
      RING_BYTES > PART_BYTES ? RING_BYTES : PART_BYTES;
  static_assert(RG * JG * CS == kThreads, "thread groups fill the CTA");
  static_assert(CC % V == 0, "a group's columns are whole chunks");
  static_assert(BM * CPR % kThreads == 0, "A copies spread evenly");
};

// A 16-byte copy from device to shared memory, not waited for; with
// `live` false the 16 bytes are zero-filled (and src is not read).
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread's copies are
// pending.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two CTAs an SM (128 registers) where the tile fits them with no spill;
// a float accumulator's 8 x 8 tile at MT = 128 (208 registers in float32,
// 182 in bfloat16) and float64's (~160) take one: at two, ptxas spilled
// float32's and float64's.
template <typename T, typename S, int MT>
__global__ void __launch_bounds__(kThreads, Geo<T, S, MT>::CTAS_PER_SM)
bell_spmm_kernel(const S* __restrict__ data, const int* __restrict__ cols,
                 const S* __restrict__ xt, S* __restrict__ yt, int kmax,
                 int m, int mtiles, long long ldx, long long ldy) {
  using G = Geo<T, S, MT>;
  using Vec = typename Vec16<S>::type;
  constexpr int NT = kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* smem = reinterpret_cast<S*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  const long long tile = blockIdx.x / cl;
  const int j0 = static_cast<int>(tile % mtiles) * MT;
  const long long i = tile / mtiles;
  const int tid = threadIdx.x;
  const int rg = tid % G::RG;
  const int jg = (tid / G::RG) % G::JG;
  const int cgr = tid / (G::RG * G::JG);

  // This CTA's slices: g = q, q + cl, ... of block row i's kmax * SLICES.
  const int total = kmax * G::SLICES;
  const int ns = total > q ? (total - q + cl - 1) / cl : 0;
  const S* arow = data + i * kmax * (BM * BN);
  const int* crow = cols + i * kmax;
  // Chunk e of a slice is row e / CPR, chunk e % CPR: this thread's first
  // (e = tid) and, since NT is a multiple of CPR, its u-th lies NT / CPR
  // rows further. Its first X row and whether each X chunk is live.
  const int row0 = tid / G::CPR;
  const int ch0 = (tid % G::CPR) * G::V;
  const S* xfirst = xt + static_cast<long long>(j0 + row0) * ldx + ch0;
  constexpr int XU = (G::XC + NT - 1) / NT;
  constexpr int DROW = NT / G::CPR;
  const long long xstep = DROW * ldx;
  const int xlive = m - j0 - row0;     // X chunk u is live if u DROW < it

  // Copy the CTA's slice s into ring buffer s % kStages: the A slice's
  // rows, then the X slice's (zero past m), c contiguous as in device
  // memory.
  auto stage = [&](int s) {
    const int g = q + cl * s;
    const int k = g / G::SLICES;
    const int c0 = (g % G::SLICES) * G::KC;
    S* as = smem + (s % kStages) * G::STAGE + row0 * G::PITCH + ch0;
    S* xs = as + BM * G::PITCH;
    const S* a = arow + static_cast<long long>(k) * (BM * BN) + c0 +
                 row0 * BN + ch0;
    const S* x = xfirst + static_cast<long long>(crow[k]) * BN + c0;
#pragma unroll
    for (int u = 0; u < G::AC; ++u) {
      copy16(as + u * DROW * G::PITCH, a + u * DROW * BN, true);
    }
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      if (G::XC % NT == 0 || tid + u * NT < G::XC) {
        const bool live = u * DROW < xlive;
        copy16(xs + u * DROW * G::PITCH, live ? x : xt, live);
      }
      x += xstep;
    }
  };

  // Whether the chunks this thread copied of slice s hold a nonzero A
  // value or a non-finite X value (its own copies are complete and
  // visible to it after wait_copies).
  auto counts = [&](int s) {
    const S* as = smem + (s % kStages) * G::STAGE + row0 * G::PITCH + ch0;
    const S* xs = as + BM * G::PITCH;
    bool any = false;
#pragma unroll
    for (int u = 0; u < G::AC; ++u) {
      const Vec v = *reinterpret_cast<const Vec*>(as + u * DROW * G::PITCH);
#pragma unroll
      for (int c = 0; c < G::V; ++c) any |= part(v, c) != T(0);
    }
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      if (G::XC % NT == 0 || tid + u * NT < G::XC) {
        const Vec v =
            *reinterpret_cast<const Vec*>(xs + u * DROW * G::PITCH);
#pragma unroll
        for (int c = 0; c < G::V; ++c) any |= !isfinite(part(v, c));
      }
    }
    return any;
  };

  T acc[G::TR][G::TJ];
#pragma unroll
  for (int p = 0; p < G::TR; ++p)
#pragma unroll
    for (int t = 0; t < G::TJ; ++t) acc[p][t] = T(0);

  // The FMAs of the slice in ring buffer `buf`: this thread's rows rg + RG
  // p and vectors jg + JG t over its group's columns, 16 bytes of columns
  // a step: the X vectors' chunks held, then each row's chunk in turn.
  auto multiply = [&](int buf) {
    const S* as = smem + buf * G::STAGE + rg * G::PITCH + cgr * G::CC;
    const S* xs = smem + buf * G::STAGE + BM * G::PITCH + jg * G::PITCH +
                  cgr * G::CC;
#pragma unroll
    for (int ch = 0; ch < G::CC; ch += G::V) {
      Vec xv[G::TJ];
#pragma unroll
      for (int t = 0; t < G::TJ; ++t) {
        xv[t] = *reinterpret_cast<const Vec*>(xs + G::JG * t * G::PITCH + ch);
      }
#pragma unroll
      for (int p = 0; p < G::TR; ++p) {
        const Vec av =
            *reinterpret_cast<const Vec*>(as + G::RG * p * G::PITCH + ch);
#pragma unroll
        for (int t = 0; t < G::TJ; ++t)
#pragma unroll
          for (int c = 0; c < G::V; ++c)
            acc[p][t] = fma(part(av, c), part(xv[t], c), acc[p][t]);
      }
    }
  };

  // The ring: slices s + 1 .. s + kStages - 1 load while slice s is
  // multiplied. One barrier a slice: after it every copy of slice s is
  // visible and every thread is done with slice s - 1, whose buffer the
  // next copies fill.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ns) stage(s);
    commit_copies();
  }
  for (int s = 0; s < ns; ++s) {
    wait_copies<kStages - 2>();
    const bool work = __syncthreads_or(counts(s)) != 0;
    if (s + kStages - 1 < ns) stage(s + kStages - 1);
    commit_copies();
    if (work) multiply(s % kStages);
  }
  wait_copies<0>();
  __syncthreads();

  // The partial tiles, partial[cgr][j][r], in this CTA's shared memory;
  // the column groups summed in order into group 0's; then rank q sums
  // its share of the output over the cluster's ranks in rank order.
  T* partial = reinterpret_cast<T*>(smem_raw);
#pragma unroll
  for (int t = 0; t < G::TJ; ++t)
#pragma unroll
    for (int p = 0; p < G::TR; ++p)
      partial[(cgr * MT + jg + G::JG * t) * G::PP + rg + G::RG * p] =
          acc[p][t];
  if constexpr (G::CS > 1) {
    __syncthreads();
    for (int e = tid; e < MT * G::PP; e += NT) {
      T sum = partial[e];
#pragma unroll
      for (int g = 1; g < G::CS; ++g) sum += partial[g * MT * G::PP + e];
      partial[e] = sum;
    }
  }
  cluster.sync();
  // Every rank's value is loaded before the first is added, so that the
  // remote loads overlap.
  const int share = MT * BM / cl;
  for (int e = q * share + tid; e < (q + 1) * share; e += NT) {
    const int j = e / BM;
    const int r = e % BM;
    if (j0 + j >= m) continue;
    T* at = partial + j * G::PP + r;
    T v[kMaxCluster];
#pragma unroll
    for (int src = 0; src < kMaxCluster; ++src) {
      if (src < cl) v[src] = *cluster.map_shared_rank(at, src);
    }
    T sum = v[0];
#pragma unroll
    for (int src = 1; src < kMaxCluster; ++src) {
      if (src < cl) sum += v[src];
    }
    yt[(j0 + j) * ldy + i * BM + r] = mg::narrow<S>(sum);
  }
  // No CTA leaves while another reads its shared memory.
  cluster.sync();
}

// The cluster size: a power of two up to kMaxCluster and the block row's
// slices, doubled while the launch has fewer than kCtasPerSm CTAs an SM.
int cluster_size(long long tiles, long long slices, int sms) {
  int cl = 1;
  while (cl < kMaxCluster && 2 * cl <= slices &&
         tiles * cl < static_cast<long long>(kCtasPerSm) * sms) {
    cl *= 2;
  }
  return cl;
}

template <typename T, typename S, int MT>
int launch_tile(const S* data, const int* cols, const S* xt, S* yt,
                long long nbr, long long kmax, long long m, long long ldx,
                cudaStream_t stream) {
  using G = Geo<T, S, MT>;
  auto kernel = bell_spmm_kernel<T, S, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mtiles = (m + MT - 1) / MT;
  const int cl = cluster_size(nbr * mtiles, kmax * G::SLICES, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nbr * mtiles * cl));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, data, cols, xt, yt,
                           static_cast<int>(kmax), static_cast<int>(m),
                           static_cast<int>(mtiles), ldx, nbr * BM);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The m-tile from m (and the accumulator T); Yt must start on 16 bytes
// (its rows are whole 16-byte vectors), data and Xt on an element. Stored
// in S, accumulated in T.
template <typename T, typename S = T>
int launch(const void* data, const void* cols, const void* xt, void* yt,
           long long nbr, long long kmax, long long m, long long ldx,
           void* stream) {
  if (reinterpret_cast<uintptr_t>(yt) % 16 != 0 || nbr < 1 || kmax < 1 ||
      m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const S* d = static_cast<const S*>(data);
  const int* c = static_cast<const int*>(cols);
  const S* x = static_cast<const S*>(xt);
  S* y = static_cast<S*>(yt);
  const auto s = static_cast<cudaStream_t>(stream);
  if (m <= kMTileSmall) {
    return launch_tile<T, S, kMTileSmall>(d, c, x, y, nbr, kmax, m, ldx, s);
  }
  if constexpr (sizeof(T) == 4) {
    if (m > kMTileMid) {
      return launch_tile<T, S, kMTileF32>(d, c, x, y, nbr, kmax, m, ldx, s);
    }
  }
  return launch_tile<T, S, kMTileMid>(d, c, x, y, nbr, kmax, m, ldx, s);
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

// data, xt and yt bfloat16, a float32 accumulator.
int mg_bell_spmm_bf16(const void* data, const void* cols, const void* xt,
                      void* yt, long long nbr, long long kmax, long long m,
                      long long ldx, void* stream) {
  return launch<float, __nv_bfloat16>(data, cols, xt, yt, nbr, kmax, m, ldx,
                                      stream);
}

}  // extern "C"
